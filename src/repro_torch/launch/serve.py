"""Batched serving driver (the port of ``repro/launch/serve.py``): prefill
a batch of prompts, then greedy-decode with the ring-buffer KV cache
(int8-quantized with --int8-kv). Weights are random, from a seed.

  python -m repro_torch.launch.serve --arch phi3-medium-14b --preset full \
      --batch 4 --prompt-len 2048 --new-tokens 32 [--int8-kv]
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # reduced

The default device is the GPU; the CPU only when asked (``--device cpu``).
A request of the families audio and vlm carries its frontend (``make_batch``'s
stub frames or patches); vlm's patches take the first
``n_frontend_tokens`` positions of the cache, so the cache is that much
longer and every decode position is offset by it, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs as C
from ..models.model import build_model, make_batch, n_prefix


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(model, params, batch, new_tokens: int):
    """Prefill ``batch["tokens"]`` (B, S) with its frontend, if any, then
    ``new_tokens - 1`` greedy decode steps, at positions past vlm's
    patches. Returns ``(tokens (B, new_tokens), info)``; ``info``
    holds the prefill seconds, the decode seconds per token and whether
    every logit over the real vocab was finite. Times are host clock
    around work that ends in a device synchronise."""
    cfg, dev = model.cfg, model.device
    vocab = cfg.vocab
    # the first decode position: vlm's patches, then the prompt
    start = n_prefix(cfg) + batch["tokens"].shape[1]
    finite = torch.ones((), dtype=torch.bool, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch,
                                  cache_len=start + new_tokens)
    finite &= torch.isfinite(logits[..., :vocab]).all()
    tok = torch.argmax(logits[..., :vocab], dim=-1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, cache = model.decode(params, cache, tok, start + i)
        finite &= torch.isfinite(logits[..., :vocab]).all()
        tok = torch.argmax(logits[..., :vocab], dim=-1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    steps = max(new_tokens - 1, 1)
    return torch.cat(out, dim=1), {
        "prefill_seconds": t_prefill,
        "prefill_tokens_per_s": batch["tokens"].numel() / t_prefill,
        "decode_steps": new_tokens - 1,
        "decode_ms_per_token": t_decode / steps * 1e3,
        "logits_finite": bool(finite),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b", choices=C.ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = C.get(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen)
    batch = make_batch(gen, cfg, args.batch, args.prompt_len)

    gen_tokens, info = serve(model, params, batch, args.new_tokens)
    print(f"arch={cfg.name} kv={cfg.kv_dtype or cfg.dtype} batch={args.batch} "
          f"device={model.device}")
    print(f"prefill {args.prompt_len} tok: {info['prefill_seconds'] * 1e3:.1f}"
          f" ms | decode {info['decode_steps']} steps: "
          f"{info['decode_ms_per_token']:.1f} ms/token")
    print("generated token ids (seq 0):", gen_tokens[0].tolist())
    if not info["logits_finite"]:
        raise SystemExit("non-finite logits")
    if not bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all()):
        raise SystemExit("token ids outside the vocabulary")
    return gen_tokens, info


if __name__ == "__main__":
    main()
