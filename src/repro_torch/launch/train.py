"""End-to-end FedMM language-model training (the port of
``repro/launch/train.py``): trains an architecture (reduced, ~100M or
full, per ``--preset``) with the FedMM trainer (``fed/trainer.py``:
quadratic surrogate, control variates, 8-bit uplink by default) on
heterogeneous synthetic token streams (``data.synthetic.token_stream``).
Weights are random, from a seed.

  python -m repro_torch.launch.train --arch gemma3-12b --preset 100m \
      --steps 20
  python -m repro_torch.launch.train --arch whisper-base --preset 100m
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset smoke --steps 20

The default device is the GPU; the CPU only when asked (``--device cpu``).
Each step prints the clients' mean loss on that step's fresh batch.
``main`` returns ``{"history": per-step metrics, "state": the final
FedLMState}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import checkpoint as ckpt
from .. import configs as C
from ..data.synthetic import token_stream
from ..fed import trainer as FT
from ..models.model import FRONTEND_KEYS, build_model


def preset_config(cfg, preset: str):
    if preset == "full":
        return cfg
    if preset == "smoke":
        return cfg.reduced()
    if preset == "100m":
        # a ~100M-parameter variant of the same family
        return dataclasses.replace(
            cfg.reduced(), n_layers=max(4, cfg.reduced().n_layers),
            d_model=512, d_ff=1536,
            n_heads=8 if cfg.n_heads else 0,
            n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
            head_dim=64 if cfg.head_dim else 0,
            vocab=min(cfg.vocab, 32768), rwkv_head_dim=64, dtype="float32")
    raise ValueError(preset)


def sample_batch(gen: torch.Generator, cfg, n_clients: int, b_local: int,
                 seq: int, device):
    """{"tokens", "labels"}: (n_clients, b_local, seq) each. Every client
    draws its own ``token_stream`` with its local batch as the stream's
    row count (each row from its own band of the vocabulary), as the
    reference's CLI does. vlm adds ``"patches"`` and audio ``"frames"``:
    (n_clients, b_local, n_frontend_tokens, d_model) float32 N(0, 1) *
    0.02, drawn after the tokens."""
    toks = torch.stack([token_stream(gen, b_local, seq + 1, cfg.vocab)
                        for _ in range(n_clients)]).to(device)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    key = FRONTEND_KEYS.get(cfg.family)
    if key:
        batch[key] = torch.randn(
            (n_clients, b_local, cfg.n_frontend_tokens, cfg.d_model),
            generator=gen).mul_(0.02).to(device)
    return batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-medium-14b", choices=C.ARCH_IDS)
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--quant-bits", type=int, default=8)
    ap.add_argument("--gamma", type=float, default=0.5)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = preset_config(C.get(args.arch), args.preset)
    model = build_model(cfg, device=args.device)
    fcfg = FT.FedLMConfig(
        n_clients=args.clients, rho=args.rho, p=args.participation,
        alpha=args.alpha, quant_bits=args.quant_bits, client_mode="logical")

    state = FT.init_state(
        model, torch.Generator(device=model.device).manual_seed(args.seed),
        fcfg)
    n_params = FT.param_count(model)
    print(f"arch={cfg.name} preset={args.preset} params={n_params/1e6:.1f}M "
          f"clients={args.clients} p={args.participation} "
          f"quant={args.quant_bits}b device={model.device}")

    step_fn = FT.make_train_step(model, fcfg)
    b_local = args.batch // args.clients
    data_gen = torch.Generator().manual_seed(args.seed)
    round_gen = torch.Generator().manual_seed(args.seed + 1)
    history = []
    t0 = time.time()
    for t in range(args.steps):
        gamma = args.gamma / (1.0 + t) ** 0.5
        batch = sample_batch(data_gen, cfg, args.clients, b_local, args.seq,
                             model.device)
        state, m = step_fn(state, batch, round_gen, gamma)
        m = {k: float(v) for k, v in m.items()}
        history.append(m)
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"step {t:5d}  loss={m['loss']:.4f} e_s={m['e_s']:.3e}  "
                  f"active={int(m['n_active'])} ({time.time() - t0:.1f}s)",
                  flush=True)
    if args.checkpoint:
        ckpt.save(args.checkpoint, state.s_hat)
        print(f"saved mirror parameter to {args.checkpoint}")
    return {"history": history, "state": state}


if __name__ == "__main__":
    main()
