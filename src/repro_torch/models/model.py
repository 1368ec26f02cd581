"""Public model API (the port of ``repro/models/model.py``):
``build_model(cfg, device) -> Model(init, prefill, decode, init_cache)``
for the families ``dense`` and ``ssm``.

Batch contract: {"tokens": (B, S) int64, "labels": (B, S) int64}.

Decode contract: the per-layer caches from ``prefill`` (or
``init_cache``), one token per sequence, the current position; returns
next-token logits and the caches, whose ring-buffer slot was written in
place.

``loss_fn`` belongs to training and is not ported yet; nor are the
families moe, hybrid, audio and vlm (ROADMAP Queue A item 11).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..api.driver import resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from . import transformer as T

SERVED_FAMILIES = ("dense", "ssm")


class Model(NamedTuple):
    cfg: ArchConfig
    device: torch.device
    init: Callable            # generator -> params (an nn.Module)
    prefill: Callable         # (params, batch, cache_len) -> (last_logits, caches)
    decode: Callable          # (params, caches, token (B,1), pos) -> (logits, caches)
    init_cache: Callable      # (batch_size, seq_len) -> zero caches


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _pad_seq(t, n):
    """Zero-pad the sequence axis (dim 1) of a (B, S, ...) cache by n."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, n))


def build_model(cfg: ArchConfig, device=None) -> Model:
    """The model on ``device``: the GPU unless the caller asks for another
    (raises without one)."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A item "
            f"11: the port serves {SERVED_FAMILIES})")
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    pattern = T.layer_pattern(cfg)

    def init(gen: torch.Generator) -> L.Params:
        """Random weights from ``gen``, which must live on the model's
        device: every matrix is drawn there, one at a time."""
        if gen.device.type != dev.type:
            raise ValueError(f"the generator is on {gen.device}, the model "
                             f"on {dev}")
        return L.Params({
            "embedding": L.embedding_init(gen, cfg, dtype),
            "layers": T.stack_init(gen, cfg, dtype, pattern),
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
        })

    @torch.inference_mode()
    def prefill(params, batch, cache_len=None):
        """cache_len: optionally allocate full-attention caches longer than
        the prompt (extra slots are masked in decode via the slot<=pos
        rule)."""
        x = L.embed(params["embedding"], batch["tokens"]).to(dtype)
        x, caches = T.stack_forward(pattern, params["layers"], cfg, x,
                                    want_cache=True)
        if cache_len is not None:
            for kind, cache in zip(pattern, caches):
                if kind == "attn_mlp":
                    n = cache_len - cache["k"].shape[1]
                    if n > 0:
                        for key in ("k", "v", "k_scale", "v_scale"):
                            if key in cache:
                                cache[key] = _pad_seq(cache[key], n)
        x = L.rmsnorm(params["final_norm"], x)
        last = L.logits_fn(params["embedding"], x[:, -1:], cfg)
        return last, caches

    @torch.inference_mode()
    def decode(params, caches, token, pos: int):
        """token: (B, 1) int64; pos: the next position index."""
        x = L.embed(params["embedding"], token).to(dtype)
        x, caches = T.stack_decode(pattern, params["layers"], cfg, x, caches,
                                   int(pos))
        x = L.rmsnorm(params["final_norm"], x)
        logits = L.logits_fn(params["embedding"], x, cfg)
        return logits, caches

    def init_cache(batch_size, seq_len):
        """Zero-filled caches shaped like prefill's output."""
        B = batch_size
        KV, hd = cfg.n_kv_heads, cfg.hd
        int8 = cfg.kv_dtype == "int8"
        kv_store = torch.int8 if int8 else dtype

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)

        def one(kind):
            if kind == "attn_mlp":
                out = {"k": zeros((B, seq_len, KV, hd), kv_store),
                       "v": zeros((B, seq_len, KV, hd), kv_store)}
                if int8:
                    out["k_scale"] = zeros((B, seq_len, KV, 1), torch.bfloat16)
                    out["v_scale"] = zeros((B, seq_len, KV, 1), torch.bfloat16)
                return out
            if kind == "rwkv":
                hr = cfg.rwkv_head_dim
                return {"shift_tm": zeros((B, cfg.d_model), dtype),
                        "shift_cm": zeros((B, cfg.d_model), dtype),
                        "wkv": zeros((B, cfg.d_model // hr, hr, hr),
                                     torch.float32)}
            raise T._not_ported(kind)

        return [one(kind) for kind in pattern]

    return Model(cfg=cfg, device=dev, init=init, prefill=prefill,
                 decode=decode, init_cache=init_cache)


def make_batch(gen: torch.Generator, cfg: ArchConfig, batch_size: int,
               seq_len: int):
    """Random batch on ``gen``'s device (for smoke tests and serving)."""
    shape = (batch_size, seq_len)
    return {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                    device=gen.device),
            "labels": torch.randint(0, cfg.vocab, shape, generator=gen,
                                    device=gen.device)}
