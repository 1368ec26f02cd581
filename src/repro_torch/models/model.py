"""Public model API (the port of ``repro/models/model.py``):
``build_model(cfg, device) -> Model(init, prefill, decode, init_cache,
loss_fn)`` for the families ``dense`` (with gemma3's sliding-window
layers), ``moe`` (``attn_moe`` layers: llama4, qwen3), ``ssm``,
``hybrid`` (jamba: ``mamba_mlp`` and ``mamba_moe`` layers, one
``attn_moe`` or ``attn_mlp`` layer in ``attn_every``, no RoPE), ``audio``
(whisper: ``cfg.n_encoder_layers`` ``enc_mlp`` layers and ``enc_norm``
over the frames, then ``cross_mlp`` layers) and ``vlm`` (internvl:
``attn_mlp`` layers over the patches followed by the tokens).

Batch contract: {"tokens": (B, S) int64, "labels": (B, S) int64};
vlm adds {"patches": (B, P, d_model)} (stub ViT embeddings), audio
{"frames": (B, F, d_model)} (stub mel + conv embeddings), both cast to
the model dtype. vlm puts the patches before the token embeddings (early
fusion): the sequence is causal over P + S positions, RoPE at 0 .. P + S
- 1, and its caches hold P + S positions, so a decode step's position
counts the patches (``launch.serve`` offsets by ``n_frontend_tokens``).
audio encodes the frames once a forward (non-causal, RoPE on) and every
``cross_mlp`` layer attends to that output; prefill's ``cache_len`` pads
their self-attention ``k``/``v``, never the encoder's ``ek``/``ev``.

Decode contract: the per-layer caches from ``prefill`` (or
``init_cache``), one token per sequence, the current position; returns
next-token logits and the caches, whose ring-buffer slot was written in
place. Decode writes position p at slot p % R of an R-slot cache and
attends over the slots <= p.

A local (``swa_mlp``) layer's cache is a ring of R = min(window,
cache_len) slots (the prompt length S without ``cache_len``; a
``cache_len`` below S counts as S), as the reference's ``init_cache``
sizes it. Prefill writes the last min(window, S) positions, position p at
slot p % R, and leaves the other slots zero, so decode agrees with
prefill at every prompt length. The reference's prefill puts them at
slots 0, 1, ... in order and never pads a local cache to ``cache_len``;
that is the same cache whenever S is a multiple of the window, or S is
at most the window and no ``cache_len`` is given. Elsewhere the
reference's decode overwrites a position still inside the window (or
reads positions in the wrong slots) and departs from its own prefill;
the port's does not.

An ``attn_moe`` layer's cache is an ``attn_mlp`` layer's. Its MoE
drops by capacity within each token group, which is not causal (a later
token can take an earlier one's slot), so its decode agrees with its
prefill only where nothing drops: a decode step's group is one token,
which never drops.

A Mamba layer's cache is its state: ``"conv"`` (B, d_conv - 1, di) in the
model dtype, the last raw ``in_proj`` rows before the conv, and ``"ssm"``
(B, di, d_state) in float32. Prefill's ``cache_len`` pads the attention
caches only.

Training: ``loss_fn(params, batch)`` is the mean next-token
cross-entropy (``layers.chunked_softmax_xent``) of the stack run with
every layer rematerialised (``stack_forward(remat=True)``), plus ``0.01
* aux``, the layers' summed mixture-of-experts balance loss (0 without
an MoE), as in the reference. It takes a ``Params`` module or the plain
tree of ``layers.params_tree`` whose leaves require gradients, and runs
outside ``inference_mode``; ``prefill`` and ``decode`` keep theirs. Under
remat the encoder's layers are rematerialised too (the reference's
encoder ``stack_forward`` takes its default ``remat=True``); the loss
reads the positions past vlm's patches only.

audio with ``kv_dtype="int8"`` raises ``NotImplementedError``: the
reference's ``cross_mlp`` prefill keeps bf16 ``k``/``v`` where its decode
reads int8 codes and scales, so its first decode step fails (ROADMAP
Queue C item 7); the port adds no feature the reference lacks.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..api.driver import resolve_device
from ..configs.base import ArchConfig
from . import layers as L
from . import transformer as T
from .sharding import like, shard

SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# the batch key of each family's frontend embeddings
FRONTEND_KEYS = {"vlm": "patches", "audio": "frames"}


class Model(NamedTuple):
    cfg: ArchConfig
    device: torch.device
    init: Callable            # generator -> params (an nn.Module)
    prefill: Callable         # (params, batch, cache_len) -> (last_logits, caches)
    decode: Callable          # (params, caches, token (B,1), pos) -> (logits, caches)
    init_cache: Callable      # (batch_size, seq_len) -> zero caches
    loss_fn: Callable         # (params, batch) -> mean xent + 0.01 aux


def n_prefix(cfg: ArchConfig) -> int:
    """The positions a request's frontend takes before its tokens: vlm's
    patches, none for another family (audio's frames are the encoder's)."""
    return cfg.n_frontend_tokens if cfg.family == "vlm" else 0


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _pad_seq(t, n):
    """Zero-pad the sequence axis (dim 1) of a (B, S, ...) cache by n."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, n))


def _ring(cache: dict, S: int, R: int) -> dict:
    """A local layer's cache of the last n <= R positions S - n .. S - 1
    (in order along dim 1) as a ring of R slots: position p at slot
    p % R, the other slots zero."""
    n = cache["k"].shape[1]
    slots = like(torch.arange(S - n, S, device=cache["k"].device) % R,
                 cache["k"])
    out = {}
    for key, t in cache.items():
        # out of place: a DTensor takes no in-place write that changes
        # its layout
        out[key] = t.new_zeros((t.shape[0], R) + tuple(t.shape[2:])) \
            .index_copy(1, slots, t)
    return out


def build_model(cfg: ArchConfig, device=None, pattern=None) -> Model:
    """The model on ``device``: the GPU unless the caller asks for another
    (raises without one). ``pattern``: its layer kinds in place of
    ``layer_pattern(cfg)`` (a shallow model of chosen kinds, which the
    dry run's ``depth_line`` counts)."""
    if cfg.family not in SERVED_FAMILIES:
        raise ValueError(f"family {cfg.family!r}: the port serves "
                         f"{SERVED_FAMILIES}")
    if cfg.family == "audio" and cfg.kv_dtype == "int8":
        raise NotImplementedError(
            "audio with the int8 KV cache: the reference's cross_mlp prefill "
            "keeps bf16 k/v that its int8 decode cannot read (ROADMAP Queue "
            "C item 7)")
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    pattern = T.layer_pattern(cfg) if pattern is None else list(pattern)
    enc_pattern = ["enc_mlp"] * cfg.n_encoder_layers
    audio, vlm = cfg.family == "audio", cfg.family == "vlm"

    def init(gen: torch.Generator) -> L.Params:
        """Random weights from ``gen``, which must live on the model's
        device: every matrix is drawn there, one at a time."""
        if gen.device.type != dev.type:
            raise ValueError(f"the generator is on {gen.device}, the model "
                             f"on {dev}")
        tree = {
            "embedding": L.embedding_init(gen, cfg, dtype),
            "layers": T.stack_init(gen, cfg, dtype, pattern),
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, dev),
        }
        if audio:
            tree["encoder"] = T.stack_init(gen, cfg, dtype, enc_pattern)
            tree["enc_norm"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
        return L.Params(tree)

    def _embed_inputs(params, batch, remat=False):
        """Token embeddings and the frontend: (x, enc_out, the positions
        of x before the tokens)."""
        x = L.embed(params["embedding"], batch["tokens"]).to(dtype)
        x = shard(x, "batch", None, None)
        if vlm:
            patches = batch["patches"].to(dtype)
            return torch.cat([patches, x], dim=1), None, patches.shape[1]
        if audio:
            enc, _, _ = T.stack_forward(enc_pattern, params["encoder"], cfg,
                                        batch["frames"].to(dtype),
                                        remat=remat)
            return x, L.rmsnorm(params["enc_norm"], enc), 0
        return x, None, 0

    @torch.inference_mode()
    def prefill(params, batch, cache_len=None):
        """cache_len: optionally allocate full-attention caches longer than
        the prompt (extra slots are masked in decode via the slot<=pos
        rule), and local rings of min(window, cache_len) slots. vlm's
        prompt is its patches and tokens: count both in ``cache_len``."""
        x, enc_out, _ = _embed_inputs(params, batch)
        x, caches, _ = T.stack_forward(pattern, params["layers"], cfg, x,
                                       enc_out, want_cache=True)
        S = x.shape[1]
        ring_len = min(cfg.window, max(S, cache_len or S))
        for i, kind in enumerate(pattern):
            cache = caches[i]
            if kind == "swa_mlp":
                caches[i] = _ring(cache, S, ring_len)
            elif (kind in T.GLOBAL_KINDS or kind == "cross_mlp") \
                    and cache_len is not None:
                n = cache_len - cache["k"].shape[1]
                if n > 0:
                    for key in ("k", "v", "k_scale", "v_scale"):
                        if key in cache:
                            cache[key] = _pad_seq(cache[key], n)
        x = L.rmsnorm(params["final_norm"], x)
        last = L.logits_fn(params["embedding"], x[:, -1:], cfg)
        return last, caches

    def loss_fn(params, batch):
        """Mean cross-entropy of ``batch["labels"]`` (B, S) given
        ``batch["tokens"]`` (B, S) and the frontend, every layer (the
        encoder's too) under remat, plus 0.01 times the summed MoE balance
        loss."""
        x, enc_out, prefix = _embed_inputs(params, batch, remat=True)
        x, _, aux = T.stack_forward(pattern, params["layers"], cfg, x,
                                    enc_out, remat=True)
        x = L.rmsnorm(params["final_norm"], x)[:, prefix:]
        return L.chunked_softmax_xent(params["embedding"], x,
                                      batch["labels"], cfg) + 0.01 * aux

    @torch.inference_mode()
    def decode(params, caches, token, pos: int):
        """token: (B, 1) int64; pos: the next position index."""
        x = L.embed(params["embedding"], token).to(dtype)
        x = shard(x, "batch", None, None)
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
            if kind in T.ATTENTION_KINDS:
                S = seq_len if kind in T.GLOBAL_KINDS else min(cfg.window,
                                                               seq_len)
                out = {"k": zeros((B, S, KV, hd), kv_store),
                       "v": zeros((B, S, KV, hd), kv_store)}
                if int8:
                    out["k_scale"] = zeros((B, S, KV, 1), torch.bfloat16)
                    out["v_scale"] = zeros((B, S, KV, 1), torch.bfloat16)
                return out
            if kind == "rwkv":
                hr = cfg.rwkv_head_dim
                return {"shift_tm": zeros((B, cfg.d_model), dtype),
                        "shift_cm": zeros((B, cfg.d_model), dtype),
                        "wkv": zeros((B, cfg.d_model // hr, hr, hr),
                                     torch.float32)}
            if kind in T.MAMBA_KINDS:
                di = cfg.expand * cfg.d_model
                return {"conv": zeros((B, cfg.d_conv - 1, di), dtype),
                        "ssm": zeros((B, di, cfg.d_state), torch.float32)}
            if kind == "cross_mlp":
                n_enc = cfg.n_frontend_tokens
                return {key: zeros((B, n, KV, hd), dtype)
                        for key, n in (("k", seq_len), ("v", seq_len),
                                       ("ek", n_enc), ("ev", n_enc))}
            raise ValueError(kind)

        return [one(kind) for kind in pattern]

    return Model(cfg=cfg, device=dev, init=init, prefill=prefill,
                 decode=decode, init_cache=init_cache, loss_fn=loss_fn)


def make_batch(gen: torch.Generator, cfg: ArchConfig, batch_size: int,
               seq_len: int):
    """Random batch on ``gen``'s device (for smoke tests and serving):
    tokens and labels, then for vlm ``"patches"`` and for audio
    ``"frames"``, (B, n_frontend_tokens, d_model) float32 N(0, 1) * 0.02
    drawn after them."""
    shape = (batch_size, seq_len)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device=gen.device),
             "labels": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device=gen.device)}
    key = FRONTEND_KEYS.get(cfg.family)
    if key:
        batch[key] = torch.randn(
            (batch_size, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=gen.device).mul_(0.02)
    return batch
