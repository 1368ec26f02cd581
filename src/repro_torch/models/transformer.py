"""Layer stacks (the port of ``repro/models/transformer.py``).

Layer "kinds" (composable sublayer patterns):
  attn_mlp   pre-norm GQA attention + SwiGLU MLP        (dense / global)
  swa_mlp    sliding-window attention + MLP             (gemma3 local)
  attn_moe   attention + mixture-of-experts             (llama4 / qwen3 /
                                                         jamba)
  rwkv       RWKV6 time-mix + channel-mix               (rwkv6)
  mamba_mlp  Mamba SSM + MLP                            (jamba)
  mamba_moe  Mamba SSM + MoE                            (jamba)
  cross_mlp  self-attn + cross-attn(enc) + MLP          (whisper decoder)
  enc_mlp    bidirectional attention + MLP              (whisper encoder)

``swa_mlp`` has ``attn_mlp``'s parameters and decode; its prefill runs the
flash kernel with ``window=cfg.window`` and keeps the last ``window`` keys
and values as its cache, as the reference does. ``models/model.py`` lays
them out as a ring that decode can trust at every prompt length.
``attn_moe`` is ``attn_mlp`` with ``moe.moe_block`` in place of the MLP:
a global causal attention layer, whose forward also returns the block's
load-balance loss (0 for every kind without an MoE). ``mamba_mlp`` and
``mamba_moe`` are ``mamba.mamba_block`` followed by the MLP or the MoE;
their cache is the block's state ``{"conv", "ssm"}``. The hybrid family
(jamba) applies no RoPE in its attention layers, as in the reference.

``enc_mlp`` has ``attn_mlp``'s parameters; its forward is non-causal
(RoPE on, as in every family but hybrid) and keeps no cache.
``cross_mlp`` adds ``norm_x`` and ``xattn`` to them: causal self-attention
with RoPE, then cross attention from ``rmsnorm(norm_x, x)`` to the
encoder's output ``enc_out`` (non-causal, RoPE on neither side), then the
MLP: two flash launches a layer in a prefill. Its cache is ``{"k", "v",
"ek", "ev"}``: the self-attention's keys and values and the encoder's
cross keys and values, all in the model dtype. Its decode is
``decode_attention`` over ``k``/``v`` and plain ``gqa_core`` over
``ek``/``ev`` (no mask), which it hands on unchanged.

The reference stacks each cycle position's parameters along a leading
axis and runs the stack under ``jax.lax.scan``; the port keeps one
parameter tree per layer and runs the stack as a Python loop
(``interop.model_params_to_torch`` unstacks the reference's trees).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba as M
from . import moe as MOE
from . import rwkv as R
from .sharding import merge_heads, shard

ATTENTION_KINDS = ("attn_mlp", "swa_mlp", "attn_moe")
MAMBA_KINDS = ("mamba_mlp", "mamba_moe")
MOE_KINDS = ("attn_moe", "mamba_moe")
# the attention kinds whose cache holds every position (no window)
GLOBAL_KINDS = ("attn_mlp", "attn_moe")


# ---------------------------------------------------------------------------
# per-kind init / full-seq forward / decode
# ---------------------------------------------------------------------------

def layer_init(kind, gen, cfg, dtype):
    if kind == "rwkv":
        return R.rwkv_block_init(gen, cfg, dtype)
    if kind not in ATTENTION_KINDS + MAMBA_KINDS + ("enc_mlp", "cross_mlp"):
        raise ValueError(kind)
    dev = gen.device
    mixer = ({"mamba": M.mamba_init(gen, cfg, dtype)} if kind in MAMBA_KINDS
             else {"attn": L.attention_init(gen, cfg, dtype)})
    if kind == "cross_mlp":
        mixer.update(norm_x=L.rmsnorm_init(cfg.d_model, dtype, dev),
                     xattn=L.attention_init(gen, cfg, dtype))
    out = {"norm1": L.rmsnorm_init(cfg.d_model, dtype, dev), **mixer,
           "norm2": L.rmsnorm_init(cfg.d_model, dtype, dev)}
    if kind in MOE_KINDS:
        out["moe"] = MOE.moe_init(gen, cfg, dtype)
    else:
        out["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return out


def _ffn(kind, params, cfg, x):
    """The layer's second half on ``x``: (output, load-balance loss or
    None)."""
    h = L.rmsnorm(params["norm2"], x)
    if kind in MOE_KINDS:
        return MOE.moe_block(params["moe"], cfg, h)
    return L.mlp(params["mlp"], h), None


def _use_rope(cfg) -> bool:
    """The reference's switch: the hybrid family's attention has no
    RoPE (its Mamba layers carry the positions)."""
    return cfg.family != "hybrid"


def _cache_layout(t):
    """A KV cache (B, S, KV, hd): batch over the client axes, sequence over
    'model' (the reference's constraint; the identity without rules)."""
    return shard(t, "batch", "cache_seq", None, None)


def layer_forward(kind, params, cfg, x, enc_out=None, want_cache=False):
    """Full-sequence forward; ``enc_out`` the encoder's output (B, F, d),
    which only ``cross_mlp`` reads. Returns (x, cache_or_None, aux): a
    local layer's cache holds the last ``cfg.window`` positions, in order;
    aux is the MoE's float32 load-balance loss, None for a kind without
    one (the reference's 0)."""
    if kind in ATTENTION_KINDS or kind == "enc_mlp":
        window = cfg.window if kind == "swa_mlp" else 0
        h, k, v = L.full_seq_attention(
            params["attn"], cfg, L.rmsnorm(params["norm1"], x),
            causal=kind != "enc_mlp", window=window, use_rope=_use_rope(cfg))
        x = x + h
        cache = None
        if want_cache and kind != "enc_mlp":
            if window:
                k, v = k[:, -window:], v[:, -window:]
            if getattr(cfg, "kv_dtype", "") == "int8":
                kq, ks = L.kv_quantize(k)
                vq, vs = L.kv_quantize(v)
                cache = {"k": _cache_layout(kq), "v": _cache_layout(vq),
                         "k_scale": ks, "v_scale": vs}
            else:
                cache = {"k": _cache_layout(k), "v": _cache_layout(v)}
        h, aux = _ffn(kind, params, cfg, x)
        return x + h, cache, aux
    if kind == "rwkv":
        x, state = R.rwkv_block(params, cfg, x)
        return x, (state if want_cache else None), None
    if kind in MAMBA_KINDS:
        h, state = M.mamba_block(params["mamba"], cfg,
                                 L.rmsnorm(params["norm1"], x))
        x = x + h
        h, aux = _ffn(kind, params, cfg, x)
        return x + h, (state if want_cache else None), aux
    if kind == "cross_mlp":
        h, k, v = L.full_seq_attention(
            params["attn"], cfg, L.rmsnorm(params["norm1"], x), causal=True)
        x = x + h
        h, ek, ev = L.full_seq_attention(
            params["xattn"], cfg, L.rmsnorm(params["norm_x"], x),
            kv_x=enc_out, causal=False, use_rope=False)
        x = x + h
        cache = ({"k": _cache_layout(k), "v": _cache_layout(v), "ek": ek,
                  "ev": ev} if want_cache else None)
        h, aux = _ffn(kind, params, cfg, x)
        return x + h, cache, aux
    raise ValueError(kind)


def layer_decode(kind, params, cfg, x, cache, pos):
    """Single-token decode. x: (B, 1, d). Returns (x, new_cache)."""
    if kind in ATTENTION_KINDS:
        h, new_cache = L.decode_attention(
            params["attn"], cfg, L.rmsnorm(params["norm1"], x), cache, pos,
            use_rope=_use_rope(cfg))
        x = x + h
        h, _ = _ffn(kind, params, cfg, x)
        return x + h, new_cache
    if kind == "rwkv":
        return R.rwkv_block(params, cfg, x, state=cache, single_step=True)
    if kind in MAMBA_KINDS:
        h, state = M.mamba_block(params["mamba"], cfg,
                                 L.rmsnorm(params["norm1"], x), state=cache,
                                 single_step=True)
        x = x + h
        h, _ = _ffn(kind, params, cfg, x)
        return x + h, state
    if kind == "cross_mlp":
        # decode_attention writes the self-attention slot into ``cache``
        # in place: the encoder's ek/ev ride along in the same dict
        h, cache = L.decode_attention(
            params["attn"], cfg, L.rmsnorm(params["norm1"], x), cache, pos)
        x = x + h
        q = L._split_heads(L.rmsnorm(params["norm_x"], x)
                           @ params["xattn"]["wq"], cfg.n_heads, cfg.hd)
        out = L.gqa_core(q, cache["ek"], cache["ev"])
        x = x + merge_heads(out) @ params["xattn"]["wo"]
        h, _ = _ffn(kind, params, cfg, x)
        return x + h, cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# pattern + stack
# ---------------------------------------------------------------------------

def layer_pattern(cfg):
    Lh = cfg.n_layers
    if cfg.family in ("dense", "vlm") and not cfg.global_every:
        return ["attn_mlp"] * Lh
    if cfg.global_every:  # gemma3: (k-1) local : 1 global
        return [("attn_mlp" if (i + 1) % cfg.global_every == 0 else "swa_mlp")
                for i in range(Lh)]
    if cfg.family == "moe":
        return ["attn_moe"] * Lh
    if cfg.family == "ssm":
        return ["rwkv"] * Lh
    if cfg.family == "hybrid":
        pat = []
        for i in range(Lh):
            attn = (i % cfg.attn_every) == (cfg.attn_every - 1)
            moe = (i % cfg.moe_every) == (cfg.moe_every - 1)
            if attn:
                pat.append("attn_moe" if moe else "attn_mlp")
            else:
                pat.append("mamba_moe" if moe else "mamba_mlp")
        return pat
    if cfg.family == "audio":
        return ["cross_mlp"] * Lh
    raise ValueError(cfg.family)


def prefill_kernel_launches(cfg) -> int:
    """The launches of the arch's sequence kernel in one prefill: the WKV6
    scan once in every rwkv layer; flash attention once in every attention
    layer and in each of audio's encoder layers, twice in a cross_mlp layer
    (self and cross attention), never in a Mamba layer."""
    pattern = layer_pattern(cfg)
    if cfg.family == "ssm":
        return pattern.count("rwkv")
    encoder = cfg.n_encoder_layers if cfg.family == "audio" else 0
    return (sum(kind in ATTENTION_KINDS for kind in pattern)
            + 2 * pattern.count("cross_mlp") + encoder)


def _cycle(pattern):
    for c in range(1, len(pattern) + 1):
        if len(pattern) % c == 0 and pattern == pattern[:c] * (len(pattern) // c):
            return c
    return len(pattern)


def stack_init(gen, cfg, dtype, pattern=None):
    """One parameter tree per layer, initialised layer by layer (one
    matrix at a time on ``gen``'s device)."""
    pattern = pattern or layer_pattern(cfg)
    return [layer_init(kind, gen, cfg, dtype) for kind in pattern]


def stack_forward(pattern, layers, cfg, x, enc_out=None, want_cache=False,
                  remat=False):
    """Returns (x, per-layer caches, aux): aux the layers' load-balance
    losses summed in float32; ``enc_out`` the encoder's output for the
    ``cross_mlp`` layers. ``remat``: under autograd, each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant), with ``enc_out``
    among its inputs, so only its inputs are kept, its activations are
    rebuilt in the backward and the gradient reaches the encoder. The
    reference checkpoints a cycle block (``jax.checkpoint`` over the
    scanned block); a layer at a time gives the same numbers with less
    memory, since the port keeps one tree per layer."""
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(pattern, layers):
        if remat and torch.is_grad_enabled():
            # the layers draw no random numbers: no RNG state to replay
            x, cache, a = checkpoint(layer_forward, kind, p, cfg, x,
                                     enc_out, want_cache, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            x, cache, a = layer_forward(kind, p, cfg, x, enc_out, want_cache)
        caches.append(cache)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def stack_decode(pattern, layers, cfg, x, caches, pos):
    new = []
    for kind, p, cache in zip(pattern, layers, caches):
        x, c2 = layer_decode(kind, p, cfg, x, cache, pos)
        new.append(c2)
    return x, new
