"""Transformer building blocks (the port of ``repro/models/layers.py``):
norms, RoPE, GQA attention (full / sliding / cross), the int8 ring-buffer
KV cache, SwiGLU MLP, embeddings. Functions over parameter trees, with
the reference's names and its ``(d_in, d_out)`` weight layout (``x @ w``);
norm and softmax statistics in float32.

Full-sequence attention runs the flash-attention kernel
(``ops.flash_attention``, forward and, when autograd asks, backward) where
the reference calls its jnp ``blocked_attention``; decode attention stays
plain PyTorch, as in the reference. ``chunked_softmax_xent`` is the
training loss: cross-entropy over sequence chunks, one chunk's float32
logits alive at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .sharding import (is_dtensor, like, merge_heads, reduced, replicated,
                       shard, splittable, write_slot)

NEG_INF = -1e9  # safe for bf16/f32 masking


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """A nested dict of weights as an ``nn.Module``: dicts become
    submodules, lists ``nn.ModuleList``s, tensors ``nn.Parameter``s.
    ``p[key]`` reads any of them, so the functions below take a ``Params``
    or a plain dict alike. The parameters do not require gradients: a
    served tree keeps no autograd graph. Training takes the plain tree of
    the same tensors (``params_tree``) and asks for the gradients it
    needs."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(Params(t) for t in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


def params_tree(p):
    """A ``Params`` module as the plain dict-and-list tree of its tensors
    (the same storage, detached), which ``repro_torch.tree`` and the
    driver walk; a plain tree passes through."""
    if isinstance(p, nn.ModuleList):
        return [params_tree(m) for m in p]
    if isinstance(p, nn.Module):
        out = {name: params_tree(m) for name, m in p.named_children()}
        out.update({name: t.detach()
                    for name, t in p.named_parameters(recurse=False)})
        return out
    if isinstance(p, dict):
        return {key: params_tree(val) for key, val in p.items()}
    if isinstance(p, (list, tuple)):
        return [params_tree(val) for val in p]
    return p


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype):
    """N(0, 1/d_in) weights (d_in, d_out), drawn in float32 on
    ``gen``'s device and cast: one float32 matrix at a time."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-5):
    """The reference's own eps (1e-5): no caller passes ``cfg.norm_eps``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta=1e4):
    """x: (..., S, H, hd) even hd; positions: broadcastable to (..., S).
    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]), as the
    reference does, not the two halves."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, hd/2)
    cos = like(torch.cos(ang)[..., None, :], x)
    sin = like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    xr1 = x1 * cos - x2 * sin
    xr2 = x1 * sin + x2 * cos
    return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_init(gen, cfg, dtype):
    hd = cfg.hd
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype),
    }


def _split_heads(x, n_heads, hd):
    return splittable(x, n_heads).reshape(x.shape[:-1] + (n_heads, hd))


def _positions(n: int, device):
    return torch.arange(n, device=device)[None]


def gqa_scores_mask(q_pos, k_pos, window: int = 0, causal: bool = True):
    """(Sq, Sk) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def gqa_attention(params, cfg, x, kv_x=None, mask=None, positions=None,
                  kv_positions=None, use_rope=True):
    """General GQA attention. x: (B, Sq, d); kv_x for cross-attention.
    mask: (Sq, Sk) or None (no masking). Returns (B, Sq, d)."""
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kv_in = x if kv_x is None else kv_x
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(kv_in @ params["wk"], KV, hd)
    v = _split_heads(kv_in @ params["wv"], KV, hd)
    if use_rope:
        if positions is None:
            positions = _positions(x.shape[1], x.device)
        if kv_positions is None:
            kv_positions = _positions(kv_in.shape[1], x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    out = gqa_core(q, k, v, mask)
    out = merge_heads(out)
    return out @ params["wo"]


def gqa_core(q, k, v, mask=None, kv_valid=None):
    """q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd). GQA via head grouping.
    Softmax statistics in f32. ``kv_valid``: optional (Sk,) bool marking
    filled cache slots (decode with a partially filled cache).
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = logits.masked_fill(like(~mask[None, None, None], logits),
                                    NEG_INF)
    if kv_valid is not None:
        logits = logits.masked_fill(
            like(~kv_valid[None, None, None, None], logits), NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def kv_quantize(t):
    """Per-(token, head) int8 quantization of K/V: t (B, S, KV, hd) ->
    (codes int8, scale bf16 (B, S, KV, 1)). Rounds half to even, as
    ``jnp.round`` does."""
    tf = t.to(torch.float32)
    scale = torch.amax(torch.abs(tf), dim=-1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(tf / safe * 127.0).to(torch.int8)
    return q, (safe / 127.0).to(torch.bfloat16)


def kv_dequantize(q, scale, dtype):
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def decode_attention(params, cfg, x, cache, pos: int, use_rope=True):
    """One-token decode: x (B, 1, d); cache {"k","v"[,"k_scale","v_scale"]}
    with k/v (B, S, KV, hd) (int8 codes + scales when cfg.kv_dtype=="int8").
    The new token's K/V are written into the cache as a ring buffer at
    ``pos % S`` and the query attends over the full (updated) cache. The
    port writes the slot in place (the reference returns a new cache), so
    a step never copies the cache. A local layer's cache is a ring of
    S = min(window, cache length) slots that prefill lays out the same
    way, so after the write it holds the last S positions up to ``pos``:
    with S = window, attending over every valid slot is the sliding
    window, with no mask of its own. Returns (out (B, 1, d), cache)."""
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    int8 = getattr(cfg, "kv_dtype", "") == "int8"
    S = cache["k"].shape[1]
    q = _split_heads(x @ params["wq"], H, hd)
    k_new = _split_heads(x @ params["wk"], KV, hd)
    v_new = _split_heads(x @ params["wv"], KV, hd)
    if use_rope:
        at = torch.full((1, 1), pos, device=x.device)
        q = rope(q, at, cfg.rope_theta)
        k_new = rope(k_new, at, cfg.rope_theta)
    slot = pos % S

    def write(name, val):
        t = write_slot(cache[name], slot, val.to(cache[name].dtype))
        cache[name] = shard(t, "batch", "cache_seq", None, None)

    if int8:
        kq, ks = kv_quantize(k_new)
        vq, vs = kv_quantize(v_new)
        write("k", kq)
        write("v", vq)
        write("k_scale", ks)
        write("v_scale", vs)
        k_att = kv_dequantize(cache["k"], cache["k_scale"], x.dtype)
        v_att = kv_dequantize(cache["v"], cache["v_scale"], x.dtype)
    else:
        write("k", k_new)
        write("v", v_new)
        k_att, v_att = cache["k"], cache["v"]
    # slot i holds position i (mod S); every slot with index <= pos is
    # filled -- once the ring wraps (pos >= S) everything is valid.
    kv_valid = torch.arange(S, device=x.device) <= pos
    out = gqa_core(q, k_att, v_att, mask=None, kv_valid=kv_valid)
    out = merge_heads(out)
    return out @ params["wo"], cache


def full_seq_attention(params, cfg, x, *, causal=True, window=0, kv_x=None,
                       use_rope=True, positions=None):
    """Projection + RoPE + flash attention + output projection.
    x: (B, S, d). kv_x (cross-attention) implies non-causal, no RoPE on kv.
    Returns (out, k, v)."""
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kv_in = x if kv_x is None else kv_x
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(kv_in @ params["wk"], KV, hd)
    v = _split_heads(kv_in @ params["wv"], KV, hd)
    if use_rope:
        if positions is None:
            positions = _positions(x.shape[1], x.device)
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = rope(k, positions, cfg.rope_theta)
        else:
            k = rope(k, _positions(kv_in.shape[1], x.device), cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = merge_heads(out)
    return out @ params["wo"], k, v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d, ff, dtype):
    return {
        "w_gate": dense_init(gen, d, ff, dtype),
        "w_in": dense_init(gen, d, ff, dtype),
        "w_out": dense_init(gen, ff, d, dtype),
    }


def mlp(params, x):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_in"])
    h = shard(h, "batch", None, "ff")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Embedding / LM head (vocab padded to a multiple of 128)
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg, dtype):
    V = cfg.padded_vocab

    def table():
        t = torch.randn((V, cfg.d_model), generator=gen, device=gen.device)
        return t.mul_(0.02).to(dtype)

    return {"embed": table(), "lm_head": table()}


def embed(params, tokens):
    # a DTensor's ids replicated first: the vocab-sharded lookup masks the
    # ids outside this rank's rows, and where DTensor gathers batch-sharded
    # ids itself it makes that mask from this rank's block of them only
    return F.embedding(replicated(tokens), params["embed"])


def logits_fn(params, x, cfg):
    """x: (B, S, d) -> (B, S, V_padded); padded tail masked to NEG_INF."""
    logits = x @ params["lm_head"].T
    pad = cfg.padded_vocab - cfg.vocab
    if pad:
        mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = logits.masked_fill(like(~mask, logits), NEG_INF)
    return logits


def _chunk_xent(head, xc, yc, vocab: int):
    """The summed cross-entropy of one chunk: float32 logits over the
    padded vocab, its tail masked to ``NEG_INF``."""
    lg = (xc @ head.T).to(torch.float32)
    if vocab < lg.shape[-1]:
        live = torch.arange(lg.shape[-1], device=lg.device) < vocab
        lg = lg.masked_fill(like(~live, lg), NEG_INF)
    if not is_dtensor(lg):
        lse = torch.logsumexp(lg, dim=-1)
    else:
        # a vocab-sharded DTensor: the max and the sum reduce over the
        # shards (two small all-reduces), where logsumexp would gather
        # the chunk's logits
        m = torch.amax(lg, dim=-1, keepdim=True).detach()
        lse = (torch.log(torch.sum(torch.exp(lg - m), dim=-1))
               + m[..., 0])
    # the target's logit, gathered from the (rows, vocab) view: the same
    # values, and a form a vocab-sharded DTensor can gather (its masked
    # partial summed before the reshape)
    tgt = reduced(torch.gather(lg.reshape(-1, lg.shape[-1]), 1,
                               yc.reshape(-1, 1)))
    return torch.sum(lse - tgt.reshape(lse.shape))


def chunked_softmax_xent(params, x, labels, cfg, chunk: int = 128):
    """Mean cross-entropy without the (B, S, V) logits: the sequence in
    chunks of ``chunk`` (the last one the remainder), each chunk's sum
    added in order, as the reference's scan does. Under autograd each
    chunk runs under ``torch.utils.checkpoint``, so its float32 logits
    are rebuilt in the backward and at most one chunk's exist at a time
    (gemma3-12b: 134 MB per 128 tokens, against 4.3 GB for 4096). x:
    (B, S, d); labels: (B, S) int64."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    # on the production mesh the head is gathered over the client axes
    # once, not once a chunk (FSDP's gather at use; the identity without
    # rules)
    head = shard(params["lm_head"], "vocab", None)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        xc, yc = x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_xent, head, xc, yc, cfg.vocab,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _chunk_xent(head, xc, yc, cfg.vocab)
        total = total + part
    return total / (B * S)
