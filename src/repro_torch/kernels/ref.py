"""Plain PyTorch oracles (the counterparts of ``repro/kernels/ref.py``):
the block quantizer, flash attention and the RWKV6 WKV recurrence, and
the backward passes of the last two (which the reference has no kernel
for: it differentiates jnp code).

Each quantizer oracle repeats the reference's arithmetic operation for
operation, so that on the same inputs (``x`` and the uniform draws ``u``)
it is bit-identical to the JAX oracle, to the Pallas kernels in interpret
mode, and to the CUDA kernels in ``csrc/quantize_block.cu``:

* ``y = x / safe * levels`` is a division, then a multiply, each rounded;
* the dequantize multiplies by the float32 reciprocal ``1 / levels`` in the
  order ``(q * safe) * inv_levels`` and never divides by ``levels``;
* the murmur hash dither wraps at 32 bits. PyTorch has no uint32
  arithmetic on the CPU, so ``murmur_u32`` works in int64 and masks to
  32 bits after every step, splitting each multiply so that no int64
  product overflows.

The attention and WKV6 oracles are held to tolerances: their sums run in
another order than the kernels'. The backward versions
(``flash_attention_backward_plain``, ``rwkv_scan_backward_plain``) follow
the algorithms of their CUDA kernels (``csrc/flash_attention_bwd.cu``,
``csrc/rwkv_scan_bwd.cu``) in float32; the tests hold them against
``torch.autograd`` through the forward oracles.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def levels_of(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1.0


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a float32 0-d tensor beside ``like`` (the float32
    rounding of the double, as JAX forms a weak-typed constant)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# the murmur hash dither in 32-bit arithmetic
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant
    ``c`` < 2^32, split at 16 bits so that no product reaches 2^63. The
    in-place steps act on temporaries only (fewer full-size buffers)."""
    lo, hi = c & 0xFFFF, c >> 16
    out = a * hi
    out.bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    out.add_(a * lo)
    return out.bitwise_and_(_M32)


def _xorshift(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.bitwise_xor(x, x >> k)


def murmur_u32(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """The murmur3 finalizer of ``idx * 2654435761 + seed`` (uint32
    semantics), as int64 values in [0, 2^32)."""
    x = _mul32(idx & _M32, 2654435761)
    x.add_(int(seed) & _M32).bitwise_and_(_M32)
    x = _mul32(_xorshift(x, 16), 0x7FEB352D)
    x = _mul32(_xorshift(x, 15), 0x846CA68B)
    return _xorshift(x, 16)


def hash_uniform(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """float32 uniforms in [0, 1) with 24-bit resolution from the hash of
    the element index (``quantize_block.py:_hash_uniform_u32``)."""
    bits = (murmur_u32(idx, seed) >> 8).to(torch.float32)
    return bits.mul_(_f32(2.0 ** -24, bits))


def hash_dither(seed: int, shape, device=None) -> torch.Tensor:
    """The dither of ``core/compression.py:hash_dither`` for a leaf of
    ``shape``: the hash of each element's row-major index, seeded by the
    folded 32-bit seed."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return hash_uniform(idx, seed).reshape(tuple(shape))


# ---------------------------------------------------------------------------
# block quantization
# ---------------------------------------------------------------------------

def quantize_groups_ref(x: torch.Tensor, u: torch.Tensor,
                        bits: int = 8) -> torch.Tensor:
    """Stochastic quantize -> dequantize of groups along the last axis.
    x: (..., g) float32; u: the same shape, uniforms in [0, 1)."""
    levels = _f32(levels_of(bits), x)
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    live = scale > 0
    safe = torch.where(live, scale, torch.ones_like(scale))
    y = x / safe * levels
    lo = torch.floor(y)
    q = lo + (u < (y - lo)).to(y.dtype)
    deq = (q * safe).mul_(_f32(1.0 / levels_of(bits), x))
    return deq.masked_fill_(~live, 0.0)


def quantize_groups_native(x: torch.Tensor, u: torch.Tensor,
                           bits: int = 8) -> torch.Tensor:
    """Dtype-preserving variant: every intermediate stays in ``x.dtype``;
    only the dither-vs-fraction comparison runs in float32."""
    dt = x.dtype
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    live = scale > 0
    safe = torch.where(live, scale, torch.ones_like(scale))
    y = x / safe * torch.tensor(levels_of(bits), dtype=dt, device=x.device)
    lo = torch.floor(y)
    up = u < (y - lo).to(torch.float32)
    q = lo + up.to(dt)
    deq = (q * safe).mul_(torch.tensor(1.0 / levels_of(bits), dtype=dt,
                                       device=x.device))
    return deq.masked_fill_(~live, 0.0)


def encode_groups_ref(x: torch.Tensor, u: torch.Tensor, bits: int = 8):
    """Wire-format encode: the same scale and rounding, returning
    ``(codes int8, scales)`` with scales ``(..., 1)`` in ``x.dtype``."""
    dt = x.dtype
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = x / safe * torch.tensor(levels_of(bits), dtype=dt, device=x.device)
    lo = torch.floor(y)
    if dt == torch.float32:
        q = lo + (u < (y - lo)).to(dt)
    else:
        q = lo + (u < (y - lo).to(torch.float32)).to(dt)
    return q.to(torch.int8), scale


def decode_groups_ref(codes: torch.Tensor, scales: torch.Tensor,
                      bits: int = 8) -> torch.Tensor:
    """Dequantize codes (..., g) int8 with scales (..., 1): the tail of
    ``quantize_groups_ref`` replayed from the payload."""
    dt = scales.dtype
    inv_levels = torch.tensor(1.0 / levels_of(bits), dtype=dt,
                              device=scales.device)
    live = scales > 0
    safe = torch.where(live, scales, torch.ones_like(scales))
    # (q * safe) * inv_levels, computed in place on the converted codes
    deq = codes.to(dt, copy=True).mul_(safe).mul_(inv_levels)
    return deq.masked_fill_(~live, 0.0)


def quantize_block_ref(x: torch.Tensor, u: torch.Tensor, bits: int = 8,
                       block: int = 256) -> torch.Tensor:
    """Flat stochastic block quantize -> dequantize: x, u (n,) with
    n % block == 0."""
    out = quantize_groups_ref(x.reshape(-1, block), u.reshape(-1, block),
                              bits=bits)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# flash attention (GQA, causal / sliding window)
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive full-materialization reference. q: (B, Sq, H, hd);
    k, v: (B, Sk, KV, hd). Query i and key j sit at positions i and j.
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    logits = logits / hd ** 0.5
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = logits.masked_fill(~mask, -1e9)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def attention_keep(Sq: int, Sk: int, causal: bool, window: int, device):
    """(Sq, Sk) bool: the (query, key) pairs the masks keep, query i and key
    j at positions i and j."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        keep &= k_pos <= q_pos
    if window:
        keep &= k_pos > q_pos - window
    return keep


def _masked_scores(q, k, causal, window, keep):
    """Float32 scores q k^T / sqrt(hd) as (B, KV, G, Sq, Sk), -inf where
    the masks (or ``keep``, an (Sq, Sk) bool mask) drop a pair."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, Sq, KV, H // KV, hd)
    if keep is None:
        keep = attention_keep(Sq, Sk, causal, window, q.device)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32))
    return s.mul_(hd ** -0.5).masked_fill_(~keep, float("-inf"))


def _row_lse(s):
    """Natural log-sum-exp over the last axis of masked scores, +inf for a
    row with every score -inf."""
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = m + torch.log(torch.exp(s - m).sum(dim=-1, keepdim=True))
    return torch.where(torch.isfinite(lse), lse,
                       torch.full_like(lse, float("inf")))


def flash_attention_lse(q, k, causal: bool = True, window: int = 0,
                        keep=None):
    """Each query row's log-sum-exp over the keys its masks keep, from the
    materialized float32 scores, in the kernels' convention: base 2
    (log2 of the sum of 2^(s log2(e)), s = q k / sqrt(hd)), +inf for a row
    with no key kept. q (B, Sq, H, hd), k (B, Sk, KV, hd) -> float32
    (B, H, Sq), which ``flash_attention(..., return_lse=True)`` returns and
    ``flash_attention_backward`` takes."""
    B, Sq, H, _ = q.shape
    lse = _row_lse(_masked_scores(q, k, causal, window, keep))
    return (lse * math.log2(math.e)).reshape(B, H, Sq)


def flash_attention_backward_plain(q, k, v, o, do, causal: bool = True,
                                   window: int = 0, keep=None, lse=None):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` given its output
    ``o`` and the output's gradient ``do``, by the kernel's algorithm in
    float32: each query row's log-sum-exp over the keys its mask keeps
    (``lse``, the forward's, (B, H, Sq) in base 2 as
    ``flash_attention_lse`` gives it; None: computed here from the
    scores) and D_i = sum do_i o_i, then P = exp(S - lse), dV = P^T dO,
    dS = P (dO V^T - D), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd),
    dK and dV summed over the query heads of each KV head. A row with no
    key kept gets no gradient. ``keep``: an (Sq, Sk) bool mask used in
    place of the one ``causal`` and ``window`` make. Returns the three in
    their inputs' dtypes."""
    f32 = torch.float32
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.to(f32).reshape(B, Sq, KV, G, hd)
    dog = do.to(f32).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(f32), v.to(f32)
    s = _masked_scores(q, k, causal, window, keep)
    # the row statistics over the kept keys, natural log
    if lse is None:
        lse = _row_lse(s)
    else:
        lse = lse.to(f32).reshape(B, KV, G, Sq, 1) * math.log(2.0)
    delta = torch.einsum("bqkgh,bqkgh->bkgq",
                         dog, o.to(f32).reshape(B, Sq, KV, G, hd))
    # pass 2: the gradients from P rebuilt with the statistics
    p = torch.exp(s.sub_(lse))
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dog)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dog, vf)
    ds = p.mul_(dp.sub_(delta[..., None]))
    del dp
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf).mul_(scale)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qg).mul_(scale)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# RWKV6 WKV recurrence
# ---------------------------------------------------------------------------

def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor):
    """WKV6: r,k,v,w: (B, S, H, hd); u: (H, hd). f32 state (B, H, hd, hd).
        y_t = r_t . (S_t + diag(u) k_t^T v_t);  S_{t+1} = diag(w_t) S_t + k_t^T v_t
    A loop over time in f32. Returns (y (B, S, H, hd) in r's dtype,
    final_state)."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), state


def rwkv_scan_backward_plain(r, k, v, w, u, dy, dstate=None):
    """Gradients (dr, dk, dv, dw, du) of ``rwkv_scan_ref`` given the
    gradient ``dy`` of y and ``dstate`` of the final state (None: zero),
    by the explicit reverse recurrence in float32. With G the gradient of
    the state S_{t+1} (starting from ``dstate``) and p_t = r_t . (u k_t),
    going back in time::

        dk_t = G v_t + r_t u (v_t . dy_t)      dv_t = G^T k_t + p_t dy_t
        dw_t[i] = sum_j G[i, j] S_t[i, j]      dr_t = S_t dy_t + u k_t (v_t . dy_t)
        du += r_t k_t (v_t . dy_t)             G <- r_t^T dy_t + diag(w_t) G

    S_t is the state before step t (all of them are kept here; the kernel
    keeps none within a chunk: it carries the state and G across chunks of
    L steps and forms each chunk's terms from its start state and end
    gradient). Returns dr, dk, dv, dw in their inputs' dtypes and du
    (H, hd) in u's."""
    f32 = torch.float32
    B, S, H, hd = r.shape
    rf, kf, vf, wf, dyf = (t.to(f32) for t in (r, k, v, w, dy))
    uf = u.to(f32)[None]
    state = torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)
    states = []
    for t in range(S):
        states.append(state)
        state = wf[:, t, :, :, None] * state \
            + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    G = (torch.zeros_like(state) if dstate is None
         else dstate.to(f32).clone())
    grads = {name: torch.zeros_like(rf) for name in ("r", "k", "v", "w")}
    du = torch.zeros((H, hd), dtype=f32, device=r.device)
    for t in reversed(range(S)):
        r_t, k_t, v_t, dy_t = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        vdy = (v_t * dy_t).sum(-1, keepdim=True)                # (B, H, 1)
        s_t = states[t]
        grads["k"][:, t] = torch.einsum("bhij,bhj->bhi", G, v_t) \
            + r_t * uf * vdy
        grads["v"][:, t] = torch.einsum("bhij,bhi->bhj", G, k_t) \
            + (r_t * uf * k_t).sum(-1, keepdim=True) * dy_t
        grads["w"][:, t] = (G * s_t).sum(-1)
        grads["r"][:, t] = torch.einsum("bhij,bhj->bhi", s_t, dy_t) \
            + uf * k_t * vdy
        du += (r_t * k_t * vdy).sum(0)
        G = wf[:, t, :, :, None] * G + r_t[..., None] * dy_t[..., None, :]
    return (grads["r"].to(r.dtype), grads["k"].to(k.dtype),
            grads["v"].to(v.dtype), grads["w"].to(w.dtype), du.to(u.dtype))
