"""The plain backward versions of the port's two LM kernels
(``kernels/ref.py``: ``flash_attention_backward_plain``,
``rwkv_scan_backward_plain``) against ``torch.autograd`` through the
forward oracles, the CPU route of ``ops.flash_attention`` and
``ops.rwkv_wkv`` under autograd, and layer remat. No JAX: the backward
kernels have no counterpart in the reference, which differentiates jnp
code; ``tests/test_torch_train.py`` holds the port's whole gradient
against ``jax.grad``.

Tolerances: inputs are drawn in float64 and both sides compute in float32
(the plain versions cast), so they differ by float32 rounding in another
order: rtol 1e-5 / atol 1e-5 of the gradient's scale. bfloat16: the two
round the same float32 result to bf16 where their sums agree, a bf16 ulp
(2^-8 of the value) where they part.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_scan as rs
from repro_torch.models.layers import params_tree
from repro_torch.models.model import build_model
from repro_torch.tree import tree_flatten, tree_unflatten

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1.6e-2, atol=1e-2)


def _normal(shape, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _scaled_close(got, want, tol):
    """``got`` within tol of ``want``, atol taken relative to the size of
    ``want``."""
    scale = float(want.float().abs().max()) or 1.0
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTENTION_CASES = [
    # B, Sq, Sk, H, KV, causal, window
    (2, 37, 37, 4, 2, True, 0),          # causal, GQA group 2
    (1, 50, 50, 4, 1, True, 9),          # sliding window, group 4
    (2, 20, 33, 2, 2, False, 0),         # non-causal, Sq < Sk
    (1, 40, 24, 6, 2, True, 0),          # causal, Sq > Sk
    (1, 30, 30, 2, 1, False, 12),        # window without causality
]


def _attention_inputs(B, Sq, Sk, H, KV, hd, dtype, seed=0):
    q = _normal((B, Sq, H, hd), seed, dtype)
    k = _normal((B, Sk, KV, hd), seed + 1, dtype)
    v = _normal((B, Sk, KV, hd), seed + 2, dtype)
    do = _normal((B, Sq, H, hd), seed + 3, dtype)
    return q, k, v, do


@pytest.mark.parametrize("hd", [8, 32, 64])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", ATTENTION_CASES)
def test_flash_backward_plain_matches_autograd(B, Sq, Sk, H, KV, causal,
                                               window, hd):
    q, k, v, do = _attention_inputs(B, Sq, Sk, H, KV, hd, torch.float32)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do.double())
    got = ref.flash_attention_backward_plain(q, k, v, o.detach().float(), do,
                                             causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _scaled_close(g, w, F32)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0)])
def test_flash_backward_plain_bf16(causal, window):
    """bfloat16 inputs: gradients in bf16, against autograd through the
    float32 plain forward (``flash_attention_plain``) of the same bf16
    values."""
    q, k, v, do = _attention_inputs(1, 48, 48, 4, 2, 32, torch.bfloat16, 5)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do.float())
    got = ref.flash_attention_backward_plain(
        q, k, v, o.detach().to(torch.bfloat16), do, causal=causal,
        window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _scaled_close(g, w, BF16)


def test_flash_backward_plain_row_without_keys_gets_no_gradient():
    """A query row that its masks keep no key for (a window without
    causality, past the last key) gets a zero gradient, and the kept rows
    theirs."""
    q, k, v, do = _attention_inputs(1, 12, 4, 2, 1, 8, torch.float32, 2)
    o = fa.flash_attention_plain(q, k, v, causal=False, window=3)
    dq, dk, dv = ref.flash_attention_backward_plain(q, k, v, o, do,
                                                    causal=False, window=3)
    keep = ref.attention_keep(12, 4, False, 3, "cpu")
    empty = ~keep.any(dim=1)
    assert bool(empty.any()) and bool((~empty).any())
    assert torch.count_nonzero(dq[:, empty]) == 0
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_flash_backward_wrapper_takes_plain_on_cpu():
    q, k, v, do = _attention_inputs(1, 20, 20, 2, 1, 32, torch.float32, 7)
    o, lse = fa.flash_attention(q, k, v, causal=True, window=5,
                                return_lse=True)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                      window=5)
    want = ref.flash_attention_backward_plain(q, k, v, o, do, causal=True,
                                              window=5, lse=lse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fa.LAUNCHES == before


def test_flash_attention_function_on_cpu_is_the_plain_gradient():
    """``FlashAttentionFn`` on CPU tensors: the plain forward, the plain
    backward, autograd's numbers."""
    q, k, v, do = _attention_inputs(2, 24, 24, 4, 2, 32, torch.float32, 8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = fa.FlashAttentionFn.apply(*leaves, True, 6)
    got = torch.autograd.grad(out, leaves, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_attention_plain(*leaves, causal=True, window=6), leaves, do)
    for g, w in zip(got, want):
        _scaled_close(g, w, F32)


def _masked_scores_log2(q, k, causal, window):
    """(B, H, Sq, Sk) float64 scores q k / sqrt(hd) times log2(e), -inf
    where the masks drop a pair."""
    B, Sq, H, hd = q.shape
    kk = k.double().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.double(), kk) / math.sqrt(hd)
    keep = ref.attention_keep(Sq, k.shape[1], causal, window, "cpu")
    return s.masked_fill(~keep, float("-inf")) * math.log2(math.e)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", ATTENTION_CASES)
def test_flash_lse_plain_matches_logsumexp(B, Sq, Sk, H, KV, causal,
                                           window):
    """``ref.flash_attention_lse``: torch.logsumexp of the masked scores
    (float64) times log2(e), in float32 (rtol 1e-6, atol 1e-5, the
    float32 rounding of sums of a few dozen terms); +inf exactly for a
    row with no key kept."""
    q, k, _, _ = _attention_inputs(B, Sq, Sk, H, KV, 32, torch.float32, 10)
    got = ref.flash_attention_lse(q, k, causal=causal, window=window)
    want = torch.logsumexp(_masked_scores_log2(q, k, causal, window) /
                           math.log2(math.e), dim=-1) * math.log2(math.e)
    assert got.shape == (B, H, Sq) and got.dtype == torch.float32
    empty = torch.isinf(want)
    assert torch.equal(torch.isposinf(got), empty)
    torch.testing.assert_close(got[~empty].double(), want[~empty],
                               rtol=1e-6, atol=1e-5)


def test_flash_lse_plain_row_without_keys_is_inf():
    """A window without causality past the last key keeps no key for the
    late rows: their lse is +inf, the others' finite."""
    q, k, _, _ = _attention_inputs(1, 12, 4, 2, 1, 8, torch.float32, 2)
    lse = ref.flash_attention_lse(q, k, causal=False, window=3)
    empty = ~ref.attention_keep(12, 4, False, 3, "cpu").any(dim=1)
    assert bool(empty.any())
    assert bool(torch.isposinf(lse[:, :, empty]).all())
    assert bool(torch.isfinite(lse[:, :, ~empty]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", ATTENTION_CASES)
def test_flash_backward_plain_with_lse_matches_own_statistics(
        B, Sq, Sk, H, KV, causal, window, dtype):
    """The plain backward fed ``flash_attention_lse`` against the same
    backward computing its own statistics: F32, or BF16 (the two round
    the same float32 gradients to bf16)."""
    q, k, v, do = _attention_inputs(B, Sq, Sk, H, KV, 32, dtype, 11)
    o = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse(q, k, causal=causal, window=window)
    got = ref.flash_attention_backward_plain(q, k, v, o, do, causal=causal,
                                             window=window, lse=lse)
    want = ref.flash_attention_backward_plain(q, k, v, o, do, causal=causal,
                                              window=window)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _scaled_close(g, w, F32 if dtype == torch.float32 else BF16)


def test_flash_attention_function_returns_non_differentiable_lse():
    """``FlashAttentionFn`` on CPU tensors returns (out, lse): lse is the
    plain one, float32 (B, H, Sq), and autograd does not track it."""
    q, k, v, _ = _attention_inputs(2, 24, 24, 4, 2, 32, torch.float32, 12)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.FlashAttentionFn.apply(*leaves, True, 6)
    assert out.requires_grad and not lse.requires_grad
    assert lse.shape == (2, 4, 24) and lse.dtype == torch.float32
    assert torch.equal(lse, ref.flash_attention_lse(q, k, causal=True,
                                                    window=6))
    assert torch.equal(out.detach(),
                       fa.flash_attention_plain(q, k, v, True, 6))


def test_flash_backward_refuses_a_wrong_lse():
    """The backward wrapper takes only the forward's (B, H, Sq) float32,
    contiguous lse."""
    q, k, v, do = _attention_inputs(1, 16, 16, 4, 2, 32, torch.float32, 13)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    for bad, err in ((lse.transpose(1, 2), ValueError),
                     (lse.double(), TypeError),
                     (lse[:, :2], ValueError),
                     (lse.repeat(1, 1, 2)[..., ::2], ValueError),
                     (None, TypeError)):
        with pytest.raises(err):
            fa.flash_attention_backward(q, k, v, o, bad, do)


# The bf16 backward kernels' tile walk (csrc/flash_attention_bwd.cu,
# namespace hopper): 64-row tiles; the dq kernel's blocks are 128 query
# rows, one consumer per 64; the dk/dv kernel's blocks are 64 keys. Keep
# TILE equal to kTileRows there.
TILE = 64


def _dq_kernel_pairs(Sq, Sk, causal, window):
    """(formed, unmasked): how often the dq kernel's walk forms each (query,
    key) pair, and the pairs it forms on a tile it does not mask."""
    formed = torch.zeros((Sq, Sk), dtype=torch.int32)
    unmasked = torch.zeros((Sq, Sk), dtype=torch.bool)
    for q0 in range(0, Sq, 2 * TILE):
        k_end = min(Sk, q0 + 2 * TILE) if causal else Sk
        k_begin = max(0, q0 - window + 1) if window else 0
        t_begin = k_begin // TILE
        n_tiles = max(0, -(-k_end // TILE) - t_begin)
        for qmin in (q0, q0 + TILE):
            for i in range(n_tiles):
                k0 = (t_begin + i) * TILE
                live = (qmin < Sq and (not causal or k0 <= qmin + TILE - 1)
                        and (not window or k0 + TILE - 1 > qmin - window))
                if not live:
                    continue
                edge = (k0 + TILE > Sk or (causal and k0 + TILE - 1 > qmin)
                        or (window and k0 <= qmin + TILE - 1 - window))
                rows, keys = slice(qmin, qmin + TILE), slice(k0, k0 + TILE)
                formed[rows, keys] += 1
                if not edge:
                    unmasked[rows, keys] = True
    return formed, unmasked


def _dkdv_kernel_pairs(Sq, Sk, causal, window):
    """The same for the dk/dv kernel's walk (one query head)."""
    formed = torch.zeros((Sq, Sk), dtype=torch.int32)
    unmasked = torch.zeros((Sq, Sk), dtype=torch.bool)
    for k0 in range(0, Sk, TILE):
        q_lo = k0 if causal else 0
        q_hi = min(Sq, k0 + TILE - 1 + window) if window else Sq
        qt_begin = q_lo // TILE
        n_qt = -(-q_hi // TILE) - qt_begin if q_hi > q_lo else 0
        for qt in range(qt_begin, qt_begin + n_qt):
            q0 = qt * TILE
            edge = (q0 + TILE > Sq or k0 + TILE > Sk
                    or (causal and k0 + TILE - 1 > q0)
                    or (window and k0 <= q0 + TILE - 1 - window))
            rows, keys = slice(q0, q0 + TILE), slice(k0, k0 + TILE)
            formed[rows, keys] += 1
            if not edge:
                unmasked[rows, keys] = True
    return formed, unmasked


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (200, 200, True, 0), (256, 256, True, 48), (300, 300, True, 200),
    (77, 130, False, 0), (130, 77, True, 0), (2048, 2048, True, 1024),
    (190, 190, False, 70), (129, 129, True, 1), (64, 300, True, 0),
])
def test_bf16_backward_tiles_cover_every_kept_pair_once(Sq, Sk, causal,
                                                        window):
    """Each kernel's walk forms every kept pair exactly once and no pair
    twice, and a tile it leaves unmasked holds only kept pairs."""
    keep = ref.attention_keep(Sq, Sk, causal, window, "cpu")
    for walk in (_dq_kernel_pairs, _dkdv_kernel_pairs):
        formed, unmasked = walk(Sq, Sk, causal, window)
        assert bool((formed[keep] == 1).all()), walk.__name__
        assert int(formed.max()) <= 1, walk.__name__
        assert not bool((unmasked & ~keep).any()), walk.__name__


def _bf16_kernel_order(q, k, v, o, lse, do, causal, window):
    """The bf16 kernels' arithmetic, emulated in float32: scores of the
    bf16 inputs, P = 2^(s log2(e) / sqrt(hd) - lse) with the forward's
    lse, D from the bf16 o and do; P rounded to bf16 for dV = P^T dO and
    dS = P (dP - D) rounded to bf16 for dQ = dS K and dK = dS^T Q, each
    product accumulated in float32; outputs rounded to bf16."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    qf, dof, of = (x.float().transpose(1, 2) for x in (q, do, o))
    kf, vf = (x.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for x in (k, v))
    c = float(np.float32(np.log2(np.e) / np.sqrt(hd)))
    keep = ref.attention_keep(Sq, k.shape[1], causal, window, "cpu")
    p = torch.exp2(qf @ kf.transpose(-1, -2) * c - lse[..., None])
    p = torch.where(keep, p, torch.zeros_like(p))
    bf = lambda x: x.to(torch.bfloat16).float()
    dv = bf(p).transpose(-1, -2) @ dof
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = bf(ds) @ kf / math.sqrt(hd)
    dk = bf(ds).transpose(-1, -2) @ qf / math.sqrt(hd)

    def per_kv(x):                    # (B, H, Sk, hd) -> (B, Sk, KV, hd)
        return x.reshape(B, H // G, G, *x.shape[2:]).sum(2).transpose(1, 2)
    return (dq.transpose(1, 2).to(torch.bfloat16),
            per_kv(dk).to(torch.bfloat16), per_kv(dv).to(torch.bfloat16))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (1, 256, 256, 8, 2, 64, True, 0),
    (1, 200, 200, 4, 1, 128, True, 48),
    (2, 77, 130, 4, 4, 32, False, 0),
    (1, 192, 192, 4, 2, 256, True, 100),
])
def test_bf16_kernel_arithmetic_within_limit(B, Sq, Sk, H, KV, hd, causal,
                                             window):
    """Rounding P and dS to bf16 before the products they feed (as the
    kernels do) keeps each gradient within the card's bf16 limit, 2e-2 x
    max |want|, of the plain backward on the same bf16 inputs."""
    q, k, v, do = _attention_inputs(B, Sq, Sk, H, KV, hd, torch.bfloat16,
                                    14)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    got = _bf16_kernel_order(q, k, v, o, lse, do, causal, window)
    want = ref.flash_attention_backward_plain(q, k, v, o, do, causal=causal,
                                              window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2e-2 * float(w.float().abs().max()), name


def test_library_path_hashes_the_headers(tmp_path):
    """A source's library is named by the headers beside it too: an
    edited header gives another path, and so a rebuild."""
    src = tmp_path / "kernel.cu"
    src.write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    flags = build.BASE_FLAGS
    first = build.library_path(src, flags)
    assert build.library_path(src, flags) == first
    header.write_text("// two\n")
    assert build.library_path(src, flags) != first
    assert build.library_path(src, flags[:-1]) != build.library_path(
        src, flags)


def test_ops_flash_attention_on_cpu_is_differentiable():
    q, k, v, do = _attention_inputs(1, 30, 30, 4, 2, 32, torch.float32, 9)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=10)
    got = torch.autograd.grad(out, leaves, do)
    want = ref.flash_attention_backward_plain(q, k, v, out.detach(), do,
                                              causal=True, window=10)
    for g, w in zip(got, want):
        _scaled_close(g, w, F32)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

def _scan_inputs(B, S, H, hd, dtype, seed=0):
    r, k, v = (_normal((B, S, H, hd), seed + i, dtype) for i in range(3))
    w = torch.exp(-torch.exp(_normal((B, S, H, hd), seed + 3) - 2.0))
    u = 0.3 * _normal((H, hd), seed + 4)
    dy = _normal((B, S, H, hd), seed + 5, dtype)
    dstate = _normal((B, H, hd, hd), seed + 6)
    return r, k, v, w.to(dtype), u, dy, dstate


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("B,S,H,hd", [(2, 13, 3, 8), (1, 40, 2, 16),
                                      (2, 7, 1, 32), (1, 1, 2, 4)])
def test_wkv6_backward_plain_matches_autograd(B, S, H, hd, with_dstate):
    r, k, v, w, u, dy, dstate = _scan_inputs(B, S, H, hd, torch.float32)
    leaves = [t.double().requires_grad_() for t in (r, k, v, w, u)]
    y, state = ref.rwkv_scan_ref(*leaves)
    loss = (y * dy.double()).sum()
    if with_dstate:
        loss = loss + (state * dstate.double()).sum()
    # one step without dstate leaves w unused: its gradient is zero
    want = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    got = ref.rwkv_scan_backward_plain(
        r, k, v, w, u, dy, dstate if with_dstate else None)
    for name, g, wnt in zip("rkvwu", got, want):
        assert g.dtype == torch.float32, name
        _scaled_close(g, wnt, F32)


def test_wkv6_backward_plain_bf16():
    """bfloat16 r, k, v, w, dy: dr, dk, dv, dw in bf16, du in u's float32,
    against autograd through the float32 oracle of the same values."""
    r, k, v, w, u, dy, _ = _scan_inputs(1, 24, 2, 16, torch.bfloat16, 3)
    leaves = [t.float().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = ref.rwkv_scan_ref(*leaves)
    want = torch.autograd.grad((y * dy.float()).sum(), leaves)
    got = ref.rwkv_scan_backward_plain(r, k, v, w, u, dy)
    for g, wnt in zip(got[:4], want[:4]):
        assert g.dtype == torch.bfloat16
        _scaled_close(g, wnt, BF16)
    assert got[4].dtype == torch.float32
    _scaled_close(got[4], want[4], F32)


def test_wkv6_backward_wrapper_and_function_on_cpu():
    """The wrapper takes the plain version on the CPU and launches
    nothing; ``WKV6Fn`` on CPU tensors gives autograd's gradient, the
    state's included."""
    r, k, v, w, u, dy, dstate = _scan_inputs(2, 11, 2, 16, torch.float32, 4)
    before = dict(rs.LAUNCHES)
    got = rs.rwkv_scan_backward(r, k, v, w, u, dy, dstate)
    want = ref.rwkv_scan_backward_plain(r, k, v, w, u, dy, dstate)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    assert rs.LAUNCHES == before
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, state = rs.WKV6Fn.apply(*leaves)
    fn_grads = torch.autograd.grad((y * dy).sum() + (state * dstate).sum(),
                                   leaves)
    for g, wnt in zip(fn_grads, want):
        _scaled_close(g, wnt, F32)


def test_ops_rwkv_wkv_on_cpu_is_differentiable():
    r, k, v, w, u, dy, _ = _scan_inputs(1, 9, 2, 16, torch.float32, 6)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, _ = ops.rwkv_wkv(*leaves)
    got = torch.autograd.grad((y * dy).sum(), leaves)
    want = ref.rwkv_scan_backward_plain(r, k, v, w, u, dy)
    for g, wnt in zip(got, want):
        _scaled_close(g, wnt, F32)


# ---------------------------------------------------------------------------
# the model: remat, and gradients reaching every leaf
# ---------------------------------------------------------------------------

def _loss_grads(model, params, batch, remat):
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    leaves, treedef = tree_flatten(params)
    live = [x.clone().requires_grad_() for x in leaves]
    p = tree_unflatten(treedef, live)
    cfg = model.cfg
    x = L.embed(p["embedding"], batch["tokens"])
    x, _, _ = T.stack_forward(T.layer_pattern(cfg), p["layers"], cfg, x,
                              remat=remat)
    x = L.rmsnorm(p["final_norm"], x)
    loss = L.chunked_softmax_xent(p["embedding"], x, batch["labels"], cfg)
    return loss, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma3-12b",
                                  "rwkv6-3b"])
def test_remat_gives_bit_identical_gradients(arch):
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = params_tree(model.init(torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 41), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss_r, g_r = _loss_grads(model, params, batch, remat=True)
    loss_p, g_p = _loss_grads(model, params, batch, remat=False)
    assert torch.equal(loss_r, loss_p)
    for a, b in zip(g_r, g_p):
        assert torch.equal(a, b)
    # the model's own loss_fn is the remat one
    assert torch.equal(model.loss_fn(params, batch), loss_r.detach())


def test_rwkv_gradient_reaches_u_decay_and_bias():
    """The decay's path (w_bias, ww, through ``w.to(r.dtype)``) and u get
    non-zero gradients."""
    cfg = dataclasses.replace(configs.get("rwkv6-3b").reduced(), n_layers=1)
    model = build_model(cfg, device="cpu")
    params = params_tree(model.init(torch.Generator().manual_seed(0)))
    toks = torch.randint(0, cfg.vocab, (1, 17),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, grads = _loss_grads(model, params, batch, remat=True)
    leaves, treedef = tree_flatten(params)
    named = tree_unflatten(treedef, list(grads))["layers"][0]
    for name in ("u", "w_bias", "ww", "mix_w", "wr", "wk", "wv"):
        assert float(named[name].abs().max()) > 0.0, name
