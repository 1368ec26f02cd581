"""The WKV6 backward kernel's chunk-parallel method against the JAX package
on the CPU.

``csrc/rwkv_scan_bwd.cu`` computes the gradient of the WKV6 recurrence in
three phases over chunks of L steps: each chunk's own state, its own
gradient and its decay product from zero (summaries), a carry of the
state forward and of its gradient backward over the chunks, and each
chunk's gradients from its start state and end gradient (a walk of G for
dv, and a per-row walk for dr, dk, dw and du that holds no state of the
chunk). ``_chunked_backward`` mirrors those phases in PyTorch, with the
kernel's steps per chunk (``KERNEL_CHUNK``, kept equal to the source's
``Steps<HD>::L``: ``test_kernel_chunk_matches_source`` reads them there),
and is held against ``jax.vjp`` of the reference model's ``wkv_scan``
(``repro.models.rwkv``) on the same numpy inputs, with cotangents for y
and for the final state.

Tolerance, per output, max |got - want| <= tol * max |want|: 1e-4 in
float32 (both sum in float32, in other orders); bf16 inputs, with the
gradients rounded to bf16, at the card's bf16 limit, 2e-2
(``tests/test_torch_cuda_train.py``). The mirror with one chunk's carry
dropped must miss the limit.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as JR
from repro_torch.kernels import rwkv_scan as trs

# steps per chunk at each head dim (csrc/rwkv_scan_bwd.cu, Steps<HD>::L)
KERNEL_CHUNK = {16: 32, 32: 32, 64: 32, 128: 16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NAMES = ("dr", "dk", "dv", "dw", "du")


def _chunked_backward(r, k, v, w, u, dy, dstate, L, drop_carry_at=None):
    """Gradients (dr, dk, dv, dw, du) of the WKV6 recurrence by the
    kernel's three phases, in float32. A chunk's missing steps are w = 1
    and k = v = r = dy = 0. ``drop_carry_at``: a chunk index c > 0 whose
    carry is dropped (the state at its start and the gradient at the end
    of chunk c - 1 taken as zero): a planted fault."""
    f32 = torch.float32
    B, S, H, hd = r.shape
    n_chunks = -(-S // L)
    pad = n_chunks * L - S

    def staged(x, fill):
        x = x.to(f32)
        if pad:
            x = torch.cat([x, torch.full((B, pad, H, hd), fill)], dim=1)
        return x.reshape(B, n_chunks, L, H, hd).permute(0, 3, 1, 2, 4)

    # (B, H, chunk, step, hd)
    rs, ks, vs, ds = (staged(x, 0.0) for x in (r, k, v, dy))
    ws = staged(w, 1.0)
    uf = u.to(f32)[None, :, None, :]

    # phase 1: k_s <- P(s+1, L) k_s, r_s <- P(0, s) r_s, D = P(0, L);
    # A = K^T V and B = R^T DY over the chunk's steps
    kd, rd = ks.clone(), rs.clone()
    q = torch.ones((B, H, n_chunks, hd))
    for s in reversed(range(L)):
        kd[..., s, :] *= q
        q = q * ws[..., s, :]
    dec = q
    q = torch.ones_like(dec)
    for s in range(L):
        rd[..., s, :] *= q
        q = q * ws[..., s, :]
    a_own = torch.einsum("bhcsi,bhcsj->bhcij", kd, vs)
    b_own = torch.einsum("bhcsi,bhcsj->bhcij", rd, ds)

    # phase 2: S_c (state at chunk c's start), E_c (gradient at its end)
    s_start, e_end = torch.empty_like(a_own), torch.empty_like(b_own)
    st = torch.zeros((B, H, hd, hd))
    for c in range(n_chunks):
        if c == drop_carry_at:
            st = torch.zeros_like(st)
        s_start[:, :, c] = st
        st = dec[:, :, c, :, None] * st + a_own[:, :, c]
    g = torch.zeros((B, H, hd, hd)) if dstate is None else dstate.to(f32)
    for c in reversed(range(n_chunks)):
        if c + 1 == drop_carry_at:
            g = torch.zeros_like(g)
        e_end[:, :, c] = g
        g = b_own[:, :, c] + dec[:, :, c, :, None] * g

    # phase 3: the chunk's products, then the row walk and the G walk
    vd = torch.einsum("bhcti,bhcsi->bhcts", vs, ds)          # v_t . dy_s
    ev = torch.einsum("bhcij,bhcsj->bhcsi", e_end, vs)       # E v_s
    qs = torch.einsum("bhcij,bhcsj->bhcsi", s_start, ds)     # S_c dy_s
    g = (e_end * s_start).sum(-1)
    p = (rs * uf[..., None, :] * ks).sum(-1)                 # (B, H, c, L)
    dr, dk, dv, dw = (torch.empty_like(rs) for _ in range(4))
    du = torch.zeros_like(g)
    for t in range(L):
        kt, wt, rt = ks[..., t, :], ws[..., t, :], rs[..., t, :]
        q = torch.ones_like(g)
        aw, ak = torch.zeros_like(g), torch.zeros_like(g)
        for s in range(t + 1, L):
            x = vd[..., t, s, None]
            qv = qs[..., s, :]
            qr = q * rs[..., s, :]
            aw = aw + qr * qv
            ak = ak + qr * x
            q = q * ws[..., s, :]
            qs[..., s, :] = wt * qv + kt * x
        vdd = vd[..., t, t, None]
        dw[..., t, :] = aw + q * g
        dk[..., t, :] = ak + q * ev[..., t, :] + rt * uf * vdd
        dr[..., t, :] = qs[..., t, :] + uf * kt * vdd
        du = du + rt * kt * vdd
        g = wt * g + kt * ev[..., t, :]
    G = e_end.clone()
    for t in reversed(range(L)):
        dv[..., t, :] = torch.einsum("bhcij,bhci->bhcj", G, ks[..., t, :]) \
            + p[..., t, None] * ds[..., t, :]
        G = ws[..., t, :, None] * G + rs[..., t, :, None] * ds[..., t, None, :]

    def unstaged(x, like):
        x = x.permute(0, 2, 3, 1, 4).reshape(B, n_chunks * L, H, hd)
        return x[:, :S].to(like.dtype)

    return (unstaged(dr, r), unstaged(dk, k), unstaged(dv, v),
            unstaged(dw, w), du.sum((0, 2)).to(u.dtype))


def _inputs(B, S, H, hd, seed, with_dstate):
    """Normal r, k, v, dy, w in (0, 1) with w = 0 exactly at step 3 and
    w = 1 over the steps from 5 on, for one chunk and more (across a chunk
    boundary where S allows), u small, dstate normal or None."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
                   for _ in range(4))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd))))
    w = w.astype(np.float32)
    if S > 3:
        w[:, 3] = 0.0
    w[:, 5:5 + KERNEL_CHUNK[hd] + 3] = 1.0
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    dstate = (rng.standard_normal((B, H, hd, hd)).astype(np.float32)
              if with_dstate else None)
    return r, k, v, w, u, dy, dstate


def _jax_grads(r, k, v, w, u, dy, dstate, dtype):
    """jax.vjp of ``wkv_scan`` at the inputs cast to ``dtype`` (u stays
    float32), with cotangent dy for y and dstate (or zero) for the final
    state: (dr, dk, dv, dw, du) as numpy float32, and the inputs as the
    reference saw them."""
    ins = [jnp.asarray(a).astype(dtype) for a in (r, k, v, w)]
    (_, st), vjp = jax.vjp(JR.wkv_scan, *ins, jnp.asarray(u))
    ct_st = jnp.zeros_like(st) if dstate is None else jnp.asarray(dstate)
    grads = vjp((jnp.asarray(dy).astype(dtype), ct_st))
    seen = [np.array(a.astype(jnp.float32)) for a in ins]
    seen_dy = np.array(jnp.asarray(dy).astype(dtype).astype(jnp.float32))
    return [np.asarray(g.astype(jnp.float32)) for g in grads], seen, seen_dy


def _ratios(got, want):
    return {name: float(np.abs(g - wn).max()) / max(float(np.abs(wn).max()),
                                                    1e-30)
            for name, g, wn in zip(NAMES, got, want)}


def _mirror(seen, u, seen_dy, dstate, dtype, hd, drop_carry_at=None):
    tdt = getattr(torch, dtype)
    r, k, v, w = (torch.from_numpy(a).to(tdt) for a in seen)
    dy = torch.from_numpy(seen_dy).to(tdt)
    ds = None if dstate is None else torch.from_numpy(dstate)
    got = _chunked_backward(r, k, v, w, torch.from_numpy(u), dy, ds,
                            KERNEL_CHUNK[hd], drop_carry_at)
    return [g.float().numpy() for g in got]


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("length", ["one-step", "below-chunk",
                                    "chunk-multiple", "ragged"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_chunked_mirror_matches_reference_vjp(hd, length, with_dstate):
    """float32, B 2 (du sums over batch and chunk), H 2."""
    L = KERNEL_CHUNK[hd]
    S = {"one-step": 1, "below-chunk": L - 5, "chunk-multiple": 2 * L,
         "ragged": 3 * L + 7}[length]
    r, k, v, w, u, dy, dstate = _inputs(2, S, 2, hd, hd + S, with_dstate)
    want, seen, seen_dy = _jax_grads(r, k, v, w, u, dy, dstate, jnp.float32)
    got = _mirror(seen, u, seen_dy, dstate, "float32", hd)
    ratios = _ratios(got, want)
    assert max(ratios.values()) <= TOL["float32"], ratios


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_chunked_mirror_matches_reference_vjp_bf16(hd):
    """bf16 r, k, v, w, dy over several chunks and a ragged last one, with
    dstate; the gradients rounded to bf16, du float32."""
    S = 3 * KERNEL_CHUNK[hd] + 7
    r, k, v, w, u, dy, dstate = _inputs(2, S, 2, hd, 7 * hd, True)
    want, seen, seen_dy = _jax_grads(r, k, v, w, u, dy, dstate,
                                     jnp.bfloat16)
    got = _mirror(seen, u, seen_dy, dstate, "bfloat16", hd)
    ratios = _ratios(got, want)
    assert max(ratios.values()) <= TOL["bfloat16"], ratios


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropped_chunk_carry_misses_the_limit(dtype):
    """A planted fault: the mirror with chunk 2's carry dropped (the state
    at its start and the gradient at the end of chunk 1 reset to zero)
    must miss the limit that the mirror meets."""
    hd = 64
    S = 3 * KERNEL_CHUNK[hd] + 7
    r, k, v, w, u, dy, dstate = _inputs(2, S, 2, hd, 11, True)
    want, seen, seen_dy = _jax_grads(r, k, v, w, u, dy, dstate,
                                     getattr(jnp, dtype))
    good = _ratios(_mirror(seen, u, seen_dy, dstate, dtype, hd), want)
    bad = _ratios(_mirror(seen, u, seen_dy, dstate, dtype, hd,
                          drop_carry_at=2), want)
    assert max(good.values()) <= TOL[dtype], good
    assert max(bad.values()) > TOL[dtype], bad


def test_kernel_chunk_matches_source():
    """``KERNEL_CHUNK`` is the source's ``Steps<HD>::L`` at every head dim
    the wrapper takes."""
    src = trs.SOURCE_BWD.read_text()
    found = {int(hd): int(L) for hd, L in re.findall(
        r"struct Steps<(\d+)> \{ static constexpr int L = (\d+); \};", src)}
    assert found == KERNEL_CHUNK
    assert set(found) == set(trs.HEAD_DIMS)
