"""The port's RWKV6 against the JAX package on the CPU.

``ops.rwkv_wkv`` (the WKV6 kernel's plain version on CPU tensors) is held
against ``rwkv_scan_pallas`` in interpret mode on the shapes of
``tests/test_kernels.py``'s ``TestRWKVScanKernel`` at its tolerance
(1e-4), and against the reference model's ``wkv_scan``. ``time_mix``,
``channel_mix`` and ``rwkv_block`` (full sequence and single step) are
held against ``repro.models.rwkv`` with the same weights and inputs, made
from a numpy seed. ``tests/test_torch_cuda_lm.py`` holds the CUDA kernel
against the plain version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
from repro.kernels.rwkv_scan import rwkv_scan_pallas
from repro.models import rwkv as JR
import repro_torch.configs as TCFG
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv_scan as trs
from repro_torch.models import rwkv as TR
from repro_torch.tree import tree_map

from _torch_parity import np_of

TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_kernels.py


def _inputs(B, S, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, H, hd))))
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,S,H,hd,chunk", [
    (1, 64, 2, 64, 64), (2, 128, 4, 32, 32), (1, 100, 2, 64, 64),
    (2, 64, 1, 128, 16),
])
def test_wkv_matches_pallas(B, S, H, hd, chunk):
    """``chunk`` varies the Pallas kernel only: the port walks time in one
    pass, and ``ops.rwkv_wkv`` refuses any other chunk."""
    arrs = _inputs(B, S, H, hd)
    y_want, st_want = rwkv_scan_pallas(*map(jnp.asarray, arrs), chunk=chunk)
    y, st = tops.rwkv_wkv(*map(_t, arrs))
    np.testing.assert_allclose(np_of(y), np.asarray(y_want), **TOL)
    np.testing.assert_allclose(np_of(st), np.asarray(st_want), **TOL)


# the CUDA kernel's rows per thread at each head dim (csrc/rwkv_scan.cu
# Tile); y sums the parts of hd / rows row groups
KERNEL_ROWS = {16: 8, 64: 16}
BF16_TOL = dict(rtol=1.6e-2, atol=4e-3)   # tests/test_torch_cuda_lm.py


def _fma(a, b, c):
    """float32 fma: the product is exact in float64, one rounding after."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_order(r, k, v, w, u, rows):
    """The WKV6 recurrence in float32 with the CUDA kernel's order of work:
    per step, p = sum_k (r_k u_k) k_k over 32 lanes (an fma chain over
    k = lane + 32 j, then a butterfly); each row group of ``rows`` rows
    forms its part of r . S in two fma chains (even and odd rows) and adds
    them, row group 0 then adds the bonus, fma(p, v_c, part); y_c sums the
    parts in row-group order; S = fma(w, S, k v). Inputs (B, S, H, hd)
    float32 (bf16 inputs widened); returns (y float32, state)."""
    Bn, S, H, hd = r.shape
    groups, nu = hd // rows, max(1, hd // 32)
    st = torch.zeros((Bn, H, hd, hd))
    ys = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        ru = torch.zeros((Bn, H, 32 * nu))
        kk = torch.zeros((Bn, H, 32 * nu))
        ru[..., :hd], kk[..., :hd] = rt * u, kt
        lanes = torch.zeros((Bn, H, 32))
        for j in range(nu):
            lanes = _fma(ru[..., 32 * j:32 * (j + 1)],
                         kk[..., 32 * j:32 * (j + 1)], lanes)
        for m in (16, 8, 4, 2, 1):
            lanes = lanes[..., :m] + lanes[..., m:2 * m]
        p = lanes[..., 0]
        sg = st.reshape(Bn, H, groups, rows, hd)
        rg = rt.reshape(Bn, H, groups, rows)
        acc = [torch.zeros((Bn, H, groups, hd)) for _ in range(2)]
        for i in range(rows):
            acc[i % 2] = _fma(rg[..., i, None], sg[..., i, :], acc[i % 2])
        part = acc[0] + acc[1]
        yt = _fma(p[..., None], vt, part[:, :, 0])
        for g in range(1, groups):
            yt = yt + part[:, :, g]
        ys.append(yt)
        st = _fma(wt[..., :, None], st, kt[..., :, None] * vt[..., None, :])
    return torch.stack(ys, dim=1), st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_kernel_arithmetic_order_within_limits(hd, dtype):
    """The CUDA kernel's order of sums, emulated here, against
    ``rwkv_scan_pallas`` in interpret mode: float32 at the reference's
    1e-4; bf16 inputs with y in bf16 at the card's bf16 limit and the
    float32 state at 1e-4. S = 45 is no multiple of the kernel's chunk
    (2048 / hd steps)."""
    r, k, v, w, u = _inputs(2, 45, 2, hd, seed=2)
    jd = getattr(jnp, dtype)
    ins = [jnp.asarray(a).astype(jd) for a in (r, k, v, w)]
    y_want, st_want = rwkv_scan_pallas(*ins, jnp.asarray(u))
    wide = [_t(np.asarray(a.astype(jnp.float32))) for a in ins]
    y, st = _kernel_order(*wide, _t(u), KERNEL_ROWS[hd])
    np.testing.assert_allclose(np_of(st), np.asarray(st_want), **TOL)
    if dtype == "float32":
        np.testing.assert_allclose(np_of(y), np.asarray(y_want), **TOL)
    else:
        got = y.to(torch.bfloat16).float()
        np.testing.assert_allclose(np_of(got),
                                   np.asarray(y_want.astype(jnp.float32)),
                                   **BF16_TOL)


def test_wkv_refuses_tpu_chunk():
    arrs = [_t(a) for a in _inputs(1, 8, 1, 32)]
    with pytest.raises(ValueError, match="selects nothing"):
        tops.rwkv_wkv(*arrs, chunk=32)
    tops.rwkv_wkv(*arrs, chunk=64)


def test_wkv_matches_model_scan_in_bfloat16():
    """bf16 inputs: y comes back in bf16, the state in f32, as the
    reference model's ``wkv_scan`` returns them."""
    arrs = _inputs(2, 48, 2, 32, seed=1)
    jy, jst = JR.wkv_scan(*(jnp.asarray(a).astype(jnp.bfloat16)
                            for a in arrs))
    y, st = trs.rwkv_scan(*(_t(a).to(torch.bfloat16) for a in arrs))
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(np_of(y.float()),
                               np.asarray(jy, np.float32), rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(np_of(st), np.asarray(jst), **TOL)


def test_wkv_routes_cpu_and_meta_to_plain():
    before = trs.LAUNCHES["rwkv_scan"]
    meta = torch.zeros((1, 3, 2, 16), device="meta")
    y, st = trs.rwkv_scan(meta, meta, meta, meta,
                          torch.zeros((2, 16), device="meta"))
    assert y.shape == (1, 3, 2, 16) and st.shape == (1, 2, 16, 16)
    assert trs.LAUNCHES["rwkv_scan"] == before
    with pytest.raises(ValueError):
        trs.rwkv_scan(meta, meta, meta, meta[:, :2],
                      torch.zeros((2, 16), device="meta"))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    """The reduced rwkv6 config of both packages (d 128, head dim 16, f32)
    and one block's weights: the reference's init, carried across."""
    jcfg = JCFG.get("rwkv6-3b").reduced()
    tcfg = TCFG.get("rwkv6-3b").reduced()
    jp = JR.rwkv_block_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # a decay bias that spreads w over (0, 1), and a non-trivial mix
    rng = np.random.default_rng(4)
    jp = dict(jp, w_bias=jnp.asarray(rng.standard_normal(128) - 1.0,
                                     jnp.float32),
              mix_k=jnp.asarray(rng.random(128), jnp.float32))
    tp = tree_map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, tcfg, jp, tp


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 128)).astype(np.float32)


def test_time_mix_matches(block):
    jcfg, tcfg, jp, tp = block
    x, prev = _x(2, 19, 5), _x(2, 1, 6)[:, 0]
    want = JR.time_mix(jp, jcfg, jnp.asarray(x), jnp.asarray(prev))
    got = TR.time_mix(tp, tcfg, _t(x), _t(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), **TOL)


def test_channel_mix_matches(block):
    jcfg, tcfg, jp, tp = block
    x, prev = _x(2, 19, 7), _x(2, 1, 8)[:, 0]
    want = JR.channel_mix(jp, jcfg, jnp.asarray(x), jnp.asarray(prev))
    got = TR.channel_mix(tp, tcfg, _t(x), _t(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), **TOL)


def test_rwkv_block_full_sequence_then_step_matches(block):
    """A full sequence from the zero state, then one single step from the
    state it leaves: outputs and every state leaf."""
    jcfg, tcfg, jp, tp = block
    x, x1 = _x(2, 23, 9), _x(2, 1, 10)
    jy, jst = JR.rwkv_block(jp, jcfg, jnp.asarray(x))
    ty, tst = TR.rwkv_block(tp, tcfg, _t(x))
    np.testing.assert_allclose(np_of(ty), np.asarray(jy), **TOL)
    for k in jst:
        np.testing.assert_allclose(np_of(tst[k]), np.asarray(jst[k]), **TOL)
    jy1, jst1 = JR.rwkv_block(jp, jcfg, jnp.asarray(x1), state=jst,
                              single_step=True)
    ty1, tst1 = TR.rwkv_block(tp, tcfg, _t(x1), state=tst, single_step=True)
    np.testing.assert_allclose(np_of(ty1), np.asarray(jy1), **TOL)
    for k in jst1:
        np.testing.assert_allclose(np_of(tst1[k]), np.asarray(jst1[k]), **TOL)
