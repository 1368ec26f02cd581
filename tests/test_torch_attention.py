"""The port's attention against the JAX package on the CPU.

``ops.flash_attention`` (the kernel's plain version on CPU tensors) is held
against ``flash_attention_pallas`` in interpret mode on every shape of
``tests/test_kernels.py``'s ``TestFlashAttentionKernel``, at its
float32 tolerances (2e-4 / 2e-5) and, in bfloat16, a few bf16 ulps
(both sides round one float32 result), tighter than its 3e-2. The layers of
``models/layers.py`` (rmsnorm, rope, gqa_core, the int8 KV quantizer,
decode attention over a bf16 and an int8 ring-buffer cache, full-sequence
attention) are held against ``repro.models.layers``. An emulation of the
bf16 CUDA kernel's order of work (128-key tiles, 64-key tiles at hd 256,
P rounded to bf16 before P V) is held against the Pallas kernel at the
kernel's bf16 limit.
Inputs come from a numpy seed and go through both packages.
``tests/test_torch_cuda_lm.py`` holds the CUDA kernels against the plain
version on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as JL
import repro_torch.configs as TCFG
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.models import layers as TL

from _torch_parity import assert_bits_equal, np_of

F32_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_kernels.py, float32
BF16_TOL = dict(rtol=3e-2, atol=3e-2)     # tests/test_kernels.py, bfloat16
# two implementations that compute in float32 and round the same result to
# bf16 differ by that rounding: one bf16 ulp is 2^-8 to 2^-7 of |want|
KERNEL_BF16_TOL = dict(rtol=1.6e-2, atol=4e-3)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a, dtype="float32"):
    """One numpy array as a jnp and a torch array of ``dtype`` (bf16 is
    rounded to nearest even on both sides)."""
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _f32(x):
    return np.asarray(np_of(x.float()) if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _qkv(B, Sq, Sk, H, KV, hd, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    return [_both(_normal(rng, s), dtype)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,qb,kb", [
    (1, 128, 128, 4, 2, 64, 128, 128),
    (2, 256, 256, 4, 4, 32, 128, 128),
    (1, 200, 200, 2, 1, 64, 128, 128),   # ragged seq vs block
    (2, 64, 64, 8, 2, 128, 64, 64),
    (1, 384, 384, 4, 2, 64, 128, 256),   # asymmetric blocks
])
def test_flash_causal_matches_pallas(B, Sq, Sk, H, KV, hd, qb, kb):
    """The tile sizes vary the Pallas kernel only: the port's tiles are
    its own, and ``ops.flash_attention`` refuses any other."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Sq, Sk, H, KV, hd)
    want = flash_attention_pallas(jq, jk, jv, causal=True, q_block=qb,
                                  kv_block=kb)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("B,Sq,H,KV,window", [
    (1, 128, 2, 1, 0),        # causal
    (1, 128, 2, 1, 48),       # sliding window
    (2, 200, 4, 2, 64),       # ragged against the 128-row block, window
])
def test_flash_hd256_matches_pallas(B, Sq, H, KV, window):
    """gemma3-12b's head dim, 256: the plain version against the Pallas
    kernel (interpret mode), causal, with and without a window."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Sq, Sq, H, KV, 256, seed=12)
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("tiles", [{"q_block": 64}, {"kv_block": 256}])
def test_flash_refuses_tpu_tile_sizes(tiles):
    (_, tq), (_, tk), (_, tv) = _qkv(1, 64, 64, 2, 1, 32)
    with pytest.raises(ValueError, match="selects nothing"):
        tops.flash_attention(tq, tk, tv, **tiles)
    tops.flash_attention(tq, tk, tv, q_block=128, kv_block=128)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_sliding_window_matches_pallas(window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 256, 256, 4, 2, 64, seed=1)
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window)
    got = tops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


def test_flash_bfloat16_matches_pallas():
    """Both compute in float32 and round the result to bf16, so they are
    held at a few bf16 ulps (KERNEL_BF16_TOL), tighter than the
    reference's 3e-2."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 128, 128, 4, 2, 64, seed=2,
                                        dtype="bfloat16")
    want = flash_attention_pallas(jq, jk, jv)
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **KERNEL_BF16_TOL)


def _key_tile(hd):
    """Keys per K/V tile of the bf16 CUDA kernel (``Tile<HD>::kKeys`` in
    ``csrc/flash_attention.cu``): 128, or 64 at hd 256."""
    return 64 if hd > 128 else 128


def _hopper_kernel_order(q, k, v, causal, window):
    """The bf16 CUDA kernel's order of work, emulated in float32 on the
    CPU: scores of the bf16 inputs in base 2 (times log2(e) / sqrt(hd)),
    masked to -1e30, taken over the kernel's key tiles in order with the
    online max and sum in float32; each tile's P rounded to bf16 before
    P V, the accumulator rescaled by exp2(m_prev - m_new); O / max(l,
    1e-30) rounded to bf16. Rows are independent, so the kernel's 128-row
    query tiles and its skipping of tiles that mask every row of one do
    not change this."""
    B, Sq, H, hd = q.shape
    kt = _key_tile(hd)
    Sk, G = k.shape[1], H // k.shape[2]
    qf = q.float().transpose(1, 2)                           # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    scale = float(np.float32(np.log2(np.e) / np.sqrt(hd)))
    neg = torch.tensor(-1e30)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, kt):
        kpos = torch.arange(k0, min(k0 + kt, Sk))[None, :]
        s = (qf @ kf[:, :, k0:k0 + kt].transpose(-1, -2)) * scale
        ok = torch.ones(Sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pb = p.to(torch.bfloat16).float()
        o = o * corr + pb @ vf[:, :, k0:k0 + kt]
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (1, 512, 512, 8, 2, 64, True, 0),      # causal, GQA 4
    (2, 200, 328, 4, 4, 128, False, 0),    # non-causal, ragged Sq and Sk
    (1, 384, 384, 8, 1, 32, True, 200),    # window ending inside a tile
    (1, 256, 256, 4, 2, 256, True, 0),     # hd 256: 64-key tiles, causal
    (1, 200, 200, 2, 1, 256, True, 100),   # hd 256, window inside a tile
])
def test_hopper_kernel_arithmetic_within_bf16_limit(B, Sq, Sk, H, KV, hd,
                                                    causal, window):
    """The bf16 kernel rounds P to bf16 before P V (as SDPA does); the
    Pallas kernel keeps P in float32. Emulated here in the kernel's order
    of work, that rounding stays inside KERNEL_BF16_TOL against the Pallas
    kernel (interpret mode) on bf16 inputs."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Sq, Sk, H, KV, hd, seed=6,
                                        dtype="bfloat16")
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window)
    got = _hopper_kernel_order(tq, tk, tv, causal, window)
    np.testing.assert_allclose(_f32(got), _f32(want), **KERNEL_BF16_TOL)


def _attention_keeping(q, k, v, keep):
    """Float32 GQA attention over the (Sq, Sk) pairs ``keep`` marks."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / hd ** 0.5
    w = torch.softmax(logits.masked_fill(~keep, -1e9), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(q.shape).to(q.dtype)


@pytest.mark.parametrize("fault", ["late_tile_skipped", "normalizer_off"])
def test_bf16_kernel_limit_fails_planted_faults(fault):
    """KERNEL_BF16_TOL is not vacuous: outputs a wrong causal kernel
    would give (a late 64-key tile skipped by every query past it; a
    normalizer 3% off) fail it, while the plain version passes."""
    (_, q), (_, k), (_, v) = _qkv(1, 512, 512, 4, 2, 64, seed=5,
                                  dtype="bfloat16")
    want = tfa.flash_attention_plain(q, k, v)
    if fault == "late_tile_skipped":
        pos = torch.arange(512)
        keep = pos[None, :] <= pos[:, None]
        keep[320:, 256:320] = False
        bad = _attention_keeping(q, k, v, keep)
    else:
        bad = (want.float() * 1.03).to(torch.bfloat16)
    np.testing.assert_allclose(
        _f32(_attention_keeping(q, k, v, torch.ones(512, 512).tril().bool())),
        _f32(want), **KERNEL_BF16_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_f32(bad), _f32(want), **KERNEL_BF16_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 40, 40, 4, 2, 32, True, 0),      # causal, GQA 2
    (1, 70, 70, 4, 1, 64, True, 16),     # sliding window, GQA 4
    (2, 24, 56, 2, 2, 32, False, 0),     # non-causal, Sq < Sk
    (1, 48, 30, 6, 2, 16, False, 0),     # non-causal, Sq > Sk
])
def test_flash_backward_plain_matches_jax_grad(B, Sq, Sk, H, KV, hd, causal,
                                               window):
    """The port's plain backward, fed the plain log-sum-exp, against
    jax.grad of the reference's ``blocked_attention`` (what the backward
    kernels replace) on the same float32 inputs: both compute in float32
    in other orders, so within rtol 1e-4 / atol 1e-5 of max |want|. Every
    row here keeps some key (the reference gives a row with none the mean
    of V, the port no gradient)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, Sq, Sk, H, KV, hd, seed=8)
    jdo, tdo = _both(_normal(np.random.default_rng(9), (B, Sq, H, hd)))
    _, vjp = jax.vjp(lambda q, k, v: JL.blocked_attention(
        q, k, v, causal=causal, window=window), jq, jk, jv)
    want = vjp(jdo)
    o, lse = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 return_lse=True)
    got = ref.flash_attention_backward_plain(tq, tk, tv, o, tdo,
                                             causal=causal, window=window,
                                             lse=lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np_of(g), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_flash_non_causal_ragged_matches_pallas():
    """Sq != Sk, non-causal."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 128, 192, 2, 2, 64, seed=3)
    want = flash_attention_pallas(jq, jk, jv, causal=False)
    got = tops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


def test_flash_routes_cpu_and_meta_to_plain():
    """CPU and shape-only meta tensors take the plain version: no launch.
    A head dim the CUDA kernel refuses is still served on the CPU."""
    before = tfa.LAUNCHES["flash_attention"]
    q = torch.zeros((1, 7, 4, 96), device="meta")
    kv = torch.zeros((1, 9, 2, 96), device="meta")
    out = tfa.flash_attention(q, kv, kv, causal=False)
    assert out.shape == (1, 7, 4, 96) and out.device.type == "meta"
    (_, tq), (_, tk), (_, tv) = _qkv(1, 5, 5, 2, 1, 96, seed=4)
    assert tfa.flash_attention(tq, tk, tv).shape == (1, 5, 2, 96)
    assert tfa.LAUNCHES["flash_attention"] == before


def test_flash_rejects_bad_shapes():
    q = torch.zeros((1, 4, 3, 32))
    kv = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :16], kv, kv)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfgs():
    """The reduced phi3 config of both packages (2 layers, d 128, H 4,
    KV 2, hd 32, f32)."""
    return (JCFG.get("phi3-medium-14b").reduced(),
            TCFG.get("phi3-medium-14b").reduced())


def _attn_params(cfg, rng, dtype="float32"):
    d, hd = cfg.d_model, cfg.hd
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    pairs = {k: _both(_normal(rng, s, d ** -0.5), dtype)
             for k, s in shapes.items()}
    return ({k: p[0] for k, p in pairs.items()},
            {k: p[1] for k, p in pairs.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(5)
    jx, tx = _both(_normal(rng, (2, 9, 64), 3.0), dtype)
    js, ts = _both(_normal(rng, (64,)), dtype)
    got = TL.rmsnorm({"scale": ts}, tx)
    want = JL.rmsnorm({"scale": js}, jx)
    assert got.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_rope_interleaved_matches():
    rng = np.random.default_rng(6)
    jx, tx = _both(_normal(rng, (2, 11, 3, 32)))
    pos = np.arange(11)[None] + 5
    got = TL.rope(tx, torch.from_numpy(pos), 1e4)
    want = JL.rope(jx, jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gqa_core_matches():
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal(rng, s)) for s in ((2, 6, 4, 32), (2, 10, 2, 32),
                                         (2, 10, 2, 32))]
    mask = np.tril(np.ones((6, 10), bool), 4)
    valid = np.arange(10) < 8
    got = TL.gqa_core(tq, tk, tv, mask=torch.from_numpy(mask),
                      kv_valid=torch.from_numpy(valid))
    want = JL.gqa_core(jq, jk, jv, mask=jnp.asarray(mask),
                       kv_valid=jnp.asarray(valid))
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_exact(dtype):
    """Codes equal, scales bit-equal (half-to-even rounding on both)."""
    rng = np.random.default_rng(8)
    x = _normal(rng, (2, 16, 2, 32), 2.0)
    x[0, 3, 1] = 0.0                                  # an all-zero row
    x[1, 2, 0, :5] = [0.5, -0.5, 1.5, 2.5, 127.0]     # .5 ties at scale 1
    jx, tx = _both(x, dtype)
    tq, ts = TL.kv_quantize(tx)
    jq, js = JL.kv_quantize(jx)
    assert_bits_equal(tq, np.asarray(jq))
    assert ts.dtype == torch.bfloat16
    assert_bits_equal(ts.view(torch.int16), np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(
        _f32(TL.kv_dequantize(tq, ts, torch.float32)),
        np.asarray(JL.kv_dequantize(jq, js, jnp.float32)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache",
                                                     "int8_cache"])
def test_decode_attention_matches(cfgs, int8):
    """One decode step over a partly filled bf16 ring-buffer cache (and
    over int8 codes + bf16 scales): the slot written at pos % S, the
    output, and the untouched slots."""
    jcfg, tcfg = cfgs
    if int8:
        jcfg = dataclasses.replace(jcfg, kv_dtype="int8")
        tcfg = dataclasses.replace(tcfg, kv_dtype="int8")
    rng = np.random.default_rng(9)
    jp, tp = _attn_params(tcfg, rng, "bfloat16")
    B, S, KV, hd, pos = 2, 12, tcfg.n_kv_heads, tcfg.hd, 7
    jx, tx = _both(_normal(rng, (B, 1, tcfg.d_model)), "bfloat16")
    k, v = (_normal(rng, (B, S, KV, hd)) for _ in range(2))
    if int8:
        jcache, tcache = {}, {}
        for name, arr in (("k", k), ("v", v)):
            jc, js = JL.kv_quantize(jnp.asarray(arr).astype(jnp.bfloat16))
            jcache[name], jcache[name + "_scale"] = jc, js
            tcache[name] = torch.from_numpy(np.array(jc))
            tcache[name + "_scale"] = torch.from_numpy(
                np.array(js).view(np.int16)).view(torch.bfloat16)
    else:
        jcache = {"k": _both(k, "bfloat16")[0], "v": _both(v, "bfloat16")[0]}
        tcache = {"k": _both(k, "bfloat16")[1], "v": _both(v, "bfloat16")[1]}
    want, jnew = JL.decode_attention(jp, jcfg, jx, jcache,
                                     jnp.asarray(pos, jnp.int32))
    got, tnew = TL.decode_attention(tp, tcfg, tx, tcache, pos)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16_TOL)
    for name in jnew:
        t, j = tnew[name], np.asarray(jnew[name])
        if t.dtype == torch.bfloat16:
            # the untouched slots cross bit for bit; the new slot's K/V
            # come out of two bf16 projections and a rope
            keep = np.arange(S) != pos
            assert_bits_equal(t.view(torch.int16)[:, keep],
                              j.view(np.int16)[:, keep])
            np.testing.assert_allclose(_f32(t[:, pos]), _f32(j[:, pos]),
                                       **BF16_TOL)
        else:
            np.testing.assert_array_equal(np_of(t)[:, np.arange(S) != pos],
                                          j[:, np.arange(S) != pos])
            assert np.abs(np_of(t)[:, pos].astype(int)
                          - j[:, pos].astype(int)).max() <= 1


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_full_seq_attention_matches(cfgs, cross):
    """Projection + rope + attention: the port's flash kernel (plain on the
    CPU) against the reference's blocked_attention, in float32; causal
    self-attention, and non-causal attention over a longer kv_x."""
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(10)
    jp, tp = _attn_params(tcfg, rng)
    jx, tx = _both(_normal(rng, (2, 37, tcfg.d_model)))
    jkv, tkv = _both(_normal(rng, (2, 53, tcfg.d_model))) if cross \
        else (None, None)
    got = TL.full_seq_attention(tp, tcfg, tx, causal=not cross, kv_x=tkv)
    want = JL.full_seq_attention(jp, jcfg, jx, causal=not cross, kv_x=jkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np.asarray(w), **F32_TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_gqa_attention_with_scores_mask_matches(cfgs, window):
    """The general (materialized) attention with a causal / windowed
    mask from gqa_scores_mask."""
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(11)
    jp, tp = _attn_params(tcfg, rng)
    jx, tx = _both(_normal(rng, (2, 19, tcfg.d_model)))
    pos = np.arange(19)
    tmask = TL.gqa_scores_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                               window=window)
    jmask = JL.gqa_scores_mask(jnp.asarray(pos), jnp.asarray(pos),
                               window=window)
    np.testing.assert_array_equal(np_of(tmask), np.asarray(jmask))
    got = TL.gqa_attention(tp, tcfg, tx, mask=tmask)
    want = JL.gqa_attention(jp, jcfg, jx, mask=jmask)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32_TOL)
