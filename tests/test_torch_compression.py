"""The port's compression engine against the JAX package: the wire format
(codes, scales, digests) bit-exact for the same folded seeds, in flat and
shard modes, bits 8 and 4, on the kernel and the plain route;
``decode . encode == apply``; ``payload_bytes == encoded_bytes``; the
reduce; integrity checks; the other compressors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro_torch.core import compression as TC
from repro_torch.kernels import quantize_block as tqb

from _torch_parity import assert_bits_equal, leaf_seeds, to_torch

KEY = jax.random.PRNGKey(7)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((16, 512)) * 2).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32),
            "a": rng.standard_normal((4, 3, 256)).astype(np.float32)}


def _pair(**kw):
    return JC.block_quant(**kw), TC.block_quant(**kw)


# kernel_threshold 1024 sends "w" and "a" (>= 1024 elements, 128-aligned
# groups) to the kernel route; the default keeps every leaf on the oracle
ROUTES = {"kernel": 1024, "plain": JC.KERNEL_DISPATCH_MIN}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dither", ["hash", "kernel"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shard_safe", [False, True])
def test_wire_format_bit_exact(shard_safe, bits, dither, route):
    jc, tc = _pair(bits=bits, block=256, dither=dither, shard_safe=shard_safe,
                   kernel_threshold=ROUTES[route], checksum=True)
    tree = _tree(bits)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = to_torch(tree)
    seeds = leaf_seeds(KEY, len(tree))
    jp, tp = jc.encode(KEY, jt), tc.encode(seeds, tt)
    for k in tree:
        assert_bits_equal(tp[k].codes, jp[k].codes, k)
        assert_bits_equal(tp[k].scales, jp[k].scales, k)
        assert_bits_equal(tp[k].check, jp[k].check, k)
        assert (tp[k].group, tp[k].mode, tp[k].shape) == \
            (jp[k].group, jp[k].mode, jp[k].shape)
    ja, ta, td = jc.apply(KEY, jt), tc.apply(seeds, tt), tc.decode(tp)
    for k in tree:
        assert_bits_equal(ta[k], ja[k], k)
        assert_bits_equal(td[k], ta[k], k)      # decode . encode == apply
    assert tc.payload_bytes(tt) == tc.encoded_bytes(tp) == tc.wire_bytes(tt)
    assert tc.payload_bytes(tt) == jc.payload_bytes(jt)
    assert tc.encoded_bytes(tp) == jc.encoded_bytes(jp)


def test_kernel_route_is_taken():
    """At the test threshold the large leaves reach the kernel wrappers
    (their plain versions on the CPU); identical bits either way."""
    calls = []
    orig = tqb.quantize_encode_grouped

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    tqb_ops = TC.kernel_ops
    try:
        tqb_ops.qb.quantize_encode_grouped = spy
        TC.block_quant(8, 256, dither="hash", kernel_threshold=1024).encode(
            [1, 2, 3], to_torch(_tree()))
    finally:
        tqb_ops.qb.quantize_encode_grouped = orig
    assert sorted(calls) == sorted([(12, 256), (32, 256)])


@pytest.mark.parametrize("shard_safe", [False, True])
def test_large_group_takes_kernel_route(shard_safe, monkeypatch):
    """A 128-aligned group above 1024 reaches the kernel wrappers, as it
    reaches the Pallas kernels in the reference, with the same bits."""
    calls = []

    def spy(name):
        orig = getattr(tqb, name)

        def wrapped(*a, group, **kw):
            calls.append((name, group))
            return orig(*a, group=group, **kw)
        monkeypatch.setattr(tqb, name, wrapped)

    for name in ("quantize_encode_grouped", "decode_reduce_grouped"):
        spy(name)
    jc, tc = _pair(bits=8, block=2048, dither="hash", shard_safe=shard_safe,
                   kernel_threshold=1024)
    # shard mode's group divides the last axis 32 ways: 65536 / 32 = 2048
    x = (np.random.default_rng(5).standard_normal((2, 65536)) * 2).astype(
        np.float32)
    keys = jax.random.split(KEY, 2)
    jps = [jc.encode(k, {"w": jnp.asarray(x)}) for k in keys]
    tps = [tc.encode(leaf_seeds(k, 1), {"w": to_torch(x)}) for k in keys]
    for jp, tp in zip(jps, tps):
        assert_bits_equal(tp["w"].codes, jp["w"].codes)
        assert_bits_equal(tp["w"].scales, jp["w"].scales)
    w = np.array([0.75, 0.25], np.float32)
    jr = jc.decode_reduce(jax.tree.map(lambda *xs: jnp.stack(xs), *jps),
                          jnp.asarray(w))
    tr = tc.decode_reduce(TC.stack_payloads(tps), torch.from_numpy(w))
    assert_bits_equal(tr["w"], jr["w"])
    assert calls == [("quantize_encode_grouped", 2048)] * 2 + \
        [("decode_reduce_grouped", 2048)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shard_safe", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_reduce_matches_reference(shard_safe, bits, route):
    jc, tc = _pair(bits=bits, block=256, dither="hash", shard_safe=shard_safe,
                   kernel_threshold=ROUTES[route])
    tree = _tree(3)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    keys = jax.random.split(KEY, 3)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jc.encode(k, jt) for k in keys])
    tstack = TC.stack_payloads([tc.encode(leaf_seeds(k, 3), to_torch(tree))
                                for k in keys])
    w = np.array([0.5, 0.0, 0.25], np.float32)
    jr = jc.decode_reduce(jstack, jnp.asarray(w))
    tr = tc.decode_reduce(tstack, torch.from_numpy(w))
    for k in tree:
        if route == "kernel" and k != "b":
            # the kernel's c-sequential order on both sides
            assert_bits_equal(tr[k], jr[k], k)
        else:
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        dec = tc.decode(tstack)[k]
        np.testing.assert_allclose(
            tr[k].numpy(), torch.tensordot(torch.from_numpy(w), dec,
                                           dims=1).numpy(),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shard_safe", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_decode_reduce_bf16_matches_reference(monkeypatch, shard_safe, route):
    """bf16 leaves: the reduce is float32 (the bf16 decode promoted, as
    ``jnp.tensordot`` promotes it) and follows the reference's
    decode-then-tensordot; on the kernel route the port's fused decode +
    reduce (which the reference keeps to float32 leaves) rounds each
    dequantized element to bf16, as decode does, so it agrees to float32
    reduction order."""
    calls = []
    orig = tqb.decode_reduce_grouped

    def spy(*a, **kw):
        calls.append(kw.get("round_to"))
        return orig(*a, **kw)
    monkeypatch.setattr(tqb, "decode_reduce_grouped", spy)
    jc, tc = _pair(bits=8, block=256, dither="hash", shard_safe=shard_safe,
                   kernel_threshold=ROUTES[route])
    tree = _tree(4)
    jt = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in tree.items()}
    keys = jax.random.split(KEY, 3)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[jc.encode(k, jt) for k in keys])
    tstack = TC.stack_payloads([tc.encode(leaf_seeds(k, 3), tt)
                                for k in keys])
    w = np.array([0.5, 0.0, 0.25], np.float32)
    jr = jc.decode_reduce(jstack, jnp.asarray(w))
    tr = tc.decode_reduce(tstack, torch.from_numpy(w))
    dec = tc.decode(tstack)
    for k in tree:
        assert tr[k].dtype == torch.float32, k
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(
            tr[k].numpy(), torch.tensordot(torch.from_numpy(w),
                                           dec[k].float(), dims=1).numpy(),
            rtol=1e-6, atol=1e-7, err_msg=k)
    # flat groups of 256: "w" and "a" on the kernel route, their decode
    # rounded to bf16 (shard-safe groups here are 16 and 8: no kernel)
    assert calls == ([torch.bfloat16] * 2
                     if route == "kernel" and not shard_safe else [])


def test_verify_and_zero_invalid_rows():
    tc = TC.block_quant(8, 256, dither="hash", checksum=True)
    tree = to_torch(_tree())
    stack = TC.stack_payloads([tc.encode([i, i + 1, i + 2], tree)
                               for i in range(3)])
    assert bool(TC.verify_payload(stack).all())
    codes = stack["w"].codes.clone()
    codes[1, 5] += 1                                  # damage client 1
    bad = dict(stack, w=TC.PackedLeaf(
        codes=codes, scales=stack["w"].scales, shape=stack["w"].shape,
        dtype=stack["w"].dtype, bits=8, group=256, mode="flat",
        check=stack["w"].check))
    ok = TC.verify_payload(bad)
    assert ok.tolist() == [True, False, True]
    zeroed = TC.zero_invalid_rows(bad, ok)
    dec = tc.decode(zeroed)
    for k in tree:
        assert bool((dec[k][1] == 0).all())
        assert torch.equal(dec[k][0], tc.decode(stack)[k][0])
    # the reference flags the same client on the same damaged buffers
    w = bad["w"]
    jcheck = w.check.numpy().view(np.uint32)
    jok = JC.leaf_checksum(jnp.asarray(w.codes.numpy()),
                           jnp.asarray(w.scales.numpy()), 1) == jcheck
    assert np.asarray(jok).tolist() == [True, False, True]


def test_nibbles_roundtrip_and_match_reference():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (6, 64)).astype(np.int8)
    packed = TC.pack_nibbles(torch.from_numpy(codes))
    assert_bits_equal(packed, JC.pack_nibbles(jnp.asarray(codes)))
    assert_bits_equal(TC.unpack_nibbles(packed), codes)
    assert_bits_equal(TC.unpack_nibbles(packed),
                      JC.unpack_nibbles(JC.pack_nibbles(jnp.asarray(codes))))


@pytest.mark.parametrize("D", [1, 3, 64, 96, 100, 128, 256, 4096, 5120,
                               17920, 3000])
@pytest.mark.parametrize("block", [64, 256])
def test_group_size_matches(D, block):
    assert TC.group_size(D, block) == JC.group_size(D, block)


@pytest.mark.parametrize("bits", [8, 4])
def test_native_compute_matches(bits):
    jc, tc = _pair(bits=bits, block=128, dither="hash", compute="native",
                   shard_safe=True)
    x = np.random.default_rng(1).standard_normal((8, 256)).astype(np.float32)
    jx = {"x": jnp.asarray(x).astype(jnp.bfloat16)}
    tx = {"x": torch.from_numpy(x).to(torch.bfloat16)}
    seeds = leaf_seeds(KEY, 1)
    jp, tp = jc.encode(KEY, jx), tc.encode(seeds, tx)
    assert_bits_equal(tp["x"].codes, jp["x"].codes)
    assert_bits_equal(tp["x"].scales.view(torch.int16),
                      np.asarray(jp["x"].scales).view(np.int16))
    ta = tc.apply(seeds, tx)["x"]
    assert_bits_equal(ta.view(torch.int16),
                      np.asarray(jc.apply(KEY, jx)["x"]).view(np.int16))
    assert tc.payload_bytes(tx) == tc.encoded_bytes(tp) == \
        jc.payload_bytes(jx)


def test_leaf_order_is_jax_order():
    tree = {"zeta": np.zeros(3), "alpha": {"k": np.ones(2), "b": np.ones(1)},
            "m": (np.ones(4), np.zeros(5))}
    from repro_torch.tree import tree_leaves
    jl = [np.asarray(x).shape for x in jax.tree.leaves(tree)]
    tl = [tuple(x.shape) for x in tree_leaves(to_torch(tree))]
    assert jl == tl


def test_uniform_dither_roundtrip():
    tc = TC.block_quant(8, 256, dither="uniform", kernel_threshold=1024)
    tree = to_torch(_tree())
    gen_seeds = [11, 22, 33]
    a = tc.apply(gen_seeds, tree)
    b = tc.decode(tc.encode(gen_seeds, tree))
    for k in tree:
        assert torch.equal(a[k], b[k])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for k in tree:
        assert torch.equal(tc.apply(g1, tree)[k], tc.apply(g2, tree)[k])


def test_other_compressors_match_reference_accounting():
    shapes = [(300,), (16, 512), ()]
    trees = ({f"l{i}": jnp.zeros(s) for i, s in enumerate(shapes)},
             {f"l{i}": torch.zeros(s) for i, s in enumerate(shapes)})
    for make in (lambda m: m.identity(), lambda m: m.rand_k(0.1),
                 lambda m: m.with_participation(m.block_quant(4, 128), 0.3)):
        jc, tc = make(JC), make(TC)
        assert tc.omega == pytest.approx(jc.omega)
        assert tc.payload_bytes(trees[1]) == jc.payload_bytes(trees[0])
        assert tc.name == jc.name
    assert TC.effective_omega(0.3, 0.25) == JC.effective_omega(0.3, 0.25)


def test_rand_k_and_participation_unbiased():
    x = {"x": torch.linspace(-1, 1, 512)}
    for comp in (TC.rand_k(0.25),
                 TC.with_participation(TC.block_quant(8, 128), 0.5)):
        gen = torch.Generator().manual_seed(0)
        mean = sum(comp.apply(gen, x)["x"] for _ in range(800)) / 800
        assert float((mean - x["x"]).abs().mean()) < 0.1


def test_seed_sequence_must_match_leaves():
    with pytest.raises(ValueError):
        TC.block_quant(8).apply([1, 2], {"a": torch.zeros(4)})
