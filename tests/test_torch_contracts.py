"""The port's ``check_compressor`` (``repro_torch.analysis.contracts``)
against the reference's (``repro.analysis.contracts``): every case of
``tests/test_analysis_contracts.py``, each held to the reference's
verdict on the same shapes (``ok``, the contracts ``checked``, the names
of the contracts violated), the port on ``meta`` tensors, the reference
under ``jax.eval_shape``. Then full-width parameter trees, the
quantizers' ``meta`` route against their plain route, and the counted
peak of a ``meta`` encode (no leaf-sized temporaries)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import check_compressor as j_check
from repro.core import compression as JC
from repro.core.compression import PackedLeaf as JPackedLeaf
from repro_torch.analysis import check_compressor as t_check
from repro_torch.core import compression as TC
from repro_torch.core.compression import PackedLeaf as TPackedLeaf
from repro_torch.kernels import quantize_block as qb
from repro_torch.tree import tree_map

J_TREE = {"w": jnp.zeros((64, 256), jnp.float32),
          "b": jnp.zeros((256,), jnp.float32)}
T_TREE = {"w": torch.zeros((64, 256)), "b": torch.zeros((256,))}


def _violated(report):
    return {v.contract for v in report.violations}


def _verdict(report):
    return report.ok, tuple(report.checked), _violated(report)


def _same_verdict(j_report, t_report):
    assert _verdict(t_report) == _verdict(j_report), (
        t_report.to_json(), j_report.to_json())
    return t_report


def _both(j_comp, t_comp, j_tree=J_TREE, t_tree=T_TREE):
    return _same_verdict(j_check(j_comp, j_tree), t_check(t_comp, t_tree))


def _t_is_packed(x):
    return isinstance(x, TPackedLeaf)


def _j_is_packed(x):
    return isinstance(x, JPackedLeaf)


# ---------------------------------------------------------------------------
# the real family passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard_safe", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_block_quant_family_passes(bits, shard_safe):
    report = _both(JC.block_quant(bits=bits, block=256,
                                  shard_safe=shard_safe),
                   TC.block_quant(bits=bits, block=256,
                                  shard_safe=shard_safe))
    report.raise_if_failed()
    assert {"apply-roundtrip", "encode-decode-roundtrip", "payload-bytes",
            "packed-layout", "decode-reduce"} <= set(report.checked)


@pytest.mark.parametrize("which", ["identity", "rand_k"])
def test_non_wire_compressors_pass(which):
    j_comp = JC.identity() if which == "identity" else JC.rand_k(0.25)
    t_comp = TC.identity() if which == "identity" else TC.rand_k(0.25)
    _both(j_comp, t_comp).raise_if_failed()


def test_pure_shape_land_no_arrays_needed():
    """(shape, dtype) stand-ins, as the reference's ShapeDtypeStructs."""
    report = _both(JC.block_quant(4, 128),
                   TC.block_quant(4, 128),
                   {"w": jax.ShapeDtypeStruct((32, 512), jnp.float32)},
                   {"w": ((32, 512), torch.float32)})
    report.raise_if_failed()


def test_bits1_is_rejected_by_the_constructor():
    with pytest.raises(ZeroDivisionError):
        JC.block_quant(bits=1, block=256)
    with pytest.raises(ZeroDivisionError):
        TC.block_quant(bits=1, block=256)


# ---------------------------------------------------------------------------
# broken compressors are rejected by the owning contract
# ---------------------------------------------------------------------------

def test_wrong_decode_dtype_rejected():
    jb, tb = JC.block_quant(8, 256), TC.block_quant(8, 256)
    report = _both(
        dataclasses.replace(jb, decode=lambda p: jax.tree.map(
            lambda x: x.astype(jnp.float16), jb.decode(p))),
        dataclasses.replace(tb, decode=lambda p: tree_map(
            lambda x: x.to(torch.float16), tb.decode(p))))
    assert "encode-decode-roundtrip" in _violated(report)
    assert any("dtype" in v.detail for v in report.violations)
    with pytest.raises(AssertionError, match="encode-decode-roundtrip"):
        report.raise_if_failed()


def test_lying_payload_model_rejected():
    lie = dict(payload_fn=lambda shape, itemsize: 1.0)
    report = _both(dataclasses.replace(JC.block_quant(4, 256), **lie),
                   dataclasses.replace(TC.block_quant(4, 256), **lie))
    assert "payload-bytes" in _violated(report)
    assert any("comm_bytes metrics would lie" in v.detail
               for v in report.violations)
    # the honest model passes the same check at tol 0.0
    assert _both(JC.block_quant(4, 256), TC.block_quant(4, 256)).ok


def test_misaligned_shard_groups_rejected():
    jb = JC.block_quant(8, 256, shard_safe=True)
    tb = TC.block_quant(8, 256, shard_safe=True)

    def smudge(leaf, packed):
        if packed(leaf) and leaf.mode == "shard":
            # group=96 does not divide the 256-wide last dim
            return dataclasses.replace(leaf, group=96)
        return leaf

    report = _both(
        dataclasses.replace(jb, encode=lambda k, t: jax.tree.map(
            lambda x: smudge(x, _j_is_packed), jb.encode(k, t),
            is_leaf=_j_is_packed)),
        dataclasses.replace(tb, encode=lambda k, t: tree_map(
            lambda x: smudge(x, _t_is_packed), tb.encode(k, t),
            is_leaf=_t_is_packed)))
    assert "packed-layout" in _violated(report)
    assert any("shard_safe alignment" in v.detail for v in report.violations)


def test_decode_reduce_that_never_reduces_rejected():
    jb, tb = JC.block_quant(8, 256), TC.block_quant(8, 256)
    report = _both(
        dataclasses.replace(jb, decode_reduce=lambda p, w, fused=None:
                            jb.decode(p)),
        dataclasses.replace(tb, decode_reduce=lambda p, w, fused=None:
                            tb.decode(p)))
    assert "decode-reduce" in _violated(report)
    assert any("leftover client axis" in v.detail for v in report.violations)


def test_upcasting_apply_rejected():
    jb, tb = JC.block_quant(8, 256), TC.block_quant(8, 256)
    report = _both(
        dataclasses.replace(jb, apply=lambda k, t: jax.tree.map(
            lambda x: x.astype(jnp.float16), jb.apply(k, t))),
        dataclasses.replace(tb, apply=lambda k, t: tree_map(
            lambda x: x.to(torch.float16), tb.apply(k, t))))
    assert "apply-roundtrip" in _violated(report)


def test_encode_without_decode_rejected():
    report = _both(dataclasses.replace(JC.block_quant(8, 256), decode=None),
                   dataclasses.replace(TC.block_quant(8, 256), decode=None))
    assert "encode-decode-roundtrip" in _violated(report)
    assert any("decode is None" in v.detail for v in report.violations)


def test_reencode_hook_is_vetted_when_present():
    report = _both(JC.block_quant(8, 256, checksum=True),
                   TC.block_quant(8, 256, checksum=True))
    report.raise_if_failed()
    assert "reencode" in report.checked
    # no hook -> nothing to vet (and no spurious violation)
    assert "reencode" not in _both(JC.identity(), TC.identity()).checked


def test_reencode_that_drops_digests_rejected():
    jb = JC.block_quant(8, 256, checksum=True)
    tb = TC.block_quant(8, 256, checksum=True)
    report = _both(
        dataclasses.replace(jb, reencode=lambda k, t: jax.tree.map(
            lambda p: dataclasses.replace(p, check=None), jb.reencode(k, t),
            is_leaf=_j_is_packed)),
        dataclasses.replace(tb, reencode=lambda k, t: tree_map(
            lambda p: dataclasses.replace(p, check=None), tb.reencode(k, t),
            is_leaf=_t_is_packed)))
    assert "reencode" in _violated(report)
    assert any("re-stamp" in v.detail for v in report.violations)


def test_reencode_passthrough_rejected():
    report = _both(
        dataclasses.replace(JC.block_quant(8, 256),
                            reencode=lambda key, tree: tree),
        dataclasses.replace(TC.block_quant(8, 256),
                            reencode=lambda key, tree: tree))
    assert "reencode" in _violated(report)


def test_report_json_shape():
    report = _both(JC.block_quant(4, 256), TC.block_quant(4, 256))
    data = report.to_json()
    assert data["ok"] is True
    assert data["violations"] == []
    assert "payload-bytes" in data["checked"]


# ---------------------------------------------------------------------------
# checksum billing + integrity (contract 7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_checksummed_family_passes_with_digests_billed(bits):
    comp = TC.block_quant(bits, 256, checksum=True)
    report = _both(JC.block_quant(bits, 256, checksum=True), comp)
    report.raise_if_failed()
    assert {"checksum-billing", "checksum-integrity"} <= set(report.checked)
    plain = TC.block_quant(bits, 256, checksum=False)
    assert (comp.payload_bytes(T_TREE) - plain.payload_bytes(T_TREE)
            == TC.CHECKSUM_BYTES * 2)
    assert (comp.wire_bytes(T_TREE) - plain.wire_bytes(T_TREE)
            == TC.CHECKSUM_BYTES * 2)


def test_unstamped_checksum_wire_rejected():
    def broken(C):
        base = C.block_quant(8, 256, checksum=True)
        plain = C.block_quant(8, 256, checksum=False)
        return dataclasses.replace(base, encode=plain.encode,
                                   payload_fn=plain.payload_fn)

    report = _both(broken(JC), broken(TC))
    assert "checksum-billing" in _violated(report)
    assert any("stamps no digest" in v.detail for v in report.violations)
    assert "payload-bytes" not in _violated(report)


def test_stale_reencode_digest_rejected():
    jb = JC.block_quant(8, 256, checksum=True)
    tb = TC.block_quant(8, 256, checksum=True)

    def j_stale(key, tree):
        pay = jb.reencode(key, tree)
        other = jb.reencode(key, jax.tree.map(lambda x: x + 1.0, tree))
        return jax.tree.map(lambda p, q: dataclasses.replace(p, check=q.check),
                            pay, other, is_leaf=_j_is_packed)

    def t_stale(key, tree):
        pay = tb.reencode(key, tree)
        other = tb.reencode(key, tree_map(lambda x: x + 1.0, tree))
        return tree_map(lambda p, q: dataclasses.replace(p, check=q.check),
                        pay, other, is_leaf=_t_is_packed)

    report = _both(dataclasses.replace(jb, reencode=j_stale),
                   dataclasses.replace(tb, reencode=t_stale))
    assert "checksum-integrity" in _violated(report)
    assert any("stale digest" in v.detail for v in report.violations)
    assert _violated(report) == {"checksum-integrity"}


# ---------------------------------------------------------------------------
# full width: the parameter trees of two configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen3-moe-235b-a22b"])
def test_full_width_parameter_tree(arch):
    """The in-kernel-dither quantizer over a config's parameter tree at
    full width and depth: the port on ``meta`` (its quantizers' ``meta``
    route: no leaf-sized temporaries), the reference's tree and verdict
    under ``jax.eval_shape``."""
    from repro.configs import get as j_config
    from repro.models.model import build_model as j_build
    from repro_torch.configs import get as t_config
    from repro_torch.launch.dryrun import meta_params

    j_tree = jax.eval_shape(j_build(j_config(arch)).init,
                            jax.random.PRNGKey(0))
    t_tree = meta_params(t_config(arch))
    qb.reset_launches()
    report = _both(JC.block_quant(8, 256, dither="kernel"),
                   TC.block_quant(8, 256, dither="kernel"), j_tree, t_tree)
    report.raise_if_failed()
    assert not any(qb.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the quantizers' meta route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group", [8, 16, 128, 256])
def test_meta_route_shapes_match_plain(group, bits):
    """Each wrapper on ``meta`` returns its kernel's shapes and dtypes, as
    its plain version does on the CPU; the decode + reduce kernel takes
    groups that are a multiple of 128 and refuses the rest on ``meta`` as
    on the card."""
    R, D, C = 3, 2 * max(group, 128), 4
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((R, D), generator=gen)
    u = torch.rand((R, D), generator=gen)
    xm, um = x.to("meta"), u.to("meta")
    for args in ((x, u), (x, None)):
        seed = None if args[1] is not None else 7
        want = qb.quantize_grouped(*args, bits=bits, group=group, seed=seed)
        got = qb.quantize_grouped(xm, None if args[1] is None else um,
                                  bits=bits, group=group, seed=seed)
        assert (got.device.type, got.shape, got.dtype) == (
            "meta", want.shape, want.dtype)
        want = qb.quantize_encode_grouped(*args, bits=bits, group=group,
                                          seed=seed)
        got = qb.quantize_encode_grouped(xm, None if args[1] is None else um,
                                         bits=bits, group=group, seed=seed)
        for g, w in zip(got, want):
            assert (g.device.type, g.shape, g.dtype) == (
                "meta", w.shape, w.dtype)
    codes, scales = qb.quantize_encode_grouped(x, u, bits=bits, group=group)
    codes = codes.expand(C, R, D).contiguous()
    scales = scales.expand(C, R, D // group).contiguous()
    w = torch.full((C,), 0.25)
    want = qb.decode_reduce_grouped(codes, scales, w, bits=bits, group=group)
    meta = [t.to("meta") for t in (codes, scales, w)]
    if qb.reduce_group_ok(group):
        got = qb.decode_reduce_grouped(*meta, bits=bits, group=group)
        assert (got.device.type, got.shape, got.dtype) == (
            "meta", want.shape, want.dtype)
    else:
        with pytest.raises(ValueError, match="multiple of 128"):
            qb.decode_reduce_grouped(*meta, bits=bits, group=group)


def test_meta_encode_counts_no_leaf_sized_temporaries():
    """The counted peak (``roofline.count_step``'s ``MemTracker``) of a
    ``meta`` encode of a 2^22-element leaf through the in-kernel dither
    holds its input, codes and scales and at most 1 MiB more: the plain
    route's int64 hash index of the leaf (32 MiB) is not made."""
    from repro_torch.launch.roofline import count_step
    R, D, g = 1 << 12, 1 << 10, 256
    x = torch.empty((R, D), device="meta")
    comp = TC.block_quant(8, g, dither="kernel")
    _, counts = count_step(comp.encode, [0], {"w": x}, external=[x])
    need = 4 * R * D + R * D + 4 * R * D // g
    assert counts["peak_bytes"] <= need + (1 << 20), counts["peak_bytes"]
    assert counts["peak_bytes"] >= need


def test_cli_contract_sweep_matches_the_reference(capsys):
    """``python -m repro_torch.analysis --contracts`` gives the reference's
    ``--contracts`` list: the same (compressor, checksum, verdict) lines in
    the same order, and the same exit code."""
    from repro.analysis.__main__ import _run_contracts as j_run
    from repro_torch.analysis.__main__ import _run_contracts as t_run

    def lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("contract ")]

    j_rc = j_run()
    want = lines(capsys.readouterr().out)
    t_rc = t_run()
    got = lines(capsys.readouterr().out)
    assert got == want
    assert len(want) == 17 and all(ln.endswith(" ok") for ln in want)
    assert t_rc == j_rc == 0
