"""The wire contracts of a ``Compressor``, checked on shape-only tensors
(the counterpart of ``repro/analysis/contracts.py``).

``check_compressor`` vets any ``core.compression.Compressor`` against the
contracts the driver relies on. Where the reference traces each hook under
``jax.eval_shape``, the port runs it on ``meta`` tensors: shapes and
dtypes propagate, nothing is allocated and no kernel launches (the
quantizer wrappers return empty outputs of their kernels' shapes on
``meta``), so a full-width parameter tree costs no memory:

1. **apply roundtrip** - ``apply(key, tree)`` preserves every leaf's
   shape AND dtype (A4 operators are endomorphisms of the surrogate
   space; a dtype drift here silently upcasts the whole driver state).
2. **decode . encode roundtrip** - decoding the encoded payload restores
   every leaf's shape and dtype exactly.
3. **payload accounting** - ``payload_bytes`` (the analytic model) ==
   the summed bytes of the ACTUAL encoded buffers (codes + scales + raw
   passthrough leaves) == ``wire_bytes``. A lying model corrupts
   ``comm_bytes`` metrics and every figure built on them.
4. **packed-leaf layout** - each ``PackedLeaf``'s static metadata is
   self-consistent: bits <= 8, group aligns with the recorded layout
   (``shard`` mode: group divides the leaf's last dim; ``flat`` mode: the
   padded stream is whole groups), scales count == group count,
   nibble-packed codes only at bits <= 4.
5. **decode_reduce** - on an (n_clients,)-stacked payload with (n,) f32
   weights, the reduce returns model-shaped leaves in a floating
   accumulation dtype (never integer codes; never a stacked axis left).
6. **reencode** (when the hook exists) - ``reencode(key, partial)`` on an
   f32 model-shaped partial yields a self-consistent packed payload whose
   digests are re-stamped (``check`` present whenever the compressor is
   checksummed), that ``decode`` restores to the f32 partial's shapes,
   and whose buffer bytes match ``payload_bytes``.
7. **checksum billing + integrity** (``checksum=True`` only) - every
   encoded ``PackedLeaf`` carries a digest of exactly ``CHECKSUM_BYTES``;
   and one CONCRETE probe runs ``encode`` (and ``reencode``, when
   present) on a tiny CPU tree and requires ``verify_payload`` to pass,
   which catches a digest copied from other buffers (its shape is right).
   The probe's tree keeps each leaf's last dim (so its groups are the
   full tree's) and cuts every leading dim to 1.

Violations are collected (not raised) so a report shows everything wrong
with a compressor at once; ``CompressorReport.raise_if_failed`` turns
them into one error.

``tree`` holds tensors (of any device; only their shapes and dtypes are
read) or ``(shape, dtype)`` stand-ins. ``key`` is what the compressors
take: a ``torch.Generator`` (default: CPU, seed 0) or per-leaf seeds.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.compression import (CHECKSUM_BYTES, PackedLeaf, _tree_bytes,
                                stack_payloads, verify_payload)
from ..tree import tree_leaves_with_path, tree_map

PACK_BITS = 4


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    contract: str   # "apply-roundtrip" / "payload-bytes" / ...
    leaf: str       # the leaf's path ("" for tree-level contracts)
    detail: str

    def format(self) -> str:
        where = f" at leaf '{self.leaf}'" if self.leaf else ""
        return f"[{self.contract}]{where}: {self.detail}"


@dataclasses.dataclass
class CompressorReport:
    name: str
    violations: list = dataclasses.field(default_factory=list)
    checked: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self):
        if self.violations:
            msg = "\n".join(v.format() for v in self.violations)
            raise AssertionError(
                f"compressor '{self.name}' violates "
                f"{len(self.violations)} contract(s):\n{msg}")

    def to_json(self) -> dict:
        return {"name": self.name, "ok": self.ok,
                "checked": list(self.checked),
                "violations": [dataclasses.asdict(v)
                               for v in self.violations]}


def _is_standin(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], torch.dtype))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _structs(tree):
    """``tree`` as ``meta`` tensors of its leaves' shapes and dtypes."""
    return tree_map(
        lambda x: _meta(x[0], x[1]) if _is_standin(x)
        else _meta(x.shape, x.dtype), tree, is_leaf=_is_standin)


def _leaf_paths(tree):
    return tree_leaves_with_path(tree,
                                 is_leaf=lambda x: isinstance(x, PackedLeaf))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _check_same_structs(report, contract, ref_tree, got_tree):
    ref = _leaf_paths(ref_tree)
    got = _leaf_paths(got_tree)
    if len(ref) != len(got):
        report.violations.append(ContractViolation(
            contract, "", f"leaf count changed: {len(ref)} -> {len(got)}"))
        return
    for (path, r), (_, g) in zip(ref, got):
        if tuple(r.shape) != tuple(g.shape):
            report.violations.append(ContractViolation(
                contract, path,
                f"shape {tuple(r.shape)} -> {tuple(g.shape)}"))
        if r.dtype != g.dtype:
            report.violations.append(ContractViolation(
                contract, path,
                f"dtype {_dtype_name(r.dtype)} -> {_dtype_name(g.dtype)}"))


def _check_packed_leaf(report, path, p: PackedLeaf):
    n = int(math.prod(p.shape)) if p.shape else 1
    if not (1 <= p.bits <= 8):
        report.violations.append(ContractViolation(
            "packed-layout", path,
            f"bits={p.bits} outside the wire format's 1..8 range"))
        return
    packed = p.codes.dtype == torch.uint8
    if packed and p.bits > PACK_BITS:
        report.violations.append(ContractViolation(
            "packed-layout", path,
            f"nibble-packed uint8 codes at bits={p.bits} > {PACK_BITS}: "
            f"two {p.bits}-bit codes do not fit one byte"))
    n_code_elems = p.codes.numel() * (2 if packed else 1)
    n_scales = p.scales.numel()
    if p.mode == "shard":
        D = p.shape[-1] if p.shape else 1
        if p.group < 1 or D % p.group != 0:
            report.violations.append(ContractViolation(
                "packed-layout", path,
                f"shard-mode group {p.group} does not divide the leaf's "
                f"last dim {D} — groups must stay shard-local (the "
                f"shard_safe alignment contract)"))
            return
        if n_code_elems != n:
            report.violations.append(ContractViolation(
                "packed-layout", path,
                f"shard-mode code stream holds {n_code_elems} elements "
                f"for a {n}-element leaf"))
        if n_scales != n // p.group:
            report.violations.append(ContractViolation(
                "packed-layout", path,
                f"{n_scales} scales for {n // p.group} groups"))
    else:  # flat
        if p.group < 1:
            report.violations.append(ContractViolation(
                "packed-layout", path, f"flat-mode group {p.group} < 1"))
            return
        padded = -(-n // p.group) * p.group
        if n_code_elems != padded:
            report.violations.append(ContractViolation(
                "packed-layout", path,
                f"flat-mode code stream holds {n_code_elems} elements; "
                f"the padded {p.group}-block stream of a {n}-element "
                f"leaf is {padded}"))
        if n_scales != padded // p.group:
            report.violations.append(ContractViolation(
                "packed-layout", path,
                f"{n_scales} scales for {padded // p.group} blocks"))


def _failed(report, contract, what, e):
    report.violations.append(ContractViolation(
        contract, "", f"{what} failed on meta tensors: "
        f"{type(e).__name__}: {e}"))
    return report


def _probe_tree(structs):
    """The concrete probe's CPU tree: each leaf's last dim kept, its
    leading dims cut to 1, values on a ramp over [-1, 1]."""
    def leaf(s):
        shape = ((1,) * (s.ndim - 1) + (s.shape[-1],)) if s.ndim else ()
        n = int(math.prod(shape)) if shape else 1
        return torch.linspace(-1.0, 1.0, n).reshape(shape).to(s.dtype)
    return tree_map(leaf, structs)


def check_compressor(comp, tree, *, n_clients: int = 4, key=None,
                     bytes_tol: float = 0.0) -> CompressorReport:
    """Validate ``comp`` against the wire contracts on ``tree``'s shapes
    (the module docstring). ``bytes_tol`` loosens contract 3 (in bytes)
    for compressors whose analytic model is intentionally approximate;
    the block quantizer family is EXACT and must pass at 0.0."""
    report = CompressorReport(name=getattr(comp, "name", repr(comp)))
    structs = _structs(tree)
    key = torch.Generator().manual_seed(0) if key is None else key

    # 1. apply roundtrip
    report.checked.append("apply-roundtrip")
    try:
        applied = comp.apply(key, structs)
    except Exception as e:
        return _failed(report, "apply-roundtrip", "apply", e)
    _check_same_structs(report, "apply-roundtrip", structs, applied)
    del applied

    if comp.encode is None:
        return report

    # 2. decode . encode roundtrip, the packed layout (4) vetted first: a
    # self-inconsistent layout usually makes decode fail opaquely
    report.checked.append("encode-decode-roundtrip")
    try:
        payload = comp.encode(key, structs)
    except Exception as e:
        return _failed(report, "encode-decode-roundtrip", "encode", e)
    report.checked.append("packed-layout")
    for path, leaf in _leaf_paths(payload):
        if isinstance(leaf, PackedLeaf):
            _check_packed_leaf(report, path, leaf)
    if comp.decode is None:
        report.violations.append(ContractViolation(
            "encode-decode-roundtrip", "",
            "encode is set but decode is None — the driver cannot "
            "aggregate what it cannot decode"))
        return report
    try:
        decoded = comp.decode(payload)
    except Exception as e:
        return _failed(report, "encode-decode-roundtrip", "decode", e)
    _check_same_structs(report, "encode-decode-roundtrip", structs, decoded)
    del decoded

    # 3. payload accounting: analytic model == actual buffers == wire_bytes
    report.checked.append("payload-bytes")
    actual = float(_tree_bytes(payload))
    model = float(comp.payload_bytes(structs))
    if abs(model - actual) > bytes_tol:
        report.violations.append(ContractViolation(
            "payload-bytes", "",
            f"payload_bytes model says {model:.1f} B but the encoded "
            f"buffers hold {actual:.1f} B (tol {bytes_tol}) — comm_bytes "
            f"metrics would lie by {model - actual:+.1f} B per client"))
    wire = float(comp.wire_bytes(structs))
    if abs(wire - actual) > bytes_tol:
        report.violations.append(ContractViolation(
            "payload-bytes", "",
            f"wire_bytes says {wire:.1f} B vs actual buffers "
            f"{actual:.1f} B"))

    # 7a. checksum billing: a checksummed wire must CARRY its digests
    if comp.checksum:
        report.checked.append("checksum-billing")
        for path, leaf in _leaf_paths(payload):
            if not isinstance(leaf, PackedLeaf):
                continue
            if leaf.check is None:
                report.violations.append(ContractViolation(
                    "checksum-billing", path,
                    f"checksum=True but encode stamps no digest — the "
                    f"wire is unverifiable and the {CHECKSUM_BYTES} "
                    f"digest bytes are billed by neither payload_bytes "
                    f"nor the measured buffers"))
            elif leaf.check.element_size() != CHECKSUM_BYTES:
                report.violations.append(ContractViolation(
                    "checksum-billing", path,
                    f"digest is {leaf.check.element_size()} B/leaf; the "
                    f"wire contract bills CHECKSUM_BYTES == "
                    f"{CHECKSUM_BYTES}"))
    del payload

    # 5. decode_reduce on a stacked payload
    if comp.decode_reduce is not None:
        report.checked.append("decode-reduce")
        try:
            stacked = stack_payloads([comp.encode(key, structs)
                                      for _ in range(n_clients)])
            reduced = comp.decode_reduce(
                stacked, _meta((n_clients,), torch.float32), fused=False)
        except Exception as e:
            return _failed(report, "decode-reduce", "decode_reduce", e)
        del stacked
        ref = _leaf_paths(structs)
        got = _leaf_paths(reduced)
        if len(ref) != len(got):
            report.violations.append(ContractViolation(
                "decode-reduce", "",
                f"leaf count changed: {len(ref)} -> {len(got)}"))
        else:
            for (path, r), (_, g) in zip(ref, got):
                if tuple(r.shape) != tuple(g.shape):
                    report.violations.append(ContractViolation(
                        "decode-reduce", path,
                        f"reduced shape {tuple(g.shape)} != model shape "
                        f"{tuple(r.shape)} (a leftover client axis means "
                        f"the reduce never happened)"))
                if not g.dtype.is_floating_point:
                    report.violations.append(ContractViolation(
                        "decode-reduce", path,
                        f"reduced dtype {_dtype_name(g.dtype)} is not "
                        f"a floating accumulation dtype"))

    # 6. reencode: re-enter the wire format from the f32 edge partial
    if comp.reencode is not None:
        report.checked.append("reencode")
        partial = tree_map(lambda s: _meta(s.shape, torch.float32), structs)
        try:
            payload2 = comp.reencode(key, partial)
        except Exception as e:
            report.violations.append(ContractViolation(
                "reencode", "",
                f"reencode failed on the f32 partial: "
                f"{type(e).__name__}: {e}"))
            return report
        for path, leaf in _leaf_paths(payload2):
            if isinstance(leaf, PackedLeaf):
                _check_packed_leaf(report, path, leaf)
                if comp.checksum and leaf.check is None:
                    report.violations.append(ContractViolation(
                        "reencode", path,
                        "checksummed compressor but the re-encoded "
                        "payload carries no digest — each tier hop must "
                        "re-stamp its own verifiable checksum"))
        try:
            decoded2 = comp.decode(payload2)
        except Exception as e:
            report.violations.append(ContractViolation(
                "reencode", "",
                f"decode of the re-encoded payload failed: "
                f"{type(e).__name__}: {e}"))
            return report
        # the boundary must give back the f32 partial it was handed
        _check_same_structs(report, "reencode", partial, decoded2)
        actual2 = float(_tree_bytes(payload2))
        model2 = float(comp.payload_bytes(partial))
        if abs(model2 - actual2) > bytes_tol:
            report.violations.append(ContractViolation(
                "reencode", "",
                f"payload_bytes model says {model2:.1f} B but the "
                f"re-encoded buffers hold {actual2:.1f} B (tol "
                f"{bytes_tol}) — backbone_bytes would lie by "
                f"{model2 - actual2:+.1f} B per edge"))

    # 7b. checksum integrity: the ONE concrete probe
    if comp.checksum:
        report.checked.append("checksum-integrity")
        concrete = _probe_tree(structs)
        try:
            pay = comp.encode(key, concrete)
            if not bool(verify_payload(pay).all()):
                report.violations.append(ContractViolation(
                    "checksum-integrity", "",
                    "encode stamps digests that do not verify against "
                    "its own buffers — every intact uplink would be "
                    "dropped as corrupt"))
            if comp.reencode is not None:
                partial_c = tree_map(lambda a: a.to(torch.float32), concrete)
                pay2 = comp.reencode(key, partial_c)
                if not bool(verify_payload(pay2).all()):
                    report.violations.append(ContractViolation(
                        "checksum-integrity", "",
                        "reencode's digests do not verify against the "
                        "re-encoded buffers — a stale digest carried "
                        "across the tier boundary makes the backbone "
                        "hop unverifiable"))
        except Exception as e:
            report.violations.append(ContractViolation(
                "checksum-integrity", "",
                f"concrete checksum probe failed to execute: "
                f"{type(e).__name__}: {e}"))
    return report
