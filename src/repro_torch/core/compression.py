"""Unbiased compression operators (assumption A4) and the partial-
participation composition of Lemma 1 (the counterpart of
``repro/core/compression.py``).

Every operator is a pair (compress_fn, omega) with
``E[Quant(s)] = s`` and ``E[||Quant(s) - s||^2] <= omega ||s||^2``,
acting leaf-wise on pytrees.

Randomness. Where the reference takes a JAX key and splits it into one key
per leaf (then folds each into a 32-bit seed), the port's compressors take
``key`` as either

* a ``torch.Generator``, from which one 32-bit seed per leaf is drawn, or
* a sequence of per-leaf 32-bit seeds (ints or an int tensor), used as
  given. Handing the reference's folded seeds (``fold_seed`` of each leaf
  key) reproduces its ``"hash"`` and ``"kernel"`` dither bit for bit.

Leaves are taken in ``repro_torch.tree`` order, which is JAX's (dicts in
sorted-key order), so the i-th seed belongs to the same leaf in both.

Dispatch. ``quantize_leaf``/``encode_leaf`` send large leaves (at least
``KERNEL_DISPATCH_MIN`` elements with a group that the CUDA kernel takes:
a multiple of 128, as in the reference, or a power of two below 128,
which the reference leaves to jnp) to ``kernels/ops.py``, everything else
to the plain oracle of ``kernels/ref.py``; both give the same bits for the
same draws. On a CUDA tensor the kernel route launches the Hopper
kernels; on the CPU it runs their plain versions. A ``DTensor`` leaf
whose local tensor is the whole leaf (fully replicated, or on a one-rank
mesh) takes these routes on its local tensor; a partitioned one whose groups each lie in one rank's block
takes the reference's ``"shard_map"`` route, one kernel launch per rank
(``kernels/ops.py:quantize_dequantize_sharded``, ``quantize_encode_
sharded``) with the dither drawn by global element index, so the result is
bit-identical to the unsharded leaf's. Other partitioned leaves are
gathered and take the plain route. The result is placed like the leaf.

Dither sources: ``"hash"`` (the murmur hash of the element index and the
leaf seed), ``"uniform"`` (``torch.rand`` from a generator seeded by the
leaf seed; not the reference's threefry draws), and ``"kernel"`` (the
dither made inside the kernel: the same murmur hash, so bit-identical to
``"hash"``; leaves off the kernel route use ``"hash"``). On the kernel
route ``"hash"`` takes the in-kernel dither too: the same bits, without
the streamed dither's int64 temporaries (several GB for one embedding
leaf at LM width).

Wire format: ``PackedLeaf`` carries int8 codes (nibble-packed uint8 for
bits <= 4), one scale per group, and an optional 32-bit digest (held as
int32 with the same bit pattern as the reference's uint32).
``decode(encode(key, tree)) == apply(key, tree)`` bit for bit, and
``payload_bytes`` equals the bytes of the encoded buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kernels import ref as kernel_ref
from ..kernels.quantize_block import kernel_group_ok, reduce_group_ok
from ..models.sharding import is_dtensor
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Pytree = object

# Leaves at least this large (with a group the kernel takes) go to the
# kernel.
KERNEL_DISPATCH_MIN = 1 << 16

# at or below this code width, two codes travel per byte
PACK_BITS = 4

DITHERS = ("hash", "uniform", "kernel")

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# per-leaf seeds
# ---------------------------------------------------------------------------

def leaf_seeds(key, n_leaves: int) -> list:
    """One 32-bit seed per leaf: drawn from a ``torch.Generator``, or taken
    from a sequence of per-leaf seeds."""
    if isinstance(key, torch.Generator):
        drawn = torch.randint(0, 1 << 32, (n_leaves,), generator=key,
                              dtype=torch.int64, device=key.device)
        return [int(s) for s in drawn.tolist()]
    seeds = key.tolist() if isinstance(key, torch.Tensor) else list(key)
    if len(seeds) != n_leaves:
        raise ValueError(f"{len(seeds)} seeds for {n_leaves} leaves")
    return [int(s) & _M32 for s in seeds]


def _tree_keyed_map(fn, key, tree):
    leaves, treedef = tree_flatten(tree)
    seeds = leaf_seeds(key, len(leaves))
    return tree_unflatten(treedef, [fn(s, x) for s, x in zip(seeds, leaves)])


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedLeaf:
    """One leaf's uplink payload: packed codes + per-group scales.

    codes: int8 ``(..., D)`` (shard mode) / ``(padded,)`` (flat mode), or
    uint8 with half the last dim when bit-packed (bits <= 4). scales: one
    per group, ``(..., D // g)`` / ``(n_blocks,)``. ``check``: the wire
    digest as an int32 tensor (the uint32 bit pattern), or None. Leading
    axes beyond the recorded layout are client/batch stacking."""
    codes: torch.Tensor
    scales: torch.Tensor
    shape: tuple
    dtype: torch.dtype
    bits: int
    group: int
    mode: str  # "shard" | "flat"
    check: Optional[torch.Tensor] = None


def _is_payload_leaf(x) -> bool:
    return isinstance(x, PackedLeaf)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], even last dim -> uint8 with adjacent pairs in
    one byte (low nibble = even index, high nibble = odd index)."""
    lo = codes[..., 0::2].to(torch.int32) & 0x0F
    hi = codes[..., 1::2].to(torch.int32) & 0x0F
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Exact inverse of ``pack_nibbles``. The reference sign-extends each
    nibble with arithmetic shifts on int8; the same shifts on the int8
    value held in int32 (shifted to the top of the word) give the same
    result without relying on uint8 -> int8 wrapping."""
    v = packed.to(torch.int32)
    b = torch.where(v >= 128, v - 256, v)          # the byte as int8
    lo = (b << 28) >> 28
    hi = b >> 4
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(tuple(packed.shape[:-1]) + (-1,))


def _maybe_pack(codes, bits: int):
    if bits <= PACK_BITS and codes.shape[-1] % 2 == 0:
        return pack_nibbles(codes)
    return codes


def _buffer_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree) -> int:
    """Actual buffer bytes of a pytree of tensors and ``PackedLeaf``s."""
    total = 0
    for leaf in tree_leaves(tree, is_leaf=_is_payload_leaf):
        if isinstance(leaf, PackedLeaf):
            total += _buffer_bytes(leaf.codes) + _buffer_bytes(leaf.scales)
            if leaf.check is not None:
                total += _buffer_bytes(leaf.check)
        else:
            total += _buffer_bytes(leaf)
    return total


def stack_payloads(payloads: list):
    """Stack per-client payload trees along a new leading client axis (what
    the reference's vmap over clients produces)."""
    def stack(*leaves):
        first = leaves[0]
        if isinstance(first, PackedLeaf):
            return dataclasses.replace(
                first, codes=torch.stack([p.codes for p in leaves]),
                scales=torch.stack([p.scales for p in leaves]),
                check=None if first.check is None
                else torch.stack([p.check for p in leaves]))
        return torch.stack(leaves)
    return tree_map(stack, payloads[0], *payloads[1:],
                    is_leaf=_is_payload_leaf)


# ---------------------------------------------------------------------------
# wire integrity: per-leaf checksums on the packed payload
# ---------------------------------------------------------------------------

CHECKSUM_BYTES = 4

_CKSUM_GOLDEN = 0x9E3779B9
_CKSUM_SCALE_SALT = 0x85EBCA6B


def _mix32(u: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on 32-bit values held in int64."""
    u = kernel_ref._mul32(u ^ (u >> 16), 0x7FEB352D)
    u = kernel_ref._mul32(u ^ (u >> 15), 0x846CA68B)
    return u ^ (u >> 16)


def _as_u32_stream(buf: torch.Tensor, n_batch: int) -> torch.Tensor:
    """Each element's 32-bit value (int64 in [0, 2^32)): f32 bit patterns,
    sub-f32 floats' bit patterns widened, integer codes sign-extended
    through int32 (uint8 zero-extended), as the reference widens them."""
    buf = buf.contiguous()
    if buf.dtype == torch.float32:
        u = buf.view(torch.int32).to(torch.int64) & _M32
    elif buf.is_floating_point():
        u = buf.view(torch.int16).to(torch.int64) & 0xFFFF
    else:
        u = buf.to(torch.int32).to(torch.int64) & _M32
    return u.reshape(tuple(buf.shape[:n_batch]) + (-1,))


def _digest(buf, n_batch: int, salt: int) -> torch.Tensor:
    u = _as_u32_stream(buf, n_batch)
    pos = torch.arange(u.shape[-1], dtype=torch.int64, device=u.device)
    terms = _mix32((u + kernel_ref._mul32(pos & _M32, _CKSUM_GOLDEN) + salt)
                   & _M32)
    # the uint32 sum wraps mod 2^32: order-independent
    return torch.sum(terms, dim=-1) & _M32


def _u32_as_i32(t: torch.Tensor) -> torch.Tensor:
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


def leaf_checksum(codes, scales, n_batch: int = 0) -> torch.Tensor:
    """The wire digest of one payload leaf's buffers, as int32 holding the
    reference's uint32 bit pattern: position-weighted murmur-mixed sum over
    the codes stream plus the (domain-separated) scales stream. ``n_batch``
    leading axes are batch dims (one digest per batch row). Placed
    (``DTensor``) buffers are digested whole."""
    if is_dtensor(codes):
        codes, scales = codes.full_tensor(), scales.full_tensor()
    total = (_digest(codes, n_batch, 0)
             + _digest(scales, n_batch, _CKSUM_SCALE_SALT)) & _M32
    return _u32_as_i32(total)


def payload_batch_dims(p: PackedLeaf) -> int:
    base = len(p.shape) if p.mode == "shard" else 1
    return p.codes.ndim - base


def verify_leaf(p) -> torch.Tensor:
    """Recompute one leaf's digest and compare to the wire checksum (True
    over the batch dims for unchecked or raw leaves)."""
    if not isinstance(p, PackedLeaf) or p.check is None:
        return torch.tensor(True)
    if payload_batch_dims(p):
        # one batch row at a time: the digest's int64 temporaries over a
        # whole client stack would be tens of GB at model width
        return torch.stack([
            verify_leaf(dataclasses.replace(p, codes=c, scales=s, check=k))
            for c, s, k in zip(p.codes, p.scales, p.check)])
    return torch.eq(leaf_checksum(p.codes, p.scales), p.check)


def verify_payload(payload) -> torch.Tensor:
    """Per-client wire verification: AND of every checksummed leaf's digest
    match, broadcast over the batch dims."""
    ok = torch.tensor(True)
    for leaf in tree_leaves(payload, is_leaf=_is_payload_leaf):
        v = verify_leaf(leaf)
        ok = torch.logical_and(ok.to(v.device), v)
    return ok


def zero_invalid_rows(payload, ok):
    """Null out every buffer row of clients that failed verification,
    BEFORE decode (corrupted scale bits can decode to NaN)."""
    okb = torch.as_tensor(ok, dtype=torch.bool)

    def _zero(buf):
        sel = okb.to(buf.device).reshape(
            tuple(okb.shape) + (1,) * (buf.ndim - okb.ndim))
        return torch.where(sel, buf, torch.zeros((), dtype=buf.dtype,
                                                 device=buf.device))

    def leaf(p):
        if not isinstance(p, PackedLeaf):
            return p
        return dataclasses.replace(
            p, codes=_zero(p.codes), scales=_zero(p.scales),
            check=None if p.check is None else _zero(p.check))

    return tree_map(leaf, payload, is_leaf=_is_payload_leaf)


# ---------------------------------------------------------------------------
# Compressor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Compressor:
    """An unbiased compressor satisfying A4(omega), with communication
    accounting. ``apply(key, tree)`` is the fused quantize -> dequantize;
    wire-format compressors also carry ``encode(key, tree)`` (-> pytree of
    ``PackedLeaf``), ``decode`` (accepts stacked payloads) and
    ``decode_reduce(payload, w, fused=None)`` (the weighted reduce over a
    stacked payload). ``key``: see the module docstring."""

    apply: Callable
    omega: float
    bits: float
    name: str = "compressor"
    payload_fn: Optional[Callable] = None
    encode: Optional[Callable] = None
    decode: Optional[Callable] = None
    decode_reduce: Optional[Callable] = None
    checksum: bool = False
    reencode: Optional[Callable] = None

    def __call__(self, key, s):
        return self.apply(key, s)

    def _leaf_payload(self, shape, itemsize: float = 4.0) -> float:
        n = float(math.prod(shape)) if shape else 1.0
        if self.payload_fn is not None:
            return float(self.payload_fn(tuple(shape), float(itemsize)))
        return n * self.bits / 8.0

    def payload_bytes(self, tree) -> float:
        """Uplink bytes for one client's payload of ``tree``'s shape (reads
        each leaf's shape and dtype)."""
        total = 0.0
        for leaf in tree_leaves(tree):
            shape = tuple(getattr(leaf, "shape", ()))
            dt = getattr(leaf, "dtype", None)
            itemsize = (float(torch.empty((), dtype=dt).element_size())
                        if dt is not None else 4.0)
            total += self._leaf_payload(shape, itemsize)
        return total

    def encoded_bytes(self, payload) -> int:
        """Actual wire bytes of one encoded payload."""
        return _tree_bytes(payload)

    def wire_bytes(self, tree) -> float:
        """Exact uplink bytes for one client, measured off the buffers of an
        encode run on shape-only (meta) tensors; the analytic
        ``payload_bytes`` for compressors without a wire format."""
        if self.encode is None:
            return self.payload_bytes(tree)
        structs = tree_map(
            lambda leaf: torch.empty(tuple(leaf.shape), dtype=leaf.dtype,
                                     device="meta"), tree)
        n = len(tree_leaves(structs))
        return float(self.encoded_bytes(self.encode([0] * n, structs)))

    def round_metrics(self, tree, p: float = 1.0) -> dict:
        return {
            "payload_bytes_per_client": self.payload_bytes(tree),
            "omega": self.omega,
            "omega_eff": effective_omega(self.omega, p),
        }


# ---------------------------------------------------------------------------
# Identity (omega = 0)
# ---------------------------------------------------------------------------

def identity() -> Compressor:
    return Compressor(
        apply=lambda key, s: s, omega=0.0, bits=32.0, name="identity",
        payload_fn=lambda shape, itemsize:
            (float(math.prod(shape)) if shape else 1.0) * itemsize)


# ---------------------------------------------------------------------------
# Stochastic uniform quantization in blocks (block-p quantization):
# per group of g along the last axis, scale = max|x|, stochastic-round
# x/scale to 2^(b-1)-1 levels. omega = block / (4 levels^2).
# ---------------------------------------------------------------------------

def group_size(D: int, block: int) -> int:
    """Largest power-of-2 group that divides the per-shard width of the
    last dim (worst case 32-way sharding), capped at ``block``."""
    per = D
    for s in (32, 16):
        if D % s == 0:
            per = D // s
            break
    per = max(per, 1)
    g = 1
    while per % (g * 2) == 0 and g * 2 <= block:
        g *= 2
    return g


def hash_dither(seed: int, shape, device=None) -> torch.Tensor:
    """The stochastic-rounding dither: murmur3-style hash of each element's
    row-major index, seeded by the leaf's 32-bit seed, as float32 uniforms
    in [0, 1) with 24-bit resolution."""
    return kernel_ref.hash_dither(seed, shape, device=device)


def _make_dither(dither: str, seed: int, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        # shape-only run (wire_bytes): no draws to make
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if dither == "hash":
        return hash_dither(seed, shape, device=device)
    if dither == "uniform":
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                          device=device)
    raise ValueError(f"unknown dither source {dither!r} (want 'hash'|"
                     f"'uniform'; 'kernel' is resolved by the dispatcher)")


def _stream_dither(dither: str) -> str:
    """'kernel' degrades to 'hash' for leaves that do not reach the
    kernel."""
    return "hash" if dither == "kernel" else dither


def _whole_on_rank(x) -> bool:
    """A ``DTensor`` whose local tensor is the whole leaf: fully
    replicated, or on a one-rank mesh."""
    return (x.device_mesh.size() == 1
            or all(pl.is_replicate() for pl in x.placements))


def _kernel_route(x: torch.Tensor, g: int, kernel_threshold: int) -> str:
    """One dispatch decision shared by apply and encode (they must agree,
    or decode . encode would not equal apply):

    * ``"kernel"``    - a large leaf whose group the kernel takes, held
      whole on this rank (a tensor, or a replicated or one-rank
      ``DTensor``);
    * ``"shard_map"`` - a partitioned ``DTensor`` leaf whose groups each
      lie in one rank's block: the kernel on each block;
    * ``"plain"``     - everything else (the oracle).

    The reference's rule is at least ``kernel_threshold`` elements and a
    128-aligned group; the port's kernels also take power-of-two groups
    below 128 (``kernel_group_ok``)."""
    if x.numel() < kernel_threshold or not kernel_group_ok(g):
        return "plain"
    if not is_dtensor(x) or _whole_on_rank(x):
        return "kernel"
    box = kernel_ops.shard_box(tuple(x.shape), x.device_mesh, x.placements)
    if box is not None and (box[-1].stop - box[-1].start) % g == 0:
        return "shard_map"
    return "plain"


def _hash_dither_box(seed: int, shape, box, device) -> torch.Tensor:
    """``hash_dither(seed, shape)[box]`` without the whole stream: the hash
    of each element's global row-major index in the block ``box``."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        r = torch.arange(box[d].start, box[d].stop, dtype=torch.int64,
                         device=device) * stride
        idx = idx + r.reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= int(shape[d])
    return kernel_ref.hash_uniform(idx, seed)


def _per_shard(seed, x, g: int, bits: int, dither: str, encode: bool,
               checksum: bool):
    """The ``"shard_map"`` route: quantize or encode a partitioned
    ``DTensor`` with one kernel launch on each rank's block. The in-kernel
    dither is seeded by position within the block, which is not stable
    under resharding, so ``dither="kernel"`` streams the hash here."""
    box = kernel_ops.shard_box(tuple(x.shape), x.device_mesh, x.placements)
    dev = x.to_local().device
    dither = _stream_dither(dither)
    if dither == "hash":
        u = _hash_dither_box(seed, tuple(x.shape), box, dev)
    else:
        u = _make_dither(dither, seed, tuple(x.shape), dev)[box]
    if not encode:
        out = kernel_ops.quantize_dequantize_sharded(x, u, bits=bits,
                                                     group=g)
        return out.to(x.dtype)
    codes, scales = kernel_ops.quantize_encode_sharded(x, u, bits=bits,
                                                       group=g)
    shape = tuple(x.shape)
    if bits <= PACK_BITS and shape[-1] % 2 == 0:
        # every block's width is a multiple of g, hence even: each packs
        # its own pairs
        codes = kernel_ops.like_dtensor(pack_nibbles(codes.to_local()),
                                        codes, shape[:-1]
                                        + (shape[-1] // 2,))
    return PackedLeaf(
        codes=codes, scales=scales, shape=shape, dtype=x.dtype, bits=bits,
        group=g, mode="shard",
        check=leaf_checksum(codes, scales) if checksum else None)


def _dtensor_leaf(fn, seed, x, kw: dict):
    """``quantize_leaf``/``encode_leaf`` (``fn``) of a ``DTensor`` leaf,
    placed like the leaf: the kernel per block on the ``"shard_map"``
    route, else ``fn`` on the whole leaf (the local tensor where it is
    whole, else gathered). A payload's codes and scales are placed like
    the leaf in the shard-safe layout, and whole tensors in the flat
    one."""
    from torch.distributed.tensor import distribute_tensor
    if _whole_on_rank(x):
        out = fn(seed, x.to_local(), **kw)
    else:
        g = (group_size(x.shape[-1], kw["block"]) if kw["shard_safe"]
             else 1)
        native = kw["compute"] == "native" and x.dtype != torch.float32
        if (g >= 2 and not native
                and _kernel_route(x, g, kw["kernel_threshold"])
                == "shard_map"):
            return _per_shard(seed, x, g, kw["bits"], kw["dither"],
                              fn is encode_leaf, kw.get("checksum", False))
        out = fn(seed, x.full_tensor(), **kw)

    def place(t):
        # every rank holds the whole result: each keeps its own block
        return distribute_tensor(t, x.device_mesh, x.placements,
                                 src_data_rank=None)

    if isinstance(out, PackedLeaf):
        if out.mode != "shard":
            return out
        return dataclasses.replace(out, codes=place(out.codes),
                                   scales=place(out.scales))
    return place(out)


def _kernel_view(x: torch.Tensor, g: int) -> torch.Tensor:
    """The (R, D) float32 view the kernel reads, on fresh storage when the
    leaf's own is not 16-byte aligned for the vector loads."""
    x2 = kernel_ops.rows_view(x.to(torch.float32), g)
    if x2.device.type == "cuda" and (x2.data_ptr() % 16
                                      or not x2.is_contiguous()):
        x2 = x2.clone(memory_format=torch.contiguous_format)
    return x2


def _check_modes(compute: str, dither: str) -> None:
    if compute not in ("f32", "native"):
        raise ValueError(f"compute={compute!r} (want 'f32'|'native')")
    if dither not in DITHERS:
        raise ValueError(f"dither={dither!r} (want one of {DITHERS})")


def quantize_leaf(seed, x, bits: int = 8, block: int = 256,
                  dither: str = "uniform", shard_safe: bool = False,
                  kernel_threshold: int = KERNEL_DISPATCH_MIN,
                  compute: str = "f32"):
    """Quantize -> dequantize ONE tensor leaf with the leaf's 32-bit
    ``seed``. Grouping via ``shard_safe``, dither via ``dither``, math via
    the kernel or the oracle (the same bits for the same draws).
    ``compute="native"`` keeps all but the dither comparison in the input
    dtype (``kernels/ref.py:quantize_groups_native``)."""
    _check_modes(compute, dither)
    if bits == 0 or x.ndim == 0 or x.numel() == 0:
        return x
    if is_dtensor(x):
        return _dtensor_leaf(quantize_leaf, seed, x, dict(
            bits=bits, block=block, dither=dither, shard_safe=shard_safe,
            kernel_threshold=kernel_threshold, compute=compute))
    orig_dtype = x.dtype
    native = compute == "native" and orig_dtype != torch.float32
    dev = x.device

    if shard_safe:
        D = x.shape[-1]
        g = group_size(D, block)
        if g < 2:
            return x
        gshape = tuple(x.shape[:-1]) + (D // g, g)
        if native:
            u = _make_dither(_stream_dither(dither), seed, x.shape, dev)
            deq = kernel_ref.quantize_groups_native(
                x.reshape(gshape), u.reshape(gshape), bits=bits)
            return deq.reshape(x.shape)
        route = _kernel_route(x, g, kernel_threshold)
        if route == "kernel":
            x2 = _kernel_view(x, g)
            if dither != "uniform":
                out = kernel_ops.quantize_dequantize_kernel_dither(
                    x2, seed, bits=bits, group=g)
            else:
                u = _make_dither(dither, seed, x.shape, dev)
                out = kernel_ops.quantize_dequantize_grouped(
                    x2, u.reshape(x2.shape), bits=bits, group=g)
            return out.reshape(x.shape).to(orig_dtype)
        u = _make_dither(_stream_dither(dither), seed, x.shape, dev)
        deq = kernel_ref.quantize_groups_ref(
            x.to(torch.float32).reshape(gshape), u.reshape(gshape), bits=bits)
        return deq.reshape(x.shape).to(orig_dtype)

    # the paper's block-p semantics: the flat stream padded to full blocks
    n = x.numel()
    pad = (-n) % block
    if native:
        u = _make_dither(_stream_dither(dither), seed, (n + pad,), dev)
        flat = x.reshape(-1)
        if pad:
            flat = F.pad(flat, (0, pad))
        out = kernel_ref.quantize_groups_native(
            flat.reshape(-1, block), u.reshape(-1, block), bits=bits)
        return out.reshape(-1)[:n].reshape(x.shape)
    flat = x.to(torch.float32).reshape(-1)
    if pad:
        flat = F.pad(flat, (0, pad))
    route = _kernel_route(x, block, kernel_threshold)
    if route == "kernel":
        if dither != "uniform":
            out = kernel_ops.quantize_dequantize_kernel_dither(
                _kernel_view(flat, block), seed, bits=bits,
                group=block).reshape(-1)
        else:
            u = _make_dither(dither, seed, (n + pad,), dev)
            out = kernel_ops.quantize_dequantize_with_dither(
                _kernel_view(flat, block).reshape(-1), u, bits=bits,
                block=block)
    else:
        u = _make_dither(_stream_dither(dither), seed, (n + pad,), dev)
        out = kernel_ref.quantize_block_ref(flat, u, bits=bits, block=block)
    return out[:n].reshape(x.shape).to(orig_dtype)


def encode_leaf(seed, x, bits: int = 8, block: int = 256,
                dither: str = "uniform", shard_safe: bool = False,
                kernel_threshold: int = KERNEL_DISPATCH_MIN,
                compute: str = "f32", checksum: bool = False):
    """Encode ONE leaf to the wire format (``PackedLeaf``), or pass it
    through raw where ``quantize_leaf`` would. Draw-for-draw and dispatch-
    for-dispatch identical to ``quantize_leaf``, so ``decode_leaf(
    encode_leaf(seed, x)) == quantize_leaf(seed, x)`` bit for bit."""
    _check_modes(compute, dither)
    if bits > 8:
        raise ValueError(f"wire format carries <= 8-bit codes, got {bits}")
    if bits == 0 or x.ndim == 0 or x.numel() == 0:
        return x
    if is_dtensor(x):
        return _dtensor_leaf(encode_leaf, seed, x, dict(
            bits=bits, block=block, dither=dither, shard_safe=shard_safe,
            kernel_threshold=kernel_threshold, compute=compute,
            checksum=checksum))
    orig_dtype = x.dtype
    native = compute == "native" and orig_dtype != torch.float32
    dev = x.device

    if shard_safe:
        D = x.shape[-1]
        g = group_size(D, block)
        if g < 2:
            return x
        gshape = tuple(x.shape[:-1]) + (D // g, g)
        route = None if native else _kernel_route(x, g, kernel_threshold)
        if native:
            u = _make_dither(_stream_dither(dither), seed, x.shape, dev)
            codes, scales = kernel_ref.encode_groups_ref(
                x.reshape(gshape), u.reshape(gshape), bits=bits)
        elif route == "kernel":
            x2 = _kernel_view(x, g)
            if dither != "uniform":
                codes, scales = kernel_ops.quantize_encode_kernel_dither(
                    x2, seed, bits=bits, group=g)
            else:
                u = _make_dither(dither, seed, x.shape, dev)
                codes, scales = kernel_ops.quantize_encode_grouped(
                    x2, u.reshape(x2.shape), bits=bits, group=g)
        else:
            u = _make_dither(_stream_dither(dither), seed, x.shape, dev)
            codes, scales = kernel_ref.encode_groups_ref(
                x.to(torch.float32).reshape(gshape), u.reshape(gshape),
                bits=bits)
        wire_codes = _maybe_pack(codes.reshape(x.shape), bits)
        wire_scales = scales.reshape(tuple(x.shape[:-1]) + (D // g,))
        return PackedLeaf(
            codes=wire_codes, scales=wire_scales, shape=tuple(x.shape),
            dtype=orig_dtype, bits=bits, group=g, mode="shard",
            check=leaf_checksum(wire_codes, wire_scales) if checksum
            else None)

    n = x.numel()
    pad = (-n) % block
    if native:
        u = _make_dither(_stream_dither(dither), seed, (n + pad,), dev)
        flat = x.reshape(-1)
        if pad:
            flat = F.pad(flat, (0, pad))
        codes, scales = kernel_ref.encode_groups_ref(
            flat.reshape(-1, block), u.reshape(-1, block), bits=bits)
    else:
        flat = x.to(torch.float32).reshape(-1)
        if pad:
            flat = F.pad(flat, (0, pad))
        route = _kernel_route(x, block, kernel_threshold)
        if route == "kernel":
            x2 = _kernel_view(flat, block)
            if dither != "uniform":
                codes, scales = kernel_ops.quantize_encode_kernel_dither(
                    x2, seed, bits=bits, group=block)
            else:
                u = _make_dither(dither, seed, (n + pad,), dev)
                codes, scales = kernel_ops.quantize_encode_grouped(
                    x2, u.reshape(-1, block), bits=bits, group=block)
        else:
            u = _make_dither(_stream_dither(dither), seed, (n + pad,), dev)
            codes, scales = kernel_ref.encode_groups_ref(
                flat.reshape(-1, block), u.reshape(-1, block), bits=bits)
    wire_codes = _maybe_pack(codes.reshape(-1), bits)
    wire_scales = scales.reshape(-1)
    return PackedLeaf(
        codes=wire_codes, scales=wire_scales, shape=tuple(x.shape),
        dtype=orig_dtype, bits=bits, group=block, mode="flat",
        check=leaf_checksum(wire_codes, wire_scales) if checksum else None)


def decode_leaf(p):
    """Dequantize one wire-format leaf (raw leaves pass through). Leading
    axes beyond the recorded layout are batch dims."""
    if not isinstance(p, PackedLeaf):
        return p
    if is_dtensor(p.codes):
        # a shard-safe payload placed like its leaf: each rank decodes its
        # own block (its groups are whole)
        codes, scales = p.codes.to_local(), p.scales.to_local()
        local_shape = tuple(scales.shape[:-1]) + (scales.shape[-1] * p.group,)
        out = decode_leaf(dataclasses.replace(
            p, codes=codes, scales=scales, shape=local_shape, check=None))
        return kernel_ops.like_dtensor(out, p.codes, tuple(p.shape))
    bits, g, shape = p.bits, p.group, tuple(p.shape)
    codes = p.codes
    if codes.dtype == torch.uint8:
        codes = unpack_nibbles(codes)
    if p.mode == "shard":
        batch = tuple(codes.shape[:codes.ndim - len(shape)])
        D = shape[-1]
        cg = codes.reshape(batch + shape[:-1] + (D // g, g))
        sg = p.scales.reshape(batch + shape[:-1] + (D // g, 1))
        deq = kernel_ref.decode_groups_ref(cg, sg, bits=bits)
        out = deq.reshape(batch + shape)
    else:
        batch = tuple(codes.shape[:-1])
        n = int(math.prod(shape))
        cg = codes.reshape(batch + (-1, g))
        sg = p.scales.reshape(batch + (p.scales.shape[-1], 1))
        deq = kernel_ref.decode_groups_ref(cg, sg, bits=bits)
        out = deq.reshape(batch + (-1,))[..., :n].reshape(batch + shape)
    return out.to(p.dtype)


def decode_tree(payload):
    """Decode every wire-format leaf of a payload pytree (stacked or not)."""
    return tree_map(decode_leaf, payload, is_leaf=_is_payload_leaf)


def decode_reduce_leaf(p, w, kernel_threshold: int = KERNEL_DISPATCH_MIN,
                       fused: Optional[bool] = None):
    """``sum_c w[c] * decode(p[c])`` over the leading client axis of ONE
    stacked payload leaf, in the accumulation dtype (float32 under float32
    weights: a bf16 stack is promoted, as ``jnp.tensordot`` promotes it).

    Large float32 or bf16 ``PackedLeaf``s whose group the kernel takes go
    to the fused decode + reduce kernel (``kernels/ops.py:
    dequantize_reduce_grouped``; the decoded client stack never exists),
    accumulating in c order; for a bf16 leaf the kernel rounds each
    dequantized element to bf16 first, as ``decode`` does. (The
    reference keeps bf16 leaves off its kernel, which accumulates the raw
    float32 dequant; the port's kernel reduces decode's own values.)
    Everything else decodes and reduces with a tensordot, which agrees with
    the kernel to float32 reduction-order rounding. ``fused=False`` forces
    the tensordot."""
    if not isinstance(p, PackedLeaf):
        return _tensordot(w, p)
    shape, g, bits = tuple(p.shape), p.group, p.bits
    n = int(math.prod(shape))
    C = w.shape[0]
    one_batch_axis = (p.codes.ndim - (len(shape) if p.mode == "shard"
                                      else 1)) == 1
    route_ok = (fused is not False and n >= kernel_threshold
                and reduce_group_ok(g) and one_batch_axis
                and p.dtype in (torch.float32, torch.bfloat16)
                and p.scales.dtype == torch.float32)
    if route_ok:
        codes = p.codes
        if codes.dtype == torch.uint8:
            codes = unpack_nibbles(codes)
        if p.mode == "shard":
            D = shape[-1]
            c3 = codes.reshape(C, -1, D)
            s3 = p.scales.reshape(C, -1, D // g)
        else:
            c3 = codes.reshape(C, -1, g)
            s3 = p.scales.reshape(C, -1, 1)
        out = kernel_ops.dequantize_reduce_grouped(
            c3.contiguous(), s3.contiguous(), w.to(c3.device), bits=bits,
            group=g,
            round_to=None if p.dtype == torch.float32 else p.dtype)
        if p.mode == "flat":
            out = out.reshape(-1)[:n]
        return out.reshape(shape)
    return _tensordot(w, decode_leaf(p))


def _tensordot(w, x):
    """sum_c w[c] * x[c] in the promoted dtype (as jnp.tensordot promotes
    a float32 weight against a bf16 stack)."""
    dt = torch.promote_types(w.dtype, x.dtype)
    return torch.tensordot(w.to(dt), x.to(dt), dims=1)


def decode_reduce_tree(payload, w,
                       kernel_threshold: int = KERNEL_DISPATCH_MIN,
                       fused: Optional[bool] = None):
    """``decode_reduce_leaf`` over a payload pytree; fold a participation
    mask into ``w`` (``mu * mask``)."""
    return tree_map(
        lambda p: decode_reduce_leaf(p, w, kernel_threshold=kernel_threshold,
                                     fused=fused),
        payload, is_leaf=_is_payload_leaf)


def block_quant(bits: int = 8, block: int = 256, dither: str = "uniform",
                shard_safe: bool = False,
                kernel_threshold: int = KERNEL_DISPATCH_MIN,
                compute: str = "f32", checksum: bool = False) -> Compressor:
    levels = 2.0 ** (bits - 1) - 1.0
    omega = block / (4.0 * levels * levels)

    def apply(key, s):
        return _tree_keyed_map(
            lambda k, x: quantize_leaf(k, x, bits=bits, block=block,
                                       dither=dither, shard_safe=shard_safe,
                                       kernel_threshold=kernel_threshold,
                                       compute=compute),
            key, s)

    def encode(key, s):
        return _tree_keyed_map(
            lambda k, x: encode_leaf(k, x, bits=bits, block=block,
                                     dither=dither, shard_safe=shard_safe,
                                     kernel_threshold=kernel_threshold,
                                     compute=compute, checksum=checksum),
            key, s)

    def decode_reduce(payload, w, fused=None):
        return decode_reduce_tree(payload, w,
                                  kernel_threshold=kernel_threshold,
                                  fused=fused)

    def payload(shape, itemsize):
        # exact wire bytes (mirrors encode_leaf): codes (1 byte per
        # coordinate, 0.5 when bits <= 4) + one scale per group + the
        # digest; raw passthrough leaves travel at their dtype
        n = float(math.prod(shape)) if shape else 1.0
        if not shape:
            return n * itemsize
        scale_sz = itemsize if compute == "native" and itemsize != 4.0 \
            else 4.0
        ck = float(CHECKSUM_BYTES) if (checksum and bits <= 8) else 0.0
        if not shard_safe:
            n_blocks = math.ceil(n / block)
            padded = n_blocks * block
            code_b = padded / 2.0 if (bits <= PACK_BITS and padded % 2 == 0) \
                else float(padded)
            return code_b + n_blocks * scale_sz + ck
        g = group_size(shape[-1], block)
        if g < 2:
            return n * itemsize
        code_b = n / 2.0 if bits <= PACK_BITS else n
        return code_b + (n / g) * scale_sz + ck

    tag = f"{dither},shard" if shard_safe else dither
    if compute == "native":
        tag += ",native"
    if checksum:
        tag += ",ck"
    wire = bits <= 8
    return Compressor(apply=apply, omega=float(omega), bits=float(bits),
                      name=f"block_quant{bits}b{block}[{tag}]",
                      payload_fn=payload,
                      encode=encode if wire else None,
                      decode=decode_tree if wire else None,
                      decode_reduce=decode_reduce if wire else None,
                      checksum=checksum and wire,
                      reencode=encode if wire else None)


# ---------------------------------------------------------------------------
# Rand-k sparsification: keep each coordinate with probability k/n,
# rescale by n/k. omega = n/k - 1.
# ---------------------------------------------------------------------------

def rand_k(fraction: float) -> Compressor:
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    omega = 1.0 / fraction - 1.0

    def leaf(seed, x):
        if x.device.type == "meta":
            # shape-only run: no draws to make
            return torch.empty_like(x)
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        keep = torch.rand(tuple(x.shape), generator=gen,
                          device=x.device) < fraction
        return torch.where(keep, x / fraction,
                           torch.zeros((), dtype=x.dtype,
                                       device=x.device)).to(x.dtype)

    def apply(key, s):
        return _tree_keyed_map(leaf, key, s)

    def payload(shape, itemsize):
        # (value, coordinate) pairs: itemsize + ceil(log2 n) bits (>= 1)
        n = float(math.prod(shape)) if shape else 1.0
        if n == 0:
            return 0.0
        idx_bits = max(1, math.ceil(math.log2(n)))
        return n * fraction * (itemsize + idx_bits / 8.0)

    return Compressor(apply=apply, omega=float(omega), bits=32.0 * fraction,
                      name=f"rand_k{fraction:g}", payload_fn=payload)


# ---------------------------------------------------------------------------
# Lemma 1: partial participation composed on top of any compressor.
#   QuantTilde(s) = (U / p) * Quant(s),  U ~ Bernoulli(p)
# ---------------------------------------------------------------------------

_PARTICIPATION_SALT = 0x50415254  # "PART": the coin's hash lane


def with_participation(base: Compressor, p: float) -> Compressor:
    """The coin U comes from the generator (before the base's seeds are
    drawn), or, given per-leaf seeds, from the hash of the first seed on
    its own salt."""
    if not 0.0 < p <= 1.0:
        raise ValueError(f"p must be in (0, 1], got {p}")
    omega_p = effective_omega(base.omega, p)

    def apply(key, s):
        if isinstance(key, torch.Generator):
            draw = torch.rand((), generator=key, device=key.device).cpu()
        else:
            first = leaf_seeds(key, len(tree_leaves(s)))[0]
            draw = kernel_ref.hash_uniform(
                torch.tensor([_PARTICIPATION_SALT]), first)[0]
        u = (draw < p).to(torch.float32)
        q = base.apply(key, s)
        return tree_map(lambda x: (u / p) * x, q)

    return Compressor(apply=apply, omega=float(omega_p), bits=base.bits * p,
                      name=f"{base.name}+pp{p:g}",
                      payload_fn=lambda shape, itemsize:
                          p * base._leaf_payload(shape, itemsize))


def effective_omega(omega: float, p: float) -> float:
    """omega_p = omega + (1 + omega)(1 - p)/p  (Lemma 1 / Theorem 1)."""
    return omega + (1.0 + omega) * (1.0 - p) / p
