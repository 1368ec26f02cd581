"""The block quantizer's three kernels: CUDA for Hopper, a plain PyTorch
version beside each.

Counterparts of the Pallas kernels in ``repro/kernels/quantize_block.py``:

* ``quantize_grouped``       <- ``quantize_grouped_pallas``: fused
  quantize -> dequantize of an ``(R, D)`` view with groups of ``g`` along
  the last axis (``g`` a multiple of 128, as the reference's kernel, or a
  power of two below 128, which the reference leaves to jnp);
* ``quantize_encode_grouped`` <- ``quantize_encode_grouped_pallas``: the
  wire encode, int8 codes ``(R, D)`` and one f32 scale per group
  ``(R, D / g)``;
* ``decode_reduce_grouped``  <- ``decode_reduce_grouped_pallas``:
  ``sum_c w_c * dequant(codes_c, scales_c)`` over a stacked ``C``-client
  payload, accumulated in ``c`` order without the decoded stack; with
  ``round_to=torch.bfloat16`` each dequantized element is rounded to bf16
  first, as ``decode`` rounds a bf16 leaf (the reference keeps such
  leaves off its kernel).

Each wrapper takes its plain version for tensors on the CPU, launches
its kernel for CUDA tensors, returns empty outputs of its kernel's shapes
and dtypes for shape-only ``meta`` tensors (so a dry run counts no
temporaries the kernels never make: the plain versions' hash dither
holds an int64 index of the whole leaf), and raises for anything else. A CUDA tensor never falls back to the plain
version. The kernels live in ``csrc/quantize_block.cu``; the library is
built with ``nvcc`` at first use into ``build/`` at the root of the
checkout and bound through ``ctypes`` (``kernels/build.py``).

The dither is streamed (``u``) or made in the kernel from ``seed``: the
in-kernel dither is the murmur hash of the global element index, the same
draws as the streamed ``"hash"`` dither, so both give the same bits.
``LAUNCHES`` counts the kernel launches of each wrapper and dither
variant; only a launch adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B
from . import ref

SOURCE = B.CSRC / "quantize_block.cu"
# no FMA contraction: the rounding must match the reference bit for bit
NVCC_FLAGS = B.BASE_FLAGS + ("-fmad=false",)

# launches per kernel variant: streamed dither, dither made in the kernel;
# ``quantize_block`` counts the streamed ``quantize`` kernel's launches for
# the flat stream (``ops.quantize_dequantize_with_dither``), apart from the
# grouped route's; a ``_small`` entry counts a variant's launches with a
# group below 128 (``small_quant_kernel`` in the source)
_VARIANTS = ("quantize", "quantize_seeded", "encode", "encode_seeded",
             "quantize_block")
LAUNCHES = {**{k: 0 for k in _VARIANTS}, "decode_reduce": 0,
            **{k + "_small": 0 for k in _VARIANTS}}
# the same ``_small`` launches by group: ``"<variant>_small_g<group>"``
LAUNCHES_BY_GROUP: dict = {}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_GROUP.clear()


def kernel_group_ok(group: int) -> bool:
    """The quantize and encode kernels take a group that is a whole number
    of 128-element chunks (one float4 per lane per chunk, the reference's
    alignment rule) or a power of two below 128 (the shard-safe groups of
    LM-width leaves: several groups per warp)."""
    return reduce_group_ok(group) or (1 <= group < 128
                                      and group & (group - 1) == 0)


def reduce_group_ok(group: int) -> bool:
    """The decode + reduce kernel takes groups that are a multiple of 128
    (16 consecutive elements of a thread share one scale)."""
    return group >= 128 and group % 128 == 0


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def _lib():
    global _LIB
    if _LIB is None:
        P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_uint
        _LIB = B.load(SOURCE, NVCC_FLAGS, {
            "qb_quantize": [P, P, P, LL, LL, I, I, U, I, I, P],
            "qb_encode": [P, P, P, P, LL, LL, I, I, U, I, I, P],
            "qb_decode_reduce": [P, P, P, P, I, LL, LL, I, I, I, I, P]})
    return _LIB


def _require(t: torch.Tensor, name: str, dtype, device,
             vector: bool = True) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vector and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the vector "
                         f"loads")


def _check_grouped(x2: torch.Tensor, group: int, bits: int) -> None:
    if x2.ndim != 2:
        raise ValueError(f"want an (R, D) view, got shape {tuple(x2.shape)}")
    if x2.shape[1] % group:
        raise ValueError(f"last axis {x2.shape[1]} is not a whole number of "
                         f"groups of {group}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits={bits} (want 2..8)")


def _check_kernel_args(x2, u2, group) -> None:
    if not kernel_group_ok(group):
        raise ValueError(f"the CUDA kernel takes groups that are a multiple "
                         f"of 128 or a power of two below it, got {group}")
    _require(x2, "x2", torch.float32, x2.device)
    if u2 is not None:
        if u2.shape != x2.shape:
            raise ValueError(f"u2 shape {tuple(u2.shape)} != x2 shape "
                             f"{tuple(x2.shape)}")
        _require(u2, "u2", torch.float32, x2.device)


def _seed_u32(seed) -> int:
    return int(seed) & 0xFFFFFFFF


def _count(variant: str, group: int) -> None:
    if group >= 128:
        LAUNCHES[variant] += 1
        return
    LAUNCHES[variant + "_small"] += 1
    key = f"{variant}_small_g{group}"
    LAUNCHES_BY_GROUP[key] = LAUNCHES_BY_GROUP.get(key, 0) + 1


# ---------------------------------------------------------------------------
# plain versions (same operation order as the kernels)
# ---------------------------------------------------------------------------

def kernel_dither_plain(shape, seed, device) -> torch.Tensor:
    """The in-kernel dither written out: the hash of each element's global
    index in the row-major (R, D) view."""
    return ref.hash_dither(_seed_u32(seed), shape, device=device)


def quantize_grouped_plain(x2, u2=None, *, bits=8, group=256, seed=None):
    if u2 is None:
        u2 = kernel_dither_plain(x2.shape, seed, x2.device)
    R, D = x2.shape
    out = ref.quantize_groups_ref(x2.reshape(R, D // group, group),
                                  u2.reshape(R, D // group, group), bits=bits)
    return out.reshape(R, D)


def quantize_encode_grouped_plain(x2, u2=None, *, bits=8, group=256,
                                  seed=None):
    if u2 is None:
        u2 = kernel_dither_plain(x2.shape, seed, x2.device)
    R, D = x2.shape
    codes, scales = ref.encode_groups_ref(x2.reshape(R, D // group, group),
                                          u2.reshape(R, D // group, group),
                                          bits=bits)
    return codes.reshape(R, D), scales.reshape(R, D // group)


def decode_reduce_grouped_plain(codes, scales, w, *, bits=8, group=256,
                                round_to=None):
    """The reference's sequential-in-c accumulation: o = w_0 * deq_0, then
    o = o + w_c * deq_c; ``round_to`` (bf16) rounds each deq_c to it
    first."""
    C, R, D = codes.shape
    out = None
    for c in range(C):
        deq = ref.decode_groups_ref(
            codes[c].reshape(R, D // group, group),
            scales[c].reshape(R, D // group, 1), bits=bits).reshape(R, D)
        if round_to is not None:
            deq = deq.to(round_to).to(torch.float32)
        contrib = w[c] * deq
        out = contrib if out is None else out + contrib
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def quantize_grouped(x2, u2=None, *, bits: int = 8, group: int = 256,
                     seed=None, count_as: str | None = None):
    """Fused quantize -> dequantize of an (R, D) float32 view, groups of
    ``group`` along the last axis. ``u2``: streamed uniform draws (R, D),
    or None to make the dither from ``seed`` (a 32-bit integer).
    ``count_as`` names the ``LAUNCHES`` entry a launch adds to (by default
    the dither variant's)."""
    _check_grouped(x2, group, bits)
    if u2 is None and seed is None:
        raise ValueError("need streamed draws u2 or an in-kernel dither seed")
    where = B.route(x2, "quantizer")
    if where == "plain":
        return quantize_grouped_plain(x2, u2, bits=bits, group=group,
                                      seed=seed)
    _check_kernel_args(x2, u2, group)
    out = torch.empty_like(x2)
    if where == "meta":
        return out
    rc = _lib().qb_quantize(
        x2.data_ptr(), None if u2 is None else u2.data_ptr(), out.data_ptr(),
        x2.shape[0], x2.shape[1], group, bits,
        _seed_u32(0 if seed is None else seed), int(u2 is None),
        x2.device.index or 0, B.stream_of(x2))
    B.check(rc, "quantize")
    _count(count_as or ("quantize" if u2 is not None
                        else "quantize_seeded"), group)
    return out


def quantize_encode_grouped(x2, u2=None, *, bits: int = 8, group: int = 256,
                            seed=None):
    """Wire encode of an (R, D) float32 view: ``(codes int8 (R, D),
    scales float32 (R, D // group))``. Dither as in ``quantize_grouped``."""
    _check_grouped(x2, group, bits)
    if u2 is None and seed is None:
        raise ValueError("need streamed draws u2 or an in-kernel dither seed")
    where = B.route(x2, "quantizer")
    if where == "plain":
        return quantize_encode_grouped_plain(x2, u2, bits=bits, group=group,
                                             seed=seed)
    _check_kernel_args(x2, u2, group)
    R, D = x2.shape
    codes = torch.empty((R, D), dtype=torch.int8, device=x2.device)
    scales = torch.empty((R, D // group), dtype=torch.float32,
                         device=x2.device)
    if where == "meta":
        return codes, scales
    rc = _lib().qb_encode(
        x2.data_ptr(), None if u2 is None else u2.data_ptr(),
        codes.data_ptr(), scales.data_ptr(), R, D, group, bits,
        _seed_u32(0 if seed is None else seed), int(u2 is None),
        x2.device.index or 0, B.stream_of(x2))
    B.check(rc, "encode")
    _count("encode" if u2 is not None else "encode_seeded", group)
    return codes, scales


def decode_reduce_grouped(codes, scales, w, *, bits: int = 8,
                          group: int = 256, round_to=None):
    """``sum_c w[c] * dequant(codes[c], scales[c])``: codes (C, R, D) int8,
    scales (C, R, D // group) float32, w (C,) float32 -> (R, D) float32,
    accumulated in c order. ``round_to``: None, or ``torch.bfloat16`` to
    round each dequantized element to bf16 before it is weighted."""
    if round_to not in (None, torch.bfloat16):
        raise ValueError(f"round_to takes None or torch.bfloat16, got "
                         f"{round_to}")
    if codes.ndim != 3:
        raise ValueError(f"codes must be (C, R, D), got {tuple(codes.shape)}")
    C, R, D = codes.shape
    _check_grouped(codes[0], group, bits)
    if tuple(scales.shape) != (C, R, D // group):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"{(C, R, D // group)}")
    if tuple(w.shape) != (C,):
        raise ValueError(f"w shape {tuple(w.shape)} != {(C,)}")
    where = B.route(codes, "quantizer")
    if where == "plain":
        return decode_reduce_grouped_plain(codes, scales,
                                           w.to(torch.float32), bits=bits,
                                           group=group, round_to=round_to)
    if not reduce_group_ok(group):
        raise ValueError(f"the CUDA kernel takes groups that are a multiple "
                         f"of 128, got {group}")
    _require(codes, "codes", torch.int8, codes.device)
    _require(scales, "scales", torch.float32, codes.device, vector=False)
    _require(w, "w", torch.float32, codes.device, vector=False)
    out = torch.empty((R, D), dtype=torch.float32, device=codes.device)
    if where == "meta":
        return out
    rc = _lib().qb_decode_reduce(
        codes.data_ptr(), scales.data_ptr(), w.data_ptr(), out.data_ptr(),
        C, R, D, group, bits, int(round_to is not None),
        codes.device.index or 0, B.stream_of(codes))
    B.check(rc, "decode_reduce")
    LAUNCHES["decode_reduce"] += 1
    return out
