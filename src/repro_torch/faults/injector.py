"""Deterministic payload damage for wire-integrity tests and drills (the
counterpart of ``repro/faults/injector.py``).

``corrupt_payload`` damages the rows of a stacked payload (a leading
client axis on every ``PackedLeaf`` buffer) that a bool flag vector
selects, in one of three ways:

* ``"flip"``: every code byte XORed with 0x55;
* ``"truncate"``: the second half of each row's flattened code stream
  flipped the same way (a message cut mid-transfer and padded);
* ``"scales"``: every scale word of the row set to the float32 quiet-NaN
  bit pattern (which the dequantize would launder into NaN).

The ``check`` buffer rides along untouched: it describes what the sender
put on the wire, so any damage is a guaranteed mismatch at
``verify_payload``. Raw (non-``PackedLeaf``) leaves carry no checksum and
pass through.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.compression import (PackedLeaf, _is_payload_leaf,
                                payload_batch_dims)
from ..tree import tree_map

_QNAN_BITS = 0x7FC00000  # float32 quiet NaN


def _select(flag, damaged, original):
    """``damaged`` on the rows ``flag`` selects (broadcast over the
    trailing dims), ``original`` elsewhere."""
    flag = flag.to(original.device)
    sel = flag.reshape(tuple(flag.shape)
                       + (1,) * (original.ndim - flag.ndim))
    return torch.where(sel, damaged, original)


def _flip(codes):
    return codes.view(torch.uint8).bitwise_xor(0x55).view(codes.dtype)


def _truncate(codes, n_batch: int):
    flat = codes.reshape(tuple(codes.shape[:n_batch]) + (-1,))
    cut = flat.shape[-1] // 2
    pos = torch.arange(flat.shape[-1], device=codes.device)
    return torch.where(pos >= cut, _flip(flat), flat).reshape(codes.shape)


def _nan_scales(scales):
    if scales.dtype == torch.float32:
        return torch.full(scales.shape, _QNAN_BITS, dtype=torch.int32,
                          device=scales.device).view(torch.float32)
    return torch.full(scales.shape, float("nan"), dtype=scales.dtype,
                      device=scales.device)


def corrupt_payload(payload, flag, kind: str = "flip"):
    """Damage the flagged clients' rows of a stacked payload tree. ``flag``
    is a bool vector (or scalar, for one client's unstacked payload) over
    the buffers' leading batch axes. Checksums ride along unmodified."""
    flag = torch.as_tensor(flag, dtype=torch.bool)

    def leaf(p):
        if not isinstance(p, PackedLeaf):
            return p
        if kind == "flip":
            return dataclasses.replace(
                p, codes=_select(flag, _flip(p.codes), p.codes))
        if kind == "truncate":
            return dataclasses.replace(p, codes=_select(
                flag, _truncate(p.codes, payload_batch_dims(p)), p.codes))
        if kind == "scales":
            return dataclasses.replace(
                p, scales=_select(flag, _nan_scales(p.scales), p.scales))
        raise ValueError(f"corrupt kind {kind!r}")

    return tree_map(leaf, payload, is_leaf=_is_payload_leaf)
