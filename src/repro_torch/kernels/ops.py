"""Public wrappers for the kernels (the counterparts of
``repro/kernels/ops.py``). The quantizer wrappers pad or reshape to the
kernel's (R, D) view and call ``quantize_block``; ``flash_attention`` and
``rwkv_wkv`` call their kernel modules. Each kernel module launches its
CUDA kernel for CUDA tensors and takes its plain version on the CPU.

The shard_map wrappers of the reference (``quantize_dequantize_sharded``,
``quantize_encode_sharded``) belong to the multi-GPU slice and are not
here yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash_attention as fa
from . import quantize_block as qb
from . import rwkv_scan as rs


def quantize_dequantize_with_dither(x, u, bits: int = 8, block: int = 256):
    """Block quantize -> dequantize of a flat float32 stream with caller-
    provided uniform draws ``u`` (same shape as ``x``); pads to the block.
    The counterpart of ``quantize_block_pallas``: the grouped kernel with
    one group per row (D == g), its launches counted under
    ``quantize_block``."""
    n = x.shape[0]
    pad = (-n) % block
    xp = F.pad(x, (0, pad)) if pad else x
    up = F.pad(u, (0, pad)) if pad else u
    out = qb.quantize_grouped(xp.reshape(-1, block), up.reshape(-1, block),
                              bits=bits, group=block,
                              count_as="quantize_block")
    return out.reshape(-1)[:n]


def quantize_dequantize_grouped(x2, u2, bits: int = 8, group: int = 256):
    """Grouped quantize -> dequantize: x2, u2 (R, D) float32, D % group == 0."""
    return qb.quantize_grouped(x2, u2, bits=bits, group=group)


def quantize_dequantize_kernel_dither(x2, seed, bits: int = 8,
                                      group: int = 256):
    """Grouped quantize -> dequantize with the dither made in the kernel
    from ``seed`` (the folded 32-bit seed): two arrays of memory traffic per
    element instead of three."""
    return qb.quantize_grouped(x2, bits=bits, group=group, seed=seed)


def quantize_encode_grouped(x2, u2, bits: int = 8, group: int = 256):
    """Wire encode with streamed draws: (codes int8 (R, D), scales f32
    (R, D // group))."""
    return qb.quantize_encode_grouped(x2, u2, bits=bits, group=group)


def quantize_encode_kernel_dither(x2, seed, bits: int = 8, group: int = 256):
    """Wire encode with the in-kernel dither."""
    return qb.quantize_encode_grouped(x2, bits=bits, group=group, seed=seed)


def dequantize_reduce_grouped(codes, scales, w, bits: int = 8,
                              group: int = 256):
    """``sum_c w[c] * dequant(codes[c], scales[c])`` without the decoded
    client stack: codes (C, R, D) int8, scales (C, R, D // group) f32,
    w (C,) f32."""
    return qb.decode_reduce_grouped(codes, scales, w.to(torch.float32),
                                    bits=bits, group=group)


def _tpu_tiles_at_default(**given) -> None:
    """The reference's tile arguments have no counterpart here: a value
    other than the default would select nothing, so it is refused."""
    defaults = {"q_block": 128, "kv_block": 128, "chunk": 64}
    for name, value in given.items():
        if value != defaults[name]:
            raise ValueError(
                f"{name}={value}: the TPU kernel's tile size selects nothing "
                f"in the Hopper kernel, whose tiles are its own; leave it at "
                f"{defaults[name]}")


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_block: int = 128, kv_block: int = 128):
    """GQA attention: q (B, Sq, H, hd), k, v (B, Sk, KV, hd) -> (B, Sq, H,
    hd). ``q_block``/``kv_block`` keep the reference's signature and must
    stay at their defaults."""
    _tpu_tiles_at_default(q_block=q_block, kv_block=kv_block)
    return fa.flash_attention(q, k, v, causal=causal, window=window)


def rwkv_wkv(r, k, v, w, u, chunk: int = 64):
    """The WKV6 recurrence: (y, final state). ``chunk`` keeps the
    reference's signature and must stay at its default: the Hopper kernel
    walks time in one pass."""
    _tpu_tiles_at_default(chunk=chunk)
    return rs.rwkv_scan(r, k, v, w, u)


def rows_view(x, group: int):
    """The (R, D) kernel view: multi-dim leaves collapse their leading dims
    and keep the grouped last axis; flat leaves tile into group-wide rows.
    Row-major order keeps the global element index (the hash-dither
    stream) unchanged."""
    return x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(-1, group)
