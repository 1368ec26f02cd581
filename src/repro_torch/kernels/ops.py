"""Public wrappers for the kernels (the counterparts of
``repro/kernels/ops.py``). The quantizer wrappers pad or reshape to the
kernel's (R, D) view and call ``quantize_block``. ``flash_attention`` and
``rwkv_wkv`` apply their kernels' ``torch.autograd.Function``s to CUDA
tensors (a forward kernel, and a backward kernel when autograd asks for
the gradient) and call the plain versions on CPU tensors, which autograd
differentiates as any PyTorch code. Each kernel module launches its CUDA
kernel for CUDA tensors and takes its plain version on the CPU.

Shape-only ``meta`` tensors take the ``autograd.Function``s too, whose
kernels then return empty outputs of their shapes (the kernel modules'
docstrings). ``DTensor`` inputs of ``flash_attention`` and ``rwkv_wkv``
run the kernel on each rank's block (``local_map``): the batch dim
stays sharded where it is, the head dim where each head count divides
the mesh dims that shard it, every other dim is gathered first.

``quantize_dequantize_sharded`` and ``quantize_encode_sharded`` are the
counterparts of the reference's shard_map wrappers: one kernel launch on
each rank's own block of a partitioned ``DTensor`` leaf, no gather.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.sharding import is_dtensor
from . import build as B
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
                              group: int = 256, round_to=None):
    """``sum_c w[c] * dequant(codes[c], scales[c])`` without the decoded
    client stack: codes (C, R, D) int8, scales (C, R, D // group) f32,
    w (C,) f32; ``round_to=torch.bfloat16`` rounds each dequantized
    element to bf16 first (a bf16 leaf's decode)."""
    return qb.decode_reduce_grouped(codes, scales, w.to(torch.float32),
                                    bits=bits, group=group,
                                    round_to=round_to)


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


def on_blocks(fn, args, lead, keep: dict, in_dims, out_dims):
    """``fn(*args)`` on each rank's block of the ``DTensor``s ``args``
    (``local_map``, inputs redistributed first). ``lead`` sets the layout:
    a mesh dim that shards a dim ``d`` of ``lead`` in ``keep`` still shards
    it when every count in ``keep[d]`` (the sizes that split along it)
    divides the mesh dims sharding it so far; every other mesh dim is
    gathered. ``in_dims``/``out_dims``: for each input and output, a map
    from ``lead``'s kept dims to that tensor's own (a dim left out is
    replicated). The gradient of an input replicated over a mesh dim that
    splits the work is each rank's part of a sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    layout, split = [], dict.fromkeys(keep, 1)
    for i, pl in enumerate(lead.placements):
        m = lead.device_mesh.size(i)
        d = next((d for d in keep if pl.is_shard(d) and all(
            c % (split[d] * m) == 0 for c in keep[d])), None)
        if d is not None:
            split[d] *= m
        layout.append(d)

    def placed(dims, summed=Replicate()):
        return [Replicate() if d is None else summed if dims.get(d) is None
                else Shard(dims[d]) for d in layout]

    outs = tuple(placed(dims) for dims in out_dims)
    return local_map(fn, out_placements=outs if len(outs) > 1 else outs[0],
                     in_placements=tuple(placed(dims) for dims in in_dims),
                     in_grad_placements=tuple(placed(dims, Partial())
                                              for dims in in_dims),
                     device_mesh=lead.device_mesh,
                     redistribute_inputs=True)(*args)


# a sequence kernel's (B, S, H, hd) tensors keep their batch and head dims
SEQ_DIMS = {0: 0, 2: 2}


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_block: int = 128, kv_block: int = 128):
    """GQA attention: q (B, Sq, H, hd), k, v (B, Sk, KV, hd) -> (B, Sq, H,
    hd). ``q_block``/``kv_block`` keep the reference's signature and must
    stay at their defaults."""
    _tpu_tiles_at_default(q_block=q_block, kv_block=kv_block)
    if is_dtensor(q):
        return on_blocks(
            lambda a, b, c: flash_attention(a, b, c, causal, window),
            (q, k, v), q, {0: (q.shape[0],), 2: (q.shape[2], k.shape[2])},
            (SEQ_DIMS,) * 3, (SEQ_DIMS,))
    if q.device.type in ("cuda", "meta"):
        return fa.FlashAttentionFn.apply(q, k, v, causal, window)[0]
    return fa.flash_attention(q, k, v, causal=causal, window=window)


def rwkv_wkv(r, k, v, w, u, chunk: int = 64):
    """The WKV6 recurrence: (y, final state). ``chunk`` keeps the
    reference's signature and must stay at its default: the Hopper kernel
    walks time in one pass."""
    _tpu_tiles_at_default(chunk=chunk)
    if is_dtensor(r):
        # u (H, hd) splits along the heads; the state (B, H, hd, hd)
        return on_blocks(rwkv_wkv, (r, k, v, w, u), r,
                         {0: (r.shape[0],), 2: (r.shape[2],)},
                         (SEQ_DIMS,) * 4 + ({2: 0},),
                         (SEQ_DIMS, {0: 0, 2: 1}))
    if r.device.type in ("cuda", "meta"):
        return rs.WKV6Fn.apply(r, k, v, w, rs.as_u32(u, r))
    return rs.rwkv_scan(r, k, v, w, u)


def shard_box(shape, mesh, placements):
    """The slices of a leaf of ``shape`` that this rank holds under
    ``placements`` on ``mesh`` (mesh dims in order, each splitting its
    tensor dim evenly, as ``DTensor`` shards), or None where a split is
    uneven or a placement is not ``Shard``/``Replicate``."""
    coord = mesh.get_coordinate()
    start, length = [0] * len(shape), [int(s) for s in shape]
    for i, pl in enumerate(placements):
        if pl.is_replicate():
            continue
        if not pl.is_shard():
            return None
        d = pl.dim % len(shape)
        m = int(mesh.mesh.shape[i])
        if length[d] % m:
            return None
        length[d] //= m
        start[d] += int(coord[i]) * length[d]
    return tuple(slice(a, a + n) for a, n in zip(start, length))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(s)
    return tuple(reversed(stride))


def like_dtensor(local, x, shape):
    """A ``DTensor`` of global ``shape`` with ``x``'s mesh and placements
    whose block on this rank is ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _local_rows(x, u, group: int):
    xl = x.to_local()
    x2 = B.aligned(rows_view(xl.to(torch.float32), group))
    return xl, x2, B.aligned(u.reshape(x2.shape))


def quantize_dequantize_sharded(x, u, bits: int = 8, group: int = 256):
    """Grouped quantize -> dequantize of a partitioned ``DTensor`` leaf:
    each rank runs the grouped kernel once on its own block (its local
    leading dims collapsed to rows). ``u``: the dither of this rank's
    elements, drawn by their GLOBAL index (``shard_box``), so the result is
    bit-identical to the unsharded kernel. Returns a ``DTensor`` placed
    like ``x``. Every group must lie inside one block (``group`` divides
    the block's last dim)."""
    xl, x2, u2 = _local_rows(x, u, group)
    out = quantize_dequantize_grouped(x2, u2, bits=bits, group=group)
    return like_dtensor(out.reshape(xl.shape), x, tuple(x.shape))


def quantize_encode_sharded(x, u, bits: int = 8, group: int = 256):
    """Wire encode of a partitioned ``DTensor`` leaf, one kernel launch per
    rank on its own block: ``(codes int8 shaped like x, scales float32
    of shape x.shape[:-1] + (D // group,))``, both ``DTensor``s placed like
    ``x`` (the scales' last dim splits as the leaf's does, since the group
    divides each block's width). ``u`` as in
    ``quantize_dequantize_sharded``."""
    xl, x2, u2 = _local_rows(x, u, group)
    codes, scales = quantize_encode_grouped(x2, u2, bits=bits, group=group)
    shape = tuple(x.shape)
    return (like_dtensor(codes.reshape(xl.shape), x, shape),
            like_dtensor(scales.reshape(tuple(xl.shape[:-1]) + (-1,)), x,
                  shape[:-1] + (shape[-1] // group,)))


def rows_view(x, group: int):
    """The (R, D) kernel view: multi-dim leaves collapse their leading dims
    and keep the grouped last axis; flat leaves tile into group-wide rows.
    Row-major order keeps the global element index (the hash-dither
    stream) unchanged."""
    return x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(-1, group)
