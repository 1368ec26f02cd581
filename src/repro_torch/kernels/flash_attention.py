"""GQA flash attention (forward): CUDA kernels for Hopper, their plain
PyTorch version beside them.

Replaces ``flash_attention_pallas`` (``repro/kernels/flash_attention.py``):
``q (B, Sq, H, hd)``, ``k, v (B, Sk, KV, hd)`` -> ``(B, Sq, H, hd)`` in
``q``'s dtype, online softmax in float32, causal / sliding-window masks
built from positions, ragged ``Sq`` and ``Sk``.

On the H100 the operations bound it (4 hd flop per valid query-key pair
per head, at the bf16 tensor-core rate). ``csrc/flash_attention.cu`` holds
two kernels behind one C entry point, both for hd 32, 64, 128 and 256
(gemma3-12b's), both reading K/V of the shared KV head through the
tensors' strides:

- **bfloat16** (the serving path): a persistent, warp-specialised kernel.
  A producer warpgroup brings Q, K and V by TMA (tensor maps over the
  tensors' own strides, zero fill past the ragged edges) into a two-stage
  ring behind mbarriers (128-key tiles; 64-key tiles at hd 256, so that
  the ring fits beside a 64 KB Q tile); two consumer warpgroups of 64
  query rows run both products on the tensor cores (``wgmma``, bf16 in,
  float32 accumulators),
  P rounded to bf16 in registers as the A operand of P V, and overlap
  each tile's softmax with the products (their own next-tile S and the
  other warpgroup's wgmmas, taken in turns).
- **float32**: a SIMT kernel (64-row query tiles over 64-key tiles, m, l
  and the accumulator in registers), kept for the float32 checks at
  2e-4 / 2e-5, which TF32 tensor cores could not meet.

Both skip KV tiles the masks empty for a whole query tile. The source
header says what bounds each and what the design does about that.

With ``return_lse=True`` the forward also returns each row's
log-sum-exp (float32 (B, H, Sq), base 2), which both kernels write in
their epilogue; the serving path asks for none, and no store is made.

The backward, ``flash_attention_backward`` (dq, dk, dv from q, k, v, the
output, its log-sum-exp and its gradient), is two kernels of its own
source, ``csrc/flash_attention_bwd.cu``, one over query tiles (D and
dq), one over key tiles (dk and dv summed over each KV head's query
heads, no atomics): in bf16 warp-specialised ``wgmma`` kernels fed by
TMA, every product on the tensor cores; in float32 SIMT kernels. The
``wgmma``, mbarrier and TMA helpers both sources use are in
``csrc/hopper.cuh``. Its header says what bounds it. ``FlashAttentionFn``
ties forward and backward together as a ``torch.autograd.Function``,
which ``kernels/ops.py`` applies to CUDA tensors.

``flash_attention`` and ``flash_attention_backward`` take the plain
versions for CPU tensors, launch their kernels for CUDA tensors, and
raise for anything else; a CUDA tensor never falls back (an hd outside
``HEAD_DIMS`` raises). ``LAUNCHES`` counts the kernels' launches
(``flash_attention``; ``flash_attention_bwd``, once per backward, for its
two kernels); only a launch adds to it. ``blocks_per_sm`` reports a
forward launch's occupancy.

Shape-only (``meta``) tensors take neither: the wrappers check the
shapes and dtypes as for a launch and return empty outputs of the
kernels' shapes through two operators of their own
(``repro_torch::flash_attention_fwd`` and ``_bwd``), whose FLOP formulas
(``forward_flops``: 4 hd flop per kept (query, key) pair and query head;
``backward_flops``: 10 hd, the five products) are registered with
``torch.utils.flop_counter``. So a dry run on ``meta`` counts the
kernel's work and memory, not the plain version's (S x S scores, both
halves of a causal product). The same formulas give ``chip_smoke.py``'s
bounds.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B
from . import ref

SOURCE = B.CSRC / "flash_attention.cu"
SOURCE_BWD = B.CSRC / "flash_attention_bwd.cu"
NVCC_FLAGS = B.BASE_FLAGS
HEAD_DIMS = (32, 64, 128, 256)
# fa_forward and fa_backward return this plus the CUresult when a tensor
# map is refused
ENCODE_ERROR = 10000

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

_LIB = None
_BWD_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _LIB = B.load(SOURCE, NVCC_FLAGS, {
            "fa_forward": [P, P, P, P, P, I, I, I, I, I, I, I,
                           LL, LL, LL, LL, LL, LL, LL, LL, LL, LL, LL, LL,
                           I, I, I, P],
            "fa_smem_bytes": [I],
            "fa_blocks_per_sm": [I, I, ctypes.POINTER(I)]})
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _BWD_LIB = B.load(SOURCE_BWD, NVCC_FLAGS, {
            "fa_backward": [P] * 10 + [I] * 7 + [LL] * 24 + [I, I, I, P],
            "fa_backward_smem_bytes": [I, I, ctypes.POINTER(I),
                                       ctypes.POINTER(I)]})
    return _BWD_LIB


def blocks_per_sm(dtype: torch.dtype, hd: int) -> int:
    """Blocks of the ``dtype`` kernel at head dim ``hd`` that one SM holds
    at once (the CUDA occupancy calculator, with the launch's dynamic
    shared memory)."""
    out = ctypes.c_int(0)
    B.check(_lib().fa_blocks_per_sm(int(dtype == torch.bfloat16), hd,
                                    ctypes.byref(out)), "flash occupancy")
    return out.value


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0):
    """``ref.flash_attention_ref`` computed in float32, cast to q's dtype."""
    f32 = torch.float32
    return ref.flash_attention_ref(q.to(f32), k.to(f32), v.to(f32),
                                   causal=causal, window=window).to(q.dtype)


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("want q (B, Sq, H, hd) and k, v (B, Sk, KV, hd)")
    Bq, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != Bq or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")


def _check_kernel_args(q, k, v) -> None:
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes hd in {HEAD_DIMS}, got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    # 16-byte loads (float32) and TMA (bf16): 16-byte aligned rows
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if any(t.stride(d) % vec for d in range(3)) or t.data_ptr() % 16:
            raise ValueError(f"{name}'s strides and address must allow "
                             f"16-byte loads along hd")


def _check_rc(rc: int, what: str) -> None:
    """Raise on a launch's non-zero return: a refused tensor map
    (ENCODE_ERROR + the CUresult) or a cudaError_t."""
    if rc >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {rc - ENCODE_ERROR}")
    B.check(rc, what)


# ---------------------------------------------------------------------------
# the kernels' work, and their shape-only route
# ---------------------------------------------------------------------------

def kept_pairs(Sq: int, Sk: int, causal: bool = True, window: int = 0) -> int:
    """The (query, key) pairs the masks keep, query i and key j at
    positions i and j (``ref.attention_keep``'s count, without the
    (Sq, Sk) mask)."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=Sk) if causal else torch.full_like(i, Sk)
    lo = (torch.clamp(i - window + 1, min=0) if window
          else torch.zeros_like(i))
    return int(torch.clamp(hi - lo, min=0).sum())


def forward_flops(B: int, Sq: int, Sk: int, H: int, hd: int,
                  causal: bool = True, window: int = 0) -> int:
    """The forward's work: Q K^T and P V, 4 hd flop per kept pair and
    query head."""
    return 4 * hd * kept_pairs(Sq, Sk, causal, window) * B * H


def backward_flops(B: int, Sq: int, Sk: int, H: int, hd: int,
                   causal: bool = True, window: int = 0) -> int:
    """The backward's work: its five products (S, dP, dV, dQ, dK), 10 hd
    flop per kept pair and query head."""
    return 10 * hd * kept_pairs(Sq, Sk, causal, window) * B * H


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> (Tensor, Tensor)")
_OPS.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor do, bool causal, int window) "
            "-> (Tensor, Tensor, Tensor)")


def _fwd_shapes(q, k, v, causal, window):
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                        dtype=torch.float32, device=q.device))


def _bwd_shapes(q, k, v, o, lse, do, causal, window):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


_OPS.impl("flash_attention_fwd", _fwd_shapes, "Meta")
_OPS.impl("flash_attention_bwd", _bwd_shapes, "Meta")


def _flops_of(fn):
    def formula(q_shape, k_shape, *args, out_shape=None, **kwargs):
        causal, window = args[-2:]
        B, Sq, H, hd = q_shape
        return fn(B, Sq, k_shape[1], H, hd, causal, window)
    return formula


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)(
        _flops_of(forward_flops))
    register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)(
        _flops_of(backward_flops))


_register_flops()


def _check_meta_args(*ts) -> None:
    """The kernels' dtype checks, on a shape-only call."""
    if ts[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{ts[0].dtype}")
    for t in ts[1:]:
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{t.dtype} beside q's {ts[0].dtype}")


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype. Query i and key j sit at positions i and j: causal keeps
    j <= i, a window keeps j > i - window. With ``return_lse``, returns
    (out, lse): lse float32 (B, H, Sq), each row's log-sum-exp in base 2
    (``ref.flash_attention_lse``'s convention), which the backward takes;
    without it the kernel stores none."""
    _check_shapes(q, k, v)
    if window < 0:
        raise ValueError(f"window={window}")
    if q.device.type == "meta":
        _check_meta_args(q, k, v)
        out, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, causal, int(window))
        return (out, lse) if return_lse else out
    if B.route(q, "flash attention") == "plain":
        out = flash_attention_plain(q, k, v, causal=causal, window=window)
        if not return_lse:
            return out
        return out, ref.flash_attention_lse(q, k, causal=causal,
                                            window=window)
    _check_kernel_args(q, k, v)
    Bq, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((Bq, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _lib().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.bfloat16), Bq, Sq, Sk, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), q.device.index or 0, B.stream_of(q))
    _check_rc(rc, "flash attention")
    LAUNCHES["flash_attention"] += 1
    return out if lse is None else (out, lse)


def _check_lse(lse, q) -> None:
    want = (q.shape[0], q.shape[2], q.shape[1])
    if not isinstance(lse, torch.Tensor):
        raise TypeError("lse must be the forward's (B, H, Sq) float32 "
                        "tensor")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse is {lse.dtype}, want float32")
    if tuple(lse.shape) != want:
        raise ValueError(f"lse {tuple(lse.shape)} != (B, H, Sq) {want}")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if lse.device != q.device:
        raise ValueError(f"lse is on {lse.device}, q on {q.device}")


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True,
                             window: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal,
    window)``, given its output ``o``, its rows' log-sum-exp ``lse``
    (float32 (B, H, Sq), from ``return_lse=True``) and the output's
    gradient ``do`` (o and do (B, Sq, H, hd) in q's dtype). Returns them
    in the inputs' dtypes."""
    _check_shapes(q, k, v)
    if window < 0:
        raise ValueError(f"window={window}")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    _check_lse(lse, q)
    if q.device.type == "meta":
        _check_meta_args(q, k, v)
        return torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, o, lse, do, causal, int(window))
    if B.route(q, "flash attention backward") == "plain":
        return ref.flash_attention_backward_plain(q, k, v, o, do,
                                                  causal=causal,
                                                  window=window, lse=lse)
    _check_kernel_args(q, k, v)
    o, do = B.aligned(o.to(q.dtype)), B.aligned(do.to(q.dtype))
    _check_kernel_args(o, do, do)
    Bq, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty_like(lse)
    rc = _bwd_lib().fa_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        int(q.dtype == torch.bfloat16), Bq, Sq, Sk, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dv.stride()[:3], int(causal), int(window), q.device.index or 0,
        B.stream_of(q))
    _check_rc(rc, "flash attention backward")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its backward kernels: the forward returns
    (out, lse) and saves q, k, v, out and its rows' log-sum-exp (lse is
    not differentiable); the backward launches
    ``flash_attention_backward``'s kernels. For CUDA and shape-only
    ``meta`` tensors (``kernels/ops.py``, which hands on ``out`` alone); on
    CPU tensors both run their plain versions."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal, ctx.window)
        return dq, dk, dv, None, None
