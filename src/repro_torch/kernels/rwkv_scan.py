"""The RWKV6 WKV recurrence: a CUDA kernel for Hopper, its plain PyTorch
version beside it.

Replaces ``rwkv_scan_pallas`` (``repro/kernels/rwkv_scan.py``): per
(batch, head), with a float32 state S (hd x hd) from zero,
``y_t = r_t . (S_t + diag(u) k_t^T v_t)`` and
``S_{t+1} = diag(w_t) S_t + k_t^T v_t``; r, k, v, w (B, S, H, hd),
u (H, hd). Returns y in r's dtype and the final state (B, H, hd, hd)
float32.

On the H100 the float32 operations bound it (5 flop per state element and
step, the rank-one u bonus aside; the bytes take about two thirds as
long). The kernel in ``csrc/rwkv_scan.cu`` applies the recurrence step by
step, so it keeps the instructions per state element and step low: each
thread holds a register tile of the state (at hd 64, 16 consecutive rows
x 2 columns) for the whole sequence, reads its rows of r, k, w as
16-byte shared loads, and spends 3 FP32 instructions per element and
step; the u bonus is rank one (``p_t v_c`` with
``p_t = sum_k r_k u_k k_k``, formed once per step); each thread leaves its
part of y in shared memory, summed over the row groups once per chunk.
Chunks of 2048 / hd steps are brought into shared memory with ``cp.async``
while the previous chunk is computed, and widened from bf16 to f32 once.
It takes hd 16, 32, 64 and 128, float32 and bfloat16, with 16-byte aligned
inputs. What bounds it now is one block's chain of steps and the SMs that
hold two blocks (``PERF.md``).

The backward, ``rwkv_scan_backward`` (dr, dk, dv, dw, du from the inputs,
dy and the final state's gradient), is a kernel of its own source,
``csrc/rwkv_scan_bwd.cu``, built apart so that the forward's library
stays what it was. It cuts the sequence into chunks of L steps (32 at
hd 64; ``wkv6_backward_chunk``) and runs three phases in one call: each
chunk's own state, own gradient and decay product from zero, a block per
(batch, head, chunk); the carry of the state forward and of its gradient
backward over the chunks, a thread per two state elements; then each
chunk's gradients from its start state and end gradient, a block per
(batch, head, chunk). No state is recovered by dividing by a decay. du
comes back as partials per (batch, head, chunk), which the wrapper sums.
``WKV6Fn`` ties the two kernels together as a
``torch.autograd.Function`` over the float32 ``u``, which
``kernels/ops.py`` applies to CUDA tensors (the cast of ``u`` stays
outside it, so autograd carries du back to u's dtype).

``rwkv_scan`` and ``rwkv_scan_backward`` take the plain versions for CPU
tensors, launch their kernels for CUDA tensors, and raise for anything
else; a CUDA tensor never falls back. ``LAUNCHES`` counts the kernels'
launches (``rwkv_scan``, ``rwkv_scan_bwd``); only a launch adds to it.

Shape-only (``meta``) tensors return empty outputs of the kernels' shapes
through two operators of their own (``repro_torch::wkv6_fwd`` and
``_bwd``), whose FLOP formulas (``forward_flops``, ``backward_flops``:
the operation counts of ``chip_smoke.py``'s bounds) are registered with
``torch.utils.flop_counter``: a dry run counts the kernel's work, not the
plain loop's.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B
from . import ref

SOURCE = B.CSRC / "rwkv_scan.cu"
SOURCE_BWD = B.CSRC / "rwkv_scan_bwd.cu"
NVCC_FLAGS = B.BASE_FLAGS
HEAD_DIMS = (16, 32, 64, 128)

LAUNCHES = {"rwkv_scan": 0, "rwkv_scan_bwd": 0}

_LIB = None
_BWD_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"wkv6_forward": [_P] * 7 + [_I] * 6 + [_P],
              "wkv6_smem_bytes": [_I, _I]}
BWD_SIGNATURES = {
    "wkv6_backward": [_P] * 13 + [_I] * 6 + [_P],
    "wkv6_backward_scratch": [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)],
    "wkv6_backward_chunk": [_I],
    "wkv6_backward_smem_bytes": [_I],
    "wkv6_backward_phase_smem_bytes": [_I, _I]}


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = B.load(SOURCE, NVCC_FLAGS, SIGNATURES)
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        _BWD_LIB = B.load(SOURCE_BWD, NVCC_FLAGS, BWD_SIGNATURES)
    return _BWD_LIB


def rwkv_scan_plain(r, k, v, w, u):
    """``ref.rwkv_scan_ref``: a loop over time in float32."""
    return ref.rwkv_scan_ref(r, k, v, w, u)


def _check_shapes(r, k, v, w, u) -> None:
    if r.ndim != 4:
        raise ValueError(f"want r (B, S, H, hd), got {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u {tuple(u.shape)} != (H, hd) {tuple(r.shape[2:])}")


def _check_kernel_args(r, k, v, w) -> None:
    hd = r.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes hd in {HEAD_DIMS}, got {hd}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def forward_flops(B: int, S: int, H: int, hd: int) -> int:
    """The forward's float32 work: per state element and step, S <- w S +
    k v (a multiply and an FMA) and r . S (an FMA), 5 flop; the u bonus is
    rank one, (sum_k r_k u_k k_k) v, 5 flop per (step, head, channel)."""
    n = B * S * H * hd
    return 5 * n * hd + 5 * n


def backward_flops(B: int, S: int, H: int, hd: int) -> int:
    """The backward's float32 work: per state element and step, the state
    rebuilt (2 flop), dk, dv, dw, dr (2 each) and G (2): 12 flop."""
    return 12 * B * S * H * hd * hd


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("wkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u) "
            "-> (Tensor, Tensor)")
_OPS.define("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
            "Tensor dy) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def _fwd_shapes(r, k, v, w, u):
    Bn, _, H, hd = r.shape
    return (torch.empty(r.shape, dtype=r.dtype, device=r.device),
            torch.empty((Bn, H, hd, hd), dtype=torch.float32,
                        device=r.device))


def _bwd_shapes(r, k, v, w, u, dy):
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (r, k, v, w, u))


_OPS.impl("wkv6_fwd", _fwd_shapes, "Meta")
_OPS.impl("wkv6_bwd", _bwd_shapes, "Meta")


def _flops_of(fn):
    def formula(r_shape, *args, out_shape=None, **kwargs):
        return fn(*r_shape)
    return formula


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula
    register_flop_formula(torch.ops.repro_torch.wkv6_fwd)(
        _flops_of(forward_flops))
    register_flop_formula(torch.ops.repro_torch.wkv6_bwd)(
        _flops_of(backward_flops))


_register_flops()


def _check_meta_dtypes(r, k, v, w) -> None:
    """The kernel's dtype checks, on a shape-only call."""
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{r.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")


def rwkv_scan(r, k, v, w, u):
    """r, k, v, w: (B, S, H, hd); u: (H, hd). Returns (y (B, S, H, hd) in
    r's dtype, final state (B, H, hd, hd) float32)."""
    _check_shapes(r, k, v, w, u)
    if r.device.type == "meta":
        _check_meta_dtypes(r, k, v, w)
        return torch.ops.repro_torch.wkv6_fwd(r, k, v, w, u)
    if B.route(r, "RWKV scan") == "plain":
        return rwkv_scan_plain(r, k, v, w, u)
    _check_kernel_args(r, k, v, w)
    Bn, S, H, hd = r.shape
    u32 = as_u32(u, r)
    y = torch.empty_like(r)
    state = torch.empty((Bn, H, hd, hd), dtype=torch.float32, device=r.device)
    rc = _lib().wkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u32.data_ptr(), y.data_ptr(), state.data_ptr(),
        int(r.dtype == torch.bfloat16), Bn, S, H, hd, r.device.index or 0,
        B.stream_of(r))
    B.check(rc, "RWKV scan")
    LAUNCHES["rwkv_scan"] += 1
    return y, state


def as_u32(u, r):
    """u as the kernels read it: float32, contiguous, on r's device."""
    return u.to(device=r.device, dtype=torch.float32).contiguous()


def rwkv_scan_backward(r, k, v, w, u, dy, dstate=None, *, lib=None):
    """Gradients (dr, dk, dv, dw, du) of ``rwkv_scan(r, k, v, w, u)`` given
    the gradient ``dy`` of y (r's shape) and ``dstate`` of the final state
    ((B, H, hd, hd) float32, or None for zero). dr, dk, dv, dw come in
    their inputs' dtypes, du (H, hd) in u's. ``lib``: a library of the
    backward's C API to launch instead of ``csrc/rwkv_scan_bwd.cu``'s (a
    build of an edited copy, to compare versions)."""
    _check_shapes(r, k, v, w, u)
    if dy.shape != r.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != r {tuple(r.shape)}")
    if r.device.type == "meta":
        _check_meta_dtypes(r, k, v, w)
        return torch.ops.repro_torch.wkv6_bwd(r, k, v, w, u, dy)
    if B.route(r, "RWKV scan backward") == "plain":
        return ref.rwkv_scan_backward_plain(r, k, v, w, u, dy, dstate)
    _check_kernel_args(r, k, v, w)
    dy = B.aligned(dy.to(r.dtype))
    Bn, S, H, hd = r.shape
    if dstate is not None:
        if tuple(dstate.shape) != (Bn, H, hd, hd):
            raise ValueError(f"dstate {tuple(dstate.shape)} != "
                             f"{(Bn, H, hd, hd)}")
        dstate = B.aligned(dstate.to(device=r.device, dtype=torch.float32))
    u32 = as_u32(u, r)
    lib = lib or _bwd_lib()
    floats = ctypes.c_longlong(0)
    B.check(lib.wkv6_backward_scratch(Bn, S, H, hd, ctypes.byref(floats)),
            "RWKV scan backward scratch")
    scratch = torch.empty((floats.value,), dtype=torch.float32,
                          device=r.device)
    grads = [torch.empty_like(r) for _ in range(4)]
    n_chunks = -(-S // lib.wkv6_backward_chunk(hd))
    du_part = torch.empty((Bn, H, n_chunks, hd), dtype=torch.float32,
                          device=r.device)
    rc = lib.wkv6_backward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u32.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(),
        *(g.data_ptr() for g in grads), du_part.data_ptr(),
        scratch.data_ptr(), int(r.dtype == torch.bfloat16), Bn, S, H, hd,
        r.device.index or 0, B.stream_of(r))
    B.check(rc, "RWKV scan backward")
    LAUNCHES["rwkv_scan_bwd"] += 1
    dr, dk, dv, dw = grads
    return dr, dk, dv, dw, du_part.sum((0, 2)).to(u.dtype)


class WKV6Fn(torch.autograd.Function):
    """``rwkv_scan`` with its backward kernel, over the float32 ``u32``
    (``as_u32``): returns (y, final state); the backward launches
    ``rwkv_scan_backward``'s kernel, with the state's gradient when the
    caller used the state and zero otherwise. For CUDA and shape-only
    ``meta`` tensors (``kernels/ops.py``)."""

    @staticmethod
    def forward(r, k, v, w, u32):
        return rwkv_scan(r, k, v, w, u32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u32 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return rwkv_scan_backward(r, k, v, w, u32, dy, dstate)
