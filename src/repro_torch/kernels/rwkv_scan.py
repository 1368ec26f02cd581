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
long), and a serial recurrence
reaches neither bound: the time is the steps times one step's dependent
chain. The kernel in ``csrc/rwkv_scan.cu`` keeps the state in registers,
4 threads per state column (hd / 4 rows each), walks time inside the
kernel with chunks of r, k, w and v staged in shared memory, and adds the
four parts of each output with two shuffles. It takes hd 32, 64 and 128,
float32 and bfloat16.

``rwkv_scan`` takes the plain version for CPU (and shape-only ``meta``)
tensors, launches the kernel for CUDA tensors, and raises for anything
else; a CUDA tensor never falls back. ``LAUNCHES`` counts the kernel's
launches; only a launch adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B
from . import ref

SOURCE = B.CSRC / "rwkv_scan.cu"
NVCC_FLAGS = B.BASE_FLAGS
HEAD_DIMS = (32, 64, 128)

LAUNCHES = {"rwkv_scan": 0}

_LIB = None


def reset_launches() -> None:
    LAUNCHES["rwkv_scan"] = 0


def _lib():
    global _LIB
    if _LIB is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _LIB = B.load(SOURCE, NVCC_FLAGS, {
            "wkv6_forward": [P, P, P, P, P, P, P, I, I, I, I, I, I, P]})
    return _LIB


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


def rwkv_scan(r, k, v, w, u):
    """r, k, v, w: (B, S, H, hd); u: (H, hd). Returns (y (B, S, H, hd) in
    r's dtype, final state (B, H, hd, hd) float32)."""
    _check_shapes(r, k, v, w, u)
    if B.route(r, "RWKV scan") == "plain":
        return rwkv_scan_plain(r, k, v, w, u)
    _check_kernel_args(r, k, v, w)
    Bn, S, H, hd = r.shape
    u32 = u.to(device=r.device, dtype=torch.float32).contiguous()
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
