"""The one timer and roofline bound of the port's kernel measurements
(``kernel_bench`` and ``chip_smoke.py`` both call them).

``time_ms`` is the mean time of a call over a run of calls: on the GPU
between two CUDA events around the run (the device's time, which
includes any gap the host leaves between launches), on the CPU by the
host clock. ``bound`` is the least time the card could take for the same
work: the larger of the bytes over the H100's memory rate and the
operations over its peak rate for their type (``launch/roofline.py``'s
constants, NVIDIA's data sheet at 700 W).
"""
from __future__ import annotations

import time

from ..launch.roofline import HBM_BW

# operations per element of the quantizer kernels, counted from their
# source: the rounding (abs, max, div, mul, floor, sub, compare, add, and
# for the dequantize two multiplies and a select), the murmur hash (two
# multiplies, an add, three shifts, three xors, a shift, a convert, a
# multiply), and the reduce's convert, two multiplies, select, multiply
# and add per client
OPS_ROUND, OPS_DEQ, OPS_HASH, OPS_REDUCE = 8, 3, 12, 6


def time_ms(fn, iters: int, warmup: int = 2, cuda: bool = True) -> float:
    """Mean time of ``fn`` over ``iters`` calls after ``warmup`` calls:
    CUDA events on the current stream, or the host clock with
    ``cuda=False``."""
    import torch
    for _ in range(warmup):
        fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    by_bytes = nbytes / HBM_BW * 1e3
    by_ops = ops / ops_per_s * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")
