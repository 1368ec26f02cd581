"""Kernel microbenchmarks of the port (the counterpart of the reference's
``benchmarks/kernel_bench.py``): the time of each CUDA kernel through
``kernels/ops.py``, of its plain PyTorch oracle, and of the unified
``core.compression`` quantize path (hash vs uniform dither), at the
reference's sizes.

The rows and their names are the reference's. On the card (the default
device) each kernel row times the CUDA kernel, and the reference's
``pallas_interp`` in a name becomes ``cuda``. With ``--device cpu`` the
wrappers run their plain versions: ``pallas_interp`` becomes ``plain``,
and every other timed row carries ``_cpu`` at the end. So a card row and
a CPU row never share a name, and ``check_kernel_bench`` never compares
them. The ``wire_bytes_*`` rows are byte counts (``us`` 0), the same on
both.

  * ``quantize_grouped_*`` / ``quantize_encode_*``: streamed vs in-kernel
    dither; ``hbm_arrays/elem`` is the memory traffic contract (3 arrays
    an element when the dither streams from memory, 2 when the kernel
    makes it), ``out_bytes/elem`` the encode's int8 codes plus its f32
    scales;
  * ``wire_bytes_*``: the encoded payload's bytes against the f32 leaf
    for one (R, 1024) leaf, and whether they match the analytic
    ``payload_bytes``.

Times: mean microseconds a call (``timing.time_ms``: CUDA events on the
card, the host clock on the CPU), after every timed call has run in
passes for ``WARM_S`` (one pass on the CPU); on the card each row is
timed ``REPEAT`` times in turns over the rows and its time is the
median. On the card a kernel row's ``derived`` adds ``bound_us``, the
least time the H100 could take for the call (``timing.bound``), and
what bounds it. At these sizes a call moves tens to hundreds of
kilobytes, so a card row measures the launch and the host's pace, not
the kernel's memory rate.

Prints ``name,us_per_call,derived`` CSV rows (the ``benchmarks/run.py``
contract); ``--json PATH`` also dumps ``[{name, us, derived}, ...]`` for
the gate (``check_kernel_bench``). ``--smoke`` takes the reference's CI
sizes: 4k streams, R = 16, attention at S 128, WKV6 at S 64 (else 64k,
R = 128, S 512 and S 256).

    python -m repro_torch.benchmarks.kernel_bench --smoke [--device cpu] \
        [--json out.json]

``pairs`` gives each kernel row's call beside its plain version on the
same tensors, for a check that the timed kernels compute what their
plain versions do (``chip_smoke.py`` makes it).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..api.driver import resolve_device
from ..core import compression as C
from ..kernels import flash_attention as fa
from ..kernels import ops, ref
from ..kernels import quantize_block as qb
from ..kernels import rwkv_scan as rs
from ..launch.roofline import PEAK_FLOPS_F32
from .timing import OPS_DEQ, OPS_HASH, OPS_ROUND, bound, time_ms

# the in-kernel dither's seed (the reference's fold_seed of its key) and
# the compressors' per-leaf seed: a fixed seed, the same work every rep
SEED, LEAF_SEED = 0x2545F491, 2
# a process starts on an idle card, whose clocks rise under load: every
# timed call runs in passes for this long before the first is timed (the
# first rows of a fresh process ran 2x slow without it)
WARM_S = 0.5
# timings of each row on the card, taken in turns over the rows, whose
# median is the row's time: a single warmed timing of a launch-bound row
# read 1.57x another run's on one host
REPEAT = 5


def _gbps(n_elem):
    return lambda us: f"{n_elem * 4 / (us / 1e6) / 1e9:.2f}GB/s"


def _specs(smoke: bool, dev: torch.device) -> list:
    """``(name, fn, derived, plain)`` of each row in the reference's
    order: ``fn`` None for a row that is not timed, ``derived`` the row's
    text as a function of its microseconds, ``plain`` the plain version
    of a kernel row's call on the same tensors (None for the other
    rows)."""
    cuda = dev.type == "cuda"
    route = "cuda" if cuda else "plain"
    tag = "" if cuda else "_cpu"
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = []

    def row(name, fn, derived):
        specs.append((name, fn, derived, None))

    def kernel(name, fn, plain, derived, nbytes, ops):
        if cuda:
            b_ms, by = bound(nbytes, ops, PEAK_FLOPS_F32)
            derived = (derived + " " if derived else "") + \
                f"bound_us={b_ms * 1e3:.3f} bound_by={by}"
        specs.append((name, fn, lambda us, d=derived: d, plain))

    # quantize: the oracle, the kernel, the unified Compressor front end
    qn = 1 << (12 if smoke else 16)
    qtag = "4k" if smoke else "64k"
    x = torch.randn((qn,), generator=gen, device=dev)
    u = torch.rand((qn,), generator=gen, device=dev)
    row(f"quantize_block_ref_{qtag}{tag}",
        lambda: ref.quantize_block_ref(x, u), _gbps(qn))
    kernel(f"quantize_block_{route}_{qtag}",
           lambda: ops.quantize_dequantize_with_dither(x, u),
           lambda: ref.quantize_block_ref(x, u), "",
           12 * qn, (OPS_ROUND + OPS_DEQ) * qn)
    for dither in ("hash", "uniform"):
        comp = C.block_quant(8, 256, dither=dither,
                             kernel_threshold=1 << 30)  # the plain route
        row(f"quantize_compressor_{dither}_{qtag}{tag}",
            lambda c=comp: c.apply([LEAF_SEED], x), _gbps(qn))

    # streamed vs in-kernel dither, (R, 1024) in groups of 256
    R = 1 << (4 if smoke else 7)
    x2 = torch.randn((R, 1024), generator=gen, device=dev)
    u2 = torch.rand((R, 1024), generator=gen, device=dev)
    n2 = x2.numel()
    kernel(f"quantize_grouped_streamed_dither_{R}x1024{tag}",
           lambda: ops.quantize_dequantize_grouped(x2, u2, bits=8,
                                                   group=256),
           lambda: qb.quantize_grouped_plain(x2, u2, bits=8, group=256),
           "hbm_arrays/elem=3", 12 * n2, (OPS_ROUND + OPS_DEQ) * n2)
    kernel(f"quantize_grouped_kernel_dither_{R}x1024{tag}",
           lambda: ops.quantize_dequantize_kernel_dither(
               x2, SEED, bits=8, group=256),
           lambda: qb.quantize_grouped_plain(x2, bits=8, group=256,
                                             seed=SEED),
           "hbm_arrays/elem=2", 8 * n2, (OPS_ROUND + OPS_DEQ + OPS_HASH) * n2)

    # the wire encode: int8 codes + f32 scales, no dequantized array
    kernel(f"quantize_encode_streamed_dither_{R}x1024{tag}",
           lambda: ops.quantize_encode_grouped(x2, u2, bits=8, group=256),
           lambda: qb.quantize_encode_grouped_plain(x2, u2, bits=8,
                                                    group=256),
           "out_bytes/elem=1.016", 9 * n2 + 4 * n2 // 256, OPS_ROUND * n2)
    kernel(f"quantize_encode_kernel_dither_{R}x1024{tag}",
           lambda: ops.quantize_encode_kernel_dither(x2, SEED, bits=8,
                                                     group=256),
           lambda: qb.quantize_encode_grouped_plain(x2, bits=8, group=256,
                                                    seed=SEED),
           "hbm_arrays/elem=2 out_bytes/elem=1.016",
           5 * n2 + 4 * n2 // 256, (OPS_ROUND + OPS_HASH) * n2)

    # the packed payload against the f32 leaf (one leaf; not timed)
    for bits in (8, 4):
        comp = C.block_quant(bits, 256)
        actual = comp.encoded_bytes(comp.encode([LEAF_SEED], x2))
        f32_bytes = n2 * 4
        derived = (f"packed={actual}B f32={f32_bytes}B "
                   f"ratio={f32_bytes / actual:.2f}x "
                   f"analytic_match={int(actual == comp.payload_bytes(x2))}")
        row(f"wire_bytes_b{bits}_{R}x1024", None, lambda us, d=derived: d)

    # flash attention: 4 query heads over 2 KV heads at hd 64, float32
    S_attn = 128 if smoke else 512
    q = torch.randn((1, S_attn, 4, 64), generator=gen, device=dev)
    k = torch.randn((1, S_attn, 2, 64), generator=gen, device=dev)
    v = torch.randn((1, S_attn, 2, 64), generator=gen, device=dev)
    flops = 2 * 2 * S_attn * S_attn * 4 * 64
    row(f"flash_attention_ref_{S_attn}{tag}",
        lambda: ref.flash_attention_ref(q, k, v),
        lambda us: f"{flops / (us / 1e6) / 1e9:.2f}GF/s")
    kernel(f"flash_attention_{route}_{S_attn}",
           lambda: ops.flash_attention(q, k, v),
           lambda: fa.flash_attention_plain(q, k, v), "",
           4 * (2 * q.numel() + k.numel() + v.numel()),
           fa.forward_flops(1, S_attn, S_attn, 4, 64, True, 0))

    # the WKV6 scan: 4 heads at hd 64
    B, S, H, hd = 1, (64 if smoke else 256), 4, 64
    r, kk, vv = (torch.randn((B, S, H, hd), generator=gen, device=dev)
                 for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=gen, device=dev))
    uu = torch.randn((H, hd), generator=gen, device=dev) * 0.1
    row(f"rwkv_scan_ref_{S}{tag}",
        lambda: ref.rwkv_scan_ref(r, kk, vv, w, uu), lambda us: "")
    kernel(f"rwkv_scan_{route}_{S}",
           lambda: ops.rwkv_wkv(r, kk, vv, w, uu),
           lambda: rs.rwkv_scan_plain(r, kk, vv, w, uu), "",
           4 * (5 * r.numel() + uu.numel() + B * H * hd * hd),
           rs.forward_flops(B, S, H, hd))
    return specs


def _rows(smoke: bool, dev: torch.device, repeat: int) -> list:
    cuda = dev.type == "cuda"
    # calls per timing: the card's launch-bound rows need more than the
    # reference's 2 / 5 host-timed reps to settle
    reps = (50 if smoke else 200) if cuda else (2 if smoke else 5)
    specs = _specs(smoke, dev)
    timed = [(name, fn) for name, fn, _, _ in specs if fn is not None]
    t0 = time.perf_counter()
    while True:                       # one pass on the CPU
        for _, fn in timed:
            fn()
        if cuda:
            torch.cuda.synchronize()
        if not cuda or time.perf_counter() - t0 >= WARM_S:
            break
    times = {name: [] for name, _ in timed}
    for _ in range(repeat):           # the rows in turns, repeat times
        for name, fn in timed:
            times[name].append(time_ms(fn, reps, warmup=1, cuda=cuda) * 1e3)
    rows = []
    for name, fn, derived, _ in specs:
        us = statistics.median(times[name]) if fn is not None else 0.0
        rows.append((name, us, derived(us)))
    return rows


def run(smoke: bool = False, device=None) -> list:
    """The rows ``(name, us, derived)`` on ``device`` (the GPU unless the
    caller names another): each timed row's median over ``REPEAT``
    timings on the card, one timing on the CPU."""
    dev = resolve_device(device)
    return _rows(smoke, dev, REPEAT if dev.type == "cuda" else 1)


def pairs(smoke: bool = False, device=None) -> list:
    """``(name, kernel, plain)`` of each kernel row: its timed call and
    its plain version's, on the same tensors as ``run`` times (the same
    seed), for a caller that holds one against the other."""
    return [(name, fn, plain) for name, fn, _, plain in
            _specs(smoke, resolve_device(device)) if plain is not None]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's CI sizes")
    ap.add_argument("--json", default=None,
                    help="also dump the rows as JSON (the gate's input)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    rows = run(smoke=args.smoke, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([{"name": n, "us": us, "derived": d}
                       for n, us, d in rows], f, indent=1)
    return rows


if __name__ == "__main__":
    main()
