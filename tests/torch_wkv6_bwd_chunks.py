"""Steps per chunk of the WKV6 backward kernel, timed on the card.

Builds ``csrc/rwkv_scan_bwd.cu`` once for each chunk length L at hd 64
(the source's ``Steps<64>::L`` replaced in a copy under ``build/``) and
launches each through ``rwkv_scan.rwkv_scan_backward(..., lib=...)``.
With ``--parent SRC``, the ``rwkv_scan_backward`` of another checkout's
package (its ``src`` directory, for example the parent commit unpacked by
``git archive``) runs beside them as that checkout builds it. Each
version is checked against ``ref.rwkv_scan_backward_plain`` at B 1, S 300,
H 2 (bf16, with the final state's gradient, 2e-2 of max |want| per
output), then timed at rwkv6-3b's train shape (bf16, B 1, S 2048, H 40,
hd 64) with CUDA events (20 calls), and each kernel's device time per call
is read from ``torch.profiler`` (5 calls). Every version runs in a process
of its own, first to last, then last to first. Prints the card, then as
its last line one JSON object (with ptxas' registers and spills of each
variant's hd 64 bf16 kernels). Not collected by pytest; needs a CUDA
device and ``nvcc``::

    PYTHONPATH=src python tests/torch_wkv6_bwd_chunks.py --chunks 16,32,64
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import rwkv_scan as rs

STEPS_64 = "struct Steps<64> { static constexpr int L = 32; };"
TRAIN_SHAPE = (1, 2048, 40, 64)
CHECK_SHAPE = (1, 300, 2, 64)
BF16_TOL = 2e-2
PROFILED_CALLS = 5


def variant(L: int) -> Path:
    """A copy of the source with L steps per chunk at hd 64."""
    src = rs.SOURCE_BWD.read_text()
    if STEPS_64 not in src:
        raise RuntimeError(f"{rs.SOURCE_BWD} holds no '{STEPS_64}'")
    path = build.BUILD_DIR / f"{rs.SOURCE_BWD.stem}_L{L}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(STEPS_64, STEPS_64.replace("32", str(L))))
    return path


def inputs(shape, seed, with_dstate=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, S, H, hd = shape
    normal = lambda *s: torch.randn(s, generator=gen, device="cuda")
    r, k, v, dy = (normal(B, S, H, hd).to(torch.bfloat16) for _ in range(4))
    w = torch.exp(-torch.exp(normal(B, S, H, hd) - 2.0)).to(torch.bfloat16)
    u = 0.1 * normal(H, hd)
    dstate = normal(B, H, hd, hd) if with_dstate else None
    return r, k, v, w, u, dy, dstate


def ptxas(report: str) -> dict:
    """Registers and spill stores of each hd 64 bf16 kernel (and the
    carry) in ptxas' report."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        m = re.search(r"(wkv6_bwd_[a-z]+)I", name)
        if m and ("13__nv_bfloat16Li64E" in name or "carryILi64E" in name):
            num = lambda pat: max(map(int, re.findall(pat, block)), default=0)
            out[m.group(1)] = {"registers": num(r"Used (\d+) registers"),
                               "spill_store_bytes":
                                   num(r"(\d+) bytes spill stores")}
    return out


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phases_ms(fn) -> dict:
    """Device time per kernel name, ms per call, over PROFILED_CALLS
    calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"wkv6_bwd_\w+", ev.key)
        if m and ev.device_time_total > 0:
            out[m.group(0)] = ev.device_time_total / PROFILED_CALLS / 1e3
    return out


def one(source: str) -> dict:
    """Check and time one version in this process: the library built from
    ``source``, or, for "", this process's own ``rwkv_scan_backward``."""
    lib = (build.load(Path(source), rs.NVCC_FLAGS, rs.BWD_SIGNATURES)
           if source else None)
    backward = (lambda *a: rs.rwkv_scan_backward(*a, lib=lib)) if lib \
        else rs.rwkv_scan_backward
    small = inputs(CHECK_SHAPE, 0, with_dstate=True)
    want = ref.rwkv_scan_backward_plain(*small)
    got = backward(*small)
    ratios = [float((g.float() - x.float()).abs().max()
                    / x.float().abs().max()) for g, x in zip(got, want)]
    if max(ratios) > BF16_TOL:
        raise SystemExit(f"{source or 'rwkv_scan_backward'} differs from "
                         f"the plain backward: {ratios}")
    big = inputs(TRAIN_SHAPE, 1)[:6]
    return {"check_err_over_max": max(ratios),
            "ms": time_ms(lambda: backward(*big)),
            "phases_ms": phases_ms(lambda: backward(*big))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="16,32,64",
                    help="steps per chunk at hd 64, comma-separated")
    ap.add_argument("--parent", default=None,
                    help="the src directory of another checkout, whose "
                         "rwkv_scan_backward runs beside the variants")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.one is not None:
        print(json.dumps(one(args.one)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    versions = {f"L{L}": variant(int(L)) for L in args.chunks.split(",")}
    build.build_many([(p, rs.NVCC_FLAGS) for p in versions.values()],
                     force=True)
    result = {"card": card, "shape": list(TRAIN_SHAPE), "dtype": "bf16",
              "versions": {name: {"ms": [], "ptxas": ptxas(
                  build.BUILD_INFO.get(p.name, ""))}
                  for name, p in versions.items()}}
    runs = {name: (str(p), os.environ) for name, p in versions.items()}
    if args.parent:
        result["versions"]["parent"] = {"ms": []}
        runs["parent"] = ("", dict(os.environ, PYTHONPATH=str(
            Path(args.parent).resolve())))
    for name in list(runs) + list(runs)[::-1]:
        source, env = runs[name]
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", source],
            capture_output=True, text=True, timeout=900, env=env)
        rec = result["versions"][name]
        if proc.returncode != 0:
            rec.setdefault("errors", []).append(
                proc.stderr.strip().splitlines()[-1:])
            continue
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["ms"].append(out.pop("ms"))
        rec.update(out)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
