"""The quantizer throughput gate of the port (the counterpart of the
reference's ``benchmarks/check_kernel_bench.py``): fails when a quantize
row of a fresh ``kernel_bench --smoke --json`` run is slower than the
committed baseline by more than ``--tol``.

Compares the ``quantize_*`` rows of the fresh run against the
``pair == "kernel_bench_smoke"`` entry of ``results/perf_log_torch.json``
(a card run's rows; the entry names the card, its power limit and the
command). A row fails when it is more than ``--tol`` (default 25%) SLOWER
than its baseline ``us``. Rows present in only one of the two sets are
reported (NEW, GONE) but do not fail the gate. Row names carry their
route (``kernel_bench``): a CPU run's rows never match a card run's, so
they come out NEW, never compared.

The baseline is time on the card that committed it. So that a uniformly
slower card (a lower power limit, a busier host) does not trip the gate
without a code change, each row's slowdown is divided by the MEDIAN
slowdown over all matched quantize rows (the drift factor, never below
1): a row fails when it is ``--tol`` slower than the baseline beyond
what every row shares. Blind spot: a change that slows every quantize
row by the same factor reads as drift; the raw ratios are printed so a
reader still sees it. With no baseline (no file, or no entry) the gate
is skipped and exits 0.

``--json`` may be given more than once: a row's fresh time is then its
median over the runs. ``--write-baseline PATH`` writes those medians as
the baseline entry instead of gating them, with the card's name and
power limit as ``nvidia-smi`` prints them.

    python -m repro_torch.benchmarks.kernel_bench --smoke --json out.json
    python -m repro_torch.benchmarks.check_kernel_bench --json out.json \
        [--json out2.json ...] [--baseline results/perf_log_torch.json] \
        [--tol 0.25] [--write-baseline PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

DEFAULT_BASELINE = "results/perf_log_torch.json"
PAIR = "kernel_bench_smoke"


def _quantize_rows(rows) -> dict:
    return {r["name"]: r["us"] for r in rows
            if r["name"].startswith("quantize_") and r["us"] > 0}


def _median_rows(paths) -> list:
    """The rows of the first run, each timed row's ``us`` the median over
    the runs that have it."""
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f))
    times: dict = {}
    for rows in runs:
        for r in rows:
            times.setdefault(r["name"], []).append(r["us"])
    return [dict(r, us=statistics.median(times[r["name"]]))
            for r in runs[0]]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def write_log(log_path: str, pair: str, entries: list) -> None:
    """Replace ``pair``'s entries of the log at ``log_path`` with
    ``entries``; every other entry is written back as it was read."""
    log = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)
    log = [e for e in log if e.get("pair") != pair] + list(entries)
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    with open(log_path, "w") as f:
        json.dump(log, f, indent=1)
        f.write("\n")


def write_baseline(path: str, rows: list, n_runs: int, card: str) -> None:
    import torch
    entry = {
        "pair": PAIR, "variant": "baseline",
        "hypothesis": (
            f"committed card baseline of the port's quantize throughput "
            f"gate (python -m repro_torch.benchmarks.check_kernel_bench, "
            f"tol 25%): each row the median over {n_runs} runs, each in a "
            f"fresh process, of `python -m repro_torch.benchmarks."
            f"kernel_bench --smoke --json` (each run a row's median over "
            f"its REPEAT timings after the warm-up) on {card} "
            f"(nvidia-smi --query-gpu=name,power.limit), torch "
            f"{torch.__version__}"),
        "multi_pod": False,
        "result": {"status": "ok", "rows": rows}}
    write_log(path, PAIR, [entry])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", required=True, action="append",
                    help="fresh kernel_bench rows (repeatable: the median "
                         "over the runs)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--tol", type=float, default=0.25,
                    help="max fractional slowdown before failing")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="write the fresh rows as the baseline entry and "
                         "exit")
    args = ap.parse_args(argv)

    rows = _median_rows(args.json)
    if args.write_baseline:
        write_baseline(args.write_baseline, rows, len(args.json), _card())
        print(f"baseline of {len(args.json)} run(s) written to "
              f"{args.write_baseline}")
        return 0
    fresh = _quantize_rows(rows)
    base_entry = None
    if os.path.exists(args.baseline):
        with open(args.baseline) as f:
            base_entry = next((e for e in json.load(f)
                               if e.get("pair") == PAIR), None)
    if base_entry is None:
        print(f"no {PAIR} baseline in {args.baseline}; skipping gate")
        return 0
    base = _quantize_rows(base_entry["result"]["rows"])

    ratios = sorted(us / base[n] for n, us in fresh.items() if n in base)
    drift = 1.0
    if ratios:
        mid = ratios[len(ratios) // 2] if len(ratios) % 2 else \
            0.5 * (ratios[len(ratios) // 2 - 1] + ratios[len(ratios) // 2])
        drift = max(1.0, mid)
    print(f"machine drift factor (median slowdown): {drift:.2f}x\n")

    failed = []
    for name, us in sorted(fresh.items()):
        if name not in base:
            print(f"NEW   {name}: {us:.1f}us (no baseline)")
            continue
        ratio = us / base[name]
        status = "FAIL" if ratio / drift > 1.0 + args.tol else "ok"
        print(f"{status:5s} {name}: {us:.1f}us vs baseline "
              f"{base[name]:.1f}us ({ratio:.2f}x raw, "
              f"{ratio / drift:.2f}x drift-adjusted)")
        if status == "FAIL":
            failed.append(name)
    for name in sorted(set(base) - set(fresh)):
        print(f"GONE  {name} (was {base[name]:.1f}us)")

    if failed:
        print(f"\nquantize throughput regressed >{args.tol:.0%} on: "
              f"{', '.join(failed)}")
        return 1
    print("\nquantize throughput within tolerance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
