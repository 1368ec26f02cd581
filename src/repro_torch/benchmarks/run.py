"""Benchmark entry point and the shared figure harness (the counterpart of
the reference's ``benchmarks/run.py``).

``harness`` is the one run loop the figure reproductions build on: it
drives ``repro_torch.api.run``, times the trajectory (``api.run``'s history
is read back to the host, so the time includes the device's work), and
returns the history as a list of float dicts.

    python -m repro_torch.benchmarks.run [--full] [--device cpu] \
        [--skip kernels,fig1,fig2,fig3,roofline]
    python -m repro_torch.benchmarks.run kernels [--smoke] [--device cpu] \
        [--json out.json]
    python -m repro_torch.benchmarks.run roofline [--markdown]

``kernels`` runs the kernel microbenchmarks (``kernel_bench``: CSV rows
``name,us_per_call,derived``) and nothing else; the full run starts with
them (the reference's sizes, not ``--smoke``). ``roofline`` renders the
roofline table of the dry run's records (``roofline_table``) and nothing
else; the full run ends with it when records exist.

Reduced sizes by default (Fig. 1 and Fig. 2 80 rounds; Fig. 3 dims 4, 8,
16 and 40 rounds); ``--full`` is the paper's scale (300 rounds; Fig. 3
dims 16, 32, 64 and 100 rounds). The GPU unless ``--device`` names
another.
"""
from __future__ import annotations

import argparse
import time

from .. import api


def harness(problem, x0, data, schedule, *, rounds=None, **kw):
    """Run one trajectory of ``api.run`` (``kw`` goes to it as it is) and
    return ``(final_state, history list of float dicts, seconds)``."""
    t0 = time.perf_counter()
    state, hist = api.run(problem, x0, data, schedule, n_rounds=rounds, **kw)
    hist = api.history_list(hist)
    return state, hist, time.perf_counter() - t0


def figure_args(doc: str, argv=None, skip: bool = False):
    """The figure scripts' command line: ``--full``, ``--device`` (and
    ``--skip`` for this entry point)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--full", action="store_true",
                    help="the paper's sizes (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    if skip:
        ap.add_argument("--skip", default="",
                        help="comma list: kernels,fig1,fig2,fig3,roofline")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["roofline"]:
        from . import roofline_table
        roofline_table.main(argv[1:])
        return
    if argv[:1] == ["kernels"]:
        from . import kernel_bench
        kernel_bench.main(argv[1:])
        return
    args = figure_args(__doc__, argv, skip=True)
    skip = set(args.skip.split(","))
    reduced = not args.full
    rounds = 300 if args.full else 80
    if "kernels" not in skip:
        print("=== kernel microbenchmarks (name,us_per_call,derived) ===")
        from . import kernel_bench
        kernel_bench.main([] if args.device is None
                          else ["--device", args.device])
    if "fig1" not in skip:
        print("\n=== Figure 1: aggregation space (FedMM vs naive) ===")
        from . import fig1_dictlearn
        fig1_dictlearn.main(reduced=reduced, rounds=rounds,
                            device=args.device)
    if "fig2" not in skip:
        print("\n=== Figure 2: control variates ===")
        from . import fig2_control_variates
        fig2_control_variates.main(reduced=reduced, rounds=rounds,
                                   device=args.device)
    if "fig3" not in skip:
        print("\n=== Figure 3: FedMM-OT vs FedAdam (L2-UVP) ===")
        from . import fig3_ot
        fig3_ot.main(dims=(4, 8, 16) if reduced else (16, 32, 64),
                     rounds=40 if reduced else 100, device=args.device)
    if "roofline" not in skip:
        from . import roofline_table
        rows = roofline_table.load()
        if rows:
            print("\n=== Roofline table (the dry run's records) ===")
            roofline_table.render(rows)


if __name__ == "__main__":
    main()
