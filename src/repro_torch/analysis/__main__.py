"""CLI: ``python -m repro_torch.analysis <paths...> [--strict] [--json out]``
(the counterpart of ``python -m repro.analysis``).

Exit codes: 0 clean; 1 findings (or, under --strict, a blown pragma
budget); 2 usage errors. ``--contracts`` also runs ``check_compressor``
over the block-quantizer family on shape-only ``meta`` tensors (no
device, no kernel launch).

``--baseline <file>`` turns findings into a RATCHET: only findings not
covered by the committed baseline fail the run, so a new rule can land
tree-wide without a pragma flood: the debt is frozen, new debt is not.
``--write-baseline <file>`` freezes the current findings (a previous
``--json`` report is also accepted as a baseline). Baselines bucket by
(rule, file): see ``Finding.baseline_key``.

A plain lint run imports the standard library only: neither torch nor
jax.
"""
from __future__ import annotations

import argparse
import json
import sys

from .linter import SCHEMA_VERSION, lint_paths
from .rules import get_rules, rule_table

DEFAULT_PATH = "src/repro_torch"
DEFAULT_MAX_PRAGMAS = 4


def _baseline_counts(findings) -> dict:
    counts: dict = {}
    for f in findings:
        counts[f.baseline_key] = counts.get(f.baseline_key, 0) + 1
    return counts


def _load_baseline(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if "baseline" in data:
        return {str(k): int(v) for k, v in data["baseline"].items()}
    if "findings" in data:      # a --json report doubles as a baseline
        counts: dict = {}
        for f in data["findings"]:
            if f.get("suppressed"):
                continue
            key = f"{f['rule']} {f['path']}"
            counts[key] = counts.get(key, 0) + 1
        return counts
    raise ValueError(f"{path}: neither a baseline nor a lint report")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="torch invariant + generator-lineage linter of the "
                    "port (rules RPL001-RPL009, RPL006 dropped) + "
                    "compressor contract checker")
    ap.add_argument("paths", nargs="*", default=[],
                    help=f"files or directories to lint (default: "
                         f"{DEFAULT_PATH})")
    ap.add_argument("--strict", action="store_true",
                    help="fail on any active finding AND enforce the "
                         "allow-pragma budget (--max-pragmas)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full report (findings + pragmas) as "
                         "JSON")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (e.g. RPL001,RPL007)")
    ap.add_argument("--max-pragmas", type=int, default=DEFAULT_MAX_PRAGMAS,
                    help="strict-mode budget of valid allow-pragmas in the "
                         "scanned tree (default %(default)s)")
    ap.add_argument("--exclude", action="append", default=[],
                    metavar="SUBSTR",
                    help="skip files whose path contains SUBSTR "
                         "(repeatable; e.g. --exclude tests/"
                         "torch_analysis_corpus)")
    ap.add_argument("--baseline", metavar="PATH", default=None,
                    help="ratchet mode: fail only on findings beyond the "
                         "committed baseline (per rule+file counts)")
    ap.add_argument("--write-baseline", metavar="PATH", default=None,
                    help="freeze the current active findings as a baseline "
                         "file and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--contracts", action="store_true",
                    help="also run check_compressor over the "
                         "block-quantizer family on meta tensors")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(rule_table())
        return 0

    paths = args.paths or [DEFAULT_PATH]
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        try:
            get_rules(rules)
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2

    report = lint_paths(paths, rules=rules, exclude=args.exclude)

    for f in report.findings:
        print(f.format())
    n_files = len(report.files)
    print(f"checked {n_files} file{'s' if n_files != 1 else ''}: "
          f"{len(report.active)} finding(s), "
          f"{len(report.suppressed)} suppressed, "
          f"{report.pragma_count} allow-pragma(s)")

    if args.write_baseline:
        payload = {"schema_version": SCHEMA_VERSION,
                   "baseline": _baseline_counts(report.active)}
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
        print(f"baseline ({len(report.active)} finding(s)) written to "
              f"{args.write_baseline}")

    # freezing a baseline is how debt gets ratcheted: the findings just
    # written ARE the baseline, so they no longer block this run
    blocking = [] if args.write_baseline else report.active
    if args.baseline:
        try:
            base = _load_baseline(args.baseline)
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            print(f"--baseline: {e}", file=sys.stderr)
            return 2
        counts = _baseline_counts(report.active)
        over = {k: c - base.get(k, 0) for k, c in counts.items()
                if c > base.get(k, 0)}
        n_new = sum(over.values())
        blocking = []
        seen: dict = {}
        for f in report.active:     # attribute the counts to findings
            seen[f.baseline_key] = seen.get(f.baseline_key, 0) + 1
            if seen[f.baseline_key] > base.get(f.baseline_key, 0):
                blocking.append(f)
        print(f"baseline: {len(report.active) - n_new} finding(s) "
              f"covered, {n_new} new")

    rc = 0
    if blocking:
        rc = 1
    if args.strict and report.pragma_count > args.max_pragmas:
        print(f"--strict: {report.pragma_count} allow-pragmas exceed the "
              f"budget of {args.max_pragmas}", file=sys.stderr)
        rc = 1

    if args.contracts:
        rc = max(rc, _run_contracts())

    if args.json:
        report.dump_json(args.json)
        print(f"report written to {args.json}")
    return rc


def _run_contracts() -> int:
    """``check_compressor`` over the reference's ``_run_contracts`` family
    (both shard_safe modes x bits 2, 4, 6, 8 x with and without a
    checksum, then ``rand_k(0.25)``) on a ``meta`` tree of a (64, 256)
    and a (256,) float32 leaf. Imports torch, so plain lint runs stay
    standard-library only."""
    import torch

    from ..core import compression
    from .contracts import check_compressor

    tree = {"w": torch.empty((64, 256), dtype=torch.float32, device="meta"),
            "b": torch.empty((256,), dtype=torch.float32, device="meta")}
    bad = 0
    for shard_safe in (False, True):
        for bits in (2, 4, 6, 8):
            for checksum in (False, True):
                comp = compression.block_quant(bits=bits, block=256,
                                               shard_safe=shard_safe,
                                               checksum=checksum)
                rep = check_compressor(comp, tree)
                status = "ok" if rep.ok else "FAIL"
                print(f"contract {comp.name:32s} "
                      f"{'+ck ' if checksum else '    '}{status}")
                for v in rep.violations:
                    print(f"  {v.contract}: {v.detail}")
                bad += 0 if rep.ok else 1
    rand = compression.rand_k(0.25)
    rep = check_compressor(rand, tree)
    print(f"contract {rand.name:32s}     {'ok' if rep.ok else 'FAIL'}")
    bad += 0 if rep.ok else 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
