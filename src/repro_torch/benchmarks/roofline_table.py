"""Render the roofline table from the port's dry-run records (the
counterpart of the reference's ``benchmarks/roofline_table.py``).

One row per (arch x shape x mesh): the three terms, the dominant one, the
peak of live bytes a device and the useful-flops ratio; with
``--detail`` also the flops and the collective bytes by kind a device.
The records are ``launch/dryrun.py``'s ``--out`` files under the port's
own names,
``results/torch_base_*.json`` (the 256-rank mesh) and
``results/torch_mp_*.json`` (512 ranks); the reference's
``results/base_*.json`` are never read. ``--markdown`` emits a table
body. Under the table, what the records say their collective bytes are:
so far ``DTensor``'s layouts chosen op by op, which set ``collective_s``
and with it the dominant term.

    PYTHONPATH=src python -m repro_torch.benchmarks.run roofline \
        [--markdown] [--detail]
"""
from __future__ import annotations

import argparse
import glob
import json

PATTERNS = ("results/torch_base_*.json", "results/torch_mp_*.json")
HEADER = ("arch", "shape", "pods", "status", "compute_s", "memory_s",
          "collective_s", "dominant", "peak_GiB", "useful_flops")
DETAIL = ("flops", "all-gather", "all-reduce", "reduce-scatter",
          "all-to-all")


def load(patterns=PATTERNS) -> list:
    rows = []
    for pat in patterns:
        for path in sorted(glob.glob(pat)):
            with open(path) as f:
                rows.extend(json.load(f))
    return rows


def render(rows, markdown: bool = False, detail: bool = False) -> list:
    rows = sorted(rows, key=lambda r: (r["arch"], r["shape"], r["multi_pod"]))
    header = HEADER + (DETAIL if detail else ())
    if markdown:
        print("| " + " | ".join(header) + " |")
        print("|" + "---|" * len(header))
    out = []
    for r in rows:
        pods = 2 if r["multi_pod"] else 1
        if r["status"] != "ok":
            vals = (r["arch"], r["shape"], pods, r["status"]) + ("-",) * (
                len(header) - 4)
        else:
            t = r["roofline"]
            ufr = r.get("useful_flops_ratio")
            vals = (r["arch"], r["shape"], pods, "ok",
                    f"{t['compute_s']:.4f}", f"{t['memory_s']:.4f}",
                    f"{t['collective_s']:.4f}", t["dominant"],
                    f"{(r['memory'].get('peak_bytes') or 0) / 2**30:.1f}",
                    f"{ufr:.2f}" if ufr else "-")
            if detail:
                vals += (f"{r['flops_per_device']:.3g}",) + tuple(
                    f"{r['collectives'].get(k, 0):.3g}" for k in DETAIL[1:])
        out.append(vals)
        if markdown:
            print("| " + " | ".join(str(v) for v in vals) + " |")
        else:
            print(("{:28s} {:12s} {:>4} {:8s}"
                   + " {:>10}" * (len(header) - 4)).format(
                       *[str(v) for v in vals]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--detail", action="store_true",
                    help="also the flops and collective bytes by kind")
    args = ap.parse_args(argv)
    rows = load()
    if not rows:
        print("no dry-run records under results/torch_base_*.json or "
              "results/torch_mp_*.json - run PYTHONPATH=src python -m "
              "repro_torch.launch.dryrun ... --out results/torch_base_<name>"
              ".json first")
        return
    render(rows, markdown=args.markdown, detail=args.detail)
    notes = sorted({r["collective_note"] for r in rows
                    if r.get("collective_note")})
    for note in notes:
        print(f"\ncollective_s: {note}.")


if __name__ == "__main__":
    main()
