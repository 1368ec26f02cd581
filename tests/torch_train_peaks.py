"""The peak device bytes of ``chip_smoke.py``'s train rounds, counted on
``meta`` tensors at one chip by the dry run's ``count_train_step`` (the
step's arguments included, as ``MemTracker`` sees them) at each run's own
depth, clients and tokens. No card: it runs on the CPU, and nothing is
allocated. The package is this checkout's (``src`` beside the script):
to set two versions' counts side by side, run a copy of the script in the
other checkout (for example the parent commit unpacked by ``git
archive``). Not collected by pytest::

    python tests/torch_train_peaks.py [--runs train_gemma3]

Prints one line a run and, last, one JSON object ``{run: peak bytes}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default=None,
                    help="comma-separated names of chip_smoke.TRAIN_RUNS "
                         "(default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS    # it puts this checkout's src first
    from repro_torch.fed import trainer as FT
    from repro_torch.launch import dryrun as D

    names = args.runs.split(",") if args.runs else list(CS.TRAIN_RUNS)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        cfg, shape, _, n = CS._phase_of(name)
        fcfg = FT.FedLMConfig(
            n_clients=n, rho=CS.TRAIN_RHO, p=1.0, alpha=0.1,
            quant_bits=CS.BITS, quant_block=CS.BLOCK, quant_dither="hash",
            client_mode="logical", use_cv=CS.TRAIN_RUNS[name][3])
        counts, _ = D.count_train_step(
            cfg, fcfg, dataclasses.replace(shape, global_batch=n),
            peak=True)
        out[name] = counts["peak_bytes"]
        print(f"{name}: peak {out[name] / 1e9:.2f} GB counted "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
