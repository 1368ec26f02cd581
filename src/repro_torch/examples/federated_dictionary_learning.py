"""Section 6 experiment driver: federated dictionary learning with FedMM
(the counterpart of the reference's
``examples/federated_dictionary_learning.py``).

Any of the three data settings (synthetic homogeneous / heterogeneous /
MovieLens-like, at the figures' reduced sizes), FedMM and the naive
Theta-aggregation baseline, with the paper's knobs on the command line:
participation, quantization bits (0 for none), the control-variate step
alpha; the step sizes are gamma_t = beta / sqrt(beta + t).

    python -m repro_torch.examples.federated_dictionary_learning \\
        --setting synth_heterogeneous --rounds 150 --alpha 0.01 --bits 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from .. import api
from ..benchmarks.fig1_dictlearn import (SETTINGS, algorithm_args,
                                         make_setting)
from ..core import compression

BY_NAME = {e.name: e for e in SETTINGS}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--setting", default="synth_heterogeneous",
                    choices=list(BY_NAME))
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--skip-naive", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = api.resolve_device(args.device)

    exp = dataclasses.replace(BY_NAME[args.setting], alpha=args.alpha,
                              participation=args.participation)
    setting = make_setting(exp, seed=0, reduced=True, device=dev)
    comp = (compression.block_quant(args.bits, 128) if args.bits
            else compression.identity())
    runs = algorithm_args(exp, setting, comp)

    out = {}
    prob, x0, data, gamma, kw = runs["fedmm"]
    _, hist = api.run(prob, x0, data, gamma, key=0, n_rounds=args.rounds,
                      device=dev, **kw)
    out["fedmm"] = api.history_list(hist)
    for t in range(0, args.rounds, max(args.rounds // 10, 1)):
        h = out["fedmm"][t]
        print(f"[FedMM] round {t:4d} loss={h['loss']:.4f} e_s={h['e_s']:.3e}")
    print(f"[FedMM] final loss={out['fedmm'][-1]['loss']:.4f}")

    if not args.skip_naive:
        # the Section 3.1 baseline is the same driver with one flag flipped
        prob, x0, data, gamma, kw = runs["naive"]
        _, hist = api.run(prob, x0, data, gamma, key=0, n_rounds=args.rounds,
                          device=dev, **kw)
        out["naive"] = api.history_list(hist)
        print(f"[naive Theta-aggregation] loss {out['naive'][0]['loss']:.4f} "
              f"-> {out['naive'][-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
