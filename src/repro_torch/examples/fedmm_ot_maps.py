"""Section 7: federated optimal-transport maps with FedMM-OT (Algorithm 3;
the counterpart of the reference's ``examples/fedmm_ot_maps.py``).

Ten hospitals (clients) hold locally skewed samples of a source
distribution P; everyone shares a public target Q. FedMM-OT aggregates the
best-response ICNN potential parameters omega_i (the pseudo-surrogate
parameters) on the server, then solves the conjugate update centrally.
Compared against FedAdam on the same budget; evaluated by L2-UVP against
the closed-form Gaussian OT map.

    python -m repro_torch.examples.fedmm_ot_maps [--rounds 50] [--device cpu]
"""
from __future__ import annotations

import argparse

from .. import api
from ..benchmarks import fig3_ot as fig3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = api.resolve_device(args.device)
    d, n_clients, rounds = 4, 10, args.rounds
    prob = fig3.make_problem(d, seed=0, n_clients=n_clients, device=dev)
    spec, cfg = fig3.setup(d, n_clients)
    init, fa = fig3.initial_states(spec, cfg, seed=0, device=dev)

    # FedMM-OT as an MMProblem on the driver: the omega iterate, the
    # conjugate potential as the server's aux state, and L2-UVP recorded
    # every 10 rounds through the problem's loss hook, in one api.run
    problem, x0, data, schedule, kw = fig3.fedmm_ot_args(prob, spec, cfg,
                                                         init)
    _, hist = api.run(problem, x0, data, schedule, n_rounds=rounds,
                      eval_every=10, device=dev, **kw)
    uvp_mm = api.history_list(hist)

    # FedAdam baseline (Section 7.3), from the same potentials: no
    # surrogate aggregation; the round shim (itself a driver
    # configuration) stepped in a Python loop
    out = {"rounds": [], "fedmm_ot": [], "fedadam": []}
    for t in range(rounds):
        fa, uvp_fa = fig3.fedadam_round(prob, spec, fa, t, dev)
        if t % 10 == 9:
            uvp_fa = float(uvp_fa)
            out["rounds"].append(t + 1)
            out["fedmm_ot"].append(uvp_mm[t]["loss"])
            out["fedadam"].append(uvp_fa)
            print(f"round {t + 1:3d}  L2-UVP  FedMM-OT="
                  f"{uvp_mm[t]['loss']:7.3f}  FedAdam={uvp_fa:7.3f}")
    print("\nFedMM-OT aggregates potential parameters (surrogate space), "
          "matching Figure 3's faster convergence.")
    return out


if __name__ == "__main__":
    main()
