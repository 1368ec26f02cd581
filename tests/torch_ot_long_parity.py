"""Fig. 3 at one dimension for the reference's full 100 rounds, the port
against the JAX package on the CPU, from the same data and initial
potentials (the reference's, carried across): every round's L2-UVP of
FedMM-OT and of FedAdam in both, the relative gap per round, and the first
round at which each gap passes 1e-4, 1e-3, 1e-2 and 1e-1.

It shows whether the port's trajectory follows the reference's over a long
run (the server's Adam count reaches 1,000, carried in the driver's aux)
or where the two part. Too long for the tier-1 tests (several minutes on
a CPU at d = 16); run it from the root of the repo:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_ot_long_parity.py \\
        [--dim 16] [--rounds 100] [--out parity.json]
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import fig3_ot as jfig3  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core import fedmm_ot as jot  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import fig3_ot as tfig3  # noqa: E402
from repro_torch.core import fedmm_ot as tot  # noqa: E402
from test_torch_ot import _np, _torch_problem  # noqa: E402

THRESHOLDS = (1e-4, 1e-3, 1e-2, 1e-1)


def reference_curves(d: int, rounds: int, key):
    """The reference ``run_dim``'s two trajectories with L2-UVP at every
    round (its own records every tenth): the same spec, config, key and
    FedAdam loop."""
    prob = jfig3.make_problem(d, key)
    spec = jot.ICNNSpec(dim=d, hidden=(64, 64, 64), strong_convexity=0.3)
    cfg = jot.FedOTConfig(n_clients=prob["client_x"].shape[0], p=1.0,
                          alpha=0.01, lam=tfig3.LAM, client_lr=2e-2,
                          client_steps=5, server_steps=10, server_lr=5e-3)
    st0, fa0 = jot.init(key, spec, cfg), jot.fedadam_init(key, spec)
    problem = jot.make_ot_problem(spec, cfg, prob["y_q"],
                                  uvp_eval=(prob["true_map"], prob["cov_q"]))
    _, hist = japi.run(problem, st0.omega, prob["client_x"], 1.0,
                       spec=jot.ot_federation_spec(cfg), key=key,
                       n_rounds=rounds, eval_batch=prob["x_eval"],
                       eval_every=1, state0=jot.to_driver(st0))
    fstep = jax.jit(lambda s, k: jot.fedadam_step(
        s, spec, prob["client_x"], prob["y_q"], lam=tfig3.LAM,
        lr=tfig3.FEDADAM_LR, key=k))
    fa, uvp_fa = fa0, []
    for t in range(rounds):
        fa = fstep(fa, jax.random.PRNGKey(t))
        uvp_fa.append(float(jot.l2_uvp(
            lambda xx: jot.icnn_grad(fa.omega, spec, xx), prob["true_map"],
            prob["x_eval"], prob["cov_q"])))
    return prob, st0, fa0, [float(v) for v in np.asarray(hist["loss"])], \
        uvp_fa


def first_past(gaps, limit):
    return next((t + 1 for t, g in enumerate(gaps)
                 if not (g <= limit)), None)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    d, rounds, key = args.dim, args.rounds, jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    prob, st0, fa0, ref_mm, ref_fa = reference_curves(d, rounds, key)
    ref_s = time.perf_counter() - t0
    init = (interop.ot_state_to_torch(_np(st0), tot.FedOTState,
                                      device="cpu"),
            interop.ot_state_to_torch(_np(fa0), tot.FedAdamState,
                                      device="cpu"))
    t0 = time.perf_counter()
    out = tfig3.run_dim(d, rounds=rounds, device="cpu",
                        prob=_torch_problem(prob, d, key), init=init)
    port_s = time.perf_counter() - t0
    record = {"dim": d, "rounds": rounds, "seconds_reference": ref_s,
              "seconds_port": port_s}
    for name, ref in (("fedmm_ot", ref_mm), ("fedadam", ref_fa)):
        port = out[name]
        gaps = [abs(p - r) / abs(r) if math.isfinite(p) and math.isfinite(r)
                else math.inf for p, r in zip(port, ref)]
        record[name] = {
            "reference": ref, "port": port, "rel_gap": gaps,
            "reference_every_tenth": tfig3.every_tenth(ref),
            "port_every_tenth": tfig3.every_tenth(port),
            "first_round_past": {str(lim): first_past(gaps, lim)
                                 for lim in THRESHOLDS}}
        print(f"{name}: reference {tfig3.every_tenth(ref)}\n"
              f"{' ' * len(name)}  port      {tfig3.every_tenth(port)}\n"
              f"{' ' * len(name)}  first round past "
              f"{record[name]['first_round_past']}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
