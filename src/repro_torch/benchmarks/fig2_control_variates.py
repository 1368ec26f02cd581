"""Figure 2 reproduction: the impact of control variates (the counterpart
of the reference's ``benchmarks/fig2_control_variates.py``).

FedMM only, alpha in {0, 0.01}, V_{0,i} = 0, partial participation
p = 0.5, exact local expectations (each active client uses all its local
examples, isolating the participation noise). The paper's observations:

  * no effect on the objective value,
  * on the homogeneous split, control variates cancel (no effect),
  * on heterogeneous splits, alpha > 0 drives E^s far lower.

    python -m repro_torch.benchmarks.fig2_control_variates [--full] [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from .. import api
from ..core.variational import make_dictlearn
from .fig1_dictlearn import SETTINGS, Setting, make_setting
from .run import figure_args, harness


def run_setting(exp, alpha: float, rounds: int = 120, reduced: bool = True,
                seed: int = 0, device=None,
                setting: Setting | None = None) -> list:
    """One FedMM trajectory; returns its history (a list of float dicts)."""
    dev = api.resolve_device(device)
    if setting is None:
        setting = make_setting(exp, seed, reduced, dev)
    spec, clients, z, theta0 = setting
    sur = make_dictlearn(spec)
    fed = api.FederationSpec(n_clients=exp.n_clients, participation=0.5,
                             alpha=alpha)
    # exact local expectation oracle: the full client shard every round
    # (a static (n, ...) pytree, reused every round)
    gamma = api.decaying_stepsize(exp.beta_stepsize)
    s0 = sur.s_bar(z[:128], theta0)
    _, hist, _ = harness(sur, s0, clients, gamma, spec=fed, key=seed,
                         rounds=rounds, eval_batch=z[:512],
                         track_mirror=True, device=dev)
    return hist


def es_tail(hist: list, rounds: int) -> float:
    """Mean E^s over the reference's window, ``hist[-rounds // 6:]``: the
    last ceil(rounds / 6) rounds."""
    return float(np.mean([x["e_s"] for x in hist[-rounds // 6:]]))


def main(reduced: bool = True, rounds: int = 120, device=None) -> list:
    rows = []
    for exp in SETTINGS:
        t0 = time.perf_counter()
        setting = make_setting(exp, reduced=reduced, device=device)
        h0, h1 = (run_setting(exp, alpha=a, rounds=rounds, device=device,
                              setting=setting)
                  for a in (0.0, 0.01))
        row = {
            "setting": exp.name,
            "es_tail_alpha0": es_tail(h0, rounds),
            "es_tail_alpha001": es_tail(h1, rounds),
            "loss_alpha0": h0[-1]["loss"], "loss_alpha001": h1[-1]["loss"],
            # uplink MB over the whole run, and the Lemma-1 effective
            # omega under p = 0.5
            "uplink_mb": float(np.sum([x["comm_bytes"] for x in h1])) / 1e6,
            "omega_eff": h1[-1]["omega_eff"],
            "seconds": time.perf_counter() - t0,
        }
        rows.append(row)
        print(f"[fig2] {exp.name:22s} E^s tail: alpha=0 {row['es_tail_alpha0']:.3e}"
              f"  alpha=.01 {row['es_tail_alpha001']:.3e}   loss "
              f"{row['loss_alpha0']:.3f} vs {row['loss_alpha001']:.3f} "
              f"uplink={row['uplink_mb']:.1f}MB omega_p={row['omega_eff']:.2f} "
              f"({row['seconds']:.1f}s)", flush=True)
    return rows


if __name__ == "__main__":
    _args = figure_args(__doc__)
    main(reduced=not _args.full, rounds=300 if _args.full else 120,
         device=_args.device)
