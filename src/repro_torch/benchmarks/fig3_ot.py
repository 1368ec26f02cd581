"""Figure 3 reproduction: FedMM-OT against FedAdam, L2-UVP over rounds (the
counterpart of the reference's ``benchmarks/fig3_ot.py``).

Federated W2 map learning with ICNN potentials on Gaussian -> Gaussian
pairs (closed-form ground-truth maps, the offline stand-in for the Korotin
et al. 2021b benchmark). n = 10 clients whose local shards are bands of P's
samples sorted by their first coordinate. The paper's observation:
FedMM-OT converges faster than FedAdam across dimensions.

Each dimension's row also holds the L2-UVP of every round and, per
algorithm, the first round (1-based) after which it is not finite (None if
none): the reference's FedMM-OT diverges at d = 32 and 64 at ``--full``.

    python -m repro_torch.benchmarks.fig3_ot [--full] [--device cpu]

Reduced: dims 4, 8, 16 and 60 rounds; ``--full``: dims 16, 32, 64 and 100
rounds. The GPU unless ``--device`` names another.
"""
from __future__ import annotations

import math
import time

import torch

from .. import api
from ..core import fedmm_ot as ot
from .run import figure_args, harness

LAM, FEDADAM_LR = 4.0, 5e-3


def make_problem(d: int, seed: int = 0, n_clients: int = 10,
                 n_per_client: int = 128, n_q: int = 512,
                 device=None) -> dict:
    """Gaussians P = N(0, S_p), Q = N(1/2, S_q) with random covariances,
    the closed-form map between them, the clients' banded shards of P's
    samples and Q's public samples. Drawn and solved on the host from
    ``seed`` (so every device gets the same), then placed on ``device``
    (the GPU unless asked otherwise)."""
    dev = api.resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    eye = torch.eye(d)
    a1 = torch.randn((d, d), generator=gen) * 0.3
    cov_p = a1 @ a1.T + eye
    a2 = torch.randn((d, d), generator=gen) * 0.3
    cov_q = a2 @ a2.T + 0.5 * eye
    m_p, m_q = torch.zeros(d), torch.ones(d) * 0.5
    _, A = ot.gaussian_ot_map(m_p, cov_p, m_q, cov_q)

    def normal(mean, cov, n):                  # by Cholesky of cov
        z = torch.randn((n, d), generator=gen)
        return mean + z @ torch.linalg.cholesky(cov).T

    x = normal(m_p, cov_p, n_clients * n_per_client)
    x = x[torch.argsort(x[:, 0])]                     # banded heterogeneity
    y_q = normal(m_q, cov_q, n_q)
    m_p, m_q, A, x, y_q, cov_q = (t.to(dev) for t in (m_p, m_q, A, x, y_q,
                                                      cov_q))
    return dict(cov_q=cov_q, true_map=ot.affine_map(m_p, m_q, A),
                client_x=x.reshape(n_clients, n_per_client, d), y_q=y_q,
                x_eval=x[:512])


def setup(d: int, n_clients: int = 10):
    """The ICNN and FedMM-OT settings of the figure: ``(ICNNSpec,
    FedOTConfig)``. strong_convexity * lam must keep the conjugate
    objective coercive: -(sc/2) c^2 + lam sc^2 c^2 > 0, so lam sc > 1/2.
    Line 6's best response is 5 local SGD steps."""
    spec = ot.ICNNSpec(dim=d, hidden=(64, 64, 64), strong_convexity=0.3)
    cfg = ot.FedOTConfig(n_clients=n_clients, p=1.0, alpha=0.01, lam=LAM,
                         client_lr=2e-2, client_steps=5, server_steps=10,
                         server_lr=5e-3)
    return spec, cfg


def first_nonfinite(values) -> int | None:
    """The 1-based round of the first value that is not finite."""
    return next((t + 1 for t, v in enumerate(values)
                 if not math.isfinite(v)), None)


def every_tenth(values) -> list:
    """The curve the figure plots: rounds 10, 20, ... and the last."""
    n = len(values)
    return [v for t, v in enumerate(values) if t % 10 == 9 or t == n - 1]


def initial_states(spec, cfg, seed: int = 0, device=None):
    """FedMM-OT's and FedAdam's starts from ``seed``: ``(FedOTState,
    FedAdamState)``. Each draws omega then theta from a generator of its
    own seeded with ``seed``, so both start from the same potentials, as
    the reference's two inits split the same key."""
    dev = api.resolve_device(device)
    return (ot.init(torch.Generator().manual_seed(seed), spec, cfg,
                    device=dev),
            ot.fedadam_init(torch.Generator().manual_seed(seed), spec,
                            device=dev))


def fedmm_ot_args(prob: dict, spec, cfg, state0, seed: int = 0) -> tuple:
    """The ``api.run`` arguments of FedMM-OT (Algorithm 3) from ``state0``
    (a ``FedOTState`` or the driver's state), L2-UVP every round through
    the problem's loss hook: ``(problem, x0, data, schedule, keywords)``."""
    if isinstance(state0, ot.FedOTState):
        state0 = ot.to_driver(state0)
    problem = ot.make_ot_problem(spec, cfg, prob["y_q"],
                                 uvp_eval=(prob["true_map"], prob["cov_q"]))
    return (problem, state0.x, prob["client_x"], 1.0,
            dict(spec=ot.ot_federation_spec(cfg), key=seed,
                 eval_batch=prob["x_eval"], state0=state0))


def fedadam_round(prob: dict, spec, state: ot.FedAdamState, t: int,
                  device=None):
    """FedAdam's round ``t`` (its draws from a generator seeded with ``t``)
    and the L2-UVP after it: ``(state, L2-UVP as a tensor)``."""
    state = ot.fedadam_step(state, spec, prob["client_x"], prob["y_q"],
                            lam=LAM, lr=FEDADAM_LR,
                            key=torch.Generator().manual_seed(t),
                            device=device)
    return state, ot.l2_uvp(lambda xx: ot.icnn_grad(state.omega, spec, xx),
                            prob["true_map"], prob["x_eval"], prob["cov_q"])


def run_fedmm_ot(prob: dict, spec, cfg, state0: ot.FedOTState, rounds: int,
                 seed: int = 0, device=None):
    """FedMM-OT on the driver, L2-UVP recorded every round: ``(per-round
    L2-UVP, seconds)``."""
    problem, x0, data, schedule, kw = fedmm_ot_args(prob, spec, cfg, state0,
                                                    seed)
    _, hist, secs = harness(problem, x0, data, schedule, rounds=rounds,
                            device=device, **kw)
    return [h["loss"] for h in hist], secs


def run_fedadam(prob: dict, spec, state0: ot.FedAdamState, rounds: int,
                device=None):
    """The FedAdam baseline, stepped in a Python loop, L2-UVP recorded
    every round: ``(per-round L2-UVP, seconds)``; the seconds end with the
    curve on the host."""
    t0 = time.perf_counter()
    state, uvp = state0, []
    for t in range(rounds):
        state, u = fedadam_round(prob, spec, state, t, device)
        uvp.append(u)
    uvp = torch.stack(uvp).tolist()
    return uvp, time.perf_counter() - t0


def run_dim(d: int, rounds: int = 60, seed: int = 0, device=None,
            prob: dict | None = None, init=None) -> dict:
    """FedMM-OT and FedAdam at dimension ``d`` from ``seed``: the data
    (``prob``, built here unless given) and the initial potentials
    (``init = (FedOTState, FedAdamState)``, ``initial_states`` unless
    given)."""
    dev = api.resolve_device(device)
    if prob is None:
        prob = make_problem(d, seed, device=dev)
    spec, cfg = setup(d, prob["client_x"].shape[0])
    if init is None:
        init = initial_states(spec, cfg, seed, dev)
    uvp_mm, secs_mm = run_fedmm_ot(prob, spec, cfg, init[0], rounds, seed,
                                   dev)
    uvp_fa, secs_fa = run_fedadam(prob, spec, init[1], rounds, dev)
    return {"fedmm_ot": uvp_mm, "fedadam": uvp_fa,
            "seconds_fedmm_ot": secs_mm, "seconds_fedadam": secs_fa}


def main(dims=(4, 8, 16), rounds: int = 60, device=None) -> list:
    rows = []
    for d in dims:
        out = run_dim(d, rounds=rounds, device=device)
        mm, fa = out["fedmm_ot"], out["fedadam"]
        row = {"dim": d, "fedmm_ot_uvp": mm[-1], "fedadam_uvp": fa[-1],
               "fedmm_ot_curve": every_tenth(mm),
               "fedadam_curve": every_tenth(fa),
               "fedmm_ot_first_nonfinite": first_nonfinite(mm),
               "fedadam_first_nonfinite": first_nonfinite(fa),
               "seconds_fedmm_ot": out["seconds_fedmm_ot"],
               "seconds_fedadam": out["seconds_fedadam"],
               "seconds": out["seconds_fedmm_ot"] + out["seconds_fedadam"]}
        rows.append(row)
        print(f"[fig3] d={d:3d}  L2-UVP: FedMM-OT={mm[-1]:7.3f}  "
              f"FedAdam={fa[-1]:7.3f}  first non-finite round: "
              f"{row['fedmm_ot_first_nonfinite']} / "
              f"{row['fedadam_first_nonfinite']}  ({row['seconds']:.1f}s)",
              flush=True)
    return rows


if __name__ == "__main__":
    _args = figure_args(__doc__)
    main(dims=(16, 32, 64) if _args.full else (4, 8, 16),
         rounds=100 if _args.full else 60, device=_args.device)
