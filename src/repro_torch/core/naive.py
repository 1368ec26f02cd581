"""The paper's comparison baseline: *parameter-space* (Theta) aggregation
(the counterpart of ``repro/core/naive.py``).

"This naive algorithm exactly mirrors FedMM, except that the
communications and the server aggregation step occur in the parameter
space and not in the surrogate space" (Section 6). Each active client
minimizes its local surrogate:

    theta_{t+1,i} = T( S_{t+1,i}(theta_t) )            (local MM step, eq. 21)
    Delta_i       = theta_{t+1,i} - theta_t - V_{t,i}
    q_i           = Quant(Delta_i)
    server:  theta_{t+1} = theta_t + gamma * (V_t + (1/p) sum mu_i q_i)

In ``repro_torch.api`` this is one flag, ``FederationSpec(aggregation="parameter")``;
this module is the shim that keeps the historical entry points.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import api
from .fedmm import FedMMConfig
from .surrogate import Surrogate


class NaiveState(NamedTuple):
    theta: object
    v: object
    v_i: object
    step: torch.Tensor


def _to_driver(state: NaiveState) -> "api.DriverState":
    return api.DriverState(x=state.theta, v=state.v, v_i=state.v_i,
                           aux=(), opt=(), step=state.step)


def _from_driver(state: "api.DriverState") -> NaiveState:
    return NaiveState(theta=state.x, v=state.v, v_i=state.v_i,
                      step=state.step)


def init(sur: Surrogate, theta0, cfg: FedMMConfig, device=None) -> NaiveState:
    return _from_driver(api.init(api.as_problem(sur), theta0,
                                 cfg.as_spec("parameter"), device=device))


def step(sur: Surrogate, state: NaiveState, client_batches, gamma, key,
         cfg: FedMMConfig, **kw) -> tuple[NaiveState, dict]:
    """One round; ``kw`` goes to ``api.step``."""
    dstate, metrics = api.step(api.as_problem(sur), cfg.as_spec("parameter"),
                               _to_driver(state), client_batches, gamma, key,
                               **kw)
    return _from_driver(dstate), metrics


def run(sur: Surrogate, theta0, client_batch_fn, gammas, key, cfg: FedMMConfig,
        n_rounds: int, eval_batch=None, surrogate_diag_batches=None, **kw):
    """Mirrors ``fedmm.run`` (one flag of ``api.run``).
    ``surrogate_diag_batches`` (optional, an (n, b, ...) pytree) turns on
    the Section 6 cross-space diagnostic E^{s,p}:
    || Tbar(theta_{t+1}) - Tbar(theta_t) ||^2 / gamma^2."""
    diag = (("e_s_p", api.mean_oracle_diag(api.as_problem(sur),
                                           surrogate_diag_batches))
            if surrogate_diag_batches is not None else None)
    state, hist = api.run(api.as_problem(sur), theta0, client_batch_fn,
                          gammas, spec=cfg.as_spec("parameter"), key=key,
                          n_rounds=n_rounds, eval_batch=eval_batch,
                          diag=diag, **kw)
    return _from_driver(state), api.history_list(hist)
