"""Algorithm 2, FedMM: Federated Majorize-Minimization (the counterpart of
``repro/core/fedmm.py``).

Each round:

  1. sample the active set A_{t+1} (A5: independent Bernoulli(p) per client),
  2. broadcast Shat_t and its mirror T(Shat_t),
  3. on each active client i:
        S_{t+1,i}  ~ oracle of E_{pi_i}[ Sbar(Z, T(Shat_t)) ]
        Delta_i    = S_{t+1,i} - Shat_t - V_{t,i}          (drift correction)
        q_i        = Quant(Delta_i)                        (compression, A4)
        V_{t+1,i}  = V_{t,i} + (alpha / p) q_i             (control variate)
  4. on the server:
        H_{t+1}    = V_t + (1/p) sum_{i in A} mu_i q_i
        Shat_{t+1} = Proj_S( Shat_t + gamma_{t+1} H_{t+1} )
        V_{t+1}    = V_t + (alpha/p) sum_{i in A} mu_i q_i

A thin shim over ``repro_torch.api``: ``FedMMConfig`` maps onto a
``FederationSpec`` with ``aggregation="surrogate"``, and ``step``/``run``
delegate to ``api.step``/``api.run``. ``key`` is a ``torch.Generator`` or,
for ``run``, an int seed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import api
from .compression import Compressor, identity
from .surrogate import Surrogate


@dataclasses.dataclass(frozen=True)
class FedMMConfig:
    """Legacy FedMM knobs; ``as_spec()`` is the bridge to ``repro_torch.api``."""
    n_clients: int
    p: float = 1.0                  # participation probability (A5)
    alpha: float = 0.0              # control-variate stepsize
    compressor: Compressor = dataclasses.field(default_factory=identity)
    mu: Optional[object] = None     # client weights; default uniform

    def as_spec(self, aggregation: str = "surrogate") -> "api.FederationSpec":
        return api.FederationSpec(
            n_clients=self.n_clients, participation=self.p, alpha=self.alpha,
            compressor=self.compressor, mu=self.mu, aggregation=aggregation)


class FedMMState(NamedTuple):
    s_hat: object        # Shat_t, the server mirror parameter
    v: object            # server control variate V_t = sum_i mu_i V_{t,i}
    v_i: object          # stacked client control variates (n leading axis)
    step: torch.Tensor


def _to_driver(state: FedMMState) -> "api.DriverState":
    return api.DriverState(x=state.s_hat, v=state.v, v_i=state.v_i,
                           aux=(), opt=(), step=state.step)


def _from_driver(state: "api.DriverState") -> FedMMState:
    return FedMMState(s_hat=state.x, v=state.v, v_i=state.v_i,
                      step=state.step)


def init(sur: Surrogate, s0, cfg: FedMMConfig, v0_i=None,
         device=None) -> FedMMState:
    return _from_driver(api.init(api.as_problem(sur), s0, cfg.as_spec(),
                                 v0_i=v0_i, device=device))


def init_control_variates_at_h(sur: Surrogate, s0, client_batches,
                               cfg: FedMMConfig):
    """The heterogeneity-robust initialization V_{0,i} = h_i(Shat_0)
    (Theorem 1 discussion): one full local expectation per client.
    ``repro_torch.api`` spells this ``FederationSpec(variates="at-init")``."""
    del cfg
    return api.variates_at_init(api.as_problem(sur), s0, client_batches)


def step(sur: Surrogate, state: FedMMState, client_batches, gamma, key,
         cfg: FedMMConfig, **kw) -> tuple[FedMMState, dict]:
    """One FedMM round. ``client_batches`` is a pytree with a leading
    client axis of size n. ``kw`` goes to ``api.step`` (``active=``,
    ``seeds=``, ``device=``, ``client_mode=``)."""
    dstate, metrics = api.step(api.as_problem(sur), cfg.as_spec(),
                               _to_driver(state), client_batches, gamma, key,
                               **kw)
    return _from_driver(dstate), metrics


def run(sur: Surrogate, s0, client_batch_fn, gammas, key, cfg: FedMMConfig,
        n_rounds: int, v0_i=None, eval_batch=None, track_mirror: bool = True,
        **kw):
    """``client_batch_fn(t, gen) -> (n, b, ...)`` pytree (or a static
    pytree). Returns (final_state, history of metric dicts). ``kw`` goes to
    ``api.run`` (``device=``, ``client_mode=``)."""
    state, hist = api.run(api.as_problem(sur), s0, client_batch_fn, gammas,
                          spec=cfg.as_spec(), key=key, n_rounds=n_rounds,
                          eval_batch=eval_batch, track_mirror=track_mirror,
                          v0_i=v0_i, **kw)
    return _from_driver(state), api.history_list(hist)

