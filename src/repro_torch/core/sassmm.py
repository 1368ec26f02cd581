"""Algorithm 1, Stochastic Approximation Stochastic Surrogate MM (SA-SSMM;
the counterpart of ``repro/core/sassmm.py``).

    for t = 0 .. T-1:
        S_{t+1}  ~ oracle of E_pi[ Sbar(Z, T(Shat_t)) ]
        Shat_{t+1} = Shat_t + gamma_{t+1} (S_{t+1} - Shat_t)

A thin shim: the recursion lives in ``repro_torch.api``
(``centralized_step`` and ``run``), which also drives FedMM and the naive
baseline. Prefer ``repro_torch.api`` in new code.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import api
from .surrogate import Surrogate


class SASSMMState(NamedTuple):
    s_hat: object        # current mirror parameter Shat_t in S
    step: torch.Tensor   # iteration counter t


def init(sur: Surrogate, s0, device=None) -> SASSMMState:
    """``s0`` on ``device`` (the GPU unless the caller asks for another)."""
    state = api.centralized_init(api.as_problem(sur), s0, device=device)
    return SASSMMState(s_hat=state.x, step=state.step)


def step(sur: Surrogate, state: SASSMMState, batch,
         gamma) -> tuple[SASSMMState, dict]:
    """One SA-SSMM iteration on the oracle's ``batch`` (on the state's
    device). Returns (new_state, metrics)."""
    dstate = api.DriverState(x=state.s_hat, v=(), v_i=(), aux=(), opt=(),
                             step=state.step)
    dstate, metrics = api.centralized_step(api.as_problem(sur), dstate,
                                           batch, gamma)
    return SASSMMState(s_hat=dstate.x, step=dstate.step), metrics


def run(sur: Surrogate, s0, batches, gammas, device=None):
    """Drive SA-SSMM over an in-memory list of batches; returns the final
    state and the per-step metrics as a list of float dicts. ``gammas``: a
    callable ``t -> gamma_t`` (1-indexed) or a sequence."""
    state, hist = api.run(api.as_problem(sur), s0, list(batches), gammas,
                          device=device)
    return (SASSMMState(s_hat=state.x, step=state.step),
            api.history_list(hist))


def decaying_stepsize(beta: float):
    """gamma_t = beta / sqrt(beta + t), the Section 6 schedule (alias of
    ``repro_torch.api.decaying_stepsize``)."""
    return api.decaying_stepsize(beta)
