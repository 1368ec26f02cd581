"""Algorithm 3, FedMM-OT: pseudo-MM for federated Wasserstein-2 maps (the
counterpart of ``repro/core/fedmm_ot.py``).

Section 7 of the paper: n clients hold samples of local distributions P_i;
everyone shares a public target Q. The potentials f_omega, f_theta are
Input Convex Neural Networks (ICNN, Amos et al. 2017); the fitted map is
x -> grad_x f_omega(x).

Local objective (eq. 33):
    W_i(omega, theta) = E_{P_i}[f_omega(X)]
                      + E_Q[ <grad f_theta(Y), Y> - f_omega(grad f_theta(Y)) ]
                      + lambda * E_Q[ || grad f_omega(grad f_theta(Y)) - Y ||^2 ]

A FedMM-OT round: the clients take a few local SGD steps on W_i(., theta_t)
from omega_t (the relaxed best response omega_i(theta_t)) and send
control-variate-corrected deltas; the server aggregates them in the
surrogate (omega) space, then takes a few Adam steps on theta against the
conjugate objective (the global conjugate update). The round's plumbing is
the driver's (``repro_torch.api``): ``make_ot_problem`` states Algorithm 3
as an ``MMProblem``, and ``step``/``fedadam_step`` are thin shims over
``api.step``.

``icnn_grad`` is the gradient of the potential with respect to its input,
written out by hand through the layers (no in-place operation), so that
the parameter gradients of the objectives (``torch.func.grad``) take the
second derivative through it, also under the driver's ``torch.func.vmap``
over clients. The softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus``;
its derivative is the sigmoid.

Randomness: ``icnn_init``/``init``/``fedadam_init`` draw from an explicit
``torch.Generator`` (the reference splits a PRNG key); ``fedadam_step``
draws its active set from the round's generator unless ``active=`` hands
one in. Tensors land on the GPU unless the caller names another device.

Evaluation: L2-UVP against the closed-form Gaussian -> Gaussian OT map.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .. import api
from ..optim.optimizers import AdamState, adam_init, adam_update
from ..tree import tree_map

Pytree = Any


# ---------------------------------------------------------------------------
# ICNN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ICNNSpec:
    dim: int
    hidden: tuple = (64, 64, 64)   # three dense layers (Korotin MMv2 style)
    strong_convexity: float = 0.1  # quadratic skip making grad f invertible


def icnn_init(gen: torch.Generator, spec: ICNNSpec, device=None) -> dict:
    """``{"Wx": [...], "Wz": [...], "b": [...], "w_out": tensor}``: the
    x-weights and the z-weights (squared at use, so nonnegative) normal with
    variance 1/fan-in, zero biases. Drawn on ``gen`` in the order Wx_0,
    Wx_1, Wz_0, Wx_2, Wz_1, ..., w_out, then placed on ``device``."""
    dev = api.resolve_device(device)

    def normal(shape, fan_in):
        x = torch.randn(shape, generator=gen, device=gen.device)
        return (x / fan_in ** 0.5).to(dev)

    params = {"Wx": [], "Wz": [], "b": []}
    prev = 0
    for i, h in enumerate(spec.hidden):
        params["Wx"].append(normal((spec.dim, h), spec.dim))
        params["b"].append(torch.zeros((h,), device=dev))
        if i > 0:
            params["Wz"].append(normal((prev, h), prev))
        prev = h
    params["w_out"] = normal((prev,), prev)
    return params


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _icnn(params, spec: ICNNSpec, x, value: bool, grad: bool):
    """The potential f(x) (``value``) and its input gradient (``grad``) in
    one pass over the layers; the one not asked for is None."""
    n_layers = len(spec.hidden)
    pre = []
    z = None
    for i in range(n_layers):
        lin = x @ params["Wx"][i] + params["b"][i]
        if i > 0:
            lin = lin + z @ (params["Wz"][i - 1] ** 2)     # nonneg z-weights
        pre.append(lin)
        if i < n_layers - 1 or value:
            z = _softplus(lin)
    sc = spec.strong_convexity
    w2 = params["w_out"] ** 2
    f = (z @ w2 + 0.5 * sc * torch.sum(x * x, dim=-1)) if value else None
    if not grad:
        return f, None
    # backward through the layers: d softplus(a) / da = sigmoid(a)
    g_a = w2 * torch.sigmoid(pre[-1])
    g_x = g_a @ params["Wx"][-1].mT
    for i in range(n_layers - 1, 0, -1):
        g_z = g_a @ (params["Wz"][i - 1] ** 2).mT
        g_a = g_z * torch.sigmoid(pre[i - 1])
        g_x = g_x + g_a @ params["Wx"][i - 1].mT
    return f, g_x + sc * x


def icnn_forward(params, spec: ICNNSpec, x):
    """Scalar convex potential f(x); x: (..., dim)."""
    return _icnn(params, spec, x, value=True, grad=False)[0]


def icnn_grad(params, spec: ICNNSpec, x):
    """grad_x f(x), batched over the leading axes: the transport map."""
    return _icnn(params, spec, x, value=False, grad=True)[1]


# ---------------------------------------------------------------------------
# The federated OT objective
# ---------------------------------------------------------------------------

def _conjugate_terms(omega, spec: ICNNSpec, y_q, ty, lam: float):
    """E_Q[<ty, Y> - f_omega(ty)] + lam E_Q ||grad f_omega(ty) - Y||^2 for
    the pushed-forward targets ``ty = grad f_theta(Y)``."""
    inner = torch.sum(ty * y_q, dim=-1)
    f_w_ty, g_w_ty = _icnn(omega, spec, ty, value=True, grad=True)
    reg = torch.sum((g_w_ty - y_q) ** 2, dim=-1)
    return torch.mean(inner - f_w_ty), lam * torch.mean(reg)


def local_objective(omega, theta, spec: ICNNSpec, x_p, y_q, lam: float):
    """W_i(omega, theta) on minibatches x_p ~ P_i, y_q ~ Q (eq. 33)."""
    return _local_objective_at(omega, spec, x_p, y_q,
                               icnn_grad(theta, spec, y_q), lam)


def _local_objective_at(omega, spec, x_p, y_q, ty, lam):
    f_w = icnn_forward(omega, spec, x_p)                   # E_{P_i} f_omega
    conj, reg = _conjugate_terms(omega, spec, y_q, ty, lam)
    return torch.mean(f_w) + conj + reg


def conjugate_objective(omega, theta, spec: ICNNSpec, y_q, lam: float):
    """The theta-dependent part of W (depends on Q only): the server's
    conjugate update (line 16) minimizes it."""
    conj, reg = _conjugate_terms(omega, spec, y_q,
                                 icnn_grad(theta, spec, y_q), lam)
    return conj + reg


# ---------------------------------------------------------------------------
# Algorithm 3
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FedOTConfig:
    n_clients: int
    p: float = 1.0
    alpha: float = 0.01
    lam: float = 1.0
    client_lr: float = 1e-3        # local best-response relaxation
    client_steps: int = 1
    server_steps: int = 10         # Adam steps for the conjugate update
    server_lr: float = 1e-3


class FedOTState(NamedTuple):
    omega: Pytree
    theta: Pytree
    v: Pytree
    v_i: Pytree
    theta_opt: AdamState   # Adam state of the server's conjugate updates
    step: torch.Tensor


def init(gen: torch.Generator, spec: ICNNSpec, cfg: FedOTConfig,
         device=None) -> FedOTState:
    """omega then theta drawn from ``gen``; variates and Adam state zero."""
    dev = api.resolve_device(device)
    omega = icnn_init(gen, spec, dev)
    theta = icnn_init(gen, spec, dev)
    v_i = tree_map(lambda x: torch.zeros((cfg.n_clients,) + tuple(x.shape),
                                         dtype=x.dtype, device=dev), omega)
    return FedOTState(omega=omega, theta=theta,
                      v=tree_map(torch.zeros_like, omega), v_i=v_i,
                      theta_opt=adam_init(theta), step=torch.tensor(0))


def make_ot_problem(spec: ICNNSpec, cfg: FedOTConfig, y_q,
                    uvp_eval=None) -> api.MMProblem:
    """The federated OT task as an ``api.MMProblem``.

    The pseudo-surrogate parameter is omega (the forward potential); the
    conjugate potential theta and its Adam state ride along as the driver's
    ``aux``:

      * ``view``        broadcasts (omega_t, theta_t) (Algorithm 3 line 4);
      * ``s_bar``       is the relaxed best response omega_i(theta_t):
        ``client_steps`` local SGD steps on W_i(., theta_t) (line 6);
      * ``server_step`` is the global conjugate update, ``server_steps``
        Adam steps on theta (line 16), after the surrogate-space
        aggregation.

    ``uvp_eval = (true_map_fn, cov_q)`` installs an L2-UVP ``loss``, so
    ``api.run(..., eval_batch=x_eval)`` records the Figure 3 metric.
    """
    def view(omega, aux):
        return omega, aux[0]

    def s_bar(x_i, view_t):                                # line 6 (relaxed)
        omega, theta = view_t
        # the pushed-forward targets do not depend on omega: once per call
        ty = icnn_grad(theta, spec, y_q)
        grad_local = torch.func.grad(
            lambda w: _local_objective_at(w, spec, x_i, y_q, ty, cfg.lam))
        w = omega
        for _ in range(cfg.client_steps):
            g = grad_local(w)
            w = tree_map(lambda a, b: a - cfg.client_lr * b, w, g)
        return w

    def server_step(aux, omega_new):                       # line 16
        theta, opt = aux
        grad_conj = torch.func.grad(
            lambda th: conjugate_objective(omega_new, th, spec, y_q, cfg.lam))
        for _ in range(cfg.server_steps):
            theta, opt = adam_update(theta, grad_conj(theta), opt,
                                     cfg.server_lr)
        return (theta, opt), {}

    loss = None
    if uvp_eval is not None:
        true_map_fn, cov_q = uvp_eval

        def loss(x_eval, omega):
            return l2_uvp(lambda xx: icnn_grad(omega, spec, xx),
                          true_map_fn, x_eval, cov_q)

    return api.MMProblem(s_bar=s_bar, T=lambda omega: omega, view=view,
                         server_step=server_step, loss=loss)


def ot_federation_spec(cfg: FedOTConfig) -> api.FederationSpec:
    return api.FederationSpec(n_clients=cfg.n_clients, participation=cfg.p,
                              alpha=cfg.alpha)


def to_driver(state: FedOTState) -> api.DriverState:
    """FedOTState -> the driver's state: omega is the iterate, the conjugate
    potential and its Adam state ride as ``aux``."""
    return api.DriverState(x=state.omega, v=state.v, v_i=state.v_i,
                           aux=(state.theta, state.theta_opt), opt=(),
                           step=state.step)


def step(state: FedOTState, spec: ICNNSpec, cfg: FedOTConfig, client_x,
         y_q, gamma, key: torch.Generator, active=None, device=None):
    """One FedMM-OT round (a shim over ``api.step``). client_x: (n, b,
    dim); y_q: (bq, dim), public. ``active`` overrides the drawn
    participation mask."""
    problem = make_ot_problem(spec, cfg, y_q)
    dstate, m = api.step(problem, ot_federation_spec(cfg), to_driver(state),
                         client_x, gamma, key, active=active, device=device)
    theta_new, opt_new = dstate.aux
    return FedOTState(omega=dstate.x, theta=theta_new, v=dstate.v,
                      v_i=dstate.v_i, theta_opt=opt_new,
                      step=dstate.step), {"omega_update": m["e_s"]}


# ---------------------------------------------------------------------------
# FedAdam baseline (Reddi et al. 2021), the Section 7.3 comparison: clients
# send gradients of the differentiable objective (33) with respect to
# (omega, theta); the server applies Adam. No surrogate aggregation.
# ---------------------------------------------------------------------------

class FedAdamState(NamedTuple):
    omega: Pytree
    theta: Pytree
    opt: AdamState          # over the dict {"omega": ..., "theta": ...}
    step: torch.Tensor


def fedadam_init(gen: torch.Generator, spec: ICNNSpec,
                 device=None) -> FedAdamState:
    dev = api.resolve_device(device)
    params = {"omega": icnn_init(gen, spec, dev),
              "theta": icnn_init(gen, spec, dev)}
    return FedAdamState(omega=params["omega"], theta=params["theta"],
                        opt=adam_init(params), step=torch.tensor(0))


def make_fedadam_problem(spec: ICNNSpec, y_q, lam: float,
                         lr: float) -> api.MMProblem:
    """FedAdam as an ``MMProblem``: the client oracle returns raw local
    gradients (spec ``delta="oracle"``), the aggregate is averaged over the
    realized active set (``normalization="realized"``), and ``server_opt``
    replaces the SA update with one Adam step."""
    def s_bar(x_i, params):
        return torch.func.grad(
            lambda pp: local_objective(pp["omega"], pp["theta"], spec, x_i,
                                       y_q, lam))(params)

    def server_opt(params, h, gamma, opt):
        del gamma
        return adam_update(params, h, opt, lr)

    return api.MMProblem(s_bar=s_bar, T=lambda params: params,
                         view=lambda params, aux: params,
                         server_opt=server_opt)


def fedadam_spec(n_clients: int, p: float) -> api.FederationSpec:
    return api.FederationSpec(n_clients=n_clients, participation=p,
                              variates="off", delta="oracle",
                              normalization="realized")


def fedadam_step(state: FedAdamState, spec: ICNNSpec, client_x, y_q,
                 lam: float, lr: float, key: torch.Generator, p: float = 1.0,
                 active=None, device=None) -> FedAdamState:
    """One FedAdam round (a shim over ``api.step``). The active set is
    Bernoulli(p) per client, drawn from ``key`` first, unless ``active``
    hands one in."""
    n = client_x.shape[0]
    if active is None:
        active = torch.rand((n,), generator=key, device=key.device).cpu() < p
    problem = make_fedadam_problem(spec, y_q, lam, lr)
    dstate = api.DriverState(x={"omega": state.omega, "theta": state.theta},
                             v=(), v_i=(), aux=(), opt=state.opt,
                             step=state.step)
    dstate, _ = api.step(problem, fedadam_spec(n, p), dstate, client_x, 1.0,
                         key, active=active, device=device)
    return FedAdamState(omega=dstate.x["omega"], theta=dstate.x["theta"],
                        opt=dstate.opt, step=dstate.step)


# ---------------------------------------------------------------------------
# Gaussian ground truth and L2-UVP (Section 7.2, offline variant)
# ---------------------------------------------------------------------------

def affine_map(m_p, m_q, A):
    """x -> m_q + A (x - m_p), batched over the leading axes."""
    return lambda x: m_q + (x - m_p) @ A.T


def gaussian_ot_map(m_p, cov_p, m_q, cov_q):
    """Closed-form W2-optimal map between Gaussians: ``(map, A)`` with
    m(x) = m_q + A (x - m_p),
    A = S_p^{-1/2} (S_p^{1/2} S_q S_p^{1/2})^{1/2} S_p^{-1/2}."""
    def sqrtm(m):
        w, v = torch.linalg.eigh(m)
        return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T

    sp_half = sqrtm(cov_p)
    sp_half_inv = torch.linalg.inv(sp_half)
    mid = sqrtm(sp_half @ cov_q @ sp_half)
    A = sp_half_inv @ mid @ sp_half_inv
    return affine_map(m_p, m_q, A), A


def l2_uvp(map_fn, true_map_fn, x_p, cov_q):
    """100 * E_P ||m - m*||^2 / Var(Q); Var(Q) is the L1 norm of Cov(Q)'s
    entries (the convention of the Korotin benchmark implementation)."""
    err = torch.mean(torch.sum((map_fn(x_p) - true_map_fn(x_p)) ** 2,
                               dim=-1))
    return 100.0 * err / torch.sum(torch.abs(cov_q))
