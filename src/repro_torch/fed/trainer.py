"""FedMM at transformer scale (the port of ``repro/fed/trainer.py``):
Algorithm 2 with the quadratic surrogate (Example 1) driving a model of
``repro_torch.models``.

Mirror parameter: Shat has the parameter tree's structure (the plain tree
of ``models.layers.params_tree``: embedding, one tree per layer, final
norm); the per-client oracle is S_i = theta - rho * grad_i(theta) on the
client's batch; T(s) = prox_{rho g}(s) = s / (1 + rho * wd) elementwise
(g = weight decay). Delta_i = S_i - Shat - V_i is encoded by the
``FederationSpec``'s compressor (by default ``block_quant`` with the hash
dither and shard-aligned groups: every leaf of at least 65,536 elements
takes the encode kernel) before the server decodes, masks and reduces it
in the SURROGATE space, and the server takes the SA step. The round is one
``api.step``.

Gradients. The oracle takes its gradient with ``torch.autograd.grad`` of
``model.loss_fn`` (every layer rematerialised with
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``), on
leaves detached from the iterate. ``torch.func.grad`` cannot be used:
it refuses saved-tensor hooks, which non-reentrant checkpointing is, and
the reentrant form refuses the kernels' ``autograd.Function``s. So the
clients run on the driver's sequential ``client_mode="scan"`` (one
client's gradient, drift and payload alive at a time), never under
``torch.func.vmap``.

Client topology (the reference's ``client_mode``):
  logical   n simulated clients run one after another: the driver's
            ``"scan"``, as the reference maps it.
  physical  the reference's batched silos (its ``"vmap"``, optionally on a
            mesh). Without a mesh the port runs them on ``"scan"`` as well:
            the two modes give the same trajectory, as the reference pins
            both of its modes to one frozen trajectory
            (``tests/test_fed_trainer.py``). With ``mesh=`` it raises
            ``NotImplementedError``: sharding the model over a mesh is
            ROADMAP Queue A item 11g, and so are ``state_specs`` and
            ``batch_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import api
from ..core import compression
from ..core.compression import Compressor
from ..models.layers import params_tree
from ..models.model import build_model
from ..tree import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class FedLMConfig:
    n_clients: int
    rho: float = 0.02              # surrogate curvature step (<= 1/L_f)
    weight_decay: float = 0.1      # g(theta) = wd/2 ||theta||^2
    p: float = 1.0                 # participation probability (A5)
    alpha: float = 0.1             # control-variate step
    quant_bits: int = 8            # 0 -> no compression
    quant_block: int = 256
    quant_dither: str = "hash"     # the murmur hash of the element index
    quant_compute: str = "f32"     # "native" keeps bf16 chains in bf16
    compressor: Optional[Compressor] = None  # overrides the quant_* fields
    client_mode: str = "physical"  # physical | logical
    use_cv: bool = True            # False: no V / V_i (alpha = 0 regime)
    server_momentum: float = 0.0   # FedAvgM heavy-ball beta on the server
    # explicit FederationSpec: overrides n_clients/p/alpha/use_cv/quant_*
    federation: Optional[api.FederationSpec] = None

    def federation_spec(self) -> api.FederationSpec:
        """This trainer's federation axes as the one ``FederationSpec`` the
        driver reads (the explicit ``federation`` if given)."""
        if self.federation is not None:
            return self.federation
        if self.compressor is not None:
            comp = self.compressor
        elif not self.quant_bits:
            comp = compression.identity()
        else:
            comp = compression.block_quant(
                self.quant_bits, self.quant_block, dither=self.quant_dither,
                shard_safe=True, compute=self.quant_compute)
        return api.FederationSpec(
            n_clients=self.n_clients, participation=self.p,
            alpha=self.alpha if self.use_cv else 0.0,
            variates="zero" if self.use_cv else "off", compressor=comp,
            server_momentum=self.server_momentum)


def resolve_compressor(cfg: FedLMConfig) -> Compressor:
    """The uplink compressor, read off the ``FederationSpec``."""
    return cfg.federation_spec().compressor


class FedLMState(NamedTuple):
    s_hat: object
    v: object
    v_i: object                    # leading client dim
    step: torch.Tensor
    opt: object = ()               # FedAvgM momentum buffer (param-shaped
                                   # when cfg.server_momentum > 0)


def param_count(model) -> int:
    """The parameters of ``model``'s ``init``, counted on fake tensors
    (shapes only: nothing is drawn or allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    twin = build_model(model.cfg, device="cpu")
    with FakeTensorMode():
        params = twin.init(torch.Generator())
        return sum(int(t.numel()) for t in params.parameters())


def choose_client_layout(n_params: int, multi_pod: bool):
    """(n_clients, mode) under the per-client control-variate memory
    budget (the reference's thresholds)."""
    silos = 32 if multi_pod else 16
    if n_params <= 2.0e10:
        return silos, "physical"
    if n_params <= 1.5e11:
        return 4, "logical"
    return 2, "logical"


def T_map(s_hat, cfg: FedLMConfig):
    """MM-2 minimizer: the prox of the l2 penalty, exact and elementwise,
    in each leaf's dtype."""
    c = 1.0 / (1.0 + cfg.rho * cfg.weight_decay)
    return tree_map(lambda x: (c * x).to(x.dtype), s_hat)


def init_state(model, gen: torch.Generator, cfg: FedLMConfig) -> FedLMState:
    """Random weights from ``gen`` (on the model's device) as the mirror
    parameter; zero variates (``()`` when the spec has none) and, with
    server momentum, a zero momentum buffer."""
    spec = cfg.federation_spec()
    params = params_tree(model.init(gen))
    opt = (tree_map(torch.zeros_like, params)
           if spec.server_momentum > 0.0 else ())
    step = torch.zeros((), dtype=torch.int64)
    if not spec.use_variates:
        return FedLMState(s_hat=params, v=(), v_i=(), step=step, opt=opt)
    v = tree_map(torch.zeros_like, params)
    v_i = tree_map(lambda x: torch.zeros((spec.n_clients,) + tuple(x.shape),
                                         dtype=x.dtype, device=x.device),
                   params)
    return FedLMState(s_hat=params, v=v, v_i=v_i, step=step, opt=opt)


def make_problem(model, cfg: FedLMConfig) -> api.MMProblem:
    """The quadratic surrogate (Example 1) on ``model.loss_fn`` as an
    ``api.MMProblem``: S_i = theta - rho * grad_i(theta) in the parameter
    dtype, T the l2 prox, the projection the identity.
    ``s_bar_metrics`` reports the client's loss from the same forward
    pass."""

    def s_bar_metrics(batch, theta):
        leaves, treedef = tree_flatten(theta)
        with torch.enable_grad():
            live = [x.detach().requires_grad_() for x in leaves]
            loss = model.loss_fn(tree_unflatten(treedef, live), batch)
            grads = torch.autograd.grad(loss, live)
        del live
        # S_i = theta - rho * g, written over each gradient (autograd's
        # fresh buffer, in the parameter dtype): no second tree
        s_i = [torch.sub(th, g.mul_(cfg.rho), out=g)
               for th, g in zip(leaves, grads)]
        return tree_unflatten(treedef, s_i), {"loss": loss.detach()}

    return api.MMProblem(
        s_bar=lambda batch, theta: s_bar_metrics(batch, theta)[0],
        s_bar_metrics=s_bar_metrics,
        T=lambda s: T_map(s, cfg))


def make_train_step(model, cfg: FedLMConfig, mesh=None):
    """Returns ``train_step(state, batch, key, gamma, **draws) -> (state,
    metrics)``. ``batch``: {"tokens": (n_clients, B_local, S), "labels":
    ...}; ``key``: the round's ``torch.Generator`` (participation, then the
    per-client, per-leaf dither seeds); ``draws``: ``active=``/``seeds=``
    handed to ``api.step`` in place of the key's draws.

    The round is one ``api.step`` on the driver's ``client_mode="scan"``
    (the module docstring says why); ``mesh=`` raises
    ``NotImplementedError`` (ROADMAP Queue A item 11g)."""
    if cfg.client_mode not in ("physical", "logical"):
        raise ValueError(f"client_mode={cfg.client_mode!r} (want "
                         f"'physical' or 'logical')")
    if mesh is not None:
        raise NotImplementedError(
            "the trainer on a mesh (physical silos sharded over mesh axes, "
            "the model over FSDP/TP) is ROADMAP Queue A item 11g")
    spec = cfg.federation_spec()
    use_cv = spec.use_variates
    problem = make_problem(model, cfg)
    device = model.device

    def train_step(state: FedLMState, batch, key, gamma, **draws):
        dstate = api.DriverState(x=state.s_hat, v=state.v, v_i=state.v_i,
                                 aux=(), opt=state.opt, step=state.step)
        new, m = api.step(problem, spec, dstate, batch, gamma, key,
                          device=device, client_mode="scan",
                          drift_metric=False, **draws)
        # the reference's metric names: e_s is ||h||^2, loss the mean of
        # the clients' losses
        metrics = {"loss": m["loss"], "e_s": m["h_norm_sq"],
                   "n_active": m["n_active"], "comm_bytes": m["comm_bytes"],
                   "omega_eff": m["omega_eff"]}
        return FedLMState(
            s_hat=new.x,
            v=new.v if use_cv else state.v,
            v_i=new.v_i if use_cv else state.v_i,
            step=new.step, opt=new.opt), metrics

    return train_step
