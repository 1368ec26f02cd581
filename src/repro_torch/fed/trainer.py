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
            ``"scan"``, as the reference maps it. No mesh: a mesh raises
            ``ValueError``, as the reference's ``api.step`` refuses
            ``"scan"`` on a mesh.
  physical  the reference's batched silos (its ``"vmap"``, optionally on a
            mesh). Without a mesh the port runs them on ``"scan"`` as well:
            the two modes give the same trajectory, as the reference pins
            both of its modes to one frozen trajectory
            (``tests/test_fed_trainer.py``). On a mesh (``mesh=`` a
            ``DeviceMesh`` with a ``client_axis`` dim) each rank runs its
            own block of silos (``api.local_rows``) one after another,
            stacks their payloads and runs the driver's mesh tail:
            ``uplink="gather"`` gathers the encoded buffers over the
            client dim, ``"reduce"`` decodes, masks and mu-reduces the
            rank's stack (with no variates through the fused decode +
            reduce kernel) and sums the float32 partial over the dim. A
            rank holds its clients' payloads, never their gradients.
            There the batch and ``v_i`` hold the rank's rows
            (``interop.fedlm_state_for_rank``).

``state_specs`` and ``batch_spec`` give the state's and the batch's
layout on the production mesh (``models.sharding``), for the dry run.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import api
from ..core import compression
from ..core.compression import Compressor
from ..models import sharding as shd
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
    attn_mode: str = "sharded"     # "replicated": attention weights not
                                   # sharded over 'model' (state_specs)
    mlp_mode: str = "generic"      # "megatron": row-parallel w_out/wo
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
        # (on DTensors, each gradient reduced to its leaf's layout first)
        grads = [shd.placed_like(g, th) for th, g in zip(leaves, grads)]
        s_i = [torch.sub(th, g.mul_(cfg.rho), out=g)
               for th, g in zip(leaves, grads)]
        return tree_unflatten(treedef, s_i), {"loss": loss.detach()}

    return api.MMProblem(
        s_bar=lambda batch, theta: s_bar_metrics(batch, theta)[0],
        s_bar_metrics=s_bar_metrics,
        T=lambda s: T_map(s, cfg))


def make_train_step(model, cfg: FedLMConfig, mesh=None,
                    client_axis: str = "clients", uplink: str = "gather"):
    """Returns ``train_step(state, batch, key, gamma, **draws) -> (state,
    metrics)``. ``batch``: {"tokens": (n_clients, B_local, S), "labels":
    ...} (on a mesh, the rank's rows of the client dim); ``key``: the
    round's ``torch.Generator`` (participation, then the per-client,
    per-leaf dither seeds; every rank draws the whole round); ``draws``:
    ``active=``/``seeds=`` handed to ``api.step`` in place of the key's
    draws.

    Without a mesh the round is one ``api.step`` on the driver's
    ``client_mode="scan"`` (the module docstring says why), and
    ``uplink="reduce"`` raises there, as the reference's does. With
    ``mesh=`` physical silos take the driver's mesh path with the rank's
    clients run in sequence, ``uplink`` passing through (``"gather"`` or
    ``"reduce"``); logical clients on a mesh raise ``ValueError``. The
    metrics carry ``collective_payload_bytes`` on a mesh."""
    if cfg.client_mode not in ("physical", "logical"):
        raise ValueError(f"client_mode={cfg.client_mode!r} (want "
                         f"'physical' or 'logical')")
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch.distributed.device_mesh."
                            f"DeviceMesh, got {type(mesh).__name__}")
        if cfg.client_mode == "logical":
            raise ValueError(
                "logical clients run in sequence on one device (the "
                "driver's client_mode='scan'), which has no mesh path — "
                "drop mesh= or use client_mode='physical'")
    spec = cfg.federation_spec()
    use_cv = spec.use_variates
    problem = make_problem(model, cfg)
    device = model.device
    route = (dict(client_mode="scan") if mesh is None else
             dict(client_mode="vmap", mesh=mesh, client_axis=client_axis,
                  _oracle_loop=True))

    def train_step(state: FedLMState, batch, key, gamma, **draws):
        dstate = api.DriverState(x=state.s_hat, v=state.v, v_i=state.v_i,
                                 aux=(), opt=state.opt, step=state.step)
        new, m = api.step(problem, spec, dstate, batch, gamma, key,
                          device=device, uplink=uplink, drift_metric=False,
                          **route, **draws)
        # the reference's metric names: e_s is ||h||^2, loss the mean of
        # the clients' losses
        metrics = {"loss": m["loss"], "e_s": m["h_norm_sq"],
                   "n_active": m["n_active"], "comm_bytes": m["comm_bytes"],
                   "omega_eff": m["omega_eff"]}
        if "collective_payload_bytes" in m:
            metrics["collective_payload_bytes"] = \
                m["collective_payload_bytes"]
        return FedLMState(
            s_hat=new.x,
            v=new.v if use_cv else state.v,
            v_i=new.v_i if use_cv else state.v_i,
            step=new.step, opt=new.opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# the layout of the state and the batches (for the dry run)
# ---------------------------------------------------------------------------

def state_specs(params_shapes, cfg: FedLMConfig, fsdp, tp="model",
                fsdp_size=16, tp_size=16):
    """Spec trees (``models.sharding``) of ``(s_hat, v, v_i)`` for the
    parameters ``params_shapes`` (a tree of real, fake or meta tensors).
    physical: the client dim over the fsdp axes, inner dims over tp only;
    logical: the client dim unsharded, inner dims over (fsdp, tp). Without
    variates ``v`` and ``v_i`` are ``()``."""
    use_cv = cfg.federation_spec().use_variates
    if cfg.client_mode == "physical":
        pspec = shd.param_specs(params_shapes, fsdp=(), fsdp_size=10**9,
                                tp=tp, tp_size=tp_size,
                                attn_mode=cfg.attn_mode,
                                mlp_mode=cfg.mlp_mode)
        lead = fsdp
    else:
        pspec = shd.param_specs(params_shapes, fsdp=fsdp, fsdp_size=fsdp_size,
                                tp=tp, tp_size=tp_size,
                                attn_mode=cfg.attn_mode,
                                mlp_mode=cfg.mlp_mode)
        lead = None
    if not use_cv:
        return pspec, (), ()
    vi_spec = tree_map(lambda s: shd.canonical((lead,) + s), pspec,
                       is_leaf=shd.is_spec)
    return pspec, pspec, vi_spec


def batch_spec(cfg: FedLMConfig, fsdp) -> tuple:
    """The spec of ``tokens`` (n, B_local, S): physical -> the client dim
    over the client axes; logical -> the local-batch dim over them."""
    if cfg.client_mode == "physical":
        return shd.canonical((fsdp, None, None))
    return shd.canonical((None, fsdp, None))
