"""Carry weights and driver state between numpy and the port.

The caller turns the JAX package's parameters or ``DriverState`` into numpy
(``jax.tree.map(np.asarray, tree)``); ``to_torch`` makes the port's
tensors of them on the GPU, or on the device the caller names, and
``to_numpy`` goes back. uint32
arrays (seeds, digests) become int64 tensors, since PyTorch has little
uint32 arithmetic. bfloat16 arrays (``ml_dtypes.bfloat16``, which
``torch.tensor`` cannot take) cross through their 16-bit pattern, bit for
bit. ``model_params_to_torch`` carries a model's weights across and
``model_params_to_numpy`` brings a per-layer tree (weights or their
gradients) back to the reference's layout; ``fedlm_state_to_torch``
carries the LM trainer's state, ``ot_state_to_torch`` the FedMM-OT and
FedAdam states, and ``state_for_rank`` and ``fedlm_state_for_rank`` a
whole driver or LM trainer state to one rank of a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from .api.driver import DriverState, resolve_device
from .fed.trainer import FedLMState
from .models import transformer as T
from .models.layers import Params, params_tree
from .optim.optimizers import AdamState
from .tree import tree_map


def _leaf_to_torch(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    if arr.dtype.name == "bfloat16":
        bits = torch.tensor(arr.view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    return torch.tensor(arr, device=device)


def to_torch(tree, device=None):
    """A pytree of numpy arrays (or array-likes) -> tensors on ``device``:
    the GPU unless the caller asks for another (raises without one)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev), tree)


def to_numpy(tree):
    """A pytree of tensors -> numpy arrays (on the host)."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def state_to_torch(state, device=None) -> DriverState:
    """Any object with the fields ``x, v, v_i, aux, opt, step`` (e.g. the
    reference's ``DriverState`` with numpy leaves) -> the port's
    ``DriverState`` on ``device`` (the GPU unless asked otherwise)."""
    return DriverState(*(to_torch(getattr(state, f), device)
                         for f in DriverState._fields))


def state_to_numpy(state: DriverState) -> DriverState:
    """The port's ``DriverState`` with numpy leaves; the reference's
    ``DriverState(*state_to_numpy(s))`` rebuilds its own."""
    return DriverState(*(to_numpy(f) for f in state))


def state_for_rank(state, spec, mesh, client_axis: str = "clients",
                   device=None) -> DriverState:
    """A whole ``DriverState`` (the reference's with numpy leaves, or the
    port's) -> this rank's layout on ``mesh``: the replicated fields
    whole, the rows of ``v_i`` that the rank's clients own
    (``api.local_rows``), on ``device`` (the GPU unless asked otherwise)."""
    from .api.driver import local_rows
    lo, hi = local_rows(spec, mesh, client_axis)
    ours = state_to_torch(state, device)
    return ours._replace(v_i=tree_map(lambda x: x[lo:hi], ours.v_i))


def fedlm_state_for_rank(state: FedLMState, spec, mesh,
                         client_axis: str = "clients",
                         device=None) -> FedLMState:
    """A whole ``FedLMState`` (the port's, or ``fedlm_state_to_torch``'s)
    -> this rank's layout on ``mesh``: ``s_hat``, ``v``, ``opt`` and
    ``step`` whole, the rows of ``v_i`` that the rank's clients own
    (``api.local_rows`` of the trainer's ``FederationSpec``), on ``device``
    (the GPU unless asked otherwise)."""
    from .api.driver import local_rows
    lo, hi = local_rows(spec, mesh, client_axis)
    ours = FedLMState(*(to_torch(f, device) for f in state))
    return ours._replace(v_i=tree_map(lambda x: x[lo:hi], ours.v_i))


def model_params_to_torch(cfg, np_params, device=None) -> Params:
    """The reference's ``build_model(cfg).init(key)`` tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``) -> the port's parameters on
    ``device`` (the GPU unless asked otherwise). The reference stacks each
    cycle position's layers along a leading axis (``params["stack"]``, one
    tree per position); the port keeps one tree per layer, so layer ``i``
    is block ``i // c`` of position ``i % c`` for a cycle of ``c``. The
    audio family's encoder (``"encoder"``, one cycle position over its
    ``n_encoder_layers``) becomes one tree per encoder layer, and
    ``"enc_norm"`` crosses as it is."""
    return Params(to_torch(_unstack(cfg, np_params), resolve_device(device)))


# the trees beside the layer stack that cross as they are
_WHOLE = ("embedding", "final_norm", "enc_norm")


def _unstack_layers(stack, pattern, lead: int):
    c = T._cycle(pattern)
    index = (slice(None),) * lead
    return [tree_map(lambda a, i=i: a[index + (i // c,)], stack[i % c])
            for i in range(len(pattern))]


def _stack_layers(layers, pattern):
    c = T._cycle(pattern)
    return tuple(tree_map(lambda *xs: np.stack(xs), *layers[pos::c])
                 for pos in range(c))


def _unstack(cfg, tree, lead: int = 0):
    """The reference's layout (``tree["stack"]`` and, for audio,
    ``tree["encoder"]``: one tree per cycle position, each leaf's axis
    ``lead`` over the cycle's blocks) -> the port's (``"layers"`` and
    ``"encoder"``: one tree per layer)."""
    out = {key: tree[key] for key in _WHOLE if key in tree}
    out["layers"] = _unstack_layers(tree["stack"], T.layer_pattern(cfg),
                                    lead)
    if "encoder" in tree:
        out["encoder"] = _unstack_layers(tree["encoder"], ["enc_mlp"] *
                                         cfg.n_encoder_layers, lead)
    return out


def model_params_to_numpy(cfg, params) -> dict:
    """The port's per-layer tree (a ``Params`` module, or a plain tree such
    as the trainer's iterate or the gradients of ``loss_fn``) -> the
    reference's layout with numpy leaves: ``"stack"`` a tuple of one tree
    per cycle position, each leaf stacked over the cycle's blocks (and
    audio's ``"encoder"`` as one position over its layers)."""
    tree = to_numpy(params_tree(params))
    out = {key: tree[key] for key in _WHOLE if key in tree}
    out["stack"] = _stack_layers(tree["layers"], T.layer_pattern(cfg))
    if "encoder" in tree:
        out["encoder"] = _stack_layers(tree["encoder"], ["enc_mlp"] *
                                       cfg.n_encoder_layers)
    return out


def fedlm_state_to_torch(cfg, state, device=None) -> FedLMState:
    """The reference's ``FedLMState`` with numpy leaves -> the port's
    ``fed.trainer.FedLMState`` on ``device`` (the GPU unless asked
    otherwise): ``s_hat``, ``v`` and ``opt`` as per-layer trees, ``v_i``
    per layer with its leading client axis; an empty ``v``, ``v_i`` or
    ``opt`` (no variates, no momentum) becomes ``()``."""
    dev = resolve_device(device)

    def tree(t, lead=0):
        if isinstance(t, (dict, tuple)) and not t:
            return ()
        return to_torch(_unstack(cfg, t, lead), dev)

    return FedLMState(s_hat=tree(state.s_hat), v=tree(state.v),
                      v_i=tree(state.v_i, lead=1),
                      step=to_torch(state.step, dev), opt=tree(state.opt))


def ot_state_to_torch(state, cls, device=None):
    """The reference's ``FedOTState`` or ``FedAdamState`` with numpy leaves
    (``AdamState`` inside) -> the port's NamedTuple ``cls`` of the same
    fields (``core.fedmm_ot.FedOTState`` or ``FedAdamState``) on
    ``device`` (the GPU unless asked otherwise). ``to_torch`` alone would
    rebuild the reference's own NamedTuple types."""
    dev = resolve_device(device)
    fields = {}
    for name in cls._fields:
        value = getattr(state, name)
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            value = AdamState(*(to_torch(getattr(value, f), dev)
                                for f in AdamState._fields))
        else:
            value = to_torch(value, dev)
        fields[name] = value
    return cls(**fields)
