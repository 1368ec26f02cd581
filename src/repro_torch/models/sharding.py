"""Logical-axis sharding rules (the port of ``repro/models/sharding.py``):
the 2-D FSDP x TP weight layout and the decode-cache layout as data, and
the one converter that hands a layout to ``torch.distributed.tensor``.

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), a mesh-dim name, or a tuple of names (one tensor dim split
over several mesh dims, major first). Entries are normalised as
``jax.sharding.PartitionSpec`` normalises them (a tuple of one name is the
name, an empty tuple is ``None``), so ``spec == tuple(PartitionSpec(...))``
entry for entry. ``placements(spec, mesh)`` turns a spec into the
``Shard``/``Replicate`` list that ``distribute_tensor`` takes.

The layout (DESIGN.md §5), with ``fsdp`` the client axes (``("data",)``
or ``("pod", "data")``) and ``tp`` = ``"model"``:

  expert stacks (E, a, b)  -> (tp on E, fsdp on a, None)   expert parallel
  embed/lm_head (V, d)     -> (tp, fsdp)                   vocab + FSDP
  any other >=2-D weight   -> (..., fsdp on dim[-2], tp on dim[-1])
  1-D / norms / small dims -> replicated

A dim is sharded only where its size divides the mesh dims' product.

One tensor per layer. The reference stacks each cycle position's layers
along a leading axis and its rule reads that axis as a dimension; the port
keeps one tensor per layer (``params["layers"][i]``, audio's
``params["encoder"][i]``). A layer's leaf takes the reference's rule on
``(1,) + shape`` with the leading entry dropped, which is what the
reference gives the layer's own axes (tp on a 1-D leaf's axis, ``nd - 2``
/ ``nd - 1`` on weights, the expert dim at ``nd - 3`` of the stacked
rank). The port has no stack axis to shard, so where the reference shards
it (fsdp on the block axis of a per-layer 1-D leaf whose block count the
fsdp size divides: rwkv6-3b's 32 blocks at fsdp 16 and 32, the norm
scales of internvl2-26b's and llama4-maverick's 48 blocks at fsdp 16)
the port's leaf is replicated over fsdp instead. The per-layer decode
cache has no block axis either: the cache rule reads batch at dim 1 of
the stacked rank, so it too sees ``(1,) + shape``.

``shard(x, *axes)`` redistributes a ``DTensor`` to the installed rules'
spec (a mesh dim that does not divide its tensor dim is left out, as the
weight rules leave it); without rules, or for a plain tensor (eager
PyTorch has no constraint on a local tensor), it returns ``x``. The models
call it where the reference constrains an activation: the embedding's
output, the MLP's hidden, the KV cache and the MoE's dispatch buffer.
The dry run (``launch/dryrun.py``) installs the rules and runs the models
on ``DTensor``s, which more helpers make possible; each is the
identity on plain tensors:

* ``like(t, ref)``: a constant a layer builds (RoPE's angles, a mask, a
  zero state) replicated on ``ref``'s mesh, so no operation mixes a
  plain tensor with a ``DTensor``;
* ``splittable(x, n)`` and ``merge_heads(x)``: the head split of a last
  dim sharded over mesh dims that do not divide the head count (phi3's 40
  heads over 16) gathers it first, forward and, for the merge, backward;
* ``placed_like(g, ref)``: a gradient reduced to its parameter's layout;
* ``write_slot(t, slot, val)``: decode's in-place write of a cache slot;
* ``whole(x)``: a value the host reads (the MoE's counts);
* ``replicated(x)``: token ids gathered before a vocab-sharded lookup,
  and ``reduced(x)``: a vocab-sharded gather's result summed before it
  is reshaped.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..tree import tree_flatten, tree_unflatten

# installed by the launcher: logical axis name -> mesh dim (or tuple)
_RULES: Optional[dict] = None

# the trees of a parameter or cache tree that hold one tree per layer
_PER_LAYER = ("layers", "encoder")


def install_rules(rules: Optional[dict]) -> None:
    global _RULES
    _RULES = rules


def get_rules() -> Optional[dict]:
    return _RULES


def _entry(e):
    """A spec entry as ``PartitionSpec`` normalises it."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


def canonical(spec) -> tuple:
    """``spec`` with every entry normalised (``("data",)`` -> ``"data"``,
    ``()`` -> ``None``)."""
    return tuple(_entry(e) for e in spec)


def is_spec(x) -> bool:
    """A spec leaf of a spec tree (``tree_map(..., is_leaf=is_spec)``)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def logical_to_spec(*logical_axes) -> tuple:
    if _RULES is None:
        raise RuntimeError("no logical-axis rules installed "
                           "(install_rules)")
    return canonical(_RULES.get(a) if a is not None else None
                     for a in logical_axes)


def placements(spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where the mesh dim appears at tensor dim ``d``,
    ``Replicate()`` elsewhere. A tuple entry shards one tensor dim over
    its mesh dims major first, which ``DTensor`` does when they stand in
    the mesh in that order; another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names or ())
    out = [Replicate() for _ in names]
    for d, e in enumerate(canonical(spec)):
        if e is None:
            continue
        group = (e,) if isinstance(e, str) else e
        idx = []
        for name in group:
            if name not in names:
                raise ValueError(f"spec entry {e!r} names {name!r}, not a "
                                 f"dim of the mesh {tuple(names)}")
            i = names.index(name)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dim {name!r} shards two tensor dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} orders its mesh dims "
                             f"otherwise than the mesh {tuple(names)}")
    return out


def _names(e) -> tuple:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (it has placements), without
    importing ``torch.distributed.tensor``."""
    return getattr(x, "placements", None) is not None


def shard(x, *logical_axes):
    """``x`` laid out by logical axis names: a ``DTensor`` redistributed
    to the installed rules' spec on its own mesh (an entry whose mesh dims
    do not divide the tensor dim replicated); ``x`` itself without rules
    or for a plain tensor."""
    if _RULES is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    spec = []
    for size, e in zip(x.shape, logical_to_spec(*logical_axes)):
        n = math.prod(int(sizes[a]) for a in _names(e))
        spec.append(e if e is None or size % n == 0 else None)
    return x.redistribute(mesh, placements(spec, mesh))


def splittable(x, n: int):
    """``x`` ready to have its last dim split into ``n`` blocks (heads): a
    ``DTensor`` whose last dim is sharded over mesh dims whose product does
    not divide ``n`` is gathered along it first; ``x`` itself otherwise."""
    if not is_dtensor(x):
        return x
    last, split = x.ndim - 1, 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(last) or pl.is_shard(-1):
            split *= x.device_mesh.size(i)
    if n % split == 0:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_shard(last) or pl.is_shard(-1) else pl
        for pl in x.placements])


def merge_heads(x):
    """``x`` (..., n, hd) as (..., n * hd). On a ``DTensor`` the gradient
    is made ``splittable`` before the backward splits it again (DTensor's
    view cannot split an unevenly sharded dim)."""
    if not is_dtensor(x):
        return x.reshape(x.shape[:-2] + (-1,))
    return _MergeHeads.apply(x)


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return x.reshape(x.shape[:-2] + (-1,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape = inputs[0].shape

    @staticmethod
    def backward(ctx, g):
        return splittable(g, ctx.shape[-2]).reshape(ctx.shape)


def replicated(x):
    """A ``DTensor`` replicated over its whole mesh; ``x`` itself for a
    plain tensor."""
    if not is_dtensor(x) or all(pl.is_replicate() for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def write_slot(t, slot: int, val):
    """``t[:, slot] = val[:, 0]`` in place; returns ``t``. On a ``DTensor``
    the write goes into the local block of the rank whose block along dim
    1 holds ``slot``, ``val`` laid out as ``t`` on every other dim first
    (a slice write into a ``DTensor`` sharded along dim 1 would go into a
    gathered copy and be lost)."""
    if not is_dtensor(t):
        t[:, slot:slot + 1] = val
        return t
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = t.device_mesh
    val = val.redistribute(mesh, [Replicate() if pl.is_shard(1) else pl
                                  for pl in t.placements])
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)
    i = slot - offset[1]
    if 0 <= i < shape[1]:
        t.to_local()[:, i:i + 1] = val.to_local()
    return t


def whole(x):
    """``x``'s global value on this rank: a ``DTensor`` replicated, then its
    local tensor; ``x`` itself otherwise."""
    return replicated(x).to_local() if is_dtensor(x) else x


def reduced(x):
    """A ``DTensor`` whose pending reductions (a partial sum, a
    vocab-sharded lookup's masked rows) are done, those mesh dims
    replicated; ``x`` itself otherwise. A masked lookup's partial cannot
    outlive a reshape of its result."""
    if not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in x.placements])


def placed_like(t, ref):
    """``t`` redistributed to ``ref``'s placements when both are
    ``DTensor``s that differ (a gradient reduced to its parameter's
    layout); ``t`` itself otherwise."""
    if (not is_dtensor(t) or not is_dtensor(ref)
            or tuple(t.placements) == tuple(ref.placements)):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def like(t, ref):
    """``t``, a constant a layer builds beside ``ref``, as a ``DTensor``
    replicated on ``ref``'s mesh when ``ref`` is a ``DTensor`` and ``t``
    is not; ``t`` itself otherwise (always, for plain tensors)."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# the rules (the reference's arithmetic, on a shape)
# ---------------------------------------------------------------------------

def _spec_for(path: str, shape, fsdp, fsdp_size: int, tp, tp_size: int,
              attn_mode: str = "sharded", mlp_mode: str = "generic") -> list:
    nd = len(shape)

    def div(dim, size):
        return shape[dim] % size == 0 and shape[dim] >= size

    base = [None] * nd
    name = path.split("/")[-1]
    if nd < 2:
        return base
    if attn_mode == "replicated" and name.split(".")[0] in (
            "wq", "wk", "wv", "wo"):
        # attention projections replicated over 'model'
        if fsdp and div(nd - 2, fsdp_size):
            base[nd - 2] = fsdp
        return base
    if mlp_mode == "megatron" and name.startswith(("w_out", "wo")) \
            and "expert" not in path:
        # row-parallel w_out/wo against the column-parallel inputs
        if div(nd - 2, tp_size):
            base[nd - 2] = tp
        if div(nd - 1, fsdp_size):
            base[nd - 1] = fsdp
        return base
    if "expert" in path and nd >= 3:
        e_dim = nd - 3
        if div(e_dim, tp_size):
            base[e_dim] = tp                   # expert parallelism
        if div(nd - 2, fsdp_size):
            base[nd - 2] = fsdp
        return base
    if name in ("embed", "lm_head"):
        if div(nd - 2, tp_size):
            base[nd - 2] = tp
        if div(nd - 1, fsdp_size):
            base[nd - 1] = fsdp
        return base
    if div(nd - 2, fsdp_size):
        base[nd - 2] = fsdp
    if div(nd - 1, tp_size):
        base[nd - 1] = tp
    return base


def _cache_spec_for(path: str, shape, batch_axes, batch_size: int,
                    tp: str, tp_size: int) -> list:
    """KV caches shard batch over the client axes and sequence over
    'model' (split-K decode attention); recurrent states shard batch and
    channels. ``shape`` has the reference's leading block axis."""
    name = path.split("/")[-1]
    nd = len(shape)
    base = [None] * nd

    def div(dim, size):
        return shape[dim] % size == 0 and shape[dim] >= size

    if nd >= 2 and div(1, batch_size):
        base[1] = batch_axes
    if name in ("k", "v", "ek", "ev", "k_scale", "v_scale") and nd == 5:
        if div(2, tp_size):
            base[2] = tp                       # sequence over 'model'
    elif name in ("shift_tm", "shift_cm") and nd == 3:
        if div(2, tp_size):
            base[2] = tp
    elif name == "wkv" and nd == 5:
        if div(4, tp_size):
            base[4] = tp
    elif name == "conv" and nd == 4:
        if div(3, tp_size):
            base[3] = tp
    elif name == "ssm" and nd == 4:
        if div(2, tp_size):
            base[2] = tp
    return base


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

def leaf_paths(tree, is_leaf=None, prefix: str = "") -> list:
    """``"a/b/0/c"`` path strings of ``tree``'s leaves, in ``tree_flatten``
    order (dicts by sorted key), as the reference names a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [prefix[:-1]]
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], is_leaf, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in leaf_paths(t, is_leaf, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [prefix[:-1]]


def _spec_tree(tree, rule, per_layer) -> object:
    """``rule(path, shape)`` over the leaves of ``tree``; a leaf for which
    ``per_layer(path)`` holds takes the rule on ``(1,) + shape`` with the
    leading entry dropped."""
    from .layers import params_tree
    tree = params_tree(tree)
    leaves, treedef = tree_flatten(tree)
    specs = []
    for path, leaf in zip(leaf_paths(tree), leaves):
        shape = tuple(leaf.shape)
        if per_layer(path):
            spec = rule(path, (1,) + shape)[1:]
        else:
            spec = rule(path, shape)
        specs.append(canonical(spec))
    return tree_unflatten(treedef, specs)


def param_specs(params, fsdp=("data",), fsdp_size: int = 16,
                tp: str = "model", tp_size: int = 16,
                attn_mode: str = "sharded", mlp_mode: str = "generic"):
    """A spec tree of ``params`` (a ``Params`` module or its plain tree;
    real, fake or meta tensors) in the layout above: the rule on each
    leaf's shape, a layer's leaves as one block of the reference's stack
    (the module docstring)."""
    fsdp = tuple(fsdp) if not isinstance(fsdp, str) else fsdp
    return _spec_tree(
        params,
        lambda path, shape: _spec_for(path, shape, fsdp, fsdp_size, tp,
                                      tp_size, attn_mode, mlp_mode),
        lambda path: path.split("/")[0] in _PER_LAYER)


def cache_specs(caches, batch_axes, batch_size: int, tp: str = "model",
                tp_size: int = 16):
    """A spec tree of the per-layer decode caches (``Model.init_cache`` or
    ``prefill``'s: a list of one dict a layer), each leaf read as one
    block of the reference's stacked cache."""
    batch_axes = (tuple(batch_axes) if not isinstance(batch_axes, str)
                  else batch_axes)
    return _spec_tree(
        caches,
        lambda path, shape: _cache_spec_for(path, shape, batch_axes,
                                            batch_size, tp, tp_size),
        lambda path: True)

