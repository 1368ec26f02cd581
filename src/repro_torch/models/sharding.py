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
spec; without rules, or for a plain tensor (eager PyTorch has no
constraint on a local tensor), it returns ``x``. The models call no
``shard`` yet: its first consumer is the dry run (ROADMAP Queue A item
12).
"""
from __future__ import annotations

from typing import Optional

from ..tree import tree_flatten, tree_unflatten
from .layers import params_tree

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


def shard(x, *logical_axes):
    """``x`` laid out by logical axis names: a ``DTensor`` redistributed
    to the installed rules' spec on its own mesh; ``x`` itself without
    rules or for a plain tensor."""
    if _RULES is None:
        return x
    spec = logical_to_spec(*logical_axes)
    if getattr(x, "placements", None) is None:
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


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

