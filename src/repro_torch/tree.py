"""Pytrees of tensors: nested dicts, lists and tuples (and NamedTuples).

``jax.tree`` flattens a dict in sorted-key order, and the port must give
the same leaf order: the i-th per-leaf dither seed belongs to the i-th
leaf. ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

Pytree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(x):
    if isinstance(x, dict):
        keys = sorted(x)
        return [x[k] for k in keys], ("dict", keys)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return list(x), ("namedtuple", type(x))
    if isinstance(x, tuple):
        return list(x), ("tuple", None)
    return list(x), ("list", None)


def _rebuild(meta, children):
    kind, aux = meta
    if kind == "dict":
        return dict(zip(aux, children))
    if kind == "namedtuple":
        return aux(*children)
    if kind == "tuple":
        return tuple(children)
    return list(children)


# The walkers are module-level functions, not recursive closures: a
# closure that calls itself is a reference cycle, and it would keep the
# leaves (full-size tensors) alive until the garbage collector runs.

def _walk(x, is_leaf, leaves: list):
    if x is None:
        return ("none", None)
    if (is_leaf is not None and is_leaf(x)) or not _is_node(x):
        leaves.append(x)
        return ("leaf", None)
    kids, meta = _children(x)
    return ("node", (meta, [_walk(k, is_leaf, leaves) for k in kids]))


def _build(d, it):
    kind, payload = d
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    meta, kids = payload
    return _rebuild(meta, [_build(k, it) for k in kids])


def tree_flatten(tree: Pytree, is_leaf: Optional[Callable] = None):
    """Returns ``(leaves, treedef)``; ``tree_unflatten(treedef, leaves)``
    rebuilds the tree."""
    leaves = []
    treedef = _walk(tree, is_leaf, leaves)
    return leaves, treedef


def tree_unflatten(treedef, leaves) -> Pytree:
    it = iter(leaves)
    out = _build(treedef, it)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return out


def tree_leaves(tree: Pytree, is_leaf: Optional[Callable] = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree,
             is_leaf: Optional[Callable] = None) -> Pytree:
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf) for r in rest]
    for ls, _ in others:
        if len(ls) != len(leaves):
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(
        treedef, [fn(x, *(o[0][i] for o in others))
                  for i, x in enumerate(leaves)])


def _walk_paths(x, is_leaf, prefix: str, out: list) -> None:
    if x is None:
        return
    if (is_leaf is not None and is_leaf(x)) or not _is_node(x):
        out.append((prefix, x))
        return
    kids, (kind, aux) = _children(x)
    if kind == "dict":
        names = [f"[{k!r}]" for k in aux]
    elif kind == "namedtuple":
        names = [f".{f}" for f in aux._fields]
    else:
        names = [f"[{i}]" for i in range(len(kids))]
    for name, kid in zip(names, kids):
        _walk_paths(kid, is_leaf, prefix + name, out)


def tree_leaves_with_path(tree: Pytree,
                          is_leaf: Optional[Callable] = None) -> list:
    """``(path, leaf)`` pairs in leaf order, each path written as
    ``jax.tree_util.keystr`` writes it (``['w']``, ``[0]``, ``.x``)."""
    out = []
    _walk_paths(tree, is_leaf, "", out)
    return out
