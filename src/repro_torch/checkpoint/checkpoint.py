"""Dependency-free pytree checkpoints (the counterpart of
``repro/checkpoint/checkpoint.py``): one self-describing ``.npz`` holding
the leaves, the tree's structure and the per-leaf dtypes, and a
``.spec.json`` sidecar with the same metadata for people to read.

Crash consistency: ``save`` writes a temporary file in the target
directory, fsyncs it and publishes it with ``os.replace`` (atomic on
POSIX), so a reader sees the old complete checkpoint or the new one,
never a torn file. ``restore`` verifies the structure against ``like``
(the tree's structure, the leaf count, every leaf's shape and dtype) and
raises on a mismatch rather than casting or rebinding leaves.

Leaves are tensors (moved to the host) or arrays; bfloat16 crosses as
its 16-bit pattern, since numpy has no bfloat16.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from ..tree import tree_flatten, tree_unflatten


def _atomic_write_bytes(path: str, write_fn) -> None:
    """Write via ``write_fn(file_object)`` to a temp file in ``path``'s
    directory, fsync, then ``os.replace`` into place."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def treedef_repr(treedef) -> str:
    """A stable text form of a ``tree_flatten`` structure (stored in files
    and compared on restore)."""
    return repr(treedef)


def dtype_name(x) -> str:
    """``"float32"``, ``"bfloat16"``, ...: a tensor's or array's dtype."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def to_host_array(x) -> np.ndarray:
    """A tensor (a CPU one; bfloat16 as its int16 bits) or an array-like
    -> a numpy array."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("move tensors to the host before encoding")
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    return np.asarray(x)


def from_host_array(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """Inverse of ``to_host_array`` for a stored tensor of ``dtype``."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    return t


def save(path: str, tree: Any) -> None:
    leaves, treedef = tree_flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {f"leaf_{i}": to_host_array(x.cpu() if isinstance(x, torch.Tensor)
                                       else x)
            for i, x in enumerate(leaves)}
    meta = {"treedef": treedef_repr(treedef), "n_leaves": len(leaves),
            "dtypes": [dtype_name(x) for x in leaves]}
    npz_path = path if path.endswith(".npz") else path + ".npz"
    _atomic_write_bytes(
        npz_path,
        lambda f: np.savez(f, __meta__=np.asarray(json.dumps(meta)), **arrs))
    _atomic_write_bytes(
        _spec_path(path),
        lambda f: f.write(json.dumps(meta).encode("utf-8")))


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``, each leaf on ``like``'s
    leaf's device. The stored structure, leaf count, shapes and dtypes
    are all verified; a mismatch raises."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves, treedef = tree_flatten(like)
    meta = json.loads(str(npz["__meta__"]))
    data_keys = [k for k in npz.files if k.startswith("leaf_")]
    if len(leaves) != len(data_keys):
        raise ValueError(f"checkpoint has {len(data_keys)} leaves, "
                         f"expected {len(leaves)}")
    if meta["treedef"] != treedef_repr(treedef):
        raise ValueError(
            f"checkpoint treedef does not match the restore target:\n"
            f"  stored:   {meta['treedef']}\n"
            f"  restore:  {treedef_repr(treedef)}\n"
            f"(restoring across structures silently rebinds leaves — "
            f"rebuild `like` with the saved structure instead)")
    out = []
    for i, ref in enumerate(leaves):
        arr = npz[f"leaf_{i}"]
        shape = tuple(ref.shape) if hasattr(ref, "shape") else arr.shape
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {i}: shape {arr.shape} != {shape}")
        stored, want = meta["dtypes"][i], dtype_name(ref)
        if stored != want:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {stored} != restore target "
                f"dtype {want} — convert explicitly if the cast is intended")
        t = from_host_array(arr, stored)
        if isinstance(ref, torch.Tensor):
            t = t.to(ref.device)
        out.append(t)
    return tree_unflatten(treedef, out)


def _spec_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".spec.json"
