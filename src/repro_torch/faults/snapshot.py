"""Crash-consistent round snapshots: one atomic, self-describing file (the
counterpart of ``repro/faults/snapshot.py``, in the same file format).

``save_snapshot`` serializes a host structure (nested dicts with string
keys, lists, tuples, ``None``, Python scalars, numpy arrays and CPU
tensors) into one file published with temp file + fsync + ``os.replace``
(``checkpoint._atomic_write_bytes``): a crash mid-save leaves the previous
complete snapshot in place.

The container is a raw stream: a magic line, the length-prefixed JSON
skeleton of the structure, then each referenced array in ``.npy``
encoding, in reference order. The large writes release the GIL, so the
scheduler's background writer does not stall the round loop. A tensor is
stored as a ``"tensor"`` node with its dtype (bfloat16 as its 16-bit
pattern) and comes back as a CPU tensor of that dtype; numpy arrays come
back as numpy. A file the reference wrote from plain numpy structures
reads back here.

Tensors must be on the host before they reach ``save_snapshot``: the
writer thread never touches a device tensor.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from ..checkpoint.checkpoint import (_atomic_write_bytes, dtype_name,
                                     from_host_array, to_host_array)

_MAGIC = b"REPRO-SNAP-v1\n"


def save_snapshot(path: str, obj: Any) -> None:
    arrays = []

    def enc(o):
        if o is None:
            return ["none"]
        if isinstance(o, bool):           # before int: bool is an int
            return ["bool", o]
        if isinstance(o, int):
            return ["int", o]
        if isinstance(o, float):
            return ["float", o]
        if isinstance(o, str):
            return ["str", o]
        if isinstance(o, dict):
            for k in o:
                if not isinstance(k, str):
                    raise TypeError(
                        f"snapshot dict keys must be str, got {k!r}")
            return ["dict", [[k, enc(v)] for k, v in o.items()]]
        if isinstance(o, tuple):
            return ["tuple", [enc(v) for v in o]]
        if isinstance(o, list):
            return ["list", [enc(v) for v in o]]
        if isinstance(o, torch.Tensor):
            if o.device.type != "cpu":
                raise ValueError(
                    f"snapshot got a {o.device.type} tensor: copy it to the "
                    f"host before handing it to the writer")
            arrays.append(to_host_array(o))
            return ["tensor", len(arrays) - 1, dtype_name(o)]
        arr = np.asarray(o)
        if arr.dtype == object:
            raise TypeError(f"cannot snapshot object of type {type(o)}")
        arrays.append(arr)
        return ["array", len(arrays) - 1]

    tree = enc(obj)
    blob = json.dumps(tree).encode("utf-8")

    def write(f):
        f.write(_MAGIC)
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for arr in arrays:
            np.lib.format.write_array(f, arr, allow_pickle=False)

    _atomic_write_bytes(path, write)


def load_snapshot(path: str) -> Any:
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{path!r} is not a repro snapshot (bad magic {magic!r})")
        n = int.from_bytes(f.read(8), "little")
        tree = json.loads(f.read(n).decode("utf-8"))

        refs = []

        def count(node):
            if node[0] in ("array", "tensor"):
                refs.append(node[1])
            elif node[0] == "dict":
                for _, v in node[1]:
                    count(v)
            elif node[0] in ("tuple", "list"):
                for v in node[1]:
                    count(v)

        count(tree)
        # members were written in reference order: read them back in order
        arrays = {i: np.lib.format.read_array(f, allow_pickle=False)
                  for i in sorted(refs)}

    def dec(node):
        kind = node[0]
        if kind == "none":
            return None
        if kind in ("bool", "int", "float", "str"):
            return node[1]
        if kind == "dict":
            return {k: dec(v) for k, v in node[1]}
        if kind == "tuple":
            return tuple(dec(v) for v in node[1])
        if kind == "list":
            return [dec(v) for v in node[1]]
        if kind == "array":
            return arrays[node[1]]
        if kind == "tensor":
            return from_host_array(arrays[node[1]], node[2])
        raise ValueError(f"unknown snapshot node kind {kind!r}")

    return dec(tree)
