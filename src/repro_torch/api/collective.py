"""The driver's mesh side: which block of clients a rank holds, and the
collectives of the uplink over the mesh dims the clients occupy.

The clients lie along one dim of a ``DeviceMesh`` (``client_axis``), or
along two under the two-tier topology (``(edge_axis, client_axis)``,
edge-major). Every collective runs over a dim's own process group
(``mesh.get_group(name)``): a gather or a sum over two dims is one over the
inner dim, then one over the outer, which keeps the edge-major client
order and, for sums, reduces within each edge first.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape(mesh: DeviceMesh) -> dict:
    """``{dim name: size}`` of a mesh with named dims (the counterpart of
    ``jax.sharding.Mesh.shape``)."""
    names = mesh.mesh_dim_names or ()
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def client_dims(topology, client_axis: str) -> tuple:
    """The mesh dims the clients occupy, outermost first."""
    if topology.is_two_tier:
        return (topology.edge_axis, client_axis)
    return (client_axis,)


def client_block(mesh: DeviceMesh, dims: tuple) -> tuple:
    """``(b, count)``: this rank holds client block ``b`` of ``count``,
    numbered row-major over ``dims`` (rank ``(e, c)`` of an ``(E, C)`` mesh
    holds block ``e * C + c``). Raises where a dim's process group numbers
    its ranks in another order than the mesh coordinate, since the
    gathers would then put the blocks out of order."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    names = list(mesh.mesh_dim_names)
    b, count = 0, 1
    for d in dims:
        i = names.index(d)
        if dist.get_rank(mesh.get_group(d)) != coord[i]:
            raise RuntimeError(
                f"mesh dim {d!r}: the process group's rank order differs "
                f"from the mesh coordinate; build the mesh over ranks in "
                f"increasing order")
        size = int(mesh.mesh.shape[i])
        b, count = b * size + int(coord[i]), count * size
    return b, count


def gather_rows(t: torch.Tensor, mesh: DeviceMesh, dims: tuple):
    """Every rank's ``t`` concatenated along dim 0 in block order."""
    for d in reversed(dims):
        group = mesh.get_group(d)
        w = dist.get_world_size(group)
        out = torch.empty((w * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        t = out
    return t


def sum_over(t: torch.Tensor, mesh: DeviceMesh, dims: tuple):
    """``t`` summed over the ranks of ``dims`` (in place on a contiguous
    ``t``; returns the summed tensor)."""
    t = t.contiguous()
    for d in reversed(dims):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(d))
    return t
