"""Device meshes (the counterpart of ``repro/launch/mesh.py``): the
production mesh and its logical-axis rules, the 2-D ``(edge, client)``
mesh of the two-tier topology and the cohort capacity of a mesh.

The production mesh is the reference's shape and names: 256 ranks as
(16, 16) ``("data", "model")``, or 512 as (2, 16, 16) ``("pod", "data",
"model")`` (pods are the federated silos). ``client_axes`` names the
client (batch, silo) dims and ``axis_rules`` the logical-axis rules that
``models.sharding.install_rules`` takes. The reference's TPU v5e
constants for its roofline are not ported: the H100's are in
``launch/roofline.py``, which the dry run (``launch/dryrun.py``) reads
beside this mesh.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, which the caller starts
(``torch.distributed.init_process_group`` with its address, world size and
rank). Each named dim has its own process group (``mesh.get_group(name)``),
which is what the driver's collectives run over. Importing this module
touches no process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..api.collective import mesh_shape
from ..api.driver import resolve_device


def _require_group(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a started process group "
                           f"(torch.distributed.init_process_group with its "
                           f"address, world size and rank)")
    # repro: allow[RPL001] the production mesh lays out every rank of the job
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the first 256 or
    512 ranks of the started process group, on the GPU unless
    ``device="cpu"``. Raises when the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _require_group("make_production_mesh")
    if world < n:
        raise ValueError(f"the production mesh {shape} {axes} needs {n} "
                         f"ranks, the process group has {world}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def client_axes(multi_pod: bool):
    """The federated-client mesh axes (batch / silo axes)."""
    return ("pod", "data") if multi_pod else ("data",)


def axis_rules(multi_pod: bool) -> dict:
    """Logical-axis -> mesh-axis rules installed for activations."""
    fsdp = client_axes(multi_pod)
    return {
        "batch": fsdp,
        "clients": fsdp,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "cache_seq": "model",
    }


def make_edge_mesh(n_edges: int, clients_per_edge: int = None, *,
                   edge_axis: str = "edge", client_axis: str = "client",
                   device=None) -> DeviceMesh:
    """A 2-D ``(edge, client)`` mesh for two-tier aggregation over the
    first ``n_edges * clients_per_edge`` ranks, on the GPU unless
    ``device="cpu"``.

    Rank ``e * clients_per_edge + c`` sits at ``(e, c)`` and hosts client
    block ``e * clients_per_edge + c``, so each edge owns a contiguous
    block of the client axis: the edge-major order ``Topology.edge_ids``
    assigns. A reduce over ``client_axis`` then sums within each edge and
    a reduce over ``edge_axis`` across edges."""
    world = _require_group("make_edge_mesh")
    if n_edges < 1:
        raise ValueError(f"n_edges must be >= 1, got {n_edges}")
    if clients_per_edge is None:
        if world % n_edges:
            raise ValueError(
                f"{world} ranks do not split over n_edges={n_edges}; pass "
                f"clients_per_edge explicitly")
        clients_per_edge = world // n_edges
    if clients_per_edge < 1:
        raise ValueError(
            f"clients_per_edge must be >= 1, got {clients_per_edge}")
    if edge_axis == client_axis:
        raise ValueError(
            f"edge_axis and client_axis must differ, both {edge_axis!r}")
    n = n_edges * clients_per_edge
    if world < n:
        raise ValueError(
            f"two-tier mesh ({n_edges} edges x {clients_per_edge} clients) "
            f"needs {n} devices (ranks), have {world}")
    grid = torch.arange(n).reshape(n_edges, clients_per_edge)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=(edge_axis, client_axis))


def cohort_capacity(mesh: DeviceMesh, client_axis="clients",
                    per_device: int = 1) -> int:
    """The cohort size to stream through ``mesh``: one client slot per rank
    on the client dim times ``per_device``. ``client_axis`` may be a tuple
    of dim names (the two-tier ``("edge", "client")`` layout); the capacity
    is then the product of their sizes times ``per_device``."""
    axes = (client_axis,) if isinstance(client_axis, str) \
        else tuple(client_axis)
    if not axes:
        raise ValueError("client_axis must name at least one mesh axis")
    shape = mesh_shape(mesh)
    for ax in axes:
        if ax not in shape:
            raise ValueError(f"client_axis={ax!r} not an axis of "
                             f"the mesh (axes: {tuple(shape)})")
    if per_device < 1:
        raise ValueError(f"per_device must be >= 1, got {per_device}")
    cap = per_device
    for ax in axes:
        cap *= shape[ax]
    return cap
