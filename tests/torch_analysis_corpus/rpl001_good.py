# ruff: noqa
"""RPL001 non-firing: dispatch on the tensor, and name the group whose
size is read."""
import torch.distributed as dist


def route(x):
    if x.device.type == "cuda":
        return "kernel"
    return "plain"


def clients_per_rank(n_clients, mesh):
    return n_clients // dist.get_world_size(mesh.get_group("clients"))
