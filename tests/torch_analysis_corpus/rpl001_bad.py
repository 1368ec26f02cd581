# ruff: noqa
"""RPL001 firing: process-wide topology in dispatch code."""
import torch
import torch.distributed as dist


def route(x):
    if x.dim() > 1 and torch.cuda.device_count() > 1:  # expect: RPL001
        return "kernel"
    return "plain"


def clients_per_rank(n_clients):
    return n_clients // dist.get_world_size()  # expect: RPL001


def world():
    # naming the whole world reads the same size
    return dist.get_world_size(dist.group.WORLD)  # expect: RPL001
