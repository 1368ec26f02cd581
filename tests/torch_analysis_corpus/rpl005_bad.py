# ruff: noqa
"""RPL005 firing: collectives with no group run over the whole world."""
import torch.distributed as dist
from torch.distributed import all_gather_into_tensor


def aggregate(t):
    dist.all_reduce(t)  # expect: RPL005
    return t


def gather(out, t):
    all_gather_into_tensor(out, t)  # expect: RPL005
    return out


def sync_weights(t):
    dist.broadcast(t, 0)  # expect: RPL005
    return t
