# ruff: noqa
"""RPL005 non-firing: every collective names its group."""
import torch.distributed as dist


def aggregate(t, mesh):
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group("clients"))
    return t


def gather(out, t, group):
    dist.all_gather_into_tensor(out, t, group)     # positional group
    return out


def sync_weights(t):
    dist.broadcast(t, 0, group=dist.group.WORLD)   # the world, said so
    return t


def gather_rows(t, index):
    return t.gather(0, index)     # Tensor.gather: no collective
