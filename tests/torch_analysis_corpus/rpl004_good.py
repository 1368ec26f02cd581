# ruff: noqa
"""RPL004 non-firing: partials cross in float32, ONE downcast after the
collective."""
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def partial_reduce(x, group):
    part = x.sum(0)
    dist.all_reduce(part, group=group)
    return part.to(torch.bfloat16)


def host_cast(x):
    # a downcast with no collective anywhere near it: fine
    return x.bfloat16()


def partial_reduce_one_line(x, group):
    # the sanctioned pattern as one expression: the downcast wraps the
    # reduction's result
    return funcol.all_reduce(x.sum(0), "sum", group).to(torch.bfloat16)
