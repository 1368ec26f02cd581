# ruff: noqa
"""RPL004 firing: a downcast BEFORE the crossing collective."""
import torch
import torch.distributed as dist


def partial_reduce(x, group):
    part = x.sum(0).to(torch.bfloat16)  # expect: RPL004
    dist.all_reduce(part, group=group)
    return part


def partial_reduce_same_line(x, group):
    # the downcast nested directly in the collective's operand
    dist.all_reduce(x.sum(0).half(), group=group)  # expect: RPL004
    return x


def gather_rows(out, t, group):
    dist.all_gather_into_tensor(out, t.to(dtype=torch.float16), group=group)  # expect: RPL004
    return out
