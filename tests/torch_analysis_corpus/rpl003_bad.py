# ruff: noqa
"""RPL003 firing: data-dependent Python control flow and host reads on
batched tensors inside vmap bodies."""
import torch
from torch.func import vmap


def clip_if_large(xs, thresh):
    def one(x):
        if x.sum() > thresh:  # expect: RPL003
            return x * 0.5
        return x

    return vmap(one)(xs)


def scaled(xs):
    def one(x):
        return x * float(x.max())  # expect: RPL003

    return vmap(one)(xs)


def host_sync(xs):
    return torch.func.vmap(lambda x: x.sum().item())(xs)  # expect: RPL003


def shrink(xs):
    def one(x):
        while x.norm() > 1.0:  # expect: RPL003
            x = x * 0.5
        return x

    return torch.func.vmap(one)(xs)
