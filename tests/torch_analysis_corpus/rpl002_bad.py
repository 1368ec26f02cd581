# ruff: noqa
"""RPL002 firing: draws off the explicit-generator chain, host randomness
and constant seeds inside traced bodies."""
import random

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def dither(x):
    return x + torch.rand(x.shape)  # expect: RPL002


def jitter_(x):
    return x.uniform_(-1.0, 1.0)  # expect: RPL002


def per_client(batches):
    def one(b):
        eps = np.random.normal(size=(4,))  # expect: RPL002
        gen = torch.Generator().manual_seed(0)  # expect: RPL002
        return b + torch.randn(b.shape, generator=gen) + eps

    return torch.func.vmap(one)(batches)


def layer(x):
    def body(h):
        return h * random.random()  # expect: RPL002

    return checkpoint(body, x, use_reentrant=False)
