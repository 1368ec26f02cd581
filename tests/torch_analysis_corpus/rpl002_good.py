# ruff: noqa
"""RPL002 non-firing: every draw names its generator; host randomness
and constant seeds only outside traced code."""
import numpy as np
import torch


def dither(x, gen):
    return x + torch.rand(x.shape, generator=gen, device=gen.device)


def jitter_(x, gen):
    return x.uniform_(-1.0, 1.0, generator=gen)


def host_batch(shape):
    # host randomness in eager set-up code is fine
    return np.random.default_rng(0).normal(size=shape)


def root_generator():
    # a constant seed at the top of the host-side chain is the idiom
    return torch.Generator().manual_seed(0)


def per_client(batches, noise):
    def one(b, e):
        return b + e          # the draws come in from the caller

    return torch.func.vmap(one)(batches, noise)
