# ruff: noqa
"""RPL008 non-firing: auxiliary draws on private lanes keyed by the
chain's seed, and the chain's owner drawing from the round's
generator."""
import torch

from faults.spec import lane_generator

_SALT_DROP = 0x0D0D
_SALT_DELAY = 0x0E0E


def client_fault_draw(seed, index, p_drop, n):
    lane = lane_generator(seed, index, _SALT_DROP)
    return torch.rand((n,), generator=lane) < p_drop


def checkpoint_jitter(gen, index):
    # the lane is keyed by the chain's seed, which it never draws
    gen = lane_generator(gen.initial_seed(), index, _SALT_DELAY)
    return torch.rand((), generator=gen)


def participation_draw(gen, p, n):
    # the chain OWNER: drawing here is the contract, not contamination
    active = torch.rand((n,), generator=gen) < p
    seeds = torch.randint(0, 2 ** 32, (n,), generator=gen)
    return active, seeds
