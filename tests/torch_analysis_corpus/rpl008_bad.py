# ruff: noqa
"""RPL008 firing: auxiliary draws (fault, checkpoint) taken from the
generator they were handed instead of a private lane."""
import torch


def client_fault_draw(gen, p_drop, n):
    drop = torch.rand((n,), generator=gen) < p_drop  # expect: RPL008
    return drop


def checkpoint_jitter(round_gen):
    return torch.rand((), generator=round_gen)  # expect: RPL008
