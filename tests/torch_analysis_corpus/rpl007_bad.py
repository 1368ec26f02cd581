# ruff: noqa
"""RPL007 firing: one generator stream opened twice and drawn from both:
the same lane, the same seed, a reseed on every iteration, a restored
state."""
import torch

from faults.spec import lane_generator


def drop_and_corrupt(seed, index, salt, n):
    drop = torch.rand((n,), generator=lane_generator(seed, index, salt))
    corr = torch.rand((n,), generator=lane_generator(seed, index, salt))  # expect: RPL007
    return drop, corr


def two_inits(seed, shape):
    g1 = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, generator=g1)
    g2 = torch.Generator().manual_seed(seed)
    b = torch.randn(shape, generator=g2)  # expect: RPL007
    return a, b


def loop_reseed(seed, n):
    total = 0.0
    for _ in range(n):
        g = torch.Generator().manual_seed(seed)
        total += torch.rand((), generator=g)  # expect: RPL007
    return total


def comp_reseed(seed, n):
    return [torch.randn((), generator=torch.Generator().manual_seed(seed))  # expect: RPL007
            for _ in range(n)]


def replayed_state(gen, n):
    state = gen.get_state()
    a = torch.rand((n,), generator=gen)
    gen.set_state(state)
    b = torch.rand((n,), generator=gen)  # expect: RPL007
    return a, b
