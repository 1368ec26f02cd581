# ruff: noqa
"""RPL007 non-firing: one generator advancing, one lane per salt, a seed
that moves with the loop, exclusive branches, generators handed on."""
import torch

from faults.spec import lane_generator

_SALT_DROP = 0x0D0D
_SALT_CORRUPT = 0x0C0C
_SALT_ROUND = 0x0B0B


def chain(gen, n_rounds):
    # drawing twice from ONE generator advances it: the idiom
    return [torch.rand((), generator=gen) for _ in range(n_rounds)]


def lanes(seed, index, n):
    drop = torch.rand((n,), generator=lane_generator(seed, index, _SALT_DROP))
    corr = torch.rand((n,), generator=lane_generator(seed, index,
                                                     _SALT_CORRUPT))
    return drop, corr


def per_round(seed, n_rounds):
    out = []
    for t in range(n_rounds):
        g = lane_generator(seed, t, _SALT_ROUND)  # the index moves
        out.append(torch.rand((), generator=g))
    return out


def branch_draw(seed, flag):
    g = torch.Generator().manual_seed(seed)
    if flag:
        return torch.rand((), generator=g)
    return torch.randn((), generator=torch.Generator().manual_seed(seed))


def same_start(init_a, init_b, seed):
    # two runs from the same start: the generators are handed to their
    # inits, no draw here replays another
    return (init_a(torch.Generator().manual_seed(seed)),
            init_b(torch.Generator().manual_seed(seed)))


def reseeded(seed, n):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((n,), generator=g)
    seed = seed + 1
    g.manual_seed(seed)
    b = torch.rand((n,), generator=g)
    return a, b
