"""Synthetic MovieLens-1M-like ratings data (the counterpart of
``repro/data/movielens.py``; an offline stand-in, nothing is downloaded): a
low-rank users x movies matrix with the geometry the paper subsamples
(5000 user vectors embedded in R^500, K = 50), plus sparse observation
noise and half-star rating levels.
"""
from __future__ import annotations

import math

import torch

from ..api.driver import resolve_device


def movielens_like(gen: torch.Generator, n_users: int = 5000,
                   n_movies: int = 500, rank: int = 50, noise: float = 0.3,
                   density: float = 0.08, device=None) -> torch.Tensor:
    """Returns ratings (n_users, n_movies) float32: dense user vectors with
    zeros for unobserved entries, the per-user rating vectors the Section 6
    experiment factorizes. Drawn on ``gen``'s device, returned on
    ``device`` (the GPU unless the caller asks for another)."""
    dev = resolve_device(device)
    g = gen.device
    u = torch.randn((n_users, rank), generator=gen, device=g) / math.sqrt(rank)
    v = torch.randn((n_movies, rank), generator=gen, device=g)
    # user/movie biases produce MovieLens-like rating mass around 3-4
    raw = (3.5 + 1.2 * (u @ v.T)
           + noise * torch.randn((n_users, n_movies), generator=gen, device=g))
    ratings = torch.clamp(torch.round(raw * 2.0) / 2.0, 0.5, 5.0)
    observed = torch.rand((n_users, n_movies), generator=gen,
                          device=g) < density
    return torch.where(observed, ratings, 0.0).to(dev, torch.float32)
