"""Staleness weights for bounded-staleness surrogate aggregation (the
counterpart of ``repro/sched/staleness.py``).

A cohort partial that lands tau server updates after it was computed is a
stale block of the incremental-MM surrogate sum; ``w(tau)`` downweights
it. Each function here has ``w(0) == 1`` exactly (``FederationSpec``
checks it again), so a cohort landing fresh contributes what the
synchronous algorithm gives it, and async with no delay is sync bit for
bit. The weights are plain Python floats, applied on the host by the
scheduler's buffer (a weight of exactly 1.0 skips the multiply).
"""
from __future__ import annotations


def constant():
    """w(tau) = 1: unweighted buffering."""
    def weight(tau: int) -> float:
        del tau
        return 1.0
    return weight


def polynomial(a: float = 0.5):
    """w(tau) = (1 + tau)^-a."""
    if a < 0.0:
        raise ValueError(f"polynomial decay needs a >= 0, got {a}")

    def weight(tau: int) -> float:
        return float((1.0 + tau) ** (-a))
    return weight


def exponential(base: float = 0.5):
    """w(tau) = base^tau."""
    if not (0.0 < base <= 1.0):
        raise ValueError(f"exponential decay needs base in (0, 1], got "
                         f"{base}")

    def weight(tau: int) -> float:
        return float(base ** tau)
    return weight
