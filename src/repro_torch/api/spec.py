"""FederationSpec — the federation concerns, composed, in one place (the
counterpart of ``repro/api/spec.py``).

Axes (the reference's semantics): ``participation`` (Bernoulli-p, A5),
``variates`` ("zero" | "at-init" | "off"), ``compressor`` (A4),
``aggregation`` ("surrogate" | "parameter"), ``normalization``
("expected" | "realized"), ``delta`` ("drift" | "oracle"),
``server_momentum`` (FedAvgM), ``max_staleness``/``staleness_weight`` (for
the cohort scheduler; validated here, unused by ``run``), ``faults`` (a
``repro_torch.faults.FaultSpec``), ``topology``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.compression import Compressor, identity, leaf_seeds
from .topology import Topology

PARTICIPATION_FULL = 1.0
VARIATES = ("zero", "at-init", "off")
AGGREGATIONS = ("surrogate", "parameter")
NORMALIZATIONS = ("expected", "realized")
DELTAS = ("drift", "oracle")


@dataclasses.dataclass(frozen=True)
class FederationSpec:
    n_clients: int
    participation: float = PARTICIPATION_FULL
    alpha: float = 0.0
    variates: str = "zero"
    compressor: Compressor = dataclasses.field(default_factory=identity)
    mu: Optional[object] = None           # client weights; uniform default
    normalize_mu: bool = False
    aggregation: str = "surrogate"
    normalization: str = "expected"
    delta: str = "drift"
    server_momentum: float = 0.0
    max_staleness: Optional[int] = None
    staleness_weight: Optional[Callable[[int], float]] = None
    faults: Optional[object] = None
    topology: Topology = dataclasses.field(default_factory=Topology)

    def __post_init__(self):
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(f"participation must be in (0, 1], got "
                             f"{self.participation}")
        if self.mu is not None:
            mu = torch.as_tensor(self.mu, dtype=torch.float32)
            if tuple(mu.shape) != (self.n_clients,):
                raise ValueError(
                    f"client weights mu must have shape "
                    f"({self.n_clients},) — one weight per client — got "
                    f"{tuple(mu.shape)}")
            total = float(torch.sum(mu))
            if self.normalize_mu:
                if total <= 0.0:
                    raise ValueError(
                        f"normalize_mu=True needs mu with a positive sum "
                        f"to rescale by, got sum {total:.6g}")
            elif abs(total - 1.0) > 1e-4:
                raise ValueError(
                    f"client weights mu sum to {total:.6g}, not 1 — pass "
                    f"normalize_mu=True to rescale, or normalize mu "
                    f"yourself")
        for field, allowed in (("variates", VARIATES),
                               ("aggregation", AGGREGATIONS),
                               ("normalization", NORMALIZATIONS),
                               ("delta", DELTAS)):
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(f"{field}={val!r} not in {allowed}")
        if self.variates == "off" and self.alpha != 0.0:
            raise ValueError("variates='off' drops V/V_i entirely; "
                             "alpha must be 0")
        if not (0.0 <= self.server_momentum < 1.0):
            raise ValueError(f"server_momentum must be in [0, 1), got "
                             f"{self.server_momentum}")
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError(f"max_staleness must be None or >= 0, got "
                             f"{self.max_staleness}")
        if self.staleness_weight is not None:
            if not callable(self.staleness_weight):
                raise ValueError("staleness_weight must be a callable "
                                 "tau -> weight")
            w0 = float(self.staleness_weight(0))
            if abs(w0 - 1.0) > 1e-6:
                raise ValueError(
                    f"staleness_weight(0) must be 1.0 so a fresh cohort "
                    f"recovers the synchronous update exactly, got {w0:.6g}")
        if not isinstance(self.topology, Topology):
            raise ValueError(f"topology must be a repro_torch.api.Topology, "
                             f"got {type(self.topology).__name__}")
        if self.topology.is_two_tier:
            if self.topology.n_edges > self.n_clients:
                raise ValueError(
                    f"topology.n_edges={self.topology.n_edges} exceeds "
                    f"n_clients={self.n_clients}")
            if self.topology.reencode and self.compressor.reencode is None:
                raise ValueError(
                    "topology.reencode=True requires a compressor with a "
                    "tier-boundary reencode hook")
        if self.faults is not None:
            from ..faults.spec import FaultSpec
            if not isinstance(self.faults, FaultSpec):
                raise ValueError(f"faults must be a repro_torch.faults."
                                 f"FaultSpec, got {type(self.faults).__name__}")
            if self.faults.corrupt > 0.0 and not (
                    self.compressor.encode is not None
                    and self.compressor.checksum):
                # undetected damage would be laundered into the aggregate
                raise ValueError(
                    "faults.corrupt > 0 requires a checksummed wire-format "
                    "compressor (e.g. block_quant(..., checksum=True)) so "
                    "damage is detected rather than laundered into the "
                    "aggregate")

    def client_weights(self, device=None) -> torch.Tensor:
        """mu_i as float32; uniform 1/n unless given explicitly."""
        if self.mu is not None:
            mu = torch.as_tensor(self.mu, dtype=torch.float32, device=device)
            return mu / torch.sum(mu) if self.normalize_mu else mu
        return torch.full((self.n_clients,), 1.0 / self.n_clients,
                          dtype=torch.float32, device=device)

    @property
    def use_variates(self) -> bool:
        return self.variates != "off"


def participation_draw(gen: torch.Generator, spec: FederationSpec,
                       n_leaves: int):
    """One round of A5 sampling and the per-client, per-leaf compression
    seeds, drawn in that order from ``gen`` (the counterpart of the
    reference's ``key -> (k_part, k_quant)`` fold): ``active`` (n,) bool,
    ``Bernoulli(p)`` each; ``seeds`` (n, n_leaves) int64 32-bit seeds."""
    n = spec.n_clients
    u = torch.rand((n,), generator=gen, device=gen.device).cpu()
    active = u < spec.participation
    seeds = torch.tensor([leaf_seeds(gen, n_leaves) for _ in range(n)],
                         dtype=torch.int64).reshape(n, n_leaves)
    return active, seeds
