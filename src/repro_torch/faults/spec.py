"""FaultSpec: deterministic, seeded fault schedules for federated rounds
(the counterpart of ``repro/faults/spec.py``).

Faults are a ``FederationSpec`` axis (``faults=FaultSpec(...)``), validated
at construction. Every per-round draw comes from a fault-private lane: a
``torch.Generator`` of its own, seeded by a mix of the chain generator's
seed (``initial_seed()``, read once per run and kept in snapshots), the
round index and a salt per kind of draw. The lanes never consume the
round's generator, so (a) a fault trajectory replays bit for bit from the
run's seed, and (b) a ``FaultSpec`` whose probabilities are all zero gives
a trajectory bit-identical to ``faults=None``.

The fault model (all independent per round), as the reference's:

* ``dropout``: a client's uplink never arrives. The drop folds into the
  participation mask, so the surviving ``mu`` mass renormalizes per the
  spec's ``normalization``. Dropped clients bill no uplink bytes.
* ``corrupt``: the payload arrives damaged (``corrupt_kind``: flipped
  codes, a garbage tail, or NaN scale bits). Needs a checksummed wire
  format; the server detects the damage, zeroes the client's buffers
  before decode and drops it from the round. Corrupt clients bill their
  bytes: the wire was used.
* ``straggle``: an async cohort lands ``straggle_delay`` later.
* ``cohort_fail``: a cohort's attempt fails; the scheduler walks a
  pre-drawn ladder of ``max_retries`` retries, billing each failure.
* ``kill_round``: ``ServerKilled`` just before that round lands.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

CORRUPT_KINDS = ("flip", "truncate", "scales")

# the reference's fold_in salts, one lane per kind of draw
_SALT_DROP = 0x0FA7D09
_SALT_CORRUPT = 0x0FA7C02
_SALT_FAIL = 0x0FA7FA1
_SALT_STRAGGLE = 0x0FA7517

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """The splitmix64 finalizer."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _M64
    return z ^ (z >> 31)


def lane_generator(seed: int, index: int, salt: int) -> torch.Generator:
    """A CPU generator private to one draw: a function of the chain's seed,
    the round (or wave) index and the draw's salt only."""
    z = _mix64((int(seed) & _M64) ^ _mix64((int(index) * 0x9E3779B97F4A7C15
                                            + salt) & _M64))
    return torch.Generator().manual_seed(z >> 1)


class ServerKilled(RuntimeError):
    """Raised at the ``kill_round`` kill point (before the round lands).
    Carries the round index; the last published snapshot is earlier."""

    def __init__(self, round_index: int):
        super().__init__(f"server killed before landing round {round_index}")
        self.round_index = round_index


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    dropout: float = 0.0            # P(client uplink lost) per round
    corrupt: float = 0.0            # P(client payload damaged) per round
    corrupt_kind: str = "flip"      # flip | truncate | scales
    straggle: float = 0.0           # P(cohort straggles) per round (async)
    straggle_delay: int = 0         # extra virtual-time delay if straggling
    cohort_fail: float = 0.0        # P(one cohort attempt fails) per attempt
    max_retries: int = 2            # retries after the first failed attempt
    retry_backoff: int = 1          # extra delay per retry attempt (async)
    kill_round: Optional[int] = None  # crash before landing this round

    def __post_init__(self):
        for f in ("dropout", "corrupt", "straggle", "cohort_fail"):
            v = getattr(self, f)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{f} must be a probability in [0, 1], "
                                 f"got {v}")
        if self.corrupt_kind not in CORRUPT_KINDS:
            raise ValueError(f"corrupt_kind={self.corrupt_kind!r} not in "
                             f"{CORRUPT_KINDS}")
        if self.straggle_delay < 0:
            raise ValueError(f"straggle_delay must be >= 0, got "
                             f"{self.straggle_delay}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, got "
                             f"{self.retry_backoff}")
        if self.kill_round is not None and self.kill_round < 0:
            raise ValueError(f"kill_round must be None or >= 0, got "
                             f"{self.kill_round}")
        if self.cohort_fail >= 1.0:
            raise ValueError("cohort_fail=1.0 fails every attempt — no "
                             "retry budget can deliver a cohort")

    @property
    def any_injection(self) -> bool:
        """True when any probabilistic fault can fire (a kill point alone
        draws nothing)."""
        return (self.dropout > 0.0 or self.corrupt > 0.0
                or self.straggle > 0.0 or self.cohort_fail > 0.0)

    # -- per-round draws (host side, off private lanes) ---------------------
    def client_draw(self, seed: int, index: int, n: int):
        """``(drop, corrupt)`` bool CPU tensors of shape ``(n,)`` for round
        ``index`` of the chain seeded ``seed``. A client drawn for both
        drops (nothing arrived to corrupt)."""
        drop = torch.rand((n,), generator=lane_generator(
            seed, index, _SALT_DROP)) < self.dropout
        corr = torch.rand((n,), generator=lane_generator(
            seed, index, _SALT_CORRUPT)) < self.corrupt
        return drop, corr & ~drop

    def cohort_draw(self, seed: int, index: int, k_cohorts: int):
        """Per-cohort draws for one round: ``fail_u`` float32 uniforms of
        shape ``(k_cohorts, max_retries + 1)`` (attempt ``a`` of cohort
        ``c`` fails iff ``fail_u[c, a] < cohort_fail``; the whole ladder is
        drawn up front) and a ``(k_cohorts,)`` bool straggle mask."""
        fail_u = torch.rand((k_cohorts, self.max_retries + 1),
                            generator=lane_generator(seed, index, _SALT_FAIL))
        straggle = torch.rand((k_cohorts,), generator=lane_generator(
            seed, index, _SALT_STRAGGLE)) < self.straggle
        return fail_u, straggle
