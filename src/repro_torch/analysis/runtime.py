"""The runtime checks behind ``api.run/step(..., sanitize=True)`` (the
counterpart of ``repro/analysis/runtime.py``).

Two guards, both off by default; the driver takes a plain ``if
sanitize:`` around them, so nothing runs when they are off.

* **Stage checks** (``Sanitizer``). The reference threads
  ``jax.experimental.checkify`` through the traced round: a NaN, a
  division by zero or an out-of-bounds index is checked at every
  primitive, and ``err.throw()`` raises with its origin. PyTorch has no
  such transform, and the shard_map rule patch that checkify needed there
  has nothing to patch here. The port checks at the boundaries of the
  round's stages instead:

  - after each stage (``STAGES``: the view ``T`` broadcast to the
    clients, the client oracle's output, ``T`` of it where the clients
    aggregate parameters, the drift, the aggregate (decoded and reduced,
    or the fused ``decode_reduce`` output), the control-variate updates,
    the server step before ``project``, and ``project``) every floating
    leaf gets one ``finite_flag``, a bool left on its device (per client
    where the clients run batched: on a mesh those are gathered, so that
    every rank raises together);
  - the integer index tensors the round gathers with (a cohort's client
    ids, the two-tier edge ids) are checked against their range, at once
    where they are host data (a gather out of range on the card is a
    device assert, not an error to read later);
  - the divisor of the ``"realized"`` normalisation gets no check: it is
    the surviving clients' count clamped at one, as in the reference, so
    it is never zero (checkify's check of it there never trips either),
    and a round with no active client is legitimate and passes;
  - one host sync at the end of the round (``raise_if_tripped``) reads
    every flag and raises ``SanitizerError`` naming the round, the first
    stage that tripped and the leaf's path.

  The checks must sit at stage level, before ``encode``: the block
  quantizer launders a NaN (``scale > 0`` is false for NaN, so a NaN
  client update becomes all-zero codes and the round stays finite). They
  only read, so a trajectory is bit for bit the same with them on. What
  checkify sees and the stage checks do not: a non-finite value made and
  consumed inside one stage (a NaN that a later ``where`` inside the
  oracle drops), and division by zero or an out-of-bounds index inside a
  problem's own code. The reference's ``checkified`` and
  ``default_errors`` (checkify's error set) have no counterpart: the
  checks are the ``Sanitizer``'s methods.
* **The comm-bytes audit** (``assert_comm_audit``) holds the analytic
  ``Compressor.payload_bytes`` to the bytes measured off the encoded
  buffers, every round (contract 3 of ``contracts.check_compressor``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..tree import tree_leaves_with_path

# the stages of a round, in the order a round passes them: the cohort's
# client ids (scheduler), the view T broadcast to the clients, each
# client's oracle output, T of it (parameter aggregation), its drift; the
# aggregate, the variates, the server step before and after project
STAGES = ("cohort", "T", "oracle", "drift", "aggregate", "variates",
          "server_step", "project")


def finite_flag(x: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """True where every element of ``x`` is finite (with ``rows``, one
    flag for each index of its leading dim). One read of ``x``:
    ``aminmax`` carries a NaN, an inf is the max or the min, and a finite
    value times 0 is 0; ``isfinite(x).all()`` makes five passes and a
    temporary of ``x``'s size."""
    if x.numel() == 0:
        return torch.ones(x.shape[:1] if rows else (), dtype=torch.bool,
                          device=x.device)
    if rows:
        x = x.reshape(x.shape[0], -1)
    lo, hi = torch.aminmax(x, dim=1) if rows else torch.aminmax(x)
    return lo * 0 + hi * 0 == 0


class SanitizerError(FloatingPointError):
    """A stage check tripped: a non-finite value or an index out of its
    range."""


class Sanitizer:
    """The flags of one round's stage checks. Each ``check_*`` call only
    queues a flag (device tensors stay on the device); ``raise_if_tripped``
    reads them all with one host sync and raises on the first that
    tripped, in the order they were queued."""

    def __init__(self):
        self._flags = []     # (what, stage, path, 0-d bool tensor)

    def check_finite(self, stage: str, tree, prefix: str = "") -> None:
        """Queue one flag per floating leaf of ``tree``: True where some
        element is NaN or infinite."""
        for path, x in tree_leaves_with_path(tree):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                self._flags.append(("non-finite value (nan or inf)", stage,
                                    prefix + path,
                                    ~finite_flag(x)))

    def check_flags(self, stage: str, flags: dict) -> None:
        """Queue flags that a stage computed itself: ``path ->`` a tensor,
        non-zero for each client whose leaf was finite."""
        for path, ok in flags.items():
            self._flags.append(("non-finite value (nan or inf)", stage,
                                path, ~ok.bool().all()))

    def check_index(self, stage: str, name: str, idx, size: int) -> None:
        """Check that every index of ``idx`` lies in ``[0, size)``: at once
        for host data (the gather it guards comes next, and reading it
        syncs nothing), else queued."""
        idx = torch.as_tensor(idx)
        bad = ((idx < 0) | (idx >= size)).any()
        what = f"index out of range [0, {size})"
        if idx.device.type == "cpu":
            if bool(bad):
                raise SanitizerError(
                    f"sanitizer: {what} before the gather, stage "
                    f"{stage!r}, leaf {name!r}")
            return
        self._flags.append((what, stage, name, bad))

    def raise_if_tripped(self, where) -> None:
        """Read every queued flag (one host sync for a device's flags) and
        raise ``SanitizerError`` on the first that tripped; then clear.
        ``where``: the round, or a callable that names it (called only to
        raise)."""
        flags, self._flags = self._flags, []
        by_device = {}
        for i, f in enumerate(flags):
            by_device.setdefault(f[3].device, []).append(i)
        hit = [False] * len(flags)
        for idx in by_device.values():
            vals = torch.stack([flags[i][3] for i in idx]).cpu().tolist()
            for i, v in zip(idx, vals):
                hit[i] = v
        for (what, stage, path, _), h in zip(flags, hit):
            if h:
                raise SanitizerError(
                    f"sanitizer: {what} at "
                    f"{where() if callable(where) else where}, stage "
                    f"{stage!r}, leaf {path!r} (the first check that "
                    f"tripped)")


def resolve_sanitizer(sanitize: Union[bool, Sanitizer]) -> Optional[Sanitizer]:
    """Normalise the ``sanitize=`` argument: True makes a sanitizer the
    call raises from itself; an instance queues into the caller's, who
    raises (the scheduler: once a round); falsy disables."""
    if isinstance(sanitize, Sanitizer):
        return sanitize
    return Sanitizer() if sanitize else None


def assert_comm_audit(comp, model_tree, measured_per_client: Optional[float],
                      *, where: str, tol: float = 0.5):
    """The comm-bytes audit: the analytic ``payload_bytes`` model must
    equal the measured per-client wire bytes (read off the actual encoded
    buffers). Both are host floats, so a lying model fails at once with a
    diagnosable error instead of corrupting ``comm_bytes`` metrics.
    ``tol`` absorbs sub-byte float representation only."""
    if measured_per_client is None:
        return
    expected = float(comp.payload_bytes(model_tree))
    if abs(float(measured_per_client) - expected) > tol:
        raise ValueError(
            f"comm-bytes audit failed ({where}): Compressor "
            f"'{getattr(comp, 'name', comp)}' bills "
            f"payload_bytes={expected:.1f} B/client but the wire "
            f"measured {float(measured_per_client):.1f} B/client — the "
            f"analytic model and the encoded buffers disagree, so the "
            f"comm_bytes metric is lying (see "
            f"analysis.contracts.check_compressor contract 3)")
