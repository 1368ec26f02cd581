"""Deterministic fault injection, wire integrity and crash recovery (the
counterpart of ``repro.faults``).

* ``FaultSpec``: seeded per-round fault schedules (dropout, corruption,
  stragglers, cohort failure, a server kill point), a ``FederationSpec``
  axis drawn from fault-private generator lanes.
* ``corrupt_payload``: deterministic wire damage for drills and tests.
* ``save_snapshot``/``load_snapshot``: atomic, self-describing snapshots
  of host structures, behind the scheduler's ``checkpoint_dir`` and
  ``resume()``.

Wire verification lives with the wire format (``core.compression``:
``leaf_checksum``, ``verify_payload``, ``zero_invalid_rows``).
"""
from .spec import CORRUPT_KINDS, FaultSpec, ServerKilled
from .injector import corrupt_payload
from .snapshot import load_snapshot, save_snapshot

__all__ = [
    "CORRUPT_KINDS",
    "FaultSpec",
    "ServerKilled",
    "corrupt_payload",
    "load_snapshot",
    "save_snapshot",
]
