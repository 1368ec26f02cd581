"""A vector-clock happens-before checker for the scheduler's cross-thread
edges (the port's own copy of ``repro/analysis/hb.py``, which it may not
import).

The scheduler is almost single-threaded: the round loop computes
cohorts, scatters variate rows into the host arena, lands updates, and
hands COPIED snapshots to a single background ``_SnapshotWriter``
thread. The correctness of that handoff rests on two invariants no type
checker sees:

* **single-writer-per-arena-slot** — every pair of writes to the same
  arena slot (a client's variate row, a participation counter) must be
  ORDERED by happens-before; two concurrent writes mean the snapshot
  thread (or any future worker) is racing the round loop on shared host
  memory;
* **snapshot-after-land** — the snapshot published for cursor ``c``
  must happen-after the server update (``land``) for round ``c - 1``;
  a snapshot that can overtake its own round would let ``resume()``
  replay from state the trajectory never reached.

The harness is the classic vector-clock construction: each thread
carries a clock (thread -> event counter); every instrumented event
ticks the calling thread's component; a ``send(token)`` publishes the
sender's clock on a channel and the matching ``recv(token)`` joins it
into the receiver's — exactly the edges the real code creates via the
executor queue (submit -> worker) and ``Future.result()`` (worker ->
submitter). A write is checked against the LAST write to its slot:
ordered iff the previous writer's clock is component-wise <= the
current writer's (transitivity makes one predecessor sufficient — an
unordered predecessor was already flagged). ``mark(label, value,
after=...)`` records a named event and optionally asserts an ordering
edge against an earlier mark (the snapshot-after-land rule).

Production code calls the module-level no-op helpers (``on_write`` /
``on_send`` / ``on_recv`` / ``on_mark``); they cost one global read
when no tracker is installed. Tests install one with ``tracking()``:

    with hb.tracking(raise_on_violation=False) as trk:
        sched.run(..., checkpoint_dir=...)
    assert trk.violations == []

Pure stdlib (``threading`` only) — importable wherever the linter is.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Optional, Tuple

__all__ = ["HBTracker", "HBViolation", "install", "uninstall", "tracking",
           "on_write", "on_send", "on_recv", "on_mark"]


class HBViolation(RuntimeError):
    """A happens-before invariant was violated (racy write / bad order)."""


def _leq(a: dict, b: dict) -> bool:
    """Component-wise <= : did the event with clock ``a`` happen-before
    (or equal) the one with clock ``b``?"""
    return all(c <= b.get(t, 0) for t, c in a.items())


def _slots(slots) -> Iterable:
    """Normalize a slot spec (scalar, ndarray of ids, iterable) to
    hashable slot keys."""
    if slots is None:
        return (None,)
    if hasattr(slots, "tolist"):
        slots = slots.tolist()
    if isinstance(slots, (list, tuple, range, set)):
        return tuple(slots)
    return (slots,)


class HBTracker:
    """Vector clocks + channel edges + per-slot last-writer checking.

    All state is guarded by one lock — the harness serializes its own
    bookkeeping (that does NOT order the instrumented events themselves:
    ordering comes only from the declared send/recv edges, which is the
    point). Violations are collected in ``violations``; with
    ``raise_on_violation`` (default) the offending thread also raises
    ``HBViolation`` — a worker-thread raise surfaces through the
    executor future exactly like a real write error would."""

    def __init__(self, *, raise_on_violation: bool = True):
        self.raise_on_violation = raise_on_violation
        self.violations: list = []
        self._lock = threading.Lock()
        self._clocks: dict = {}     # thread ident -> {ident: counter}
        self._chan: dict = {}       # channel token -> sender clock copy
        self._writes: dict = {}     # (resource, slot) -> (clock, ident, name)
        self._marks: dict = {}      # (label, value) -> clock copy

    # -- clock mechanics (call with the lock held) ----------------------

    def _tick(self, tid: int) -> dict:
        clk = self._clocks.setdefault(tid, {})
        clk[tid] = clk.get(tid, 0) + 1
        return clk

    def _violate(self, msg: str):
        self.violations.append(msg)
        if self.raise_on_violation:
            raise HBViolation(msg)

    # -- instrumented events --------------------------------------------

    def write(self, resource: str, slots=None):
        """One thread wrote the given slots of ``resource``. Flags any
        slot whose previous write (by another thread) is not ordered
        before this one."""
        tid = threading.get_ident()
        name = threading.current_thread().name
        with self._lock:
            clk = self._tick(tid)
            snap = dict(clk)
            for s in _slots(slots):
                prev = self._writes.get((resource, s))
                self._writes[(resource, s)] = (snap, tid, name)
                if prev is not None:
                    pclk, ptid, pname = prev
                    if ptid != tid and not _leq(pclk, clk):
                        self._violate(
                            f"unsynchronized write: thread {name!r} wrote "
                            f"{resource!r} slot {s} concurrently with "
                            f"thread {pname!r} — no happens-before edge "
                            f"orders the two writes (single-writer-per-"
                            f"slot invariant)")

    def send(self, token):
        """Publish the calling thread's clock on channel ``token`` (the
        handoff half of a cross-thread edge, e.g. an executor submit)."""
        tid = threading.get_ident()
        with self._lock:
            clk = self._tick(tid)
            self._chan[token] = dict(clk)

    def recv(self, token):
        """Join channel ``token``'s published clock into the calling
        thread's (the receive half: worker start, ``Future.result()``).
        Unknown tokens are ignored — the send side may be uninstrumented
        code paths (e.g. a tracker installed mid-run)."""
        tid = threading.get_ident()
        with self._lock:
            clk = self._tick(tid)
            src = self._chan.get(token)
            if src is not None:
                for t, c in src.items():
                    if clk.get(t, 0) < c:
                        clk[t] = c

    def mark(self, label: str, value=None,
             after: Optional[Tuple[str, object]] = None):
        """Record a named event; with ``after=(label, value)``, assert
        the earlier mark happened-before this one (e.g. snapshot cursor
        ``c`` after the round ``c - 1`` land)."""
        tid = threading.get_ident()
        name = threading.current_thread().name
        with self._lock:
            clk = self._tick(tid)
            self._marks[(label, value)] = dict(clk)
            if after is not None:
                prev = self._marks.get(after)
                if prev is None or not _leq(prev, clk):
                    why = ("was never marked" if prev is None else
                           "is not ordered before it")
                    self._violate(
                        f"ordering violation: mark {label}:{value} in "
                        f"thread {name!r} requires {after[0]}:{after[1]} "
                        f"to happen-before, but it {why}")


# -- module-global installation (the production no-op hooks) -------------

_TRACKER: Optional[HBTracker] = None


def install(tracker: HBTracker) -> None:
    global _TRACKER
    _TRACKER = tracker


def uninstall() -> None:
    global _TRACKER
    _TRACKER = None


@contextlib.contextmanager
def tracking(*, raise_on_violation: bool = True):
    """Install a fresh ``HBTracker`` for the block and yield it."""
    trk = HBTracker(raise_on_violation=raise_on_violation)
    install(trk)
    try:
        yield trk
    finally:
        uninstall()


def on_write(resource: str, slots=None) -> None:
    t = _TRACKER
    if t is not None:
        t.write(resource, slots)


def on_send(token) -> None:
    t = _TRACKER
    if t is not None:
        t.send(token)


def on_recv(token) -> None:
    t = _TRACKER
    if t is not None:
        t.recv(token)


def on_mark(label: str, value=None,
            after: Optional[Tuple[str, object]] = None) -> None:
    t = _TRACKER
    if t is not None:
        t.mark(label, value, after=after)
