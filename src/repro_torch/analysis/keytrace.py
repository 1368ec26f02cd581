"""The runtime audit of the generator chain behind ``audit_keys=True``
(the counterpart of ``repro/analysis/keytrace.py``).

The reference's chain is JAX keys; the port's is ``torch.Generator``s.
While a ``KeyAudit`` is active, every draw through the samplers the port
calls (``SAMPLERS``: ``torch.rand``, ``randn``, ``randint``, ``randperm``,
``bernoulli``, ``normal``, ``multinomial``) is recorded into a
``KeyTraceReport`` with its call site and a fingerprint of the generator
it draws from: the generator's device and a digest of its
``get_state()`` bytes (the device's default generator where the call
passes none). A state is what a key is to the reference: two draws from
the same state give correlated values. So two draws from one state at
different call sites raise ``KeyReuseError`` at the second site, naming
the first. One allowance, the reference's: an exact re-execution (same
sampler, same call site, same state) is recorded but not flagged. That is
the re-derivation idiom (the scheduler hands each cohort a generator
restored to the wave's state, and ``data_fn`` re-draws the wave's batch
and slices it), which reproduces identical values rather than
correlating draws that should be independent. Every replay guarantee
(bit-identical ``resume()``, a zero-probability ``FaultSpec`` equal to
``faults=None``) holds only if no state is drawn from twice.

Mechanics: the audit replaces the ``torch`` module's sampler attributes
for the duration of a ``with audit.activate():`` block. Every call site
in the port goes through attribute lookup (``torch.rand(...)``), so the
wrappers see them all. The wrappers read the state before delegating to
the original functions untouched, so trajectories are bit-identical with
the audit on, and restore the attributes on exit, also when the body
raises. Draws on ``meta`` tensors have no state to read and are skipped.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import sys
from typing import Optional, Union

import torch

__all__ = ["KeyAudit", "KeyEvent", "KeyReuseError", "KeyTraceReport",
           "resolve_audit"]

# the torch attributes wrapped while an audit is active
SAMPLERS = ("rand", "randn", "randint", "randperm", "bernoulli", "normal",
            "multinomial")


class KeyReuseError(RuntimeError):
    """The same generator state was drawn from at two call sites."""


@dataclasses.dataclass(frozen=True)
class KeyEvent:
    """One recorded draw."""
    kind: str                       # "consume:<sampler>"
    key: tuple                      # (device, digest of the state)
    salt: Optional[int]             # the reference's fold_in data: None
    site: str                       # "file.py:123 in fn"
    seq: int                        # 0-based position in the trace

    def to_json(self) -> dict:
        return {"kind": self.kind, "key": list(self.key),
                "salt": self.salt, "site": self.site, "seq": self.seq}


class KeyTraceReport:
    """The ordered event log of one audited run."""

    def __init__(self):
        self.events: list = []

    def __len__(self):
        return len(self.events)

    def signature(self) -> list:
        """(kind, key, salt) triples, free of sites and positions, so that
        a ``resume()`` replay can be compared suffix for suffix with the
        uninterrupted run's trace."""
        return [(e.kind, e.key, e.salt) for e in self.events]

    def consumed_keys(self) -> set:
        return {e.key for e in self.events if e.kind.startswith("consume:")}

    def to_json(self) -> dict:
        return {"n_events": len(self.events),
                "events": [e.to_json() for e in self.events]}


def _default_generator(device: torch.device):
    if device.type == "cpu":
        return torch.default_generator
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.default_generators[index]
    return None


def _draw_device(args, kwargs) -> torch.device:
    """The device a draw runs on: its ``device=``, else its tensor
    argument's (``bernoulli``, ``normal``, ``multinomial``), else the
    CPU."""
    if kwargs.get("device") is not None:
        return torch.device(kwargs["device"])
    for a in list(args) + [kwargs.get("input"), kwargs.get("mean"),
                           kwargs.get("std")]:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def generator_fingerprint(gen) -> tuple:
    """A hashable view of a generator's state: its device and a digest of
    ``get_state()``."""
    state = gen.get_state()
    digest = hashlib.blake2b(state.numpy().tobytes(), digest_size=16)
    return (str(gen.device), digest.hexdigest())


def _draw_fingerprint(args, kwargs) -> Optional[tuple]:
    """The fingerprint of the state a draw reads; None for a draw on
    ``meta`` tensors (no state)."""
    gen = kwargs.get("generator")
    if gen is None:
        device = _draw_device(args, kwargs)
        if device.type == "meta":
            return None
        gen = _default_generator(device)
        if gen is None:
            return None
    elif gen.device.type == "meta" or _draw_device(args, kwargs).type \
            == "meta":
        return None
    return generator_fingerprint(gen)


def _call_site() -> str:
    """The innermost stack frame outside this module and torch itself:
    the call site a reuse error points at. The frames are walked, not
    formatted: ``traceback.extract_stack`` reads every frame's source
    line, on every draw."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        fn = code.co_filename.replace("\\", "/")
        if not (fn.endswith("analysis/keytrace.py") or "/torch/" in fn):
            return f"{code.co_filename}:{frame.f_lineno} in {code.co_name}"
        frame = frame.f_back
    return "<unknown>"


class KeyAudit:
    """Records (and polices) the draws of the generator chain.

    Use as ``api.run(..., audit_keys=True)`` for the checks alone, or make
    one and pass it (``audit_keys=audit``) to read ``audit.report``
    afterwards. Re-entrant: nested ``activate()`` blocks share one patch
    installation."""

    def __init__(self, *, raise_on_reuse: bool = True):
        self.report = KeyTraceReport()
        self.raise_on_reuse = raise_on_reuse
        self.reuse_events: list = []    # (KeyEvent, first KeyEvent)
        self._consumed: dict = {}       # fingerprint -> first KeyEvent
        self._depth = 0
        self._saved: dict = {}

    def _on_draw(self, fn: str, fingerprint):
        ev = KeyEvent(kind=f"consume:{fn}", key=fingerprint, salt=None,
                      site=_call_site(), seq=len(self.report.events))
        self.report.events.append(ev)
        first = self._consumed.get(fingerprint)
        if first is None:
            self._consumed[fingerprint] = ev
            return
        if first.kind == ev.kind and first.site == ev.site:
            # an exact re-execution reproduces the same values: the
            # re-derivation idiom, recorded and not flagged
            return
        self.reuse_events.append((ev, first))
        if self.raise_on_reuse:
            raise KeyReuseError(
                f"duplicate generator state: torch.{fn} at {ev.site} draws "
                f"from the state already drawn from by {first.kind} at "
                f"{first.site} — every consumer needs a generator state of "
                f"its own (the determinism contract audit_keys enforces)")

    def _wrap(self, name: str, orig):
        def wrapper(*args, **kwargs):
            fingerprint = _draw_fingerprint(args, kwargs)
            if fingerprint is not None:
                self._on_draw(name, fingerprint)
            return orig(*args, **kwargs)

        wrapper._repro_key_audit = True     # guard against double-wrap
        wrapper.__name__ = getattr(orig, "__name__", name)
        wrapper.__wrapped__ = orig
        return wrapper

    @contextlib.contextmanager
    def activate(self):
        if self._depth == 0:
            self._saved = {}
            for name in SAMPLERS:
                orig = getattr(torch, name)
                if getattr(orig, "_repro_key_audit", False):
                    continue
                self._saved[name] = orig
                setattr(torch, name, self._wrap(name, orig))
        self._depth += 1
        try:
            yield self
        finally:
            self._depth -= 1
            if self._depth == 0:
                for name, orig in self._saved.items():
                    setattr(torch, name, orig)
                self._saved = {}


def resolve_audit(audit_keys: Union[bool, KeyAudit]) -> Optional[KeyAudit]:
    """Normalise the ``audit_keys=`` argument: True makes an ephemeral
    audit (checks only), an instance is used as it is, falsy disables."""
    if isinstance(audit_keys, KeyAudit):
        return audit_keys
    return KeyAudit() if audit_keys else None
