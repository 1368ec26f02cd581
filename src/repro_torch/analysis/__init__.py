"""Analysis tools of the port (the counterpart of ``repro.analysis``):

* ``contracts``: ``check_compressor``, the wire contracts of a
  ``Compressor`` checked on shape-only ``meta`` tensors;
* ``runtime``: the stage checks behind ``api.run/step(..., sanitize=True)``
  and the comm-bytes audit;
* ``keytrace``: the audit of the generator chain behind
  ``audit_keys=True``;
* ``hb``: the happens-before checker that the scheduler's population and
  snapshot writer report to.

The reference's static linter (``linter``, ``rules``, ``keyflow``,
``modindex``, ``findings``, ``__main__``) has no counterpart yet.
"""

__all__ = [
    "CompressorReport", "ContractViolation", "check_compressor",
    "KeyAudit", "KeyReuseError", "KeyTraceReport",
    "HBTracker", "HBViolation",
]

_EXPORTS = {"CompressorReport": "contracts", "ContractViolation": "contracts",
            "check_compressor": "contracts", "KeyAudit": "keytrace",
            "KeyReuseError": "keytrace", "KeyTraceReport": "keytrace",
            "HBTracker": "hb", "HBViolation": "hb"}


def __getattr__(name):
    # resolved on first use: the driver imports ``keytrace`` and
    # ``runtime``, and ``contracts`` imports the compressors, which the
    # driver imports too
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
