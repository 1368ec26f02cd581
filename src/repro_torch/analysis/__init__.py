"""Analysis tools of the port (the counterpart of ``repro.analysis``):

* the static linter (``linter``, ``rules``, ``keyflow``, ``modindex``,
  ``findings``; CLI ``python -m repro_torch.analysis src/repro_torch
  --strict [--contracts]``): rules RPL001-RPL009 (RPL006 dropped) in
  their torch meaning, standard library only;
* ``contracts``: ``check_compressor``, the wire contracts of a
  ``Compressor`` checked on shape-only ``meta`` tensors;
* ``runtime``: the stage checks behind ``api.run/step(..., sanitize=True)``
  and the comm-bytes audit;
* ``keytrace``: the audit of the generator chain behind
  ``audit_keys=True``;
* ``hb``: the happens-before checker that the scheduler's population and
  snapshot writer report to.
"""

__all__ = [
    "Finding", "Pragma", "Severity",
    "LintReport", "lint_file", "lint_paths", "lint_source",
    "RULES", "rule_table",
    "CompressorReport", "ContractViolation", "check_compressor",
    "KeyAudit", "KeyReuseError", "KeyTraceReport",
    "HBTracker", "HBViolation",
]

_EXPORTS = {"Finding": "findings", "Pragma": "findings",
            "Severity": "findings", "LintReport": "linter",
            "lint_file": "linter", "lint_paths": "linter",
            "lint_source": "linter", "RULES": "rules",
            "rule_table": "rules", "CompressorReport": "contracts",
            "ContractViolation": "contracts",
            "check_compressor": "contracts", "KeyAudit": "keytrace",
            "KeyReuseError": "keytrace", "KeyTraceReport": "keytrace",
            "HBTracker": "hb", "HBViolation": "hb"}


def __getattr__(name):
    # resolved on first use: the driver imports ``keytrace`` and
    # ``runtime``, and ``contracts`` imports the compressors, which the
    # driver imports too; the linter's modules are standard library only
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
