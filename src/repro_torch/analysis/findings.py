"""Finding and pragma types of the port's linter and its CLI (the
counterpart of ``repro/analysis/findings.py``, same syntax and JSON).

A ``Finding`` is one rule violation at one source location. A deliberate
site is excused by the allow-pragma (spelled with a real rule id, e.g.
RPL001)

    # repro: allow[RPLxxx] <reason>

on the SAME line as the finding or the line immediately above it. The
reason is required: a bare ``allow[...]`` suppresses nothing, so every
deliberate violation carries its justification next to the code.
"""
from __future__ import annotations

import dataclasses
import enum
import io
import re
import tokenize
from typing import Optional

PRAGMA_RE = re.compile(
    r"#\s*repro:\s*allow\[(?P<rule>RPL\d{3})\]\s*(?P<reason>.*?)\s*$")


class Severity(enum.Enum):
    ERROR = "error"      # a shipped-bug class: fails --strict
    WARNING = "warning"  # suspicious but not a known shipped class

    def __str__(self):
        return self.value


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""
    rule: str            # "RPL001"
    path: str            # file path as given to the linter
    line: int            # 1-based
    col: int             # 0-based (ast convention)
    message: str
    severity: Severity = Severity.ERROR
    suppressed: bool = False          # an allow-pragma covered it
    suppression: Optional[str] = None  # the pragma's reason text

    def format(self) -> str:
        tag = " (allowed: %s)" % self.suppression if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} [{self.severity}] {self.message}{tag}")

    @property
    def baseline_key(self) -> str:
        """The (rule, file) bucket the --baseline ratchet counts findings
        in — deliberately line- and message-agnostic so unrelated edits
        that shift line numbers don't invalidate a committed baseline."""
        return f"{self.rule} {self.path}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "message": self.message,
            "severity": str(self.severity), "suppressed": self.suppressed,
            "suppression": self.suppression,
        }


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One parsed ``# repro: allow[RPLxxx] reason`` comment."""
    rule: str
    line: int
    reason: str

    @property
    def valid(self) -> bool:
        return bool(self.reason)

    def to_json(self) -> dict:
        return {"rule": self.rule, "line": self.line, "reason": self.reason}


def parse_pragmas(source: str) -> list[Pragma]:
    """All allow-pragmas in a source file (valid or not — pragmas with an
    empty reason are reported as findings by the linter, not honored).

    Only real COMMENT tokens count: pragma-shaped text inside a string
    literal or docstring (e.g. documentation quoting the convention) is
    not a pragma — it must neither suppress a finding on the adjacent
    line nor consume the --strict budget.
    """
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = PRAGMA_RE.search(tok.string)
            if m:
                out.append(Pragma(rule=m.group("rule"), line=tok.start[0],
                                  reason=m.group("reason").strip()))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # unparseable source is an RPL999 finding upstream, not ours
    return out
