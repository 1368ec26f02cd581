"""File walker, rule driver and pragma accounting of the port's linter
(the counterpart of ``repro/analysis/linter.py``).

``lint_paths`` is the programmatic entry (tests and the CLI both use it):
parse each ``*.py`` once, build one ``ModuleIndex``, run every requested
rule, then apply allow-pragmas: a finding at line L is suppressed by a
valid ``# repro: allow[<rule>] <reason>`` pragma on line L or L-1.
Pragmas are themselves audited: a pragma with an empty reason and a
pragma that suppresses NOTHING (stale: the code moved or the rule no
longer fires) are findings, so the allow list can only shrink by edits
that keep it honest. Standard library only: a lint run imports neither
torch nor the rest of the port.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Iterable, Optional

from .findings import Finding, Severity, parse_pragmas
from .modindex import ModuleIndex, ProjectIndex
from .rules import get_rules

# pragma bookkeeping findings (not real rules — never suppressible)
_PRAGMA_RULE = "RPL000"

# version of the LintReport.to_json shape; bump on any key change so the
# --baseline ratchet and CI artifact consumers can reject mismatches
SCHEMA_VERSION = 2


@dataclasses.dataclass
class LintReport:
    """Aggregated result over one or more files."""
    findings: list = dataclasses.field(default_factory=list)
    pragmas: list = dataclasses.field(default_factory=list)
    files: list = dataclasses.field(default_factory=list)

    @property
    def active(self) -> list:
        """Findings that fail the build (not suppressed)."""
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list:
        return [f for f in self.findings if f.suppressed]

    @property
    def pragma_count(self) -> int:
        """Valid allow-pragmas in the scanned tree (the --strict budget)."""
        return sum(1 for p in self.pragmas if p.valid)

    @property
    def ok(self) -> bool:
        return not self.active

    def extend(self, other: "LintReport"):
        self.findings.extend(other.findings)
        self.pragmas.extend(other.pragmas)
        self.files.extend(other.files)

    def to_json(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "files": list(self.files),
            "n_findings": len(self.active),
            "n_suppressed": len(self.suppressed),
            "n_pragmas": self.pragma_count,
            "findings": [f.to_json() for f in self.findings],
            "pragmas": [p.to_json() for p in self.pragmas],
        }

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)


def _apply_pragmas(findings: list, pragmas: list, path: str) -> LintReport:
    """Suppress findings covered by valid pragmas; flag invalid and stale
    pragmas as findings of their own."""
    used = set()
    out = []
    for f in sorted(findings, key=lambda f: (f.line, f.col, f.rule)):
        hit = None
        for p in pragmas:
            if p.rule == f.rule and p.valid and p.line in (f.line,
                                                           f.line - 1):
                hit = p
                break
        if hit is not None:
            used.add((hit.rule, hit.line))
            out.append(dataclasses.replace(f, suppressed=True,
                                           suppression=hit.reason))
        else:
            out.append(f)
    for p in pragmas:
        if not p.valid:
            out.append(Finding(
                rule=_PRAGMA_RULE, path=path, line=p.line, col=0,
                message=f"allow-pragma for {p.rule} without a reason — "
                        f"every deliberate violation must say why "
                        f"(# repro: allow[{p.rule}] <reason>)"))
        elif (p.rule, p.line) not in used:
            out.append(Finding(
                rule=_PRAGMA_RULE, path=path, line=p.line, col=0,
                message=f"stale allow-pragma: no {p.rule} finding on this "
                        f"or the next line — remove it (the code it "
                        f"excused moved or was fixed)"))
    return LintReport(findings=out, pragmas=list(pragmas), files=[path])


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Iterable[str]] = None,
                project: Optional[ProjectIndex] = None) -> LintReport:
    """Lint one source string (the corpus tests' entry point)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        f = Finding(rule="RPL999", path=path, line=e.lineno or 0, col=0,
                    message=f"syntax error: {e.msg}",
                    severity=Severity.ERROR)
        return LintReport(findings=[f], files=[path])
    index = ModuleIndex(tree)
    index.project = project
    findings = []
    for fn, _ in get_rules(rules).values():
        findings.extend(fn(index, path))
    # dedupe: a rule revisiting a node through an alias must yield ONE
    # finding per site
    seen, unique = set(), []
    for f in findings:
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return _apply_pragmas(unique, parse_pragmas(source), path)


def lint_file(path: str,
              rules: Optional[Iterable[str]] = None,
              project: Optional[ProjectIndex] = None) -> LintReport:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path=path, rules=rules,
                           project=project)


def iter_python_files(paths: Iterable[str], exclude: Iterable[str] = ()):
    exclude = [x.replace(os.sep, "/") for x in exclude]

    def keep(p: str) -> bool:
        q = p.replace(os.sep, "/")
        return not any(x in q for x in exclude)

    for p in paths:
        if os.path.isfile(p):
            if keep(p):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    full = os.path.join(root, name)
                    if name.endswith(".py") and keep(full):
                        yield full


def build_project_index(files: Iterable[str]) -> ProjectIndex:
    """Prepass: collect every module's top-level integer constants so
    RPL009 can resolve salts through from-imports. Unparseable files are
    skipped here — they surface as RPL999 findings in the main pass."""
    project = ProjectIndex()
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except (SyntaxError, OSError, UnicodeDecodeError):
            continue
        project.add(path, ModuleIndex(tree))
    return project


def lint_paths(paths: Iterable[str],
               rules: Optional[Iterable[str]] = None,
               exclude: Iterable[str] = ()) -> LintReport:
    files = list(iter_python_files(paths, exclude=exclude))
    project = build_project_index(files)
    report = LintReport()
    for path in files:
        report.extend(lint_file(path, rules=rules, project=project))
    return report
