"""The port's static linter (``repro_torch.analysis``: rules RPL001-RPL009
in their torch meaning, RPL006 dropped).

Contracts pinned here, on the corpus under ``tests/torch_analysis_corpus``
(parsed, never imported):
  * every kept rule fires EXACTLY at the ``# expect: RPLnnn`` markers of
    its bad file and is silent on its good file; RPL006 is dropped, named
    as such, and has no corpus case;
  * pragma accounting: a valid allow-pragma on the finding's line or the
    line above suppresses it with its reason; a reason-less pragma
    suppresses nothing and is an RPL000 finding, as is a stale one;
    pragma-shaped text in strings is no pragma;
  * a syntax error is an RPL999 finding, not a crash;
  * the port's own tree is clean within DEFAULT_MAX_PRAGMAS pragmas;
  * the CLI's exit codes, the --strict budget, the --baseline ratchet,
    --write-baseline, --exclude, and that a plain lint run imports neither
    torch nor jax.

No JAX and nothing of the reference: ``tests/test_torch_lint_parity.py``
holds the port's linter against the reference's.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import (RULES, LintReport, lint_file, lint_paths,
                                  lint_source, rule_table)
from repro_torch.analysis.__main__ import DEFAULT_MAX_PRAGMAS, main
from repro_torch.analysis.linter import SCHEMA_VERSION
from repro_torch.analysis.rules import DROPPED, get_rules

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "torch_analysis_corpus"
SRC = REPO / "src" / "repro_torch"

BAD_FILES = sorted(CORPUS.glob("rpl*_bad.py"))
GOOD_FILES = sorted(CORPUS.glob("rpl*_good.py"))


def _expected_markers(path: Path):
    out = []
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = re.search(r"# expect: (RPL\d{3})", line)
        if m:
            out.append((m.group(1), i))
    return sorted(out)


@pytest.mark.parametrize("path", BAD_FILES, ids=lambda p: p.stem)
def test_corpus_bad_fires_exactly_at_markers(path):
    expected = _expected_markers(path)
    assert expected, f"{path} has no # expect: markers"
    report = lint_file(str(path))
    got = sorted((f.rule, f.line) for f in report.active)
    assert got == expected
    assert not report.suppressed


@pytest.mark.parametrize("path", GOOD_FILES, ids=lambda p: p.stem)
def test_corpus_good_is_silent(path):
    report = lint_file(str(path))
    assert report.ok, [f.format() for f in report.active]
    assert not report.findings


def test_every_kept_rule_has_firing_and_nonfiring_cases():
    fired = {f.rule for p in BAD_FILES for f in lint_file(str(p)).active}
    assert fired == set(RULES), (
        f"rules without a firing corpus case: {set(RULES) - fired}")
    for rid in RULES:
        stem = rid.lower()
        assert (CORPUS / f"{stem}_bad.py").exists()
        assert (CORPUS / f"{stem}_good.py").exists()


def test_rule_ids_kept_or_dropped_never_reused():
    # every id of the reference's RPL001-RPL009 is kept or named dropped
    assert set(RULES) | set(DROPPED) == {f"RPL00{i}" for i in range(1, 10)}
    assert not set(RULES) & set(DROPPED)
    assert set(DROPPED) == {"RPL006"}
    import repro_torch.analysis.rules as rules_mod
    for rid in DROPPED:
        assert f"* {rid}" in rules_mod.__doc__
        assert f"{rid}  (dropped)" in rule_table()
        assert not list(CORPUS.glob(f"{rid.lower()}_*.py"))
    with pytest.raises(KeyError, match="dropped"):
        get_rules(["RPL006"])


def test_pragma_accounting():
    report = lint_file(str(CORPUS / "pragmas_mixed.py"))
    # two valid suppressions: pragma on the line above, pragma on the line
    sup = sorted((f.rule, f.line) for f in report.suppressed)
    assert sup == [("RPL001", 8), ("RPL001", 14)]
    assert all(f.suppression for f in report.suppressed)
    # the reason-less pragma suppresses nothing and is RPL000; the stale
    # RPL003 pragma is RPL000 too; quoted pragma text counts for nothing
    act = sorted((f.rule, f.line) for f in report.active)
    assert act == [("RPL000", 20), ("RPL000", 26), ("RPL001", 21),
                   ("RPL001", 38)]
    assert report.pragma_count == 3  # 2 used + 1 stale (still has a reason)


def test_real_tree_is_clean_within_pragma_budget():
    report = lint_paths([str(SRC)])
    assert report.ok, "\n".join(f.format() for f in report.active)
    assert report.pragma_count <= DEFAULT_MAX_PRAGMAS, (
        f"{report.pragma_count} allow-pragmas > budget "
        f"{DEFAULT_MAX_PRAGMAS}: {[p.to_json() for p in report.pragmas]}")
    # no stale pragma: every one suppresses a finding
    assert len(report.suppressed) == report.pragma_count
    assert len(report.files) > 90


def test_syntax_error_is_a_finding_not_a_crash():
    report = lint_source("def broken(:\n", path="x.py")
    assert [f.rule for f in report.findings] == ["RPL999"]
    assert not report.ok


def test_rules_subset_and_unknown_rule():
    path = CORPUS / "rpl001_bad.py"
    only_2 = lint_file(str(path), rules=["RPL002"])
    assert not only_2.findings
    with pytest.raises(KeyError, match="RPL042"):
        lint_file(str(path), rules=["RPL042"])


def test_report_json_roundtrip(tmp_path):
    report = lint_file(str(CORPUS / "pragmas_mixed.py"))
    out = tmp_path / "report.json"
    report.dump_json(str(out))
    data = json.loads(out.read_text())
    assert data["schema_version"] == SCHEMA_VERSION == 2
    assert data["n_findings"] == len(report.active) == 4
    assert data["n_suppressed"] == 2
    assert data["n_pragmas"] == 3
    assert {f["rule"] for f in data["findings"]} == {"RPL000", "RPL001"}
    assert [f["line"] for f in data["findings"]] == [
        f.line for f in report.findings]


@pytest.mark.parametrize("source,rule", [
    # the generator made from the loop index is fresh every iteration
    ("import torch\n"
     "def f(seed, n):\n"
     "    out = []\n"
     "    for i in range(n):\n"
     "        g = torch.Generator().manual_seed(seed + i)\n"
     "        out.append(torch.rand((), generator=g))\n"
     "    return out\n", None),
    # an if/else that rebinds the seed on one arm: no replay after it
    ("import torch\n"
     "def f(seed, flag):\n"
     "    a = torch.rand((), generator=torch.Generator().manual_seed(seed))\n"
     "    if flag:\n"
     "        seed = seed + 1\n"
     "    else:\n"
     "        seed = seed + 2\n"
     "    return a, torch.rand((), generator=torch.Generator().manual_seed(seed))\n",
     None),
    # an impure seed (it draws) opens a stream of its own
    ("import torch\n"
     "def f(gen):\n"
     "    a = torch.rand((), generator=torch.Generator().manual_seed(\n"
     "        int(torch.randint(0, 9, (), generator=gen))))\n"
     "    b = torch.rand((), generator=torch.Generator().manual_seed(\n"
     "        int(torch.randint(0, 9, (), generator=gen))))\n"
     "    return a, b\n", None),
    # two unseeded generators start from torch's one default seed
    ("import torch\n"
     "def f():\n"
     "    a = torch.rand((), generator=torch.Generator())\n"
     "    return a, torch.rand((), generator=torch.Generator())\n",
     ("RPL007", 4)),
    # api/driver.py's seed -> generator helper twice on one seed
    ("import torch\n"
     "from ..api.driver import _as_generator\n"
     "def f(seed):\n"
     "    g1, g2 = _as_generator(seed), _as_generator(seed)\n"
     "    return torch.rand((), generator=g1), torch.rand((), generator=g2)\n",
     ("RPL007", 5)),
    # torch.autograd.grad takes outputs, not a function: nothing traced
    ("import torch\n"
     "import numpy as np\n"
     "def loss(x):\n"
     "    return x + np.random.normal()\n"
     "def step(x):\n"
     "    return torch.autograd.grad(loss, x)\n", None),
    # functools.partial of a body passed to vmap is a vmap body
    ("import functools\n"
     "import torch\n"
     "def body(x, t):\n"
     "    return x.item() + t\n"
     "def f(xs):\n"
     "    return torch.func.vmap(functools.partial(body, t=1))(xs)\n",
     ("RPL003", 4)),
    # a forward of an autograd.Function is traced: host randomness in it
    # fires, a Python if on its inputs does not (it runs eagerly)
    ("import random\n"
     "import torch\n"
     "class F(torch.autograd.Function):\n"
     "    @staticmethod\n"
     "    def forward(ctx, x, flag):\n"
     "        if flag:\n"
     "            return x\n"
     "        return x * random.random()\n", ("RPL002", 8)),
    # re.compile and a module's own checkpoint are no transforms
    ("import re\n"
     "import numpy as np\n"
     "from .snap import checkpoint\n"
     "def body(x):\n"
     "    return np.random.normal()\n"
     "P = re.compile(body)\n"
     "Q = checkpoint(body)\n", None),
])
def test_lexical_cases(source, rule):
    report = lint_source(source, path="case.py")
    got = [(f.rule, f.line) for f in report.active]
    assert got == ([] if rule is None else [rule]), \
        [f.format() for f in report.active]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120)


def _main(capsys, *args):
    rc = main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_strict_clean_on_real_tree(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(REPO)          # the default path is src/repro_torch
    out = tmp_path / "lint.json"
    rc, stdout, _ = _main(capsys, "--strict", "--json", str(out))
    assert rc == 0, stdout
    data = json.loads(out.read_text())
    assert data["n_findings"] == 0
    assert data["n_pragmas"] <= DEFAULT_MAX_PRAGMAS
    assert any(f.endswith("analysis/rules.py") for f in data["files"])


def test_cli_fails_on_bad_corpus_file(capsys):
    rc, stdout, _ = _main(capsys, str(CORPUS / "rpl001_bad.py"))
    assert rc == 1
    assert "RPL001" in stdout


def test_cli_pragma_budget_enforced(capsys):
    # the corpus's 3 valid pragmas over a budget of 2 fail --strict even
    # where the findings are ratcheted away by a baseline
    path = str(CORPUS / "pragmas_mixed.py")
    rc, _, err = _main(capsys, path, "--strict", "--max-pragmas", "2")
    assert rc == 1
    assert "allow-pragmas exceed the budget of 2" in err
    rc, _, err = _main(capsys, path, "--strict", "--max-pragmas", "3")
    assert "exceed" not in err


def test_cli_baseline_ratchet(tmp_path, capsys):
    """--write-baseline freezes the debt (exit 0), --baseline lets the
    frozen findings through and blocks only NEW ones."""
    base = tmp_path / "baseline.json"
    bad = str(CORPUS / "rpl001_bad.py")
    rc, stdout, _ = _main(capsys, bad, "--write-baseline", str(base))
    assert rc == 0, stdout
    assert "written to" in stdout
    payload = json.loads(base.read_text())
    assert payload["schema_version"] == SCHEMA_VERSION
    assert payload["baseline"] == {f"RPL001 {bad}": 3}
    rc, stdout, _ = _main(capsys, bad, "--baseline", str(base))
    assert rc == 0, stdout
    assert "0 new" in stdout
    rc, stdout, _ = _main(capsys, bad, str(CORPUS / "rpl002_bad.py"),
                          "--baseline", str(base))
    assert rc == 1
    assert "5 new" in stdout
    # a --json report doubles as a baseline
    report = tmp_path / "report.json"
    rc, _, _ = _main(capsys, bad, "--json", str(report))
    assert rc == 1
    rc, stdout, _ = _main(capsys, bad, "--baseline", str(report))
    assert rc == 0 and "0 new" in stdout
    # a file that is neither is a usage error
    junk = tmp_path / "junk.json"
    junk.write_text("{}")
    rc, _, err = _main(capsys, bad, "--baseline", str(junk))
    assert rc == 2 and "neither" in err


def test_cli_exclude_and_rules_subset(capsys):
    rc, stdout, _ = _main(capsys, str(CORPUS), "--exclude",
                          "torch_analysis_corpus")
    assert rc == 0 and "checked 0 files" in stdout
    report = lint_paths([str(CORPUS)], exclude=["_bad", "pragmas_", "xmod_"])
    assert report.ok, [f.format() for f in report.active]
    assert report.files and all("_bad" not in f for f in report.files)
    bad = str(CORPUS / "rpl007_bad.py")
    rc, stdout, _ = _main(capsys, bad, "--rules", "RPL007", "--strict")
    assert rc == 1 and "RPL007" in stdout
    rc, stdout, _ = _main(capsys, bad, "--rules", "RPL003", "--strict")
    assert rc == 0, stdout
    for unknown in ("RPL042", "RPL006"):
        rc, _, err = _main(capsys, bad, "--rules", unknown)
        assert rc == 2 and unknown in err
    rc, stdout, _ = _main(capsys, "--list-rules")
    assert rc == 0 and stdout.strip() == rule_table()


def test_cross_module_salt_collision_needs_project_index():
    a = CORPUS / "xmod_salts_a.py"
    b = CORPUS / "xmod_salts_b.py"
    # standalone the imported salt is unresolvable -> RPL009 stays silent
    assert lint_file(str(b)).ok
    report = lint_paths([str(a), str(b)])
    got = [(f.rule, Path(f.path).name, f.line) for f in report.active]
    assert got == [("RPL009", "xmod_salts_b.py", 16)]


def test_plain_lint_run_imports_neither_torch_nor_jax():
    # every rule, the default path and a corpus bad file; the subprocess
    # starts from nothing, so sys.modules shows what the run imported
    code = (
        "import sys\n"
        "from repro_torch.analysis.__main__ import main\n"
        "rc = main(['--strict'])\n"
        "assert rc == 0, rc\n"
        "rc = main(['tests/torch_analysis_corpus/rpl007_bad.py',\n"
        "           'tests/torch_analysis_corpus/rpl008_bad.py',\n"
        "           'tests/torch_analysis_corpus/rpl009_bad.py'])\n"
        "assert rc == 1, rc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'numpy', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for rid in ("RPL007", "RPL008", "RPL009"):
        assert rid in r.stdout


def test_cli_module_entry_point(tmp_path):
    r = _run_cli("src/repro_torch", "--strict")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout
    r = _run_cli(str(CORPUS / "rpl005_bad.py"))
    assert r.returncode == 1 and r.stdout.count("RPL005") == 3


def test_contracts_flag_on_meta_tensors(capsys):
    rc, stdout, _ = _main(capsys, str(CORPUS / "rpl001_good.py"),
                          "--contracts")
    assert rc == 0, stdout
    lines = [ln for ln in stdout.splitlines() if ln.startswith("contract ")]
    assert len(lines) == 17 and all(ln.endswith(" ok") for ln in lines)


class TestLintReportApi:
    def test_extend_merges(self):
        a = lint_file(str(CORPUS / "rpl001_bad.py"))
        b = lint_file(str(CORPUS / "rpl002_bad.py"))
        merged = LintReport()
        merged.extend(a)
        merged.extend(b)
        assert len(merged.active) == len(a.active) + len(b.active)
        assert len(merged.files) == 2
