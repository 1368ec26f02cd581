"""The port's linter held against the reference's (``repro.analysis``).

The reference's linter is standard library only and ``src/repro`` has no
``__init__.py``, so this file imports no JAX. On the same inputs the two
agree on: the pragmas of every file of the reference's corpus and of
both source trees, ``dotted_name``/``last_component``, the (rule, line,
suppressed) sets on the reference's own RPL001 and pragma corpus files,
the cross-module constant resolution of its salt fixture, RPL999, and
the JSON report's keys. (``--contracts`` against the reference's
``_run_contracts`` imports JAX: ``tests/test_torch_contracts.py``.)
"""
import ast
from pathlib import Path

import pytest

from repro.analysis import findings as j_findings
from repro.analysis import linter as j_linter
from repro.analysis import modindex as j_modindex
from repro_torch.analysis import findings as t_findings
from repro_torch.analysis import linter as t_linter
from repro_torch.analysis import modindex as t_modindex

REPO = Path(__file__).resolve().parents[1]
REF_CORPUS = REPO / "tests" / "analysis_corpus"
PRAGMA_FILES = (sorted(REF_CORPUS.glob("*.py"))
                + sorted((REPO / "src" / "repro").rglob("*.py"))
                + sorted((REPO / "src" / "repro_torch").rglob("*.py"))
                + sorted((REPO / "tests" / "torch_analysis_corpus")
                         .glob("*.py")))


def _pragmas(mod, source):
    return [(p.rule, p.line, p.reason, p.valid)
            for p in mod.parse_pragmas(source)]


def test_parse_pragmas_agree_on_every_file():
    n = 0
    for path in PRAGMA_FILES:
        source = path.read_text()
        want = _pragmas(j_findings, source)
        assert _pragmas(t_findings, source) == want, path
        n += len(want)
    assert n >= 4 + 3          # the reference's 4 and its corpus's 3


@pytest.mark.parametrize("source", [
    # a reason-less pragma, pragma text in a string, an unterminated
    # string (tokenize fails: no pragmas, no crash)
    "x = 1  # repro: allow[RPL001]\n",
    "x = '# repro: allow[RPL001] in a string'\n",
    "#repro:allow[RPL004]   spaced   \nx = 1\n",
    "x = '''\n# repro: allow[RPL001] unterminated\n",
])
def test_parse_pragmas_agree_on_edge_cases(source):
    assert _pragmas(t_findings, source) == _pragmas(j_findings, source)


def test_dotted_name_and_last_component_agree():
    exprs = ["jax.lax.scan", "torch.func.vmap", "x", "a.b.c.d", "f()",
             "f().g", "x[0].y", "(a + b).c", "'s'.join", "self.gen.seed"]
    for text in exprs:
        node = ast.parse(text, mode="eval").body
        assert t_modindex.dotted_name(node) == j_modindex.dotted_name(node)
        assert (t_modindex.last_component(node)
                == j_modindex.last_component(node))
    # every call's callee in the reference's source tree
    for path in sorted((REPO / "src" / "repro").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                assert (t_modindex.dotted_name(node.func)
                        == j_modindex.dotted_name(node.func)), path


def _verdicts(report):
    return sorted((f.rule, f.line, f.suppressed, f.suppression)
                  for f in report.findings)


@pytest.mark.parametrize("name", ["rpl001_bad.py", "rpl001_good.py",
                                  "pragmas_mixed.py"])
def test_rpl001_and_pragma_verdicts_agree(name):
    path = str(REF_CORPUS / name)
    want = _verdicts(j_linter.lint_file(path, rules=["RPL001"]))
    got = _verdicts(t_linter.lint_file(path, rules=["RPL001"]))
    assert got == want
    if name != "rpl001_good.py":
        assert want


def test_pragma_accounting_agrees_with_every_rule():
    # the pragma corpus under each linter's full rule set: the same
    # suppressed sites, the same RPL000 (reason-less and stale) sites
    path = str(REF_CORPUS / "pragmas_mixed.py")
    j = j_linter.lint_file(path)
    t = t_linter.lint_file(path)
    assert _verdicts(t) == _verdicts(j)
    assert t.pragma_count == j.pragma_count == 3


def _resolved(mod, project, path):
    index = mod.ModuleIndex(ast.parse(path.read_text()))
    index.project = project
    return [(getattr(n, "lineno", 0), getattr(n, "col_offset", 0),
             index.resolve_int(n)) for n in ast.walk(index.tree)
            if isinstance(n, (ast.Name, ast.Attribute, ast.Constant,
                              ast.UnaryOp))]


def test_cross_module_constant_resolution_agrees():
    files = [str(REF_CORPUS / "xmod_salts_a.py"),
             str(REF_CORPUS / "xmod_salts_b.py")]
    j_project = j_linter.build_project_index(files)
    t_project = t_linter.build_project_index(files)
    b = REF_CORPUS / "xmod_salts_b.py"
    want = _resolved(j_modindex, j_project, b)
    assert _resolved(t_modindex, t_project, b) == want
    assert 0xBEEF in {v for _, _, v in want}
    # standalone (no project), the import stays unresolved in both
    assert (_resolved(t_modindex, None, b) == _resolved(j_modindex, None, b))
    for mod_expr, name in (("xmod_salts_a", "SHARED_SALT"),
                           (".xmod_salts_a", "SHARED_SALT"),
                           ("analysis_corpus.xmod_salts_a", "SHARED_SALT"),
                           ("xmod_salts_a", "MISSING"), ("", "SHARED_SALT")):
        assert (t_project.lookup(mod_expr, name)
                == j_project.lookup(mod_expr, name))
    for path in ("src/repro/faults/spec.py", "src/repro/__init__.py",
                 "tests/analysis_corpus/x.py", "a\\b.py"):
        assert (t_modindex.module_dotted_path(path)
                == j_modindex.module_dotted_path(path))


def test_reference_salts_resolve_alike_across_the_tree():
    # every integer the reference's own tree resolves, the port's index
    # resolves the same way (the reference's fault salts among them)
    files = list(j_linter.iter_python_files([str(REPO / "src" / "repro")]))
    assert files == list(t_linter.iter_python_files(
        [str(REPO / "src" / "repro")]))
    j_project = j_linter.build_project_index(files)
    t_project = t_linter.build_project_index(files)
    for path in files:
        p = Path(path)
        assert (_resolved(t_modindex, t_project, p)
                == _resolved(j_modindex, j_project, p)), path


def test_syntax_error_agrees():
    source = "def broken(:\n    pass\n"
    j = j_linter.lint_source(source, path="x.py")
    t = t_linter.lint_source(source, path="x.py")
    assert [f.to_json() for f in t.findings] == \
        [f.to_json() for f in j.findings]
    assert [f.rule for f in t.findings] == ["RPL999"]


def test_json_report_keys_agree(tmp_path):
    path = str(REF_CORPUS / "pragmas_mixed.py")
    j = j_linter.lint_file(path).to_json()
    t = t_linter.lint_file(path).to_json()
    assert t_linter.SCHEMA_VERSION == j_linter.SCHEMA_VERSION == 2
    assert list(t) == list(j)
    assert [list(f) for f in t["findings"]] == [list(f) for f in j["findings"]]
    assert [list(p) for p in t["pragmas"]] == [list(p) for p in j["pragmas"]]
    assert t["pragmas"] == j["pragmas"]
    for key in ("schema_version", "files", "n_suppressed", "n_pragmas"):
        assert t[key] == j[key]
