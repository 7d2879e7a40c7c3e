"""The port's linter finds what the reference's finds, and the port
carries zero unsuppressed findings, as the reference does.

``predictionio_torch/tools/lint/`` is the port's copy of
``predictionio_tpu/tools/lint/``. Both linters run over both packages'
trees once, in one module-scoped fixture (so ``--dist loadfile`` keeps
the cost on one worker), in whole-program mode with every suppression
comment ignored: their raw findings (rule, path, line, column, message)
must be equal, and so must what each file's suppressions leave of them,
per file and with the project rules. Over ``predictionio_torch/`` the
port's linter must leave nothing: a finding is fixed, or suppressed with
a ``# graftlint: disable=RULE — why`` comment that says why the code is
right. The positive snippets of ``tests/test_lint.py`` (each rule's
fixture that must fire) go through both linters too, per file and per
project. No wall-clock budget is asserted here: under a loaded test run
a budget measures the machine.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import os
from pathlib import Path

import pytest

from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools import lint as jax_lint
from predictionio_tpu.tools.lint import engine as jax_engine
from predictionio_tpu.tools.lint import project as jax_project
from predictionio_torch.tools import cli
from predictionio_torch.tools import lint
from predictionio_torch.tools.lint import engine, project

from tests import test_lint as jax_lint_tests
from tests.test_torch_benchcmp import root_logging_restored  # noqa: F401
from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TREES = {"jax": ROOT / "predictionio_tpu", "port": ROOT / "predictionio_torch"}
LINTERS = {"jax": (jax_lint, jax_engine, jax_project),
           "port": (lint, engine, project)}


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.message)


@contextlib.contextmanager
def _suppressions_ignored(engine_mod):
    """Every suppression comment hides nothing (GL00 still reports an
    unjustified one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod.Suppressions, "hides", lambda self, f: False)
        yield


def _honored(findings, engine_mod, project_mod, rules=None):
    """What each file's suppressions leave of raw findings (the rule set
    ``rules`` only, when given)."""
    hides = engine_mod.Suppressions.hides
    return [f for f in findings
            if (rules is None or f.rule in rules)
            and not hides(project_mod.get_module(f.path).suppressions, f)]


@pytest.fixture(scope="module")
def raw():
    """{(linter, tree): (raw whole-program findings, files scanned)}."""
    out = {}
    for name, (lint_mod, engine_mod, _) in LINTERS.items():
        for tree, path in TREES.items():
            with _suppressions_ignored(engine_mod):
                out[name, tree] = lint_mod.lint_project([str(path)])
    return out


def _passes(raw, linter, tree):
    """(per-file findings, whole-program findings) the linter reports
    over the tree, suppressions honored."""
    lint_mod, engine_mod, project_mod = LINTERS[linter]
    findings, _ = raw[linter, tree]
    per_file = _honored(findings, engine_mod, project_mod,
                        rules=set(lint_mod.RULES) | {"GL00", "GL01"})
    return per_file, _honored(findings, engine_mod, project_mod)


@pytest.mark.parametrize("mode", ["per_file", "project"])
def test_the_port_has_no_unsuppressed_findings(raw, mode):
    per_file, whole = _passes(raw, "port", "port")
    findings = per_file if mode == "per_file" else whole
    assert raw["port", "port"][1] > 100
    assert not findings, (
        f"{len(findings)} {mode} finding(s) over predictionio_torch/:\n"
        + "\n".join(str(f) for f in findings))


@pytest.mark.parametrize("tree", sorted(TREES))
def test_both_linters_find_the_same_before_suppressions(raw, tree):
    (jax_found, jax_files), (port_found, port_files) = (
        raw["jax", tree], raw["port", tree])
    assert port_files == jax_files
    assert [_key(f) for f in port_found] == [_key(f) for f in jax_found]
    # the trees hold suppressed findings of both layers, so the
    # comparison covers real findings, not two empty lists
    assert {f.rule for f in jax_found} & set(jax_lint.RULES)
    assert {f.rule for f in jax_found} & set(jax_lint.PROJECT_RULES)


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("mode", ["per_file", "project"])
def test_both_linters_leave_the_same_findings(raw, tree, mode):
    index = 0 if mode == "per_file" else 1
    assert ([_key(f) for f in _passes(raw, "port", tree)[index]]
            == [_key(f) for f in _passes(raw, "jax", tree)[index]])


def test_the_per_file_pass_is_the_whole_program_pass_less_its_rules(raw):
    """What ``_passes`` derives for the per-file mode is what
    ``lint_paths`` reports: the JAX linter's own per-file pass over the
    port's tree (its parses are cached from the fixture)."""
    assert ([_key(f) for f in jax_lint.lint_paths([str(TREES["port"])])]
            == [_key(f) for f in _passes(raw, "jax", "port")[0]])


# -- the reference's rule fixtures -------------------------------------------

POSITIVE = sorted(name for name, fn in inspect.getmembers(
    jax_lint_tests, inspect.isfunction)
    if name.startswith("test_") and "positive" in name)


def test_the_reference_has_positive_fixtures():
    assert len(POSITIVE) >= 30


@pytest.mark.parametrize("name", POSITIVE)
def test_both_linters_find_the_same_in_a_positive_fixture(
        tmp_path, monkeypatch, name):
    """Run the reference's test (it writes its snippets under a fresh
    directory and asserts what must fire), then lint that directory with
    both linters, per file and as a project."""
    written = []
    for helper in ("lint_src", "lint_project_src"):
        real = getattr(jax_lint_tests, helper)

        def recording(path, src, relpath="mod.py", _real=real):
            written.append(path / relpath)
            return _real(path, src, relpath)

        monkeypatch.setattr(jax_lint_tests, helper, recording)
    getattr(jax_lint_tests, name)(tmp_path)
    assert written, f"{name} wrote no snippet"
    files = sorted({str(p) for p in written})
    for mode in ("per_file", "project"):
        if mode == "per_file":
            got = [jax_lint.lint_paths(files), lint.lint_paths(files)]
        else:
            got = [jax_lint.lint_project([str(tmp_path)])[0],
                   lint.lint_project([str(tmp_path)])[0]]
        jax_found, port_found = ([_key(f) for f in g] for g in got)
        assert port_found == jax_found, (mode, jax_found, port_found)
    assert jax_found, f"{name} fired nothing"


# -- pio lint ------------------------------------------------------------------

def _rule_lines(text):
    return [line for line in text.splitlines()
            if line[:2] in ("JT", "GL")]


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_with_no_path_the_port_lints_its_installed_package(tmp_path,
                                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert engine.default_paths() == [str(TREES["port"])]
    assert jax_engine.default_paths() == [str(TREES["jax"])]
    seen = []
    monkeypatch.setattr(engine, "lint_project",
                        lambda paths: (seen.append(list(paths)) or ([], 7)))
    rc, out, _ = _run(cli.main, ["lint", "--project"])
    assert rc == 0 and seen == [[str(TREES["port"])]]
    assert out.strip() == "graftlint: clean (7 file(s) scanned)"


@pytest.mark.parametrize("argv", [
    ["lint", "--list-rules"],
    ["lint", "no/such/path.py"],
    ["lint", "--json", "{fixture}"],
    ["lint", "--project", "{fixture}"],
    ["lint", "{fixture}"],
])
def test_cli_lint_answers_like_jax(tmp_path, argv):
    fixture = tmp_path / "serving" / "mod.py"
    fixture.parent.mkdir()
    fixture.write_text("import urllib.request\n\n\ndef fetch(url):\n"
                       "    return urllib.request.urlopen(url).read()\n")
    argv = [a.replace("{fixture}", str(fixture)) for a in argv]
    jax_out = _run(jax_cli.main, argv)
    port_out = _run(cli.main, argv)
    if "--list-rules" in argv:
        # the same rules, ids and names; one rationale in the port's copy
        # names no change of the JAX package's history
        assert port_out[0] == jax_out[0] == 0
        assert _rule_lines(port_out[1]) == _rule_lines(jax_out[1])
        return
    assert port_out == jax_out
    if "no/such/path.py" in argv:
        assert port_out[0] == 2 and "graftlint:" in port_out[2]


def test_python_m_entry_point_is_the_engine_main():
    source = (TREES["port"] / "tools" / "lint" / "__main__.py").read_text()
    assert "from predictionio_torch.tools.lint.engine import main" in source
    assert os.path.exists(TREES["port"] / "tools" / "lint" / "rules.py")
