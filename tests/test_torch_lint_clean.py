"""The port carries zero unsuppressed lint findings, as the reference does.

``tests/test_lint_clean.py`` holds ``predictionio_tpu/`` to zero
findings of the per-file pass (``lint_paths``) and of the whole-program
concurrency pass (``lint_project``); the same two passes over
``predictionio_torch/`` must report none either. A finding is fixed, or
suppressed with a ``# graftlint: disable=RULE — why`` comment that
says why the code is right. No wall-clock budget is asserted here: the
lint's speed is the reference's gate, and under a loaded test run a
budget measures the machine.
"""

from pathlib import Path

import pytest

from predictionio_tpu.tools.lint import lint_paths, lint_project

PORT = Path(__file__).resolve().parents[1] / "predictionio_torch"


@pytest.mark.parametrize("mode", ["per_file", "project"])
def test_the_port_has_no_unsuppressed_findings(mode):
    if mode == "per_file":
        findings = lint_paths([str(PORT)])
    else:
        findings, files = lint_project([str(PORT)])
        assert files > 100
    assert not findings, (
        f"{len(findings)} {mode} finding(s) over predictionio_torch/:\n"
        + "\n".join(str(f) for f in findings))
