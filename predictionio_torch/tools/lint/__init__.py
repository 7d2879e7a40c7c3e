"""graftlint — JAX/TPU-aware static analysis for the DASE pipeline.

The port's copy of ``predictionio_tpu/tools/lint/``: the same rules,
rule ids and findings on either package's tree; with no path it lints
the installed ``predictionio_torch`` package.

Ordinary linters can't see this framework's hazard class: traced-value
host syncs (JT01), Python branches on tracers (JT02), low-precision
accumulation (JT03, the bf16-Gramian bug class), swallowed exceptions on
serving hot paths (JT04), undeclared mesh axes (JT05) and per-request
blocking transfers in HTTP handlers (JT06). With ``--project`` the
whole-program layer (project.py + concurrency.py) adds lock-discipline
inference and race/deadlock detection across the fleet substrate:
unguarded shared mutation (JT18), lock-order cycles (JT19) and
check-then-act splits (JT20).

    python -m predictionio_torch.tools.lint [paths] [--project] [--json]
    pio lint [--project] [paths]
    bin/lint

Suppress a reviewed finding with a justified comment:

    ...  # graftlint: disable=JT01 — one-time warm-up, not a hot path
"""

from __future__ import annotations

from predictionio_torch.tools.lint.engine import (
    Finding,
    Rule,
    RULES,
    lint_file,
    lint_paths,
    lint_project,
    main,
    register,
    run_cli,
)
from predictionio_torch.tools.lint import rules  # noqa: F401 — registers JT01-JT17, JT22-JT23
from predictionio_torch.tools.lint.project import PROJECT_RULES, register_project
from predictionio_torch.tools.lint import concurrency  # noqa: F401 — registers JT18-JT21

__all__ = [
    "Finding",
    "Rule",
    "RULES",
    "PROJECT_RULES",
    "lint_file",
    "lint_paths",
    "lint_project",
    "main",
    "register",
    "register_project",
    "run_cli",
    "rules",
    "concurrency",
]
