"""Workflow-level knobs (copy of ``predictionio_tpu/workflow/config.py``;
ref: workflow/WorkflowParams.scala:19)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class WorkflowParams:
    """ref: WorkflowParams.scala:19 — batch label, verbosity, model saving,
    sanity-check skipping and the stop-after debug interruptions
    (ref: Engine.scala:624-648)."""

    batch: str = ""
    verbose: int = 2
    save_model: bool = True
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    env: Dict[str, str] = field(default_factory=dict)
