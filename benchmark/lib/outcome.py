"""What a runner hands back to ``run.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class Outcome:
    #: units of work the window attempted, and those that failed
    attempted: int
    failed: int
    #: end-to-end metrics by name (host clock), ``--trace 0``
    e2e: Dict[str, float]
    #: the numbers the check compares, by name (limits: limits/<cell>.json)
    readings: Dict[str, float]
    #: ``torch.cuda.max_memory_allocated`` over set-up and window, read
    #: before the reference ran
    memory_peak_bytes: int
    #: ``--trace 1``: what the per-layer readers read (``metrics/``)
    context: Optional[dict] = None
    #: ``--trace 1``: the traced window (a ``trace.Session``)
    trace: Optional[object] = None
    #: what the run prints to standard error before its checks: each
    #: unit's seconds in the window, and the runner's own stage times
    log: Optional[dict] = None
