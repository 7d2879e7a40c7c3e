"""Structured logging: one JSON object per line, trace-correlated.

Copy of ``predictionio_tpu/obs/logging.py``: ``setup()`` runs when a
server starts (the engine, event and admin servers' mains), never at
import.

The reference scatters its operational story across log4j layouts and
``println``; here every server entry point funnels through ``setup()``,
which installs a root handler whose records carry the active request's
trace id (obs/trace.py contextvar) — so a ``grep <trace-id>`` joins the
HTTP access line, the slow-request record, the storage round-trip and
the error traceback for one request across every log stream.

Two formats, switched by ``PIO_LOG_JSON``:

  JSON (servers' default): ``{"ts": ..., "level": "INFO", "logger":
  "predictionio_torch.serving.engine_server", "message": ...,
  "trace": "<id>", ...}`` — structured extras attach via
  ``logger.info("...", extra={"pio": {...}})`` and are merged into the
  object (the slow-request log in obs/flight.py uses this to carry the
  full stage breakdown)

  plain (the ``pio`` console's default): the classic human line, with
  `` [trace=<id>]`` appended when a trace is active

``setup()`` is idempotent and never raises: logging must not change
whether serving runs.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict, Optional

from predictionio_torch.obs import trace


class JSONFormatter(logging.Formatter):
    """One JSON object per record; the active trace id rides along."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id = trace.current_trace_id()
        if trace_id:
            out["trace"] = trace_id
        extra = getattr(record, "pio", None)
        if isinstance(extra, dict):
            # structured payload wins over the envelope only for keys
            # the envelope does not own
            for k, v in extra.items():
                out.setdefault(k, v)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class PlainTraceFormatter(logging.Formatter):
    """The human line; `` [trace=<id>]`` appended under an active trace."""

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        trace_id = trace.current_trace_id()
        if trace_id:
            line += f" [trace={trace_id}]"
        return line


def _want_json(default_json: bool) -> bool:
    raw = os.environ.get("PIO_LOG_JSON")
    if raw is None:
        return default_json
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


_installed_handler: Optional[logging.Handler] = None


def setup(level: int = logging.INFO, default_json: bool = True,
          stream=None) -> logging.Handler:
    """Install the structured root handler (idempotent; replaces the
    handler it installed before, never anyone else's).

    Servers call this with the default (JSON unless ``PIO_LOG_JSON=0``);
    the interactive ``pio`` console passes ``default_json=False`` so
    operator terminals stay human-readable unless opted in."""
    global _installed_handler
    root = logging.getLogger()
    handler = logging.StreamHandler(stream or sys.stderr)
    if _want_json(default_json):
        handler.setFormatter(JSONFormatter())
    else:
        handler.setFormatter(PlainTraceFormatter(
            "%(levelname)s:%(name)s:%(message)s"))
    if _installed_handler is not None and _installed_handler in (
            root.handlers):
        root.removeHandler(_installed_handler)
    root.addHandler(handler)
    root.setLevel(level)
    _installed_handler = handler
    return handler
