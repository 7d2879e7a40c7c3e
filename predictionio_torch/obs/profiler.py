"""On-demand profiling on the card: capture windows + device-time summary.

Counterpart of ``predictionio_tpu/obs/profiler.py``, on
``torch.profiler`` with CPU and CUDA activities instead of the JAX
profiler's xplane:

  - ``capture(seconds)`` records a window of the LIVE process (the
    other threads' serving or training work; CUPTI traces every kernel
    the process launches) and writes it as a Chrome trace
    (``trace.json``, opens in Perfetto or ``chrome://tracing``) under
    ``PIO_PROFILE_DIR`` or a fresh temporary directory. Wired to
    ``POST /admin/profile?seconds=N`` on every server.
  - :func:`summarize` is what the JAX module's ``parse_xplane`` /
    ``step_breakdown`` were: device time by kernel name (launch counts
    and summed self time, read by ``tools/device_time.device_split``,
    the one reader of a trace's device events) and the idle share of
    the window.

``ProfilerBusy`` and ``ProfilerUnavailable`` keep their meaning. A
process with a CUDA card always has the profiler; without one it is
unavailable (``POST /admin/profile`` answers 501) unless
``PIO_PROFILE_FORCE=1``, which records CPU activity only, so tests
drive the capture path on the CPU. torch is imported when a capture
starts, never when this module is.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)


class ProfilerUnavailable(RuntimeError):
    """No CUDA card to profile (and no PIO_PROFILE_FORCE)."""


class ProfilerBusy(RuntimeError):
    """A capture window is already open (one at a time)."""


_capture_lock = threading.Lock()
_active = threading.Event()


def backend() -> str:
    """``cuda`` when this process can reach a card, else ``cpu``; never
    imports torch when nothing has."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available():
        return "cuda"
    return "cpu"


def available() -> bool:
    """Whether a capture records a device timeline: always on a card;
    on the CPU only under ``PIO_PROFILE_FORCE=1`` (CPU activity)."""
    if os.environ.get("PIO_PROFILE_FORCE") == "1":
        return True
    if "torch" not in sys.modules:
        import torch  # noqa: F401 — a capture needs it anyway
    return backend() == "cuda"


def active() -> bool:
    """A capture window is open now."""
    return _active.is_set()


def clamp_seconds(seconds: float) -> float:
    """The EFFECTIVE capture window for a requested length (bounds a
    typo'd N at 5 minutes). Callers that report the window to an
    operator must echo this value, not the request."""
    seconds = float(seconds)
    if not seconds >= 0.0:  # negatives AND NaN ("nan" parses as float)
        return 0.0
    return min(seconds, 300.0)


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def summarize(prof, window_sec: float) -> Dict[str, Any]:
    """Device time of a finished profile by short kernel name, and the
    share of the ``window_sec`` window the device spent idle (1 - summed
    kernel time over the window, clamped at 0: kernels on one stream do
    not overlap)."""
    from predictionio_torch.tools import device_time

    kernels = device_time.device_split(prof)
    device_ms = sum(v["ms"] for v in kernels.values())
    window_ms = window_sec * 1e3
    return {
        "window_ms": window_ms,
        "device_ms": device_ms,
        "idle_share": (max(0.0, 1.0 - device_ms / window_ms)
                       if window_ms > 0 else None),
        "kernels": kernels,
    }


def kernel_count(summary: Dict[str, Any], prefix: str) -> int:
    """Launches of the kernels whose short name starts with ``prefix``
    (``topk_dot`` -> ``topk_dot_kernel``)."""
    return sum(v["count"] for name, v in summary["kernels"].items()
               if name.startswith(prefix))


@contextlib.contextmanager
def trace_capture(out_dir: str):
    """``with trace_capture(dir) as result:`` — the block runs under
    ``torch.profiler``; on exit the Chrome trace is written to
    ``dir/trace.json`` and ``result`` (a dict) gains ``artifact``,
    ``seconds`` and ``summary``. Raises ProfilerBusy while another
    window is open."""
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already running")
    try:
        import torch
        from torch.profiler import profile

        os.makedirs(out_dir, exist_ok=True)
        result: Dict[str, Any] = {}
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with profile(activities=_activities()) as prof:
            # the window is the time the caller's work was traced, not
            # the profiler's own start and stop
            t0 = time.perf_counter()
            _active.set()
            try:
                yield result
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                window = time.perf_counter() - t0
                _active.clear()
        path = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(path)
        result.update({"artifact": path, "seconds": window,
                       "summary": summarize(prof, window)})
        log.info("profiler capture of %.3fs written to %s", window, path)
    finally:
        _capture_lock.release()


def capture(seconds: float, out_dir: Optional[str] = None) -> Dict[str, Any]:
    """Record a profiling window of this process: ``{"artifact": the
    Chrome trace's path, "seconds": the window, "summary":
    summarize()}``. Raises ProfilerUnavailable without a card (and
    without PIO_PROFILE_FORCE) and ProfilerBusy when a window is open."""
    if not available():
        raise ProfilerUnavailable(
            f"torch.profiler needs a CUDA card (backend: {backend()})")
    seconds = clamp_seconds(seconds)
    path = (out_dir or os.environ.get("PIO_PROFILE_DIR")
            or tempfile.mkdtemp(prefix="pio_profile_"))
    with trace_capture(path) as result:
        time.sleep(seconds)
    return result
