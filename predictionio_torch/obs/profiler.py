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
  - :func:`summarize` is what the JAX module's ``parse_xplane`` was:
    device time by kernel name (launch counts and summed self time,
    read by ``tools/device_time.device_split``, the one reader of a
    trace's device events) and the idle share of the window. A capture
    with no card (``device: "cpu"``) also keeps its CPU operators' self
    time (``cpu_ops``).
  - :func:`parse_capture`, :func:`per_step` and :func:`step_breakdown`
    give a finished capture JAX's record shape: ``device_time_sec``
    and the top 8 ``by_category`` (``time_frac`` and ``launches``,
    keyed by kernel short name, so ``flash_ce_kernel_bf16``,
    ``embed_update_kernel`` and ``topk_dot_kernel`` stand under their
    own names), then device ms a step. ``workflow/train.py``'s
    ``PIO_PROFILE_DIR`` capture writes it as ``breakdown.json``; on a
    capture without a card the CPU operators take the kernels' place
    (``device: "cpu"``). No subprocess is needed: no proto stack has
    to be kept apart, as the JAX parser's must.

A window on a card opens after a lead-in. A ``torch.profiler`` session
started in a process that has run a while drops the device records of
the first kernels it sees: 4 of 100 markers at 100 s of the process's
age, 17 at 250 s, 37 at 500 s on an H100 host
(``tools/profile_window.py --lead none``), and as many when the session
only waits before its first kernel, while the records it keeps are
stamped within a millisecond of their launches. So a window whose first
kernels are the caller's would lose them: a capture opened late in a
long-lived process (``POST /admin/profile`` on a server up for hours)
under-counts, and a short one records nothing.
:func:`windowed_profile` starts the profiler, then launches a tiny
kernel every millisecond for :func:`lead_in_sec` (it grows with the
process's age) so that the lead-in's kernels take that loss; then a
marker opens the caller's window and a second one closes it. The
summary keeps the device records between the two markers, so the
lead-in stays out of ``seconds`` and ``idle_share``. The lead-in's
length is fitted to windows up to ~925 s of age; where it falls short
and the card's record of a marker is lost, the window has no bounds,
and its summary says ``window_lost`` and holds no device time rather
than counting the lead-in as the caller's.

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

#: the lead-in per second of the process's age, its floor and its cap:
#: a tiny kernel a millisecond, over ten times the records a session
#: dropped at 500 s of age on an H100 host (37)
LEAD_PER_SEC_OF_AGE = 1e-3
LEAD_FLOOR_SEC = 0.02
LEAD_MAX_SEC = 10.0
LEAD_SPACING_SEC = 1e-3
#: the record_function ranges around the markers that open and close a
#: window on a card
OPEN_MARK = "pio_profiler::open"
CLOSE_MARK = "pio_profiler::close"


def process_age_sec() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def lead_in_sec(age_sec: Optional[float] = None) -> float:
    """The wait between a profiler's start and the caller's window at a
    process age of ``age_sec`` (this process's when None)."""
    age = process_age_sec() if age_sec is None else age_sec
    return min(LEAD_MAX_SEC,
               LEAD_FLOOR_SEC + LEAD_PER_SEC_OF_AGE * max(0.0, age))


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


def _mark(name: str) -> None:
    """One small kernel inside a ``record_function`` range called
    ``name`` (the profiler also records the range on the card)."""
    import torch

    with torch.profiler.record_function(name):
        torch.ones(1, device="cuda")


def _lead_kernel() -> None:
    """One tiny kernel of the lead-in, waited for."""
    import torch

    torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _lead_in(seconds: float, sleep) -> None:
    """A tiny kernel every ``LEAD_SPACING_SEC`` for ``seconds``."""
    end = time.perf_counter() + seconds
    while True:
        _lead_kernel()
        if time.perf_counter() >= end:
            return
        sleep(LEAD_SPACING_SEC)


def device_window(prof) -> Dict[str, Any]:
    """Where a :func:`windowed_profile`'s markers put the caller's
    window on the card's clock: ``start_us`` (the end of the open
    marker's range as the card recorded it) and ``end_us`` (the start of
    the close marker's), each None when the card's record of it was
    lost, ``lost`` (either was), and ``clock_offset_ms``, the card's
    start of the open marker less its range's start on the host clock
    (the marker's launch latency)."""
    import torch

    events = prof.events()
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    host = {e.name: e for e in events
            if e.device_type == cpu and e.name in (OPEN_MARK, CLOSE_MARK)}
    card = {e.name: e for e in events
            if e.device_type == cuda and e.name in (OPEN_MARK, CLOSE_MARK)}
    opened, closed = card.get(OPEN_MARK), card.get(CLOSE_MARK)
    return {
        "start_us": opened.time_range.end if opened else None,
        "end_us": closed.time_range.start if closed else None,
        "lost": opened is None or closed is None,
        "clock_offset_ms": ((opened.time_range.start
                             - host[OPEN_MARK].time_range.start) / 1e3
                            if opened and OPEN_MARK in host else None),
    }


@contextlib.contextmanager
def windowed_profile(sleep=time.sleep):
    """``with windowed_profile() as w:`` — the block runs under
    ``torch.profiler``; on exit ``w`` holds ``prof``, ``seconds`` (the
    block's time on the host clock, from the open marker to the last
    device work's end), ``lead_sec`` and, on a card, ``window``
    (:func:`device_window`). On a card the block starts after the
    lead-in (:func:`lead_in_sec`) and the open marker."""
    import torch
    from torch.profiler import profile

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    state: Dict[str, Any] = {"lead_sec": 0.0, "window": None}
    with profile(activities=_activities()) as prof:
        state["prof"] = prof
        if cuda:
            state["lead_sec"] = lead_in_sec()
            _lead_in(state["lead_sec"], sleep)
            _mark(OPEN_MARK)
        # the window is the time the caller's work was traced, not the
        # profiler's own start and stop
        t0 = time.perf_counter()
        try:
            yield state
        finally:
            if cuda:
                torch.cuda.synchronize()
            state["seconds"] = time.perf_counter() - t0
            if cuda:
                _mark(CLOSE_MARK)
                torch.cuda.synchronize()
    if cuda:
        state["window"] = device_window(prof)
        if state["window"]["lost"]:
            log.warning("the profiler window lost a marker: its %.3fs "
                        "lead-in did not take the session's first lost "
                        "records, so the window has no device time",
                        state["lead_sec"])


def summarize(prof, window_sec: float,
              window: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Device time of a finished profile by short kernel name, and the
    share of the ``window_sec`` window the device spent idle (1 - summed
    kernel time over the window, clamped at 0: kernels on one stream do
    not overlap). ``window`` (:func:`device_window`) keeps only the
    device records between its markers; a window that lost a marker has
    no bounds, so its summary says ``window_lost`` and holds no kernels,
    ``device_ms`` or ``idle_share``."""
    import torch

    from predictionio_torch.tools import device_time

    window_ms = window_sec * 1e3
    out: Dict[str, Any] = {
        "window_ms": window_ms,
        "device": "cuda" if torch.cuda.is_available() else "cpu",
    }
    if window is not None:
        out["window"] = dict(window)
    if window is not None and window["lost"]:
        out.update({"window_lost": True, "device_ms": None,
                    "idle_share": None, "kernels": {}})
        return out
    kernels = device_time.device_split(prof, window=window)
    device_ms = sum(v["ms"] for v in kernels.values())
    out.update({
        "device_ms": device_ms,
        "idle_share": (max(0.0, 1.0 - device_ms / window_ms)
                       if window_ms > 0 else None),
        "kernels": kernels,
    })
    if out["device"] == "cpu":
        out["cpu_ops"] = device_time.cpu_split(prof)
    return out


def kernel_count(summary: Dict[str, Any], prefix: str) -> int:
    """Launches of the kernels whose short name starts with ``prefix``
    (``topk_dot`` -> ``topk_dot_kernel``)."""
    return sum(v["count"] for name, v in summary["kernels"].items()
               if name.startswith(prefix))


@contextlib.contextmanager
def trace_capture(out_dir: str):
    """``with trace_capture(dir) as result:`` — the block runs under
    ``torch.profiler`` (:func:`windowed_profile`: on a card, after the
    lead-in); on exit the Chrome trace is written to ``dir/trace.json``
    and ``result`` (a dict) gains ``artifact``, ``seconds``,
    ``lead_sec`` and ``summary``. Raises ProfilerBusy while another
    window is open."""
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already running")
    try:
        os.makedirs(out_dir, exist_ok=True)
        result: Dict[str, Any] = {}
        with windowed_profile() as w:
            _active.set()
            try:
                yield result
            finally:
                _active.clear()
        path = os.path.join(out_dir, "trace.json")
        w["prof"].export_chrome_trace(path)
        result.update({"artifact": path, "seconds": w["seconds"],
                       "lead_sec": w["lead_sec"],
                       "summary": summarize(w["prof"], w["seconds"],
                                            w["window"])})
        log.info("profiler capture of %.3fs written to %s", w["seconds"],
                 path)
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


def parse_capture(capture: Dict[str, Any]) -> Dict[str, Any]:
    """A finished :func:`trace_capture` result in the JAX parser's shape:
    ``device_time_sec`` and the top 8 ``by_category`` by time, each with
    its ``time_frac`` and ``launches``, plus ``launches`` of every
    category and ``device``. With no card the CPU operators' self time
    stands in (``device: "cpu"``), so the CPU runs the whole path."""
    summary = capture.get("summary")
    if not summary:
        return {"error": "the capture holds no summary"}
    if summary.get("window_lost"):
        return {"error": "the capture lost a window marker: no device "
                         "time"}
    device = summary.get("device", "cuda")
    split = (summary.get("cpu_ops") or {}) if device == "cpu" else (
        summary.get("kernels") or {})
    total_ms = sum(v["ms"] for v in split.values())
    cats = sorted(split.items(), key=lambda kv: -kv[1]["ms"])
    return {
        "device": device,
        "device_time_sec": round(total_ms / 1e3, 6),
        "by_category": {
            name: {"time_frac": round(v["ms"] / max(total_ms, 1e-12), 3),
                   "launches": int(v["count"])}
            for name, v in cats[:8]
        },
        "launches": {name: int(v["count"]) for name, v in cats},
    }


def per_step(parsed: Dict[str, Any], steps: int) -> Optional[Dict[str, Any]]:
    """Per-STEP device-time breakdown from an already-parsed capture that
    covered ``steps`` train steps: device ms/step overall and per
    category (JAX's ``per_step``, the same rounding). None when the
    capture carries no device time or ``steps`` is unknown (<= 0) — a
    whole-train total must never masquerade as a per-step number."""
    if not parsed.get("device_time_sec") or steps <= 0:
        return None
    dev = parsed["device_time_sec"]
    return {
        "steps": int(steps),
        "device_ms_per_step": round(dev / steps * 1e3, 4),
        "by_category_ms_per_step": {
            cat: round(v["time_frac"] * dev / steps * 1e3, 4)
            for cat, v in (parsed.get("by_category") or {}).items()
        },
    }


def step_breakdown(capture: Dict[str, Any], steps: int) -> Dict[str, Any]:
    """:func:`parse_capture` + :func:`per_step` over a finished capture;
    the parsed capture rides along under ``trace`` (JAX's
    ``step_breakdown``)."""
    parsed = parse_capture(capture)
    if "error" in parsed:
        return parsed
    out = per_step(parsed, steps)
    if out is None:
        return {"error": f"no per-step breakdown (steps={steps}, "
                         f"device_time_sec="
                         f"{parsed.get('device_time_sec')})",
                "trace": parsed}
    out["trace"] = parsed
    return out
