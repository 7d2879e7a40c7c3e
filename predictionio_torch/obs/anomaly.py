"""Regression sentinel: online change-point detection with attribution.

Copy of ``predictionio_tpu/obs/anomaly.py``. What follows is the JAX
module's account.

The timelines (obs/timeline.py) RECORD what every key series did; this
module INTERPRETS them: a p99 that doubled after a hot-swap, an MFU
sagging after a patch storm, a recall eroding fold by fold. Detection
is dependency-free and deterministic — given the same rings it always
reaches the same verdicts (no hidden clock reads in the math; the scan
instant is injectable):

  - the ring is split into a BASELINE window (the older half, at least
    ``min_samples`` points) and a SCAN region (the rest)
  - the baseline yields a rolling median ``m`` and a MAD-derived
    robust sigma (1.4826 * MAD — the normal-consistent scale)
  - level shift: the median of the last ``recent`` points vs ``m`` as
    a z-score — the step detector
  - slow drift: a one-sided CUSUM over the scan region's per-point
    z-scores (slack ``k``, threshold ``h``) — small persistent
    deviations accumulate where no single window trips the z test
  - a DEADBAND (relative to the baseline median, with an absolute
    floor) holds both detectors silent through noise: a 2% p99 wiggle
    is not an incident even when sigma is tiny
  - per-series DIRECTION config: a recall *drop* and a p99 *rise* both
    alarm; the improving direction never does

Every detected shift is joined against the ops journal
(obs/journal.py) within ``PIO_ANOMALY_WINDOW_SEC`` of its onset to
name the nearest plausible causal event — "serve_p99_ms +2.3σ
sustained, 4.1 s after reload → instance i-42 on r1" — which is the
whole point: five telemetry planes become answers. Scans ride the
flight-recorder snapshot cadence (obs/flight.py — no thread of our
own); state transitions are journaled (``anomaly`` /
``anomaly_resolved``) and exported as ``pio_anomaly_active{series}`` /
``pio_anomaly_events_total{series}``. Served at ``GET /admin/anomaly``
(+ the fleet merge), rendered by ``pio anomalies`` (exit 1 while any
anomaly is active) and the dashboard ``/anomaly`` panel.

Config (env, read per scan):
  PIO_ANOMALY_WINDOW_SEC   journal join window around an onset
                           (default 30)
  PIO_ANOMALY_Z            level-shift z threshold (default 3.0)
  PIO_ANOMALY_CUSUM        CUSUM trip threshold h (default 6.0)
  PIO_ANOMALY_MIN_SAMPLES  baseline points required (default 12)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_torch.obs import journal, metrics

DEFAULT_WINDOW_SEC = 30.0
DEFAULT_Z = 3.0
DEFAULT_CUSUM_H = 6.0
DEFAULT_MIN_SAMPLES = 12
#: points in the level-shift window (the "recent median")
DEFAULT_RECENT = 5
#: CUSUM slack: per-point z below this never accumulates
CUSUM_K = 0.5
#: per-point z-scores are clipped before the CUSUM so one wild outlier
#: cannot trip the drift detector by itself
Z_CLIP = 8.0
#: MAD floor as a fraction of the baseline median — a perfectly flat
#: baseline must not turn any wiggle into infinite sigmas
SIGMA_FLOOR_FRAC = 1e-3

_ACTIVE = metrics.gauge(
    "pio_anomaly_active",
    "1 while the regression sentinel holds this series anomalous",
    ("series",),
)

_EVENTS_TOTAL = metrics.counter(
    "pio_anomaly_events_total",
    "Anomaly activations detected per series (resolution not counted)",
    ("series",),
)

#: per-series-family detection config, keyed by the series name's
#: first dot-component (``serve_p99_ms.myengine`` -> ``serve_p99_ms``).
#: direction: which way the REGRESSION points; deadband: relative to
#: the baseline median; abs_deadband: absolute floor for near-zero
#: baselines. Families not listed use _DEFAULT_CFG.
SERIES_CONFIG: Dict[str, Dict[str, Any]] = {
    "serve_p99_ms": {"direction": "up", "deadband": 0.10,
                     "abs_deadband": 1.0},
    "serve_p50_ms": {"direction": "up", "deadband": 0.10,
                     "abs_deadband": 0.5},
    "http_rps": {"direction": "both", "deadband": 0.25,
                 "abs_deadband": 1.0},
    "mfu": {"direction": "down", "deadband": 0.10,
            "abs_deadband": 1e-6},
    "staleness_sec": {"direction": "up", "deadband": 0.25,
                      "abs_deadband": 5.0},
    "quality": {"direction": "down", "deadband": 0.05,
                "abs_deadband": 0.01},
    "quality.rmse_drift": {"direction": "up", "deadband": 0.10,
                           "abs_deadband": 0.01},
    "mem": {"direction": "down", "deadband": 0.15,
            "abs_deadband": 1.0},
    "prof": {"direction": "up", "deadband": 0.25,
             "abs_deadband": 0.005},
    "inflight": {"direction": "up", "deadband": 0.50,
                 "abs_deadband": 2.0},
    # the data plane (obs/dataobs.py): an eps collapse or surge both
    # matter; skew and unknown-ratio regress UPWARD only (a hot-key
    # storm, a model gone stale for live traffic)
    "data.eps": {"direction": "both", "deadband": 0.25,
                 "abs_deadband": 1.0},
    "data.skew": {"direction": "up", "deadband": 0.15,
                  "abs_deadband": 0.1},
    "data.unknown_ratio": {"direction": "up", "deadband": 0.10,
                           "abs_deadband": 0.02},
}

_DEFAULT_CFG: Dict[str, Any] = {"direction": "both", "deadband": 0.10,
                                "abs_deadband": 1e-9}


def series_config(name: str) -> Dict[str, Any]:
    """The family config for a series name: the longest configured
    dotted prefix wins (``quality.rmse_drift`` over ``quality``)."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        cfg = SERIES_CONFIG.get(".".join(parts[:i]))
        if cfg is not None:
            return cfg
    return _DEFAULT_CFG


def _median(values: List[float]) -> float:
    n = len(values)
    s = sorted(values)
    mid = n // 2
    if n % 2:
        return s[mid]
    return (s[mid - 1] + s[mid]) / 2.0


def detect(points: List[Tuple[float, float]],
           cfg: Optional[Dict[str, Any]] = None,
           z_threshold: Optional[float] = None,
           cusum_h: Optional[float] = None,
           min_samples: Optional[int] = None,
           recent: int = DEFAULT_RECENT) -> Optional[Dict[str, Any]]:
    """Run both detectors over one series' ring. ``points`` is the
    timeline shape: (ts, value) oldest first. Returns None (no
    anomaly) or a verdict dict — pure function of its inputs, the
    deterministic core the unit pins exercise."""
    cfg = cfg or _DEFAULT_CFG
    z_threshold = (metrics.env_float("PIO_ANOMALY_Z", DEFAULT_Z)
                   if z_threshold is None else z_threshold)
    cusum_h = (metrics.env_float("PIO_ANOMALY_CUSUM", DEFAULT_CUSUM_H)
               if cusum_h is None else cusum_h)
    min_samples = (metrics.env_int("PIO_ANOMALY_MIN_SAMPLES",
                                   DEFAULT_MIN_SAMPLES)
                   if min_samples is None else min_samples)
    n = len(points)
    baseline_n = max(min_samples, n // 2)
    if n - baseline_n < max(2, recent // 2) or baseline_n < min_samples:
        return None  # not enough history to split baseline vs scan
    values = [float(v) for _, v in points]
    base = values[:baseline_n]
    m = _median(base)
    mad = _median([abs(v - m) for v in base])
    sigma = max(1.4826 * mad, SIGMA_FLOOR_FRAC * abs(m), 1e-12)
    band = max(float(cfg.get("deadband", 0.10)) * abs(m),
               float(cfg.get("abs_deadband", 1e-9)))
    direction = cfg.get("direction", "both")

    # level shift: recent median vs baseline median
    recent_vals = values[-min(recent, n - baseline_n):]
    delta = _median(recent_vals) - m
    z = delta / sigma

    # slow drift: one-sided CUSUMs over the scan region
    s_hi = s_lo = 0.0
    cusum_hi = cusum_lo = 0.0
    for v in values[baseline_n:]:
        zi = max(-Z_CLIP, min(Z_CLIP, (v - m) / sigma))
        s_hi = max(0.0, s_hi + zi - CUSUM_K)
        s_lo = max(0.0, s_lo - zi - CUSUM_K)
        cusum_hi = max(cusum_hi, s_hi)
        cusum_lo = max(cusum_lo, s_lo)

    def tripped(side: str) -> Tuple[bool, str]:
        if side == "up":
            if delta <= band:
                return False, ""  # deadband holds (or wrong direction)
            if z >= z_threshold:
                return True, "step"
            if s_hi >= cusum_h:
                return True, "drift"
        else:
            if delta >= -band:
                return False, ""
            if z <= -z_threshold:
                return True, "step"
            if s_lo >= cusum_h:
                return True, "drift"
        return False, ""

    hit, mode = False, ""
    if direction in ("up", "both"):
        hit, mode = tripped("up")
    if not hit and direction in ("down", "both"):
        hit, mode = tripped("down")
    if not hit:
        return None

    # onset: the earliest point of the trailing run that is outside
    # the deadband in the anomalous direction — what the journal join
    # anchors on
    sign = 1.0 if delta > 0 else -1.0
    onset_ts = points[-1][0]
    for ts, v in reversed(points[baseline_n:]):
        if sign * (float(v) - m) > band:
            onset_ts = ts
        else:
            break
    return {
        "mode": mode,                      # step | drift
        "direction": "up" if delta > 0 else "down",
        "baseline": round(m, 6),
        "sigma": round(sigma, 6),
        "recent": round(m + delta, 6),
        "delta": round(delta, 6),
        "z": round(z, 2),
        "cusum": round(cusum_hi if delta > 0 else cusum_lo, 2),
        "onset_ts": onset_ts,
    }


def window_sec() -> float:
    return max(0.0, metrics.env_float("PIO_ANOMALY_WINDOW_SEC",
                                      DEFAULT_WINDOW_SEC))


def attribute(onset_ts: float,
              events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The nearest plausible causal journal event: within the window
    around ``onset_ts``, preferring the closest event at-or-before the
    onset (a cause precedes its effect; an event shortly AFTER the
    onset can still be the best name for it when sampling granularity
    blurs the order). The sentinel's own events never explain an
    anomaly."""
    window = window_sec()
    best: Optional[Dict[str, Any]] = None
    best_rank: Tuple[int, float] = (2, float("inf"))
    for event in events:
        if event.get("kind") in ("anomaly", "anomaly_resolved"):
            continue
        ts = event.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        gap = onset_ts - float(ts)
        if abs(gap) > window:
            continue
        rank = (0, gap) if gap >= 0 else (1, -gap)
        if rank < best_rank:
            best_rank = rank
            best = event
    if best is None:
        return None
    cause = {k: v for k, v in best.items() if k != "mono"}
    cause["gap_sec"] = round(onset_ts - float(best["ts"]), 3)
    return cause


class Sentinel:
    """Scans the timeline rings, holds per-series anomaly state."""

    #: recent resolved episodes kept for the /admin/anomaly payload
    HISTORY = 32

    def __init__(self):
        self._lock = threading.Lock()
        self._active: Dict[str, Dict[str, Any]] = {}
        self._history: List[Dict[str, Any]] = []
        self._last_scan_ms = 0.0

    def scan(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One detection pass over every timeline series; updates
        active state, gauges and the journal. Deterministic given the
        rings and ``now``."""
        from predictionio_torch.obs import timeline

        now = time.time() if now is None else now
        t0 = time.perf_counter()
        doc = timeline.TIMELINE.series()
        events = journal.JOURNAL.recent()
        verdicts: Dict[str, Dict[str, Any]] = {}
        for name, points in doc.get("series", {}).items():
            verdict = detect([(p[0], p[1]) for p in points],
                             cfg=series_config(name))
            if verdict is not None:
                verdicts[name] = verdict
        with self._lock:
            started = {k: v for k, v in verdicts.items()
                       if k not in self._active}
            resolved = {k: v for k, v in self._active.items()
                        if k not in verdicts}
            for name, verdict in verdicts.items():
                prior = self._active.get(name)
                if prior is not None:
                    # an ongoing anomaly keeps its first onset and
                    # attribution; only the live stats refresh
                    verdict["onset_ts"] = prior["onset_ts"]
                    verdict["since"] = prior["since"]
                    if "cause" in prior:
                        verdict["cause"] = prior["cause"]
                else:
                    verdict["since"] = now
                self._active[name] = verdict
            for name in resolved:
                del self._active[name]
        for name, verdict in started.items():
            cause = attribute(verdict["onset_ts"], events)
            if cause is not None:
                verdict["cause"] = cause
            _EVENTS_TOTAL.labels(name).inc()
            _ACTIVE.labels(name).set(1)
            journal.JOURNAL.emit(
                "anomaly", series=name, mode=verdict["mode"],
                direction=verdict["direction"], z=verdict["z"],
                baseline=verdict["baseline"], value=verdict["recent"],
                cause_kind=(verdict.get("cause") or {}).get("kind"))
        for name, verdict in resolved.items():
            _ACTIVE.labels(name).set(0)
            journal.JOURNAL.emit(
                "anomaly_resolved", series=name,
                duration_sec=round(now - verdict.get("since", now), 3))
            episode = dict(verdict)
            episode["series"] = name
            episode["resolved_ts"] = round(now, 3)
            episode["duration_sec"] = round(
                now - verdict.get("since", now), 3)
            with self._lock:
                self._history.append(episode)
                del self._history[:-self.HISTORY]
        elapsed_ms = round((time.perf_counter() - t0) * 1e3, 3)
        with self._lock:
            self._last_scan_ms = elapsed_ms
        return self.report()

    def report(self) -> Dict[str, Any]:
        """The ``GET /admin/anomaly`` payload."""
        with self._lock:
            active = {name: dict(v) for name, v in
                      sorted(self._active.items())}
            history = [dict(e) for e in self._history]
        return {
            "window_sec": window_sec(),
            "active": active,
            "recent_resolved": history,
            "scan_ms": self._last_scan_ms,
        }

    def any_active(self) -> bool:
        with self._lock:
            return bool(self._active)

    def reset(self) -> None:
        with self._lock:
            names = list(self._active)
            self._active.clear()
            self._history.clear()
            self._last_scan_ms = 0.0
        for name in names:
            _ACTIVE.labels(name).set(0)


#: the process-global sentinel every server serves at /admin/anomaly
SENTINEL = Sentinel()

# ride the flight recorder's snapshot cadence (after the timeline's own
# listener by registration order, so a scan sees the sample that woke
# it: importing the timeline here registers its listener first);
# /admin/anomaly reads also scan, so an idle server still verdicts
# while someone is watching
from predictionio_torch.obs import flight, timeline  # noqa: E402,F401 — cadence wiring

flight.add_snapshot_listener(lambda: SENTINEL.scan(), name="anomaly")
