"""Declarative SLOs with multi-window burn-rate alerting.

Copy of ``predictionio_tpu/obs/slo.py``: it reads the port's
``pio_serving_request_seconds`` and ``pio_http_requests_total``, which
carry the JAX names; every method that reads the clock takes ``now=``.

An SLO here is a statement like "99% of serving requests finish under
100 ms" or "99.9% of HTTP requests do not 5xx", evaluated against the
metrics the servers already record — the latency SLO reads the
``pio_serving_request_seconds`` histogram's buckets, the availability
SLO reads ``pio_http_requests_total`` by status. Nothing new is
measured; this module turns the existing counters into a paging signal.

Burn rate is the SRE-workbook quantity: (observed error rate) /
(error budget). Burn 1.0 spends the budget exactly at the objective's
pace; burn 14.4 exhausts a 30-day budget in ~2 days. Alerts use the
standard multi-window, multi-burn-rate rules so a blip does not page
but a real regression pages fast:

  fast page:  burn >= 14.4 over BOTH the last 5m and the last 1h
  slow page:  burn >= 6    over BOTH the last 30m and the last 6h

Windows are computed from periodic cumulative (good, total) snapshots.
The sampler rides the flight recorder's snapshot cadence (one hook —
obs/flight.py already wakes on that interval) and also samples on
every read, so an ``/admin/slo`` poll or ``pio slo`` call is always
current. Tests feed synthetic samples directly via ``record()``.

Surfaces: ``GET /admin/slo`` on every server (serving/http.py),
``pio slo`` in the CLI, and the dashboard's ``/slo`` panel.

Alert DELIVERY: ``add_alert_listener`` registers a callback invoked on
every alert transition (ok -> firing, firing -> resolved) during
evaluation — the resilience webhook sink (resilience/alerts.py)
subscribes here, and the engine server's admission controller reads
the resulting ``pio_slo_burn_rate`` gauge.

Declarative objectives: operators page on THEIR objectives, not the
defaults — :func:`configure` applies an ``slo`` block (an engine.json
top-level ``"slo"`` object, or a standalone JSON file named by
``PIO_SLO_FILE``, loaded at server start):

    {"latency_ms": 50, "latency_objective": 0.999,
     "availability_objective": 0.995,
     "shed": {"queue_depth": 128, "inflight": 64, "burn": 10.0}}

(the ``shed`` block is consumed by the engine server's admission
controller; this module applies the objective keys.)

Config (all env):
  PIO_SLO_LATENCY_MS              latency threshold (default 100)
  PIO_SLO_LATENCY_OBJECTIVE       fraction under threshold (default 0.99)
  PIO_SLO_AVAILABILITY_OBJECTIVE  fraction non-5xx (default 0.999)
  PIO_SLO_FILE                    JSON file with the block above
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_torch.obs import flight, metrics

#: (window_seconds pairs, burn threshold) — the SRE-workbook defaults
FAST_WINDOWS = (300.0, 3600.0)
FAST_BURN = 14.4
SLOW_WINDOWS = (1800.0, 21600.0)
SLOW_BURN = 6.0

#: snapshots kept: 6h of 60s cadence plus generous slack
SAMPLE_CAPACITY = 512

#: minimum spacing between samples — the nominal cadence. On-read
#: ticks (every /admin/slo or dashboard poll) are no-ops inside this
#: window; otherwise a 1s-autorefresh dashboard would churn the
#: 512-sample ring in minutes and silently shrink the 6h slow window
#: to however far back the flood reaches.
MIN_SAMPLE_SPACING_SEC = 60.0

_BURN_GAUGE = metrics.gauge(
    "pio_slo_burn_rate",
    "Latest burn rate per SLO and evaluation window",
    ("slo", "window"),
)
_ALERT_GAUGE = metrics.gauge(
    "pio_slo_alert_firing",
    "Whether an SLO's multi-window burn-rate alert is firing (1) or "
    "not (0)",
    ("slo",),
)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One objective over an existing metric family.

    kind "latency": ``metric`` is a histogram; good = observations in
    buckets whose upper bound is <= ``threshold_ms`` (the tightest
    bucket boundary at or above the threshold — bucket math, so this
    agrees with any PromQL evaluation of the same rule).

    kind "availability": ``metric`` is a counter labeled with
    ``status``; good = series whose status parses below 500.
    """

    name: str
    kind: str                      # "latency" | "availability"
    metric: str
    objective: float
    threshold_ms: Optional[float] = None
    #: optional counter whose cumulative value ADDS to the good count
    #: (clamped at total). The serving-latency SLO points this at
    #: ``pio_router_hedge_rescues_total``: a request the router's hedge
    #: saved answers the client in time even though the slow primary
    #: attempt eventually records an over-threshold observation — that
    #: observation must not burn latency budget (ROADMAP item B).
    good_credit_metric: Optional[str] = None

    def budget(self) -> float:
        return max(1e-9, 1.0 - self.objective)

    # -- cumulative (good, total) from the live registry -------------------
    def measure(self) -> Tuple[float, float]:
        family = metrics.REGISTRY.get(self.metric)
        if family is None:
            return 0.0, 0.0
        if self.kind == "latency":
            return self._measure_latency(family)
        return self._measure_availability(family)

    def _measure_latency(self, family) -> Tuple[float, float]:
        threshold = (self.threshold_ms or 0.0) / 1e3
        good = total = 0.0
        for _values, child in family.children():
            for bound, running in child.cumulative():
                if bound >= threshold or bound == math.inf:
                    good += running
                    break
            total += child.count
        if self.good_credit_metric:
            credit_family = metrics.REGISTRY.get(self.good_credit_metric)
            if credit_family is not None:
                credit = sum(child.value
                             for _v, child in credit_family.children())
                # cumulative counter + cumulative good: window deltas in
                # burn_rate subtract cleanly, so each rescued request
                # credits exactly one good observation
                good = min(total, good + credit)
        return good, total

    def _measure_availability(self, family) -> Tuple[float, float]:
        try:
            idx = family.labelnames.index("status")
        except ValueError:
            return 0.0, 0.0
        good = total = 0.0
        for values, child in family.children():
            v = child.value
            total += v
            try:
                status = int(values[idx])
            except (ValueError, IndexError):
                status = 0
            if status < 500:
                good += v
        return good, total


def default_slos() -> List[SLO]:
    return slos_from_config({})


def slos_from_config(config: Dict[str, Any]) -> List[SLO]:
    """The two framework SLOs, with a declarative block's overrides
    applied over the env defaults."""
    return [
        SLO(
            name="serving-latency",
            kind="latency",
            metric="pio_serving_request_seconds",
            objective=float(config.get(
                "latency_objective",
                metrics.env_float("PIO_SLO_LATENCY_OBJECTIVE", 0.99))),
            threshold_ms=float(config.get(
                "latency_ms",
                metrics.env_float("PIO_SLO_LATENCY_MS", 100.0))),
            # hedge-saved requests answered the client in time: their
            # slow primary attempt's histogram observation must not
            # read as a latency SLO miss (router wires the counter)
            good_credit_metric="pio_router_hedge_rescues_total",
        ),
        SLO(
            name="http-availability",
            kind="availability",
            metric="pio_http_requests_total",
            objective=float(config.get(
                "availability_objective",
                metrics.env_float("PIO_SLO_AVAILABILITY_OBJECTIVE", 0.999))),
        ),
    ]


# -- alert transition listeners ------------------------------------------------

_alert_listeners: List[Any] = []
_alert_listeners_lock = threading.Lock()


def add_alert_listener(fn) -> None:
    """Register ``fn(slo_name, firing, entry_dict)`` to run on every
    alert transition any monitor evaluates (the delivery seam the
    webhook sink plugs into)."""
    with _alert_listeners_lock:
        if fn not in _alert_listeners:
            _alert_listeners.append(fn)


def remove_alert_listener(fn) -> None:
    with _alert_listeners_lock:
        if fn in _alert_listeners:
            _alert_listeners.remove(fn)


def _notify_alert(name: str, firing: bool, entry: Dict[str, Any]) -> None:
    with _alert_listeners_lock:
        listeners = list(_alert_listeners)
    for fn in listeners:
        try:
            fn(name, firing, entry)
        except Exception:  # noqa: BLE001 — a broken sink must not break evaluation
            import logging

            logging.getLogger(__name__).exception(
                "SLO alert listener failed for %s", name)


def burn_rate(samples: List[Tuple[float, float, float]],
              now: float, window: float, budget: float) -> Optional[float]:
    """Burn over the trailing ``window`` from cumulative samples
    ``(ts, good, total)``: error fraction of the requests that arrived
    in the window, divided by the error budget. None when the window
    has no two samples or saw no traffic — "no data" must stay
    distinguishable from "burning at 0"."""
    if not samples:
        return None
    start = now - window
    # the baseline is the newest sample at or before the window start
    # (falling back to the oldest available — a partially covered
    # window still evaluates, it just spans less history)
    baseline = samples[0]
    for s in samples:
        if s[0] <= start:
            baseline = s
        else:
            break
    latest = samples[-1]
    if latest[0] <= baseline[0]:
        return None
    d_total = latest[2] - baseline[2]
    d_good = latest[1] - baseline[1]
    if d_total <= 0:
        return None
    error_rate = min(1.0, max(0.0, (d_total - d_good) / d_total))
    return error_rate / budget


class SLOMonitor:
    """Cumulative snapshot series per SLO + the multi-window evaluation."""

    def __init__(self, slos: Optional[List[SLO]] = None):
        self._lock = threading.Lock()
        # serializes transition detection + listener notification so
        # concurrent evaluations (snapshot cadence vs /admin/slo reads)
        # can never deliver firing/resolved to a sink out of order
        self._transition_lock = threading.Lock()
        self._slos: Dict[str, SLO] = {}
        self._samples: Dict[str, "collections.deque"] = {}
        self._firing: Dict[str, bool] = {}
        self._last_tick = 0.0
        for slo in (slos if slos is not None else default_slos()):
            self.add(slo)

    def add(self, slo: SLO) -> None:
        with self._lock:
            prior = self._slos.get(slo.name)
            self._slos[slo.name] = slo
            series = self._samples.setdefault(
                slo.name, collections.deque(maxlen=SAMPLE_CAPACITY))
            if prior is not None and prior != slo:
                # a changed objective invalidates the old samples' good
                # counts (good is threshold-dependent for latency SLOs)
                series.clear()

    def replace(self, slos: List[SLO]) -> None:
        """Swap the monitored SLO set (declarative reconfiguration);
        series for unchanged SLOs are kept."""
        with self._lock:
            keep = {s.name for s in slos}
            for name in list(self._slos):
                if name not in keep:
                    del self._slos[name]
                    self._samples.pop(name, None)
                    self._firing.pop(name, None)
        for slo in slos:
            self.add(slo)

    def slos(self) -> List[SLO]:
        with self._lock:
            return list(self._slos.values())

    def record(self, name: str, ts: float, good: float, total: float) -> None:
        """Append one cumulative sample (tests feed synthetic series
        here; live sampling goes through ``tick``)."""
        with self._lock:
            series = self._samples.setdefault(
                name, collections.deque(maxlen=SAMPLE_CAPACITY))
            series.append((float(ts), float(good), float(total)))

    def tick(self, now: Optional[float] = None) -> None:
        """Sample every SLO's (good, total) from the live registry.
        Rate-limited so the cadence hook and on-read ticks coexist."""
        now = time.time() if now is None else now
        with self._lock:
            if now - self._last_tick < MIN_SAMPLE_SPACING_SEC:  # graftlint: disable=JT15 — the spacing check must read the SAME injectable clock the burn-window samples are stamped with (tests drive synthetic now); a second monotonic clock would let cadence and series disagree
                return
            self._last_tick = now
            slos = list(self._slos.values())
        for slo in slos:
            good, total = slo.measure()
            self.record(slo.name, now, good, total)

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The full evaluation served by /admin/slo: per SLO, the burn
        rate in each window, which alert pair is firing, and the state
        ("firing" / "ok" / "no_data")."""
        now = time.time() if now is None else now
        out: List[Dict[str, Any]] = []
        for slo in self.slos():
            with self._lock:
                samples = list(self._samples.get(slo.name, ()))
            budget = slo.budget()
            windows: Dict[str, Optional[float]] = {}
            for seconds in sorted(set(FAST_WINDOWS + SLOW_WINDOWS)):
                label = _window_label(seconds)
                burn = burn_rate(samples, now, seconds, budget)
                windows[label] = None if burn is None else round(burn, 3)
                _BURN_GAUGE.labels(slo.name, label).set(
                    0.0 if burn is None else burn)
            fast = _pair_firing(windows, FAST_WINDOWS, FAST_BURN)
            slow = _pair_firing(windows, SLOW_WINDOWS, SLOW_BURN)
            firing = bool(fast or slow)
            has_data = any(v is not None for v in windows.values())
            state = "firing" if firing else ("ok" if has_data else "no_data")
            _ALERT_GAUGE.labels(slo.name).set(1.0 if firing else 0.0)
            entry: Dict[str, Any] = {
                "name": slo.name,
                "kind": slo.kind,
                "metric": slo.metric,
                "objective": slo.objective,
                "burn_rates": windows,
                "alerts": {
                    "fast": {"windows": [_window_label(w)
                                         for w in FAST_WINDOWS],
                             "threshold": FAST_BURN, "firing": fast},
                    "slow": {"windows": [_window_label(w)
                                         for w in SLOW_WINDOWS],
                             "threshold": SLOW_BURN, "firing": slow},
                },
                "state": state,
            }
            if slo.threshold_ms is not None:
                entry["threshold_ms"] = slo.threshold_ms
            out.append(entry)
            # transition detection: notify listeners on ok->firing and
            # firing->resolved edges only (no_data never resolves a
            # page). The compare-set-notify triple is atomic under the
            # transition lock: two racing evaluations with opposite
            # verdicts still deliver a sequence consistent with the
            # recorded state, never resolved-before-firing.
            with self._transition_lock:
                with self._lock:
                    was = self._firing.get(slo.name, False)
                    if state != "no_data":
                        self._firing[slo.name] = firing
                if state != "no_data" and firing != was:
                    _notify_alert(slo.name, firing, entry)
        return {"generated_unix": round(now, 3), "slos": out}

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        """tick + evaluate: the read path ``/admin/slo`` serves."""
        self.tick(now)
        return self.evaluate(now)

    def clear(self) -> None:
        with self._lock:
            for series in self._samples.values():
                series.clear()
            self._firing.clear()
            self._last_tick = 0.0


def _window_label(seconds: float) -> str:
    if seconds < 3600:
        return f"{int(seconds // 60)}m"
    return f"{int(seconds // 3600)}h"


def _pair_firing(windows: Dict[str, Optional[float]],
                 pair: Tuple[float, float], threshold: float) -> bool:
    values = [windows.get(_window_label(w)) for w in pair]
    return all(v is not None and v >= threshold for v in values)


#: the process-global monitor every server's /admin/slo reads
MONITOR = SLOMonitor()


def configure(config: Dict[str, Any]) -> None:
    """Apply a declarative SLO block (see module docstring) to the
    process-global monitor. The ``shed`` sub-block is NOT consumed
    here — the engine server's admission controller reads it."""
    MONITOR.replace(slos_from_config(config or {}))


_file_config: Optional[Dict[str, Any]] = None
_file_config_path: Optional[str] = None
_file_lock = threading.Lock()


def configure_from_env() -> Optional[Dict[str, Any]]:
    """Load ``PIO_SLO_FILE`` (once per path) into the global monitor
    and return the parsed block — callers that own shedding thresholds
    (the engine server) read the ``shed`` key off the result. Called
    by every server's ``start()``; a malformed file fails LOUDLY (a
    silently ignored objectives file means paging on the wrong
    numbers)."""
    import json as _json
    import os as _os

    global _file_config, _file_config_path
    path = _os.environ.get("PIO_SLO_FILE")
    if not path:
        return None
    with _file_lock:
        if path == _file_config_path:
            return _file_config
        with open(path) as f:  # graftlint: disable=JT21 — once-per-path cold config load: the lock makes read+configure+cache one transaction so racing starters cannot half-apply; never on a request path
            config = _json.load(f)
        if not isinstance(config, dict):
            raise ValueError(f"PIO_SLO_FILE {path}: expected a JSON object")
        configure(config)
        _file_config, _file_config_path = config, path
        return config

# ride the flight recorder's snapshot cadence: one sample per interval
# while traffic flows, without a thread of our own. EVALUATE on the
# same cadence — evaluation is what refreshes the burn-rate gauges
# (the admission controller's shed signal) and fires alert transitions
# (the webhook sink); sampling alone would leave both dead on an
# unattended server until someone happened to poll /admin/slo.
flight.add_snapshot_listener(
    lambda: (MONITOR.tick(), MONITOR.evaluate()), name="slo")


def _journal_alert(name: str, firing: bool, entry: Dict[str, Any]) -> None:
    """Alert fire/resolve edges land in the ops journal: a burn-rate
    page is an operational state change the anomaly sentinel and
    ``pio journal`` should be able to line up against reloads and
    breaker flips."""
    from predictionio_torch.obs import journal

    journal.emit("slo_alert", slo=name, firing=firing,
                 state=entry.get("state"),
                 burn_rates=entry.get("burn_rates"))


add_alert_listener(_journal_alert)
