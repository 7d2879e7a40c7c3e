"""Flight recorder: the black box for the serving/training path.

Copy of ``predictionio_tpu/obs/flight.py``, with one addition: a
:class:`FlightRecorder` reads its clocks from ``clock=`` (any object
with ``time()``, ``perf_counter()`` and ``monotonic()``; the ``time``
module by default, which is what the JAX copy reads), so a test can
drive it through an injected clock. What follows is the JAX module's
account.

Aggregate telemetry (obs/metrics.py) answers "how is the fleet doing";
it cannot answer "what exactly happened to THAT request". This module
keeps the evidence an operator needs for the post-hoc question without
reproducing anything:

  - a bounded ring buffer of COMPLETED request records — server, method,
    route, status, trace id, total duration, per-stage timings (parse /
    queue / batch / dispatch / device / serialize, plus the
    unattributed remainder so stages always sum to the total) and the
    request's own span tree (collected via a trace-sink, O(1) per span,
    never a ring scan on the hot path)
  - periodic metric snapshots (a compact registry summary every
    ``SNAPSHOT_INTERVAL_SEC``), so a dump carries the aggregate context
    the individual records sat in
  - a slow-request log: any request slower than ``PIO_SLOW_MS`` is
    flagged in its record AND emitted through the ``pio.slow`` logger
    with the full stage breakdown (JSON-parseable under
    obs/logging.py's formatter)
  - error capture: a handler that raises or answers >= 500 produces a
    record carrying the error, and — when ``PIO_FLIGHT_DIR`` is set —
    an automatic JSON dump file, no operator action required

The whole dump is served as JSON by ``GET /admin/flight`` on every PIO
server (serving/http.py routes it, like ``/metrics``) and by
``pio flight --url ...``.

Beyond the per-request records, the recorder optionally captures the
QUERY PAYLOADS themselves (``PIO_FLIGHT_PAYLOADS`` > 0): a bounded ring
of the last N ``/queries.json`` bodies (each capped at
``PIO_FLIGHT_PAYLOAD_BYTES``), the raw material the replay harness
(workflow/replay.py) re-plays against a candidate instance. Payloads
are user data — ``GET /admin/flight`` serves them ONLY when an admin
token is configured and presented; with no token set the dump carries
the capture counts but never the bodies.

Config (all env):
  PIO_FLIGHT_CAPACITY        ring size (default 256 records)
  PIO_SLOW_MS                slow-request threshold in ms (default 1000;
                             0 flags everything — useful in tests)
  PIO_FLIGHT_DIR             directory for automatic error dumps (unset
                             = ring-only, no files)
  PIO_FLIGHT_MAX_DUMPS       dump files kept in PIO_FLIGHT_DIR (default
                             64; oldest evicted first)
  PIO_FLIGHT_MAX_DUMP_BYTES  total bytes of dump files kept (default
                             64 MiB; oldest evicted first)
  PIO_FLIGHT_PAYLOADS        query payloads captured for replay
                             (default 0 = capture off)
  PIO_FLIGHT_PAYLOAD_BYTES   per-payload size cap (default 4096;
                             oversized payloads are skipped, counted)
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from predictionio_torch.obs import metrics, trace

log = logging.getLogger(__name__)

#: the slow-request log: one record per over-threshold request, carrying
#: the stage breakdown; under obs/logging.py JSON output each line is a
#: parseable object with the request's trace id
slow_log = logging.getLogger("pio.slow")

DEFAULT_CAPACITY = 256
DEFAULT_SLOW_MS = 1000.0
SNAPSHOT_INTERVAL_SEC = 60.0
#: snapshots kept alongside the record ring
SNAPSHOT_CAPACITY = 32
#: per-request span cap: a runaway span loop must not balloon one record
MAX_SPANS_PER_RECORD = 128

_RECORDS_TOTAL = metrics.counter(
    "pio_flight_records_total",
    "Requests recorded by the flight recorder, by outcome "
    "(ok / slow / error)",
    ("outcome",),
)

_DUMPS_EVICTED_TOTAL = metrics.counter(
    "pio_flight_dumps_evicted_total",
    "PIO_FLIGHT_DIR dump files evicted (oldest first) to stay under "
    "the count/byte caps",
)

_NEGATIVE_REMAINDER_TOTAL = metrics.counter(
    "pio_flight_negative_remainder_total",
    "Requests whose attributed stage time exceeded the measured total "
    "(clock skew, overlapping stage notes): the unattributed remainder "
    "was clamped to 0 so tail attribution never sees a negative share",
)

#: attributed-over-total slack before a clamp counts as a negative
#: remainder: per-stage ms are rounded to 3 decimals, so honest sums
#: can overshoot the total by fractions of a microsecond
_NEGATIVE_REMAINDER_TOLERANCE_MS = 0.01

DEFAULT_MAX_DUMPS = 64
DEFAULT_MAX_DUMP_BYTES = 64 * 1024 * 1024

DEFAULT_PAYLOAD_BYTES = 4096

_PAYLOADS_SKIPPED = metrics.counter(
    "pio_flight_payloads_skipped_total",
    "Query payloads not captured because they exceeded "
    "PIO_FLIGHT_PAYLOAD_BYTES",
)

_LISTENER_ERRORS_TOTAL = metrics.counter(
    "pio_snapshot_listener_errors_total",
    "Snapshot-cadence listener failures, by listener name — a nonzero "
    "rate means one periodic consumer (SLO sampler, timeline, anomaly "
    "sentinel) is broken while the others keep riding the cadence",
    ("listener",),
)


def payload_capacity() -> int:
    """The PIO_FLIGHT_PAYLOADS capture size (0 = off; read per call so
    env changes and test monkeypatching take effect immediately)."""
    return max(0, metrics.env_int("PIO_FLIGHT_PAYLOADS", 0))


def _enforce_dump_caps(out_dir: str) -> None:
    """Bound PIO_FLIGHT_DIR: keep at most PIO_FLIGHT_MAX_DUMPS files
    and PIO_FLIGHT_MAX_DUMP_BYTES total, evicting oldest-first (by
    mtime) — a long-lived erroring server must not fill the disk with
    post-mortems of the same failure."""
    max_dumps = max(1, metrics.env_int("PIO_FLIGHT_MAX_DUMPS",
                                       DEFAULT_MAX_DUMPS))
    max_bytes = max(0, metrics.env_int("PIO_FLIGHT_MAX_DUMP_BYTES",
                                       DEFAULT_MAX_DUMP_BYTES))
    try:
        entries = []
        with os.scandir(out_dir) as it:
            for entry in it:
                if not entry.name.endswith(".json"):
                    continue
                st = entry.stat()
                entries.append((st.st_mtime, st.st_size, entry.path))
    except OSError as e:
        log.warning("flight dump cap scan of %s failed: %s", out_dir, e)
        return
    entries.sort()  # oldest first
    total = sum(size for _, size, _ in entries)
    evict = []
    # the newest dump (the one just written) always survives — an
    # over-cap single file still beats losing the only post-mortem
    while len(entries) > 1 and (len(entries) > max_dumps
                                or (max_bytes and total > max_bytes)):
        mtime, size, path = entries.pop(0)
        total -= size
        evict.append(path)
    for path in evict:
        try:
            os.remove(path)
            _DUMPS_EVICTED_TOTAL.inc()
        except OSError as e:
            log.warning("flight dump eviction of %s failed: %s", path, e)


def write_dump_file(prefix: str, payload: Dict[str, Any]) -> Optional[str]:
    """Write one JSON diagnostic dump into PIO_FLIGHT_DIR (error dumps,
    watchdog stack dumps) and enforce the directory caps. Returns the
    path, or None when PIO_FLIGHT_DIR is unset or the write failed —
    never raises, diagnostics must not take down the diagnosed."""
    out_dir = os.environ.get("PIO_FLIGHT_DIR")
    if not out_dir:
        return None
    name = "{}-{}.json".format(prefix, int(time.time() * 1e3))
    path = os.path.join(out_dir, name)
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, sort_keys=True)
    except OSError as e:
        log.warning("flight dump to %s failed: %s", path, e)
        return None
    _enforce_dump_caps(out_dir)
    return path


def slow_threshold_ms() -> float:
    """The PIO_SLOW_MS threshold (read per request: env changes and
    test monkeypatching take effect immediately)."""
    raw = os.environ.get("PIO_SLOW_MS")
    if raw is None:
        return DEFAULT_SLOW_MS
    try:
        return float(raw)
    except ValueError:
        return DEFAULT_SLOW_MS


def _metrics_snapshot() -> Dict[str, Any]:
    """A compact registry summary: per family, the summed child values
    (counter/gauge) or total (count, sum) (histogram) — enough to see
    rates and load around a record without the full exposition."""
    out: Dict[str, Any] = {}
    for family in metrics.REGISTRY.collect():
        children = [c for _, c in family.children()]
        if not children:
            continue
        if family.kind == "histogram":
            count = total = 0
            for c in children:
                n, s = c.snapshot()
                count += n
                total += s
            out[family.name] = {"count": count, "sum": round(total, 6)}
        else:
            out[family.name] = round(sum(c.value for c in children), 6)
    return out


class FlightRecorder:
    """Bounded ring of completed request records + metric snapshots.

    ``begin`` opens a record for an in-flight request (keyed by a unique
    integer, NOT the trace id — nested servers in one process can serve
    the same propagated trace concurrently); stage timings and fields
    attach by trace id to the OLDEST open record with that id (the edge
    request that owns the latency budget); ``finish`` seals the record
    into the ring."""

    def __init__(self, capacity: Optional[int] = None,
                 snapshot_interval: float = SNAPSHOT_INTERVAL_SEC,
                 clock: Any = time):
        self._clock = clock
        if capacity is None:
            try:
                capacity = int(os.environ.get("PIO_FLIGHT_CAPACITY",
                                              DEFAULT_CAPACITY))
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=self.capacity)
        self._snapshots: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=SNAPSHOT_CAPACITY))
        self._snapshot_interval = snapshot_interval
        self._last_snapshot = 0.0   # monotonic: a cadence, not a timestamp
        #: captured query payloads for the replay harness (opt-in via
        #: PIO_FLIGHT_PAYLOADS; the deque is re-bounded on capacity
        #: changes at capture time)
        self._payloads: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=1))
        self._keys = itertools.count(1)
        # open records, insertion-ordered (dict preserves order): the
        # oldest open record for a trace id is the edge request
        self._open: Dict[int, Dict[str, Any]] = {}

    # -- request lifecycle --------------------------------------------------
    def begin(self, trace_id: str, server: str, method: str,
              route: str) -> int:
        record = {
            "trace": trace_id,
            "server": server,
            "method": method,
            "route": route,
            "start_unix": round(self._clock.time(), 6),
            "stages": {},
            "spans": [],
            "_t0": self._clock.perf_counter(),
        }
        with self._lock:
            key = next(self._keys)
            self._open[key] = record
        return key

    def _find_open(self, trace_id: Optional[str]) -> Optional[Dict[str, Any]]:
        if trace_id is None:
            ctx = trace.current_context()
            trace_id = ctx.trace_id if ctx else None
        if trace_id is None:
            return None
        for record in self._open.values():  # oldest first
            if record["trace"] == trace_id:
                return record
        return None

    def note_stage(self, stage: str, seconds: float,
                   trace_id: Optional[str] = None) -> None:
        """Attribute ``seconds`` of the request to ``stage`` (additive:
        repeated notes accumulate). No open record -> silent no-op, so
        instrumented paths need no "is the recorder watching" guards."""
        with self._lock:
            record = self._find_open(trace_id)
            if record is None:
                return
            stages = record["stages"]
            stages[stage] = round(stages.get(stage, 0.0) + seconds * 1e3, 3)

    def note_field(self, name: str, value: Any,
                   trace_id: Optional[str] = None) -> None:
        """Attach one JSON-serializable field to the open record."""
        with self._lock:
            record = self._find_open(trace_id)
            if record is not None and not name.startswith("_"):
                record[name] = value

    def on_span(self, span_record: Dict[str, Any]) -> None:
        """trace-sink: route an emitted span into the open record that
        owns its trace (bounded per record)."""
        with self._lock:
            record = self._find_open(span_record.get("trace"))
            if record is not None and len(record["spans"]) < (
                    MAX_SPANS_PER_RECORD):
                record["spans"].append(span_record)

    def finish(self, key: int, status: Optional[int],
               error: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Seal an open record: compute the total + unattributed stage,
        flag slow/error outcomes, snapshot metrics on the interval, and
        append to the ring. Returns the sealed record."""
        with self._lock:
            record = self._open.pop(key, None)
        if record is None:
            return None
        total_ms = (self._clock.perf_counter() - record.pop("_t0")) * 1e3
        record["duration_ms"] = round(total_ms, 3)
        record["status"] = status
        stages = record["stages"]
        attributed = sum(stages.values())
        # the remainder (header parse, thread scheduling, GIL waits)
        # keeps sum(stages) == duration_ms by construction, so a stage
        # breakdown can always be read as a complete account; a NEGATIVE
        # remainder (attributed stages overlapped, or their clocks
        # skewed past the wall total) clamps to 0 and is counted — tail
        # attribution must never report a negative stage share
        remainder = total_ms - attributed
        if remainder < -_NEGATIVE_REMAINDER_TOLERANCE_MS:
            _NEGATIVE_REMAINDER_TOTAL.inc()
        stages["unattributed"] = round(max(0.0, remainder), 3)
        # precedence: an exception that escaped the handler, then an
        # error the handler noted itself (the engine server's answered
        # 500 path), then the bare status
        error = error or record.get("error")
        if error is None and status is not None and status >= 500:
            error = f"handler answered {status}"
        if error is not None:
            record["error"] = error
        slow = total_ms >= slow_threshold_ms()
        if slow:
            record["slow"] = True
        outcome = "error" if error is not None else (
            "slow" if slow else "ok")
        _RECORDS_TOTAL.labels(outcome).inc()
        # the cadence is a DURATION between snapshots: measured on the
        # monotonic clock (JT15) — an NTP step must not stall or storm
        # the snapshot (and every listener riding it); the snapshot's
        # own ts stays wall time, it is a record, not a measurement
        now_mono = self._clock.monotonic()
        snap = None
        with self._lock:
            if now_mono - self._last_snapshot >= self._snapshot_interval:
                self._last_snapshot = now_mono
                snap = {"ts": round(self._clock.time(), 3)}
            self._ring.append(record)
        if snap is not None:
            # registry walk outside the ring lock (it takes family locks)
            snap["metrics"] = _metrics_snapshot()
            with self._lock:
                self._snapshots.append(snap)
            # periodic consumers (the SLO monitor's sampler, the
            # timeline, the anomaly sentinel) ride the same cadence
            # instead of running threads of their own; each is isolated
            # AND counted — one broken listener must neither starve the
            # others nor fail silently forever (the JT09 stance: a
            # periodic consumer that stops producing needs a symptom)
            for name, fn in list(_snapshot_listeners):
                try:
                    fn()
                except Exception:  # noqa: BLE001 — cadence must survive
                    _LISTENER_ERRORS_TOTAL.labels(name).inc()
                    log.exception("flight snapshot listener %r (%s) "
                                  "failed", fn, name)
        if slow:
            slow_log.warning(
                "slow request: %s %s %.1f ms (threshold %.1f ms)",
                record["method"], record["route"], total_ms,
                slow_threshold_ms(),
                extra={"pio": {k: v for k, v in record.items()
                               if k != "spans"}},
            )
        if error is not None:
            self._dump_on_error(record)
        return record

    # -- query-payload capture (replay's raw material) ----------------------
    def record_payload(self, route: str, payload: Any,
                       nbytes: Optional[int] = None) -> bool:
        """Capture one query payload for later replay (no-op while
        PIO_FLIGHT_PAYLOADS is 0). ``nbytes`` is the serialized size
        the caller already knows (the request body length) — payloads
        over PIO_FLIGHT_PAYLOAD_BYTES are skipped and counted, so one
        megabyte query cannot crowd out the ring or bloat the dump."""
        cap = payload_capacity()
        if cap <= 0:
            return False
        limit = max(1, metrics.env_int("PIO_FLIGHT_PAYLOAD_BYTES",
                                       DEFAULT_PAYLOAD_BYTES))
        if nbytes is None:
            try:
                nbytes = len(json.dumps(payload))
            except (TypeError, ValueError):
                return False
        if nbytes > limit:
            _PAYLOADS_SKIPPED.inc()
            return False
        entry = {"ts": round(self._clock.time(), 3), "route": route,
                 "payload": payload}
        with self._lock:
            ring = self._payloads
            if ring.maxlen != cap:
                ring = collections.deque(ring, maxlen=cap)
                self._payloads = ring
            ring.append(entry)
        return True

    def payloads(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The captured query payloads, oldest first (``n`` newest when
        given)."""
        with self._lock:
            out = list(self._payloads)
        if n is None:
            return out
        return out[-n:] if n > 0 else []

    # -- reading ------------------------------------------------------------
    def records(self, n: Optional[int] = None,
                slow_only: bool = False) -> List[Dict[str, Any]]:
        """The last ``n`` sealed records (all when None), oldest
        first. ``n <= 0`` is an explicit "none" — Python's ``[-0:]``
        would silently mean "all"."""
        with self._lock:
            out = list(self._ring)
        if slow_only:
            out = [r for r in out if r.get("slow") or r.get("error")]
        if n is None:
            return out
        return out[-n:] if n > 0 else []

    def snapshots(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._snapshots)

    def dump(self, n: Optional[int] = None, slow_only: bool = False,
             include_payloads: bool = False) -> Dict[str, Any]:
        """The full flight dump (what ``GET /admin/flight`` serves).

        Captured query payloads are USER DATA: they ride along only
        when the caller says so (the admin route includes them exactly
        when a bearer token is configured AND was presented); otherwise
        the dump carries the capture counts, never the bodies."""
        captured = self.payloads()
        out = {
            "capacity": self.capacity,
            "slow_threshold_ms": slow_threshold_ms(),
            "records": self.records(n, slow_only=slow_only),
            "metric_snapshots": self.snapshots(),
            "payload_capture": {
                "capacity": payload_capacity(),
                "captured": len(captured),
                "included": bool(include_payloads),
            },
        }
        if include_payloads:
            out["payloads"] = captured
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._snapshots.clear()
            self._open.clear()
            self._payloads.clear()

    # -- error dumps --------------------------------------------------------
    def _dump_on_error(self, record: Dict[str, Any]) -> None:
        """Automatic dump on a handler error: the record is already in
        the ring (visible at /admin/flight with no operator action);
        with PIO_FLIGHT_DIR set, the whole dump also lands as a JSON
        file — the post-mortem survives the process. The directory is
        capped (count + bytes, oldest evicted) by write_dump_file."""
        path = write_dump_file(
            "flight-{}".format(record.get("trace", "noid")[:16]),
            self.dump())
        if path is not None:
            log.warning("handler error on %s %s — flight dump written "
                        "to %s", record["method"], record["route"], path)


#: periodic-cadence listeners invoked whenever a metric snapshot is
#: taken (every SNAPSHOT_INTERVAL_SEC while requests flow), as
#: (name, fn) pairs — the name labels the per-listener error counter
_snapshot_listeners: List[Any] = []


def add_snapshot_listener(fn, name: Optional[str] = None) -> None:
    """Register ``fn()`` to run on the recorder's snapshot cadence
    (idempotent per function object). ``name`` labels the listener's
    failures in ``pio_snapshot_listener_errors_total`` — pass the
    subsystem name (``slo``, ``timeline``, ``anomaly``); anonymous
    registrations fall back to the function's module."""
    if name is None:
        name = getattr(fn, "__module__", "") or "anonymous"
        name = name.rsplit(".", 1)[-1]
    if all(existing is not fn for _, existing in _snapshot_listeners):
        _snapshot_listeners.append((name, fn))


#: the process-global recorder every server records into
RECORDER = FlightRecorder()

# spans route into open request records as they are emitted
trace.add_sink(RECORDER.on_span)


def begin(trace_id: str, server: str, method: str, route: str) -> int:
    return RECORDER.begin(trace_id, server, method, route)


def finish(key: int, status: Optional[int],
           error: Optional[str] = None) -> Optional[Dict[str, Any]]:
    return RECORDER.finish(key, status, error)


def note_stage(stage: str, seconds: float,
               trace_id: Optional[str] = None) -> None:
    RECORDER.note_stage(stage, seconds, trace_id)


def note_field(name: str, value: Any,
               trace_id: Optional[str] = None) -> None:
    RECORDER.note_field(name, value, trace_id)


def record_payload(route: str, payload: Any,
                   nbytes: Optional[int] = None) -> bool:
    return RECORDER.record_payload(route, payload, nbytes)
