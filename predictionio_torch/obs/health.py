"""Active health monitoring: probes, the health registry, watchdogs.

Port of ``predictionio_tpu/obs/health.py``. The registry, the storage,
flight-error, disk and queue-depth probes and the watchdogs are
copies, with two device-facing probes rewritten:

  devices       ``torch.cuda``: the card count and name, and one tiny
                synchronised op on each card a deployment registered
                (:func:`register_device`). A card that fails it is
                FAILED, never DEGRADED, and nothing falls back to the
                CPU; a process that registered no card (an event
                server, a ``device="cpu"`` deployment) reports ``cpu``.
  compile_cache the JAX probe over the kernel-library cache
                (``parallel/compile_cache.py``): the hit rate of
                ``pio_kernel_build_total`` (``cached`` hits, ``built``
                misses) against ``PIO_CACHE_HIT_FLOOR`` once
                ``PIO_CACHE_MIN_LOOKUPS`` lookups were made, with the
                JAX probe's status and reason texts.
  kernels       the port's own: every kernel library this process
                asked for (``ops/kernels/__init__.py``: what a
                deployment's warm-up launched) is loaded.

A :class:`Watchdog` reads its clocks from ``clock=`` (an object with
``monotonic()`` and ``perf_counter()``; the ``time`` module by
default, which is what the JAX copy reads). One built with another
clock gets a monitor of its own that runs no thread: :meth:`Watchdog.
poll` fires what has expired, so a test drives it without waiting.
The shared monitor's thread starts with the first armed watch, never
at import, ends a second after the last watch is disarmed, and
:func:`stop_monitor` joins it at once. What follows is the JAX
module's account.

Everything the obs stack had before this module describes what already
happened (metrics, traces, flight records, profiles). This module is
the half an operator pages on: a process-global :class:`HealthRegistry`
of named probes answering "can this server do its job RIGHT NOW", and
:class:`Watchdog` deadman timers that notice a hung training step or a
wedged serving dispatch while it is still hung.

Probes return one of three states:

  OK        the dependency answers within budget
  DEGRADED  still serving, but an operator should look (slow storage,
            deep serving queue, low disk)
  FAILED    the server cannot do useful work (storage unreachable)

The shared HTTP layer (serving/http.py) serves the registry on every
server:

  GET /healthz  liveness — cheap, always 200 while the process can
                answer at all (no probes run; a wedged process simply
                never responds)
  GET /readyz   readiness — runs the probes; 200 with per-probe detail
                while nothing FAILED, 503 + the same detail otherwise

Watchdogs: ``Watchdog.watch()`` wraps one unit of work (a serving
dispatch); ``Watchdog.deadman()`` + ``beat()`` guard a long run that
reports progress (training steps). Either way, when the work exceeds
``PIO_STALL_FACTOR`` (default 10) x its trailing-median duration the
monitor thread fires ONCE per armed watch: the
``pio_watchdog_stall_total`` counter, a ``pio.stall`` structured log
line carrying the active trace id — and, for watchdogs created with
``dump_stacks=True`` (the train-step deadman), a flight-style stack
dump of every thread into ``PIO_FLIGHT_DIR``, so the evidence of WHERE
it hung survives the eventual kill -9.

Config (all env):
  PIO_STALL_FACTOR           stall threshold as a multiple of the
                             trailing median (default 10)
  PIO_STORAGE_PROBE_WARN_MS  storage probe latency that flags DEGRADED
                             (default 250)
  PIO_DISK_MIN_FREE_MB       free-space floor for PIO_FLIGHT_DIR /
                             PIO_TRACE_LOG before DEGRADED (default
                             256; FAILED below 1/8 of it)
  PIO_QUEUE_DEPTH_LIMIT      serving queue depth that flags DEGRADED
                             (default 8x the batcher's max_batch)
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import statistics
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_torch.obs import flight, journal, metrics, trace

log = logging.getLogger(__name__)

#: the stall log: one record per watchdog firing, carrying the stalled
#: work's trace id; JSON-parseable under obs/logging.py's formatter
stall_log = logging.getLogger("pio.stall")

OK = "ok"
DEGRADED = "degraded"
FAILED = "failed"

#: severity order for aggregating probe results into one answer
_RANK = {OK: 0, DEGRADED: 1, FAILED: 2}

DEFAULT_STALL_FACTOR = 10.0

_PROBE_STATUS = metrics.gauge(
    "pio_health_probe_status",
    "Latest result per health probe (0 ok / 1 degraded / 2 failed)",
    ("probe",),
)
_PROBE_SECONDS = metrics.histogram(
    "pio_health_probe_seconds",
    "Health probe execution time",
    ("probe",),
    buckets=(0.0005, 0.0025, 0.01, 0.05, 0.25, 1.0, 5.0),
)
_STALL_TOTAL = metrics.counter(
    "pio_watchdog_stall_total",
    "Watchdog firings: watched work exceeded PIO_STALL_FACTOR x its "
    "trailing median duration",
    ("watchdog",),
)


def stall_factor() -> float:
    """PIO_STALL_FACTOR, read per arm so tests and live retuning apply
    without a restart."""
    return max(1.0, metrics.env_float("PIO_STALL_FACTOR",
                                      DEFAULT_STALL_FACTOR))


@dataclasses.dataclass
class ProbeResult:
    """One probe's verdict. ``reason`` must say enough to act on —
    "FAILED" without a reason is a page with no runbook."""

    status: str
    reason: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {"status": self.status, "reason": self.reason}


def ok(reason: str = "") -> ProbeResult:
    return ProbeResult(OK, reason)


def degraded(reason: str) -> ProbeResult:
    return ProbeResult(DEGRADED, reason)


def failed(reason: str) -> ProbeResult:
    return ProbeResult(FAILED, reason)


class HealthRegistry:
    """Named probes, run together for ``GET /readyz``.

    Registration is last-wins (a re-created in-process server replaces
    its predecessor's probe rather than stacking a stale one); a probe
    that RAISES is a FAILED result, never a failed readyz handler."""

    def __init__(self):
        self._lock = threading.Lock()
        self._probes: Dict[str, Callable[[], ProbeResult]] = {}

    def register(self, name: str, probe: Callable[[], ProbeResult]) -> None:
        with self._lock:
            self._probes[name] = probe

    def unregister(self, name: str, probe: Optional[Callable] = None) -> None:
        """Remove a probe. With ``probe`` given, remove only if it is
        still the registered one — a stopped owner must not tear down
        the probe a newer owner registered under the same name."""
        with self._lock:
            if probe is None or self._probes.get(name) is probe:
                self._probes.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._probes)

    def run(
        self, extra: Optional[Dict[str, Callable[[], ProbeResult]]] = None,
    ) -> Tuple[str, Dict[str, Dict[str, Any]]]:
        """Run every registered probe (+ per-call ``extra`` ones, e.g.
        the serving server's own storage) and aggregate: the overall
        status is the worst individual one."""
        with self._lock:
            probes = dict(self._probes)
        if extra:
            probes.update(extra)
        overall = OK
        detail: Dict[str, Dict[str, Any]] = {}
        for name in sorted(probes):
            t0 = time.perf_counter()
            try:
                result = probes[name]()
                if not isinstance(result, ProbeResult):
                    result = ok() if result else failed("probe returned falsy")
            except Exception as e:  # noqa: BLE001 — a raising probe IS the finding
                result = failed(f"{type(e).__name__}: {e}")
            elapsed = time.perf_counter() - t0
            _PROBE_STATUS.labels(name).set(_RANK.get(result.status, 2))
            _PROBE_SECONDS.labels(name).observe(elapsed)
            entry = result.as_dict()
            entry["latency_ms"] = round(elapsed * 1e3, 3)
            detail[name] = entry
            if _RANK.get(result.status, 2) > _RANK[overall]:
                overall = result.status
        return overall, detail


#: the process-global registry every server's /readyz runs
REGISTRY = HealthRegistry()


# ---------------------------------------------------------------------------
# Built-in probes
# ---------------------------------------------------------------------------

def storage_probe(storage) -> ProbeResult:
    """Live round-trip against every configured repository: any
    unreachable repo is FAILED (the server cannot answer queries or
    record events), a slow-but-answering backend is DEGRADED."""
    if storage is None:
        return ok("no storage attached")
    t0 = time.perf_counter()
    results = storage.verify_all_data_objects()
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    down = sorted(repo for repo, up in results.items() if not up)
    if down:
        return failed(f"unreachable: {', '.join(down)}")
    warn_ms = metrics.env_float("PIO_STORAGE_PROBE_WARN_MS", 250.0)
    if elapsed_ms > warn_ms:
        return degraded(
            f"probe took {elapsed_ms:.0f} ms (warn {warn_ms:.0f} ms)")
    return ok(f"{len(results)} repositories in {elapsed_ms:.1f} ms")


#: the CUDA devices deployments serve from: the devices probe checks
#: each with a synchronised op (a set of device strings)
_device_lock = threading.Lock()
_DEVICES: Dict[str, int] = {}


def register_device(device: Any) -> None:
    """A deployment on ``device`` went live: the devices probe checks
    it from now on (CPU devices are not registered; counted, so two
    deployments on one card need two :func:`unregister_device`)."""
    name = str(device)
    if not name.startswith("cuda"):
        return
    with _device_lock:
        _DEVICES[name] = _DEVICES.get(name, 0) + 1


def unregister_device(device: Any) -> None:
    name = str(device)
    with _device_lock:
        if name in _DEVICES:
            _DEVICES[name] -= 1
            if _DEVICES[name] <= 0:
                del _DEVICES[name]


def _devices_probe() -> ProbeResult:
    """The cards this process serves from answer a synchronised op.
    No registered card: ``cpu``, and torch is not even imported here.
    Any failure is FAILED: a deployment asked for the card."""
    with _device_lock:
        devices = sorted(_DEVICES)
    if not devices:
        return ok("cpu")
    import torch

    if not torch.cuda.is_available():
        return failed(f"CUDA unavailable to a deployment on "
                      f"{', '.join(devices)}")
    names = []
    for name in devices:
        dev = torch.device(name)
        one = torch.ones(1, device=dev)
        value = float((one + one).item())     # launches and synchronises
        torch.cuda.synchronize(dev)
        if value != 2.0:
            return failed(f"{name}: a tiny op answered {value}, not 2.0")
        names.append(f"{name} {torch.cuda.get_device_name(dev)}")
    return ok(f"{torch.cuda.device_count()} CUDA device(s); serving on "
              + "; ".join(names))


def _kernels_probe() -> ProbeResult:
    """Every kernel library this process asked for is loaded: a warm-up
    that launched a kernel loaded its library first, so a missing one
    means a build or load failed."""
    from predictionio_torch.ops import kernels

    wanted, loaded = kernels.requested_kernels(), kernels.loaded_kernels()
    if not wanted:
        return ok("no kernel requested")
    missing = sorted(set(wanted) - set(loaded))
    if missing:
        return failed(f"kernel library not loaded: {', '.join(missing)}")
    return ok("loaded: " + ", ".join(sorted(loaded)))


def _compile_cache_probe() -> ProbeResult:
    """JAX's probe over the kernel-library requests: a ``cached`` one is
    a hit, a ``built`` one a miss, summed over the kernels."""
    family = metrics.REGISTRY.get("pio_kernel_build_total")
    hits = misses = 0.0
    if family is not None:
        for values, child in family.children():
            if values[-1] == "cached":
                hits += child.value
            elif values[-1] == "built":
                misses += child.value
    lookups = hits + misses
    min_lookups = metrics.env_float("PIO_CACHE_MIN_LOOKUPS", 32.0)
    if lookups < min_lookups:
        return ok(f"{int(lookups)} lookup(s); floor applies from "
                  f"{int(min_lookups)}")
    rate = hits / lookups
    floor = metrics.env_float("PIO_CACHE_HIT_FLOOR", 0.5)
    if rate < floor:
        return degraded(
            f"compile-cache hit rate {rate:.2f} below floor {floor:.2f} "
            f"({int(hits)}/{int(lookups)}) — recompiling work another "
            "process already paid for")
    return ok(f"hit rate {rate:.2f} over {int(lookups)} lookups")


def _flight_error_probe() -> ProbeResult:
    records = flight.RECORDER.records(64)
    if len(records) < 16:
        return ok(f"{len(records)} recent request(s)")
    errors = sum(1 for r in records if r.get("error"))
    rate = errors / len(records)
    if rate > 0.5:
        return degraded(
            f"{errors}/{len(records)} recent requests errored — see "
            "/admin/flight?slow=1")
    return ok(f"{errors}/{len(records)} recent requests errored")


def _disk_probe() -> ProbeResult:
    """Free-space headroom for the diagnostic sinks. A full disk fails
    flight dumps and the trace log silently — exactly when they are
    about to be needed."""
    import shutil

    paths = []
    flight_dir = os.environ.get("PIO_FLIGHT_DIR")
    if flight_dir:
        paths.append(("PIO_FLIGHT_DIR", flight_dir))
    trace_log_path = os.environ.get("PIO_TRACE_LOG")
    if trace_log_path:
        paths.append(("PIO_TRACE_LOG", os.path.dirname(trace_log_path) or "."))
    if not paths:
        return ok("no diagnostic sinks configured")
    min_free = metrics.env_float("PIO_DISK_MIN_FREE_MB", 256.0) * (1 << 20)
    worst = ok("")
    notes = []
    for name, path in paths:
        try:
            free = shutil.disk_usage(path).free
        except OSError as e:
            candidate = degraded(f"{name} ({path}): {e}")
            if _RANK[candidate.status] > _RANK[worst.status]:
                worst = candidate
            continue
        notes.append(f"{name} {free / (1 << 20):.0f} MB free")
        if free < min_free / 8:
            candidate = failed(f"{name} ({path}) nearly full: "
                               f"{free / (1 << 20):.0f} MB free")
        elif free < min_free:
            candidate = degraded(f"{name} ({path}) low: "
                                 f"{free / (1 << 20):.0f} MB free "
                                 f"(floor {min_free / (1 << 20):.0f} MB)")
        else:
            continue
        if _RANK[candidate.status] > _RANK[worst.status]:
            worst = candidate
    return worst if worst.status != OK else ok("; ".join(notes))


def queue_depth_probe(get_depth: Callable[[], Optional[int]],
                      limit: int) -> Callable[[], ProbeResult]:
    """A probe over a serving queue's depth (the MicroBatcher registers
    one over a weakref'd queue — ``get_depth`` answering None means the
    batcher is gone and the probe reports a clean OK)."""

    def probe() -> ProbeResult:
        depth = get_depth()
        if depth is None:
            return ok("no active batcher")
        if depth >= limit:
            return degraded(
                f"serving queue depth {depth} >= {limit} — dispatches "
                "are not keeping up with arrivals")
        return ok(f"queue depth {depth}")

    return probe


_defaults_installed = False
_defaults_lock = threading.Lock()


def install_default_probes() -> None:
    """Register the process-level probes (idempotent; called lazily by
    the first ``/readyz``). Per-server probes — storage, queue depth —
    attach separately because they are bound to instances."""
    global _defaults_installed
    with _defaults_lock:
        if _defaults_installed:
            return
        REGISTRY.register("devices", _devices_probe)
        REGISTRY.register("compile_cache", _compile_cache_probe)
        REGISTRY.register("kernels", _kernels_probe)
        REGISTRY.register("flight_errors", _flight_error_probe)
        REGISTRY.register("disk", _disk_probe)
        # device-memory headroom (obs/memacct.py): DEGRADED under the
        # PIO_MEM_HEADROOM_FLOOR fraction of capacity — the operator
        # warning that the next deploy will be preflight-refused
        from predictionio_torch.obs import memacct

        REGISTRY.register("device_memory", memacct.device_memory_probe)
        _defaults_installed = True


# ---------------------------------------------------------------------------
# Watchdogs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Watch:
    watchdog: "Watchdog"
    deadline: float            # monotonic seconds
    armed_at: float
    trace_id: Optional[str]
    fired: bool = False
    deadman: bool = False


#: seconds the monitor thread waits with nothing armed before it ends
IDLE_EXIT_SEC = 1.0


class _Monitor:
    """Every armed watch of its watchdogs; fires each expired watch
    exactly once. ``threaded``: one daemon thread, started with the
    first armed watch, wakes at the earliest deadline and ends once
    nothing has been armed for ``IDLE_EXIT_SEC`` (the shared monitor);
    otherwise :meth:`fire_expired` is called by the owner
    (a watchdog on an injected clock)."""

    def __init__(self, clock: Any = time, threaded: bool = True):
        self._clock = clock
        self._threaded = threaded
        self._cond = threading.Condition()
        self._watches: Dict[int, _Watch] = {}
        self._keys = 0
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    def arm(self, watch: _Watch) -> int:
        with self._cond:
            self._keys += 1
            key = self._keys
            self._watches[key] = watch
            if self._threaded and (self._thread is None
                                   or not self._thread.is_alive()):
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._run, name="pio-watchdog", daemon=True)
                self._thread.start()
            self._cond.notify()
        return key

    def disarm(self, key: int) -> None:
        with self._cond:
            self._watches.pop(key, None)
            self._cond.notify()

    def rearm(self, key: int, deadline: float) -> None:
        with self._cond:
            watch = self._watches.get(key)
            if watch is not None:
                watch.deadline = deadline
                watch.armed_at = self._clock.monotonic()
                watch.fired = False
                self._cond.notify()

    def _take_expired(self) -> Tuple[List[_Watch], Optional[float]]:
        # caller holds the condition
        now = self._clock.monotonic()
        expired = [w for w in self._watches.values()
                   if not w.fired and w.deadline <= now]
        for w in expired:
            w.fired = True  # fire once per armed window
        pending = [w.deadline for w in self._watches.values()
                   if not w.fired]
        timeout = max(0.0, min(pending) - now) if pending else None
        return expired, timeout

    def fire_expired(self) -> int:
        """Fire every watch past its deadline now; returns how many."""
        with self._cond:
            expired, _ = self._take_expired()
        for w in expired:  # outside the lock: firing takes others
            w.watchdog._fire(w)
        return len(expired)

    def stop(self, timeout: float = 5.0) -> bool:
        """End the thread (the next armed watch starts a new one)."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
            return not thread.is_alive()
        return True

    def _run(self) -> None:
        while True:
            try:
                with self._cond:
                    if self._stopping:
                        return
                    if not self._watches:
                        # idle: wait a while for the next watch, then
                        # end (the next arm starts a new thread), so no
                        # thread outlives the work it watched by long
                        self._cond.wait(IDLE_EXIT_SEC)
                        if not self._watches:
                            self._thread = None
                            return
                    expired, timeout = self._take_expired()
                    if not expired:
                        self._cond.wait(timeout)
                        continue
                for w in expired:  # outside the lock: firing takes others
                    w.watchdog._fire(w)
            except Exception:  # noqa: BLE001 — a dead monitor watches nothing
                log.exception("watchdog monitor iteration failed")
                time.sleep(1.0)


_MONITOR = _Monitor()


def stop_monitor(timeout: float = 5.0) -> bool:
    """Join the shared monitor's thread (tests, process teardown)."""
    return _MONITOR.stop(timeout)


class Watchdog:
    """Stall detection for one class of work.

    ``watch()`` wraps a bounded unit (one serving dispatch): the
    deadline is ``stall_factor() x max(min_seconds, trailing median)``,
    armed only once ``min_history`` completed durations exist — a cold
    watchdog never false-positives on warm-up compiles. ``deadman()`` +
    ``beat(seconds)`` guard a long run that reports progress: each beat
    records a duration and pushes the deadline out; silence beyond the
    deadline fires.
    """

    def __init__(self, name: str, min_seconds: float = 1.0,
                 min_history: int = 8, history: int = 256,
                 dump_stacks: bool = False,
                 factor: Optional[float] = None,
                 clock: Any = time):
        import collections

        self._clock = clock
        self._monitor = (_MONITOR if clock is time
                         else _Monitor(clock, threaded=False))
        self.name = name
        self.min_seconds = min_seconds
        self.min_history = max(1, min_history)
        self.dump_stacks = dump_stacks
        self._factor = factor
        self._lock = threading.Lock()
        self._durations: "collections.deque[float]" = collections.deque(
            maxlen=history)
        self._deadman_key: Optional[int] = None

    # -- timing model -------------------------------------------------------
    def record(self, seconds: float) -> None:
        with self._lock:
            self._durations.append(float(seconds))

    def deadline_seconds(self) -> Optional[float]:
        """Seconds of silence that count as a stall; None while there is
        not enough history to call anything a stall."""
        with self._lock:
            if len(self._durations) < self.min_history:
                return None
            median = statistics.median(self._durations)
        factor = self._factor if self._factor is not None else stall_factor()
        return max(self.min_seconds, median) * factor

    # -- bounded-unit mode --------------------------------------------------
    @contextlib.contextmanager
    def watch(self):
        """Guard one unit of work; always records its duration into the
        trailing window on exit."""
        deadline = self.deadline_seconds()
        key = None
        if deadline is not None:
            now = self._clock.monotonic()
            key = self._monitor.arm(_Watch(
                watchdog=self, deadline=now + deadline, armed_at=now,
                trace_id=trace.current_trace_id()))
        t0 = self._clock.perf_counter()
        try:
            yield
        finally:
            if key is not None:
                self._monitor.disarm(key)
            self.record(self._clock.perf_counter() - t0)

    # -- deadman mode -------------------------------------------------------
    @contextlib.contextmanager
    def deadman(self):
        """Activate deadman supervision for the enclosed run. The timer
        only fires once ``beat()`` has built enough history."""
        self.start_deadman()
        try:
            yield self
        finally:
            with self._lock:
                key, self._deadman_key = self._deadman_key, None
            if key is not None:
                self._monitor.disarm(key)

    def beat(self, seconds: Optional[float] = None) -> None:
        """Report progress (optionally with the completed unit's
        duration). No-op unless a ``deadman()`` block is active — plain
        ``watch()`` users and bare metric feeds stay cheap."""
        if seconds is not None:
            self.record(seconds)
        with self._lock:
            active = self._deadman_key
            armed = active is not None
        deadline = self.deadline_seconds()
        if deadline is None:
            return
        now = self._clock.monotonic()
        if armed:
            self._monitor.rearm(active, now + deadline)

    def start_deadman(self) -> None:
        """Arm the persistent deadman entry (used via ``deadman()``;
        separate so the first beat can arm lazily)."""
        with self._lock:
            if self._deadman_key is not None:
                return
        deadline = self.deadline_seconds()
        if deadline is None:
            # not enough history yet: register a placeholder armed far
            # out; beats re-arm it to the real deadline as history lands
            deadline = 10 * 365 * 86400.0
        now = self._clock.monotonic()
        key = self._monitor.arm(_Watch(
            watchdog=self, deadline=now + deadline, armed_at=now,
            trace_id=trace.current_trace_id(), deadman=True))
        with self._lock:
            # re-validate: a concurrent start_deadman may have armed
            # between the check above and our arm — keeping both keys
            # would leak a monitor entry that fires (and beats would
            # re-arm only one of them), so the loser disarms itself
            if self._deadman_key is None:
                self._deadman_key = key
                key = None
        if key is not None:
            self._monitor.disarm(key)

    def poll(self) -> int:
        """Fire this watchdog's expired watches now (a watchdog on an
        injected clock has no thread doing it); returns how many."""
        return self._monitor.fire_expired()

    # -- firing -------------------------------------------------------------
    def _fire(self, watch: _Watch) -> None:
        waited = self._clock.monotonic() - watch.armed_at
        payload: Dict[str, Any] = {
            "watchdog": self.name,
            "waited_sec": round(waited, 3),
            "stall_factor": (self._factor if self._factor is not None
                             else stall_factor()),
        }
        if watch.trace_id:
            payload["trace"] = watch.trace_id
        dump_path = None
        if self.dump_stacks:
            dump_path = self._dump_stacks(payload)
            if dump_path:
                payload["stack_dump"] = dump_path
        stall_log.warning(
            "watchdog %s: no completion after %.1f s (deadline was "
            "factor x trailing median)%s", self.name, waited,
            f"; stacks dumped to {dump_path}" if dump_path else "",
            extra={"pio": payload},
        )
        journal.emit("watchdog_stall", watchdog=self.name,
                     waited_sec=payload["waited_sec"],
                     stall_trace=watch.trace_id,
                     stack_dump=dump_path)
        # the counter is the LAST effect: anything observing it (tests,
        # alert rules sampling right after a stall) sees the log line,
        # stack dump and journal entry already landed
        _STALL_TOTAL.labels(self.name).inc()

    def _dump_stacks(self, payload: Dict[str, Any]) -> Optional[str]:
        """Flight-style dump of every thread's stack — the post-mortem
        for a hang, written through the capped flight-dump path."""
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = {
            f"{names.get(tid, '?')}-{tid}": traceback.format_stack(frame)
            for tid, frame in frames.items()
        }
        return flight.write_dump_file(
            f"stall-{self.name}", {"stall": payload, "threads": stacks})


#: the training-step deadman: armed by workflow/train.py around
#: engine.train, beaten by torchmon.observe_train_step — a hung step
#: produces a stack dump while the hang is still observable
TRAIN_WATCHDOG = Watchdog("train_step", min_seconds=1.0, dump_stacks=True)
