"""Replica supervisor: N engine-server replicas as one serving fleet.

Copy of ``predictionio_tpu/serving/fleet.py`` with two changes:
:func:`deploy_fleet_argv` spawns the port's CLI
(``python -m predictionio_torch.tools.cli deploy``) with the parent's
``--device``, so every subprocess replica serves on the card unless the
parent was asked for the CPU; and a supervisor registers its ``fleet``
readiness probe as one bound method it keeps, so that ``stop()``
removes it (the JAX supervisor passes a fresh bound method to
``unregister``, which removes a probe only when it is the registered
object, so a stopped fleet's probe stays and reads DEGRADED). What
follows is the JAX module's account.

The reference deploys each trained engine as ONE process
(CreateServer / ``GET /reload``) — one crash or one mid-traffic reload
away from an outage. This module is the redundancy half of the fleet
story (serving/router.py is the routing half):

  spawn      N engine-server replicas — subprocesses on ephemeral
             ports in production (``pio deploy --replicas N``), or
             in-process threaded servers for tier-1 CPU tests (same
             HTTP surface, so the supervisor/router code path is
             identical in both modes)
  monitor    a supervision loop probes each replica's existing
             ``GET /readyz``: a failing probe EVICTS the replica from
             rotation (the router stops selecting it), a succeeding
             one re-admits it — readiness, not liveness, drives
             placement
  restart    a replica that stops answering (process exit, closed
             socket) is restarted under the resilience layer's
             full-jitter backoff (resilience/policy.py), with the
             attempt counter reset after a stable period — crash loops
             back off, one-off crashes restart fast
  hot-swap   :meth:`FleetSupervisor.rolling_reload` rolls the fleet
             onto the newest COMPLETED instance one replica at a time:
             drain from rotation, ``GET /reload`` (load + warm BEFORE
             the in-replica swap, serving/engine_server.py), rejoin —
             live traffic never waits on a compile and the fleet never
             drops below N-1 ready replicas
  canary     :meth:`FleetSupervisor.start_canary` puts the newest
             COMPLETED instance on EXACTLY ONE replica through the
             same drain→reload→rejoin machinery; the router then tags
             per-lane latency histograms and samples paired answers
             (serving/router.py), obs/quality.py renders the
             promote/rollback verdict, and the supervisor acts on it
             automatically (``PIO_CANARY_AUTO``, default on): promote
             = rolling-swap the rest of the fleet onto the candidate,
             rollback = swap the canary replica BACK onto the baseline
             instance (``GET /reload?instance=<baseline>``). With
             ``canary_mode`` (``pio deploy --canary`` /
             ``PIO_FLEET_CANARY=1``) the auto-swap watch starts a
             canary instead of a full rolling swap when a new
             COMPLETED instance lands — train-to-serving with a
             quality gate and no operator in the loop.

Observability: ``pio_fleet_replica_up{replica}``,
``pio_fleet_replica_version{replica,version}``,
``pio_fleet_restarts_total{replica}``, ``pio_fleet_ready_replicas``,
a ``fleet`` readiness probe, a ``fleet.ready`` timeline series, and
the ``GET/POST /admin/fleet`` surface (serving/http.py) on whichever
server holds the supervisor (normally the router).

Env knobs: ``PIO_REPLICAS`` (deploy default), ``PIO_FLEET_PROBE_SEC``
(supervision cadence, default 0.5), ``PIO_FLEET_PROBE_DEADLINE``
(per-probe timeout, default 2), ``PIO_FLEET_BACKOFF_BASE`` /
``PIO_FLEET_BACKOFF_CAP`` (restart backoff, default 0.5/30),
``PIO_FLEET_WATCH_SEC`` (auto rolling swap on a new COMPLETED
instance; 0 = manual, the default), ``PIO_DRAIN_TIMEOUT`` (drain
window per replica, shared with the SIGTERM handler).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from predictionio_torch.obs import health, journal, metrics, timeline, trace
from predictionio_torch.resilience.policy import Policy
from predictionio_torch.serving.http import drain_timeout

log = logging.getLogger(__name__)

# replica lifecycle states
STARTING = "starting"    # launched, first ready probe pending
READY = "ready"          # in rotation
EVICTED = "evicted"      # alive but failing readiness; out of rotation
DRAINING = "draining"    # deliberately out of rotation (swap/admin)
DEAD = "dead"            # unreachable; restart scheduled under backoff
STOPPED = "stopped"      # terminated on purpose; never restarted

#: consecutive transport-level probe failures before a replica is
#: declared DEAD (a single blip only evicts)
CRASH_THRESHOLD = 2
#: seconds after launch() during which a STARTING replica whose
#: process is still alive may refuse connections without being
#: declared dead: a subprocess replica's boot includes the torch import,
#: model load and warm-up compiles — killing a slow boot respawns an
#: equally slow boot, forever (``PIO_FLEET_STARTUP_GRACE`` overrides)
DEFAULT_STARTUP_GRACE_SEC = 180.0
#: seconds of uninterrupted readiness after which the restart-backoff
#: attempt counter resets (a once-a-day crash should restart fast)
STABLE_RESET_SEC = 30.0

_REPLICA_UP = metrics.gauge(
    "pio_fleet_replica_up",
    "1 while the replica is in rotation (READY), else 0",
    ("replica",),
)
_REPLICA_VERSION = metrics.gauge(
    "pio_fleet_replica_version",
    "1 for the engine instance a replica currently serves (the rolling "
    "swap is observable as this label moving replica by replica)",
    ("replica", "version"),
)
_RESTARTS = metrics.counter(
    "pio_fleet_restarts_total",
    "Supervisor-initiated replica restarts after a crash",
    ("replica",),
)
_READY_GAUGE = metrics.gauge(
    "pio_fleet_ready_replicas",
    "Replicas currently in rotation",
)
_SWAPS = metrics.counter(
    "pio_fleet_rolling_swaps_total",
    "Rolling hot-swaps completed, by outcome",
    ("outcome",),
)

#: supervisors running in THIS process (dashboard /fleet panel; the
#: threaded tier-1 mode and `pio deploy --replicas` both land here)
ACTIVE: List["FleetSupervisor"] = []


def _free_port() -> int:
    """An ephemeral port for a subprocess replica (bind-and-release;
    the tiny reuse race is covered by the engine server's bind retry)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Replica:
    """One supervised replica: state, version, and the router's
    outstanding-request count (the power-of-two-choices load signal)."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()
        self.state = STOPPED
        self.version: Optional[str] = None
        self.restarts = 0
        self.probe_failures = 0
        self.backoff_attempt = 0
        self.next_restart_at = 0.0    # monotonic
        self.ready_since = 0.0        # monotonic
        self.launched_at = 0.0        # monotonic; set by the supervisor
        self.last_probe: Optional[Dict[str, Any]] = None
        self._outstanding = 0
        _REPLICA_UP.labels(name).set(0.0)

    # -- mode-specific hooks -------------------------------------------------
    @property
    def port(self) -> int:
        raise NotImplementedError

    def launch(self) -> None:
        raise NotImplementedError

    def terminate(self, drain: bool = True) -> None:
        raise NotImplementedError

    def request_stop(self) -> None:
        """Begin an asynchronous stop where the mode supports one (a
        subprocess gets its SIGTERM now, drains while its siblings
        drain); ``terminate()`` still completes the teardown. Fleet
        shutdown signals every replica first so the worst case is ONE
        drain window, not N of them stacked sequentially."""

    def process_alive(self) -> Optional[bool]:
        """False when the replica's process/loop is definitely gone;
        None when only the probe can tell (subprocess still running,
        threaded server object present)."""
        return None

    # -- router-side load accounting -----------------------------------------
    def begin_request(self) -> None:
        with self.lock:
            self._outstanding += 1

    def end_request(self) -> None:
        with self.lock:
            self._outstanding = max(0, self._outstanding - 1)

    def outstanding(self) -> int:
        with self.lock:
            return self._outstanding

    # -- shared plumbing -----------------------------------------------------
    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            outstanding = self._outstanding
        return {
            "name": self.name,
            "mode": type(self).__name__.replace("Replica", "").lower(),
            "port": self.port if self.state != DEAD else None,
            "state": self.state,
            "version": self.version,
            "restarts": self.restarts,
            "outstanding": outstanding,
            "lastProbe": self.last_probe,
        }


class ThreadedReplica(Replica):
    """An in-process engine server on an ephemeral port — the tier-1
    CPU mode. Same HTTP surface as a subprocess replica, so the
    supervisor, router and chaos tests exercise the production path."""

    def __init__(self, name: str, factory: Callable[[str], Any]):
        super().__init__(name)
        self._factory = factory
        self.server = None

    @property
    def port(self) -> int:
        return self.server.port if self.server is not None else 0

    def launch(self) -> None:
        self.server = self._factory(self.name).start()

    def terminate(self, drain: bool = True) -> None:
        server, self.server = self.server, None
        if server is None:
            return
        try:
            server.stop()
        except Exception:  # noqa: BLE001 — a half-dead server (killed
            # socket) must not fail the restart that replaces it
            log.exception("stopping threaded replica %s failed", self.name)

    def process_alive(self) -> Optional[bool]:
        if self.server is None:
            return False
        try:
            # a closed listening socket (fileno -1) IS this mode's
            # "process exited": kill() and real OSError deaths leave
            # the server object in place, so presence alone can't
            # clear a DRAINING replica whose loop died
            if self.server.httpd.socket.fileno() < 0:
                return False
        except (OSError, AttributeError):
            return False
        return None

    def kill(self) -> None:
        """Chaos hook: die like a crashed process — the listening
        socket closes abruptly (new connections refused, serve loop
        dead), nothing is drained or deregistered."""
        if self.server is not None:
            try:
                self.server.httpd.socket.close()
            except OSError:
                pass


class SubprocessReplica(Replica):
    """A child ``pio deploy`` on an ephemeral port — the production
    mode. SIGTERM on terminate: the child's install_drain_handler
    (serving/http.py) drains in-flight requests before exiting."""

    def __init__(self, name: str, argv: List[str],
                 env: Optional[Dict[str, str]] = None):
        super().__init__(name)
        #: argv with a ``{port}`` placeholder, e.g.
        #: [sys.executable, "-m", "predictionio_torch.tools.cli",
        #:  "deploy", "--engine-json", "engine.json",
        #:  "--ip", "127.0.0.1", "--port", "{port}"]
        self._argv = argv
        self._env = env or {}
        self._port = 0
        self.proc: Optional[subprocess.Popen] = None
        self._term_sent = False

    @property
    def port(self) -> int:
        return self._port

    def launch(self) -> None:
        self._port = _free_port()
        argv = [a.format(port=self._port) for a in self._argv]
        # PIO_REPLICAS must not leak into the child: a replica is a
        # single server by definition (see deploy_fleet_argv — this is
        # the second belt on the fork-bomb guard)
        env = {**os.environ, **self._env, "PIO_CHAOS_TAG": self.name,
               "PIO_REPLICAS": "1"}
        self.proc = subprocess.Popen(argv, env=env)
        self._term_sent = False
        log.info("replica %s: spawned pid %d on port %d", self.name,
                 self.proc.pid, self._port)

    def request_stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            self._term_sent = True

    def terminate(self, drain: bool = True) -> None:
        proc, self.proc = self.proc, None
        if proc is None or proc.poll() is not None:
            return
        if not self._term_sent:
            # a SECOND SIGTERM would spawn a second concurrent drain
            # thread in the child — signal exactly once
            proc.terminate()  # SIGTERM -> child drains via its handler
        self._term_sent = False
        try:
            proc.wait(timeout=(drain_timeout() + 5.0) if drain else 5.0)
        except subprocess.TimeoutExpired:
            log.warning("replica %s ignored SIGTERM; killing", self.name)
            proc.kill()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                log.error("replica %s unkillable (pid %d)", self.name,
                          proc.pid)

    def process_alive(self) -> Optional[bool]:
        return False if (self.proc is None
                         or self.proc.poll() is not None) else None


def threaded_fleet(n: int, factory: Callable[[str], Any],
                   prefix: str = "r") -> List[ThreadedReplica]:
    """N threaded replicas named ``r0..rN-1``; ``factory(name)`` must
    return an UNstarted EngineServer bound to port 0."""
    return [ThreadedReplica(f"{prefix}{i}", factory) for i in range(n)]


def subprocess_fleet(n: int, argv: List[str],
                     env: Optional[Dict[str, str]] = None,
                     prefix: str = "r") -> List[SubprocessReplica]:
    return [SubprocessReplica(f"{prefix}{i}", argv, env)
            for i in range(n)]


class FleetSupervisor:
    """Owns the replicas: spawn, probe, evict/re-admit, restart with
    backoff, and coordinate the rolling hot-swap."""

    def __init__(
        self,
        replicas: List[Replica],
        probe_interval: Optional[float] = None,
        restart_policy: Optional[Policy] = None,
        version_source: Optional[Callable[[], Optional[str]]] = None,
        backoff: Optional[Callable[[int], float]] = None,
        canary_mode: Optional[bool] = None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        self._probe_interval = probe_interval
        self._policy = restart_policy or Policy(
            deadline=metrics.env_float("PIO_FLEET_PROBE_DEADLINE", 2.0),
            retries=0,
            backoff_base=metrics.env_float("PIO_FLEET_BACKOFF_BASE", 0.5),
            backoff_cap=metrics.env_float("PIO_FLEET_BACKOFF_CAP", 30.0),
        )
        # injectable for deterministic backoff tests; defaults to the
        # policy's full-jitter schedule
        self._backoff = backoff or self._policy.backoff_seconds
        #: latest COMPLETED instance id (storage watch) — drives the
        #: optional auto-swap and names the swap target in snapshots
        self._version_source = version_source
        self._stop_evt = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._swap_lock = threading.Lock()
        self._swap_thread: Optional[threading.Thread] = None
        self._state_lock = threading.Lock()
        self._swap: Dict[str, Any] = {"active": False, "last": None}
        self._last_watch = 0.0
        #: None = read PIO_FLEET_CANARY at watch time; explicit bool =
        #: `pio deploy --canary` / tests
        self._canary_mode = canary_mode
        self._canary: Dict[str, Any] = {"active": False, "last": None}
        self._canary_thread: Optional[threading.Thread] = None
        #: hot-path copy of the active canary replica's name (plain
        #: attribute read — the router checks it on every answer)
        self._canary_name: Optional[str] = None
        #: the one bound probe object, so stop() unregisters what
        #: start() registered
        self._fleet_probe_fn = self._fleet_probe

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        for replica in self.replicas:
            self._launch(replica)
        health.REGISTRY.register("fleet", self._fleet_probe_fn)
        timeline.TIMELINE.add_collector(self._timeline_collector)
        ACTIVE.append(self)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="fleet-monitor")
        self._monitor.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        self._canary_name = None  # routers must stop shadow-sampling now
        if self._monitor is not None:
            self._monitor.join(timeout=10)
        # signal everyone first (subprocess drains run in PARALLEL —
        # sequential terminate() would stack up to N drain windows and
        # blow through orchestrator stop timeouts), then reap each
        for replica in self.replicas:
            self._set_state(replica, STOPPED)
            replica.request_stop()
        for replica in self.replicas:
            replica.terminate()
            # retire this fleet's per-replica series: a later fleet in
            # the same process (bench's 1/2/4 sweep) must not inherit
            # phantom replicas still exported at 0 / on an old version
            _REPLICA_UP.remove(replica.name)
            if replica.version:
                _REPLICA_VERSION.remove(replica.name, replica.version)
        health.REGISTRY.unregister("fleet", self._fleet_probe_fn)
        timeline.TIMELINE.remove_collector(self._timeline_collector)
        if self in ACTIVE:
            ACTIVE.remove(self)
        _READY_GAUGE.set(0.0)

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 60.0) -> bool:
        """Block until ``n`` (default: all) replicas are READY."""
        want = len(self.replicas) if n is None else n
        return self._await(lambda: self.ready_count() >= want, timeout)

    # -- rotation view (the router reads these) ------------------------------
    def ready_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.state == READY]

    def ready_count(self) -> int:
        return len(self.ready_replicas())

    def size(self) -> int:
        return len(self.replicas)

    # -- supervision loop ----------------------------------------------------
    def probe_interval(self) -> float:
        if self._probe_interval is not None:
            return self._probe_interval
        return max(0.05, metrics.env_float("PIO_FLEET_PROBE_SEC", 0.5))

    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self.probe_interval()):
            try:
                for replica in list(self.replicas):
                    if self._stop_evt.is_set():
                        return
                    self._tick(replica)
                self._maybe_auto_swap()
                self._maybe_canary_decision()
                _READY_GAUGE.set(float(self.ready_count()))
            except Exception:  # noqa: BLE001 — the supervisor dying
                # silently IS the outage this module exists to prevent
                log.exception("fleet monitor iteration failed")

    def _tick(self, replica: Replica) -> None:
        if replica.state == STOPPED:
            return
        if replica.state == DRAINING:
            # a drain parks the replica out of rotation on purpose, so
            # no probing (a green probe must not re-admit it) — but a
            # crash while parked must still be noticed, or an
            # operator-held replica whose process died reads
            # "draining" (with a live-looking port) forever
            if replica.process_alive() is False:
                self._mark_dead(replica, "process exited while draining")
            return
        if replica.state == DEAD:
            if time.monotonic() >= replica.next_restart_at:
                self._restart(replica)
            return
        if replica.process_alive() is False:
            self._mark_dead(replica, "process exited")
            return
        self.probe_and_update(replica)

    def probe_and_update(self, replica: Replica) -> None:
        """One readiness probe, state updated from the verdict. Called
        by the monitor each tick and by the rolling swap's waits (the
        swap must not be hostage to the monitor cadence). DRAINING is
        deliberate (an operator's or the swap's own eviction) and
        DEAD/STOPPED are terminal-until-restart: a green probe must
        never silently overrule them."""
        if replica.state in (DRAINING, DEAD, STOPPED):
            return
        status, body = self._probe(replica)
        if replica.state in (DRAINING, DEAD, STOPPED):
            # the state changed under the (up to deadline-long) probe —
            # an operator drain, the swap's own eviction, or a
            # concurrent death verdict. Acting on the stale probe here
            # would put a deliberately-drained replica back in rotation.
            return
        if status is None:
            # a STARTING replica whose process is alive gets a boot
            # grace window: connection-refused during the torch import /
            # model load / warm-up is a slow boot, not a crash —
            # restarting it would respawn an equally slow boot forever
            if (replica.state == STARTING
                    and replica.process_alive() is not False
                    and time.monotonic() - replica.launched_at
                    < metrics.env_float("PIO_FLEET_STARTUP_GRACE",
                                        DEFAULT_STARTUP_GRACE_SEC)):
                return
            replica.probe_failures += 1
            if replica.probe_failures >= CRASH_THRESHOLD:
                self._mark_dead(replica, str(body))
            else:
                self._set_state(replica, EVICTED)
            return
        replica.probe_failures = 0
        replica.last_probe = {"status": status,
                              "overall": (body or {}).get("status")}
        if status == 200:
            if replica.state != READY:
                self._refresh_version(replica)
                replica.ready_since = time.monotonic()
                self._set_state(replica, READY)
            elif replica.backoff_attempt and (
                    time.monotonic() - replica.ready_since
                    > STABLE_RESET_SEC):
                replica.backoff_attempt = 0
        else:
            # alive but not ready (readyz FAILED): out of rotation
            # until the probe greens — eviction, not a restart
            self._set_state(replica, EVICTED)

    def _probe(self, replica: Replica):
        """(status, parsed body) — (None, error) on transport failure."""
        try:
            req = urllib.request.Request(f"{replica.base_url}/readyz",
                                         headers=trace.traced_headers())
            with urllib.request.urlopen(
                    req, timeout=self._policy.deadline) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                body = {}
            return e.code, body
        except (OSError, ValueError) as e:
            return None, f"{type(e).__name__}: {e}"

    def _refresh_version(self, replica: Replica) -> None:
        """The engine instance a replica serves, from its status page
        (works identically for threaded and subprocess replicas)."""
        if self._stop_evt.is_set():
            # stop() retires this fleet's per-replica series; a
            # straggling swap thread must not re-mint them
            return
        try:
            req = urllib.request.Request(f"{replica.base_url}/",
                                         headers=trace.traced_headers())
            with urllib.request.urlopen(
                    req, timeout=self._policy.deadline) as resp:
                status = json.loads(resp.read() or b"{}")
        except (OSError, ValueError):
            return
        version = status.get("engineInstanceId")
        if version and version != replica.version:
            if replica.version:
                _REPLICA_VERSION.remove(replica.name, replica.version)
            replica.version = version
            _REPLICA_VERSION.labels(replica.name, version).set(1.0)

    def _set_state(self, replica: Replica, state: str,
                   deliberate: bool = False) -> None:
        """``deliberate`` marks an operator/swap transition; without it
        a probe-driven READY or EVICTED write loses to a concurrent
        drain/death verdict."""
        with self._state_lock:
            if replica.state == state:
                return
            if state != STOPPED and self._stop_evt.is_set():
                # stop() owns every replica's final state: a rolling
                # swap still in flight (it checks the stop event only
                # BETWEEN replicas, and _reload can block minutes) must
                # not flip a STOPPED replica back or re-mint the gauge
                # children stop() just removed
                return
            if (not deliberate and state in (READY, EVICTED)
                    and replica.state in (DRAINING, DEAD, STOPPED)):
                # a probe verdict racing a concurrent drain/death: the
                # deliberate transition wins (probe_and_update's
                # re-check closes the wide window; this closes the
                # residual one between that re-check and the write —
                # for BOTH probe outcomes: a green probe must not
                # readmit a drained replica, and a failed probe must
                # not flip it to EVICTED, where the next green probe
                # would readmit it)
                return
            old = replica.state
            replica.state = state
            _REPLICA_UP.labels(replica.name).set(
                1.0 if state == READY else 0.0)
        journal.emit("replica_state", replica=replica.name, prev=old,
                     state=state, deliberate=deliberate)
        log.info("replica %s: %s -> %s", replica.name, old, state)

    def _mark_dead(self, replica: Replica, reason: str) -> None:
        if replica.state == DEAD:
            return
        self._schedule_restart(replica, reason)

    def _schedule_restart(self, replica: Replica, reason: str) -> None:
        delay = self._backoff(replica.backoff_attempt)
        replica.backoff_attempt += 1
        replica.next_restart_at = time.monotonic() + delay
        self._set_state(replica, DEAD)
        log.warning("replica %s dead (%s); restart #%d in %.2fs",
                    replica.name, reason, replica.restarts + 1, delay)

    def _launch(self, replica: Replica) -> None:
        try:
            replica.launch()
            replica.probe_failures = 0
            replica.launched_at = time.monotonic()
            self._set_state(replica, STARTING)
        except Exception:  # noqa: BLE001 — a failed spawn re-enters
            # the backoff schedule instead of crashing the supervisor.
            # Restarts arrive here already DEAD, where _mark_dead's
            # idempotence guard would skip rescheduling and the next
            # monitor tick would retry the failing launch immediately —
            # schedule the next attempt unconditionally.
            log.exception("launching replica %s failed", replica.name)
            self._schedule_restart(replica, "launch failed")

    def _restart(self, replica: Replica) -> None:
        _RESTARTS.labels(replica.name).inc()
        replica.restarts += 1
        replica.terminate(drain=False)  # clear any half-dead remnant
        self._launch(replica)

    # -- rolling hot-swap ----------------------------------------------------
    def rolling_reload(self, force: bool = False) -> Dict[str, Any]:
        """Roll every live replica onto the newest COMPLETED instance,
        one at a time: wait for the REST of the fleet to be ready,
        drain this replica from rotation (router in-flight falls to
        zero), ``GET /reload`` (load + warm happens before the
        in-replica swap, so the replica itself never serves a cold
        model), then rejoin before the next replica drains — the fleet
        never drops below N-1 ready replicas and traffic never waits
        on a compile. DEAD replicas are skipped: their restart path
        already boots from the latest instance. ``force`` overrides
        each replica's device-memory preflight (obs/memacct.py — a
        refusal otherwise answers 507 and the replica rejoins on its
        old model)."""
        with self._swap_lock:
            with self._state_lock:
                self._swap = {"active": True, "started_unix": time.time(),
                              "last": self._swap.get("last")}
            journal.emit("swap", phase="start", forced=force)
            result = self._rolling_reload_locked(force=force)
            with self._state_lock:
                self._swap = {"active": False, "last": result}
            _SWAPS.labels(result["outcome"]).inc()
            journal.emit("swap", phase="end",
                         outcome=result["outcome"],
                         swapped=result["swapped"],
                         errors=len(result["errors"]) or None,
                         version=result["version"])
            return result

    def _rolling_reload_locked(self, force: bool = False) -> Dict[str, Any]:
        swapped: List[str] = []
        errors: List[str] = []
        for replica in list(self.replicas):
            if self._stop_evt.is_set():
                errors.append("fleet stopping")
                break
            if replica.state in (DEAD, STOPPED):
                continue
            if replica.state == DRAINING:
                # operator-held (pio fleet --drain): the swap must not
                # reload-and-readmit a replica someone deliberately
                # pulled for debugging — it picks the new version up
                # whenever it is readmitted or restarted
                errors.append(f"{replica.name}: operator-drained; "
                              "skipped")
                continue
            outcome = self._swap_one(replica, errors, force=force)
            if outcome == "abort":
                break
            if outcome == "swapped":
                swapped.append(replica.name)
        return {
            "outcome": "ok" if not errors else "partial",
            "swapped": swapped,
            "errors": errors,
            "version": self.version(),
            "finished_unix": round(time.time(), 3),
        }

    def _swap_one(self, replica: Replica, errors: List[str],
                  instance_id: Optional[str] = None,
                  force: bool = False) -> str:
        """Drain→reload→rejoin ONE replica under the fleet's N-1 floor
        guards — the shared core of the rolling swap and the canary
        lane (``instance_id`` targets a specific completed instance,
        the canary rollback; ``force`` overrides the replica's
        device-memory preflight). Appends operator-facing error
        strings; returns "swapped", "skip" (this replica failed/was
        skipped but siblings may proceed) or "abort" (the fleet never
        converged — nothing later can safely drain either)."""
        # hold the N-1 floor: every OTHER live replica must be
        # back in rotation before this one leaves it
        if not self._await_others_ready(replica, timeout=60.0):
            errors.append(f"{replica.name}: fleet never converged "
                          "to ready before drain")
            return "abort"
        # _await_others_ready converges VACUOUSLY when every peer
        # is DEAD/STOPPED — draining the last ready replica would
        # take the fleet to zero for a whole reload+warm window.
        # Skip it; dead peers boot onto the new version anyway.
        if not any(p.state == READY for p in self.replicas
                   if p is not replica):
            errors.append(f"{replica.name}: only ready replica — "
                          "refusing to drain the fleet to zero")
            return "skip"
        self._set_state(replica, DRAINING)
        if not self._await(lambda: replica.outstanding() == 0,
                           timeout=drain_timeout()):
            errors.append(f"{replica.name}: drain window expired "
                          f"with {replica.outstanding()} in flight")
            # proceed anyway: the replica keeps answering its
            # stragglers from the OLD model while it reloads
        status, body = self._reload(replica, instance_id, force=force)
        if status == 507:
            # the replica's OOM preflight (obs/memacct.py) refused the
            # candidate: a capacity verdict, not a failure — the
            # replica rejoins on its old model and the reason (sizes,
            # headroom) surfaces through `pio fleet` / /admin/fleet;
            # retry with {"force": true} to override
            errors.append(f"{replica.name}: preflight refused the "
                          f"deploy (507 insufficient device memory): "
                          f"{body}")
            journal.emit("preflight_refused", replica=replica.name,
                         instance=instance_id, detail=str(body)[:200])
        elif status != 200:
            errors.append(f"{replica.name}: reload answered "
                          f"{status}: {body}")
        if status != 200:
            # re-enter rotation on the old model: a failed swap
            # must degrade to "stale replica", never "lost replica"
            self._set_state(replica, EVICTED, deliberate=True)
            self.probe_and_update(replica)
            return "skip"
        self._refresh_version(replica)
        self._set_state(replica, EVICTED, deliberate=True)
        if not self._await(lambda: replica.state == READY,
                           timeout=60.0, probe=replica):
            errors.append(f"{replica.name}: not ready after reload")
            return "skip"
        return "swapped"

    def _reload(self, replica: Replica,
                instance_id: Optional[str] = None,
                force: bool = False):
        """One replica's ``GET /reload`` — generous timeout: the warm
        compile is exactly what we drained the replica to hide. With
        ``instance_id``, the replica reloads that SPECIFIC completed
        instance (``?instance=`` — the canary rollback lane);
        ``force=1`` overrides its device-memory preflight."""
        try:
            params = []
            if instance_id:
                params.append(
                    "instance=" + urllib.parse.quote(instance_id))
            if force:
                params.append("force=1")
            url = f"{replica.base_url}/reload"
            if params:
                url += "?" + "&".join(params)
            req = urllib.request.Request(
                url, headers=trace.traced_headers())
            reload_timeout = metrics.env_float(
                "PIO_FLEET_RELOAD_TIMEOUT", 300.0)
            with urllib.request.urlopen(req, timeout=reload_timeout) as resp:  # graftlint: disable=JT21 — _swap_lock exists to serialize rolling swaps fleet-wide: one replica drains/reloads at a time BY DESIGN; a concurrent swap is the outage this wait prevents
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode(errors="replace")[:200]
        except (OSError, ValueError) as e:
            return None, f"{type(e).__name__}: {e}"

    def _await(self, predicate: Callable[[], bool], timeout: float,
               probe: Optional[Replica] = None) -> bool:
        """Poll ``predicate`` to ``timeout``; with ``probe`` given, also
        re-probe that replica — PACED at the fleet's probe interval
        (the predicate polls at 50 Hz, but each probe is a full /readyz
        round on the target incl. storage round-trips; firing those at
        poll speed would hammer a replica that is busy converging)."""
        deadline = time.monotonic() + timeout
        interval = self.probe_interval()
        next_probe = 0.0
        while time.monotonic() < deadline:
            if predicate():
                return True
            now = time.monotonic()
            if probe is not None and now >= next_probe:
                self.probe_and_update(probe)
                next_probe = now + interval
            time.sleep(0.02)
        return bool(predicate())

    def _await_others_ready(self, replica: Replica,
                            timeout: float) -> bool:
        """Wait for every live replica EXCEPT ``replica`` to be READY,
        probing the laggards directly (the swap must not be hostage to
        the monitor's tick alignment) — paced at the probe interval,
        same rationale as ``_await``."""
        interval = self.probe_interval()
        next_probe = [0.0]

        def others_converged() -> bool:
            converged = True
            now = time.monotonic()
            may_probe = now >= next_probe[0]
            if may_probe:
                next_probe[0] = now + interval
            for peer in self.replicas:
                # DRAINING peers are operator-held: waiting on them
                # would deadlock the swap, probing them would readmit
                # them against the operator's intent — neither
                if peer is replica or peer.state in (DEAD, STOPPED,
                                                     DRAINING):
                    continue
                if peer.state != READY:
                    if may_probe:
                        self.probe_and_update(peer)
                    converged = converged and peer.state == READY
            return converged

        return self._await(others_converged, timeout)

    def start_rolling_reload(self, force: bool = False) -> bool:
        """Kick a rolling swap on a background thread (the admin/route
        entry point — a swap can take minutes of warm compile per
        replica). False when one is already running. ``force``
        overrides each replica's device-memory preflight."""
        with self._state_lock:
            # check-and-spawn atomically: two concurrent callers (an
            # operator /reload racing the auto-swap watch) must not both
            # see "no swap running" and queue two back-to-back swaps
            if self._stop_evt.is_set():
                return False
            if self._swap.get("active"):
                return False
            if self._canary.get("active") or (
                    self._canary_thread is not None
                    and self._canary_thread.is_alive()):
                # rolling everything would silently promote the
                # candidate — including during the DEPLOY window, where
                # _canary["active"] is still False but the canary
                # thread is mid-drain/reload; the canary verdict (or an
                # explicit promote/rollback) owns leaving the canary
                # state
                return False
            if (self._swap_thread is not None
                    and self._swap_thread.is_alive()):
                return False
            self._swap_thread = threading.Thread(
                target=self._swap_guarded, args=(force,), daemon=True,
                name="fleet-swap")
            self._swap_thread.start()
            return True

    def _swap_guarded(self, force: bool = False) -> None:
        try:
            self.rolling_reload(force=force)
        except Exception:  # noqa: BLE001 — a crashed background swap
            # must leave a visible verdict, not a forever-"active" state
            log.exception("rolling reload failed")
            with self._state_lock:
                self._swap = {"active": False,
                              "last": {"outcome": "crashed"}}

    # -- canary lane ---------------------------------------------------------
    def canary_mode(self) -> bool:
        """Whether a new COMPLETED instance should land as a CANARY
        (one replica + verdict) instead of a full rolling swap."""
        if self._canary_mode is not None:
            return self._canary_mode
        return metrics.env_int("PIO_FLEET_CANARY", 0) > 0

    def canary(self) -> Dict[str, Any]:
        with self._state_lock:
            return dict(self._canary)

    def canary_replica_name(self) -> Optional[str]:
        """The active canary replica's name, or None — the router's
        hot-path check (a plain attribute read, no lock)."""
        return self._canary_name

    def start_canary(self, force: bool = False) -> bool:
        """Kick a canary deploy on a background thread: the newest
        COMPLETED instance lands on exactly ONE replica through the
        drain→reload→rejoin machinery; the router then tags lanes and
        samples paired answers until a verdict (auto or operator)
        promotes or rolls back. False when a swap or canary is already
        running (or the fleet is stopping). ``force`` overrides the
        canary replica's device-memory preflight — an oversized
        candidate is otherwise refused (507) before it can OOM the
        replica, and the canary ends in an error verdict."""
        with self._state_lock:
            if self._stop_evt.is_set():
                return False
            if self._swap.get("active") or self._canary.get("active"):
                return False
            if (self._swap_thread is not None
                    and self._swap_thread.is_alive()):
                return False
            if (self._canary_thread is not None
                    and self._canary_thread.is_alive()):
                return False
            self._canary_thread = threading.Thread(
                target=self._canary_start_guarded, args=(force,),
                daemon=True, name="fleet-canary")
            self._canary_thread.start()
            return True

    def _canary_start_guarded(self, force: bool = False) -> None:
        try:
            self._start_canary(force=force)
        except Exception:  # noqa: BLE001 — a crashed canary deploy must
            # leave a visible verdict, not a forever-"starting" state
            log.exception("canary deploy failed")
            with self._state_lock:
                self._canary = {"active": False,
                                "last": {"outcome": "crashed"}}
            self._canary_name = None

    def _start_canary(self, force: bool = False) -> None:
        from predictionio_torch.obs import quality

        with self._swap_lock:  # a canary IS a (one-replica) swap:
            # serialize against rolling swaps so the two can never
            # drain the same fleet concurrently
            errors: List[str] = []
            baseline = self.version()
            candidate = None
            if self._version_source is not None:
                try:
                    candidate = self._version_source()
                except Exception as e:  # noqa: BLE001 — a storage blip
                    # is an error verdict, not a crash
                    errors.append(f"version source failed: {e}")
            if baseline is None:
                errors.append("fleet is not on a single version — "
                              "converge (rolling reload) before a canary")
            elif not candidate or candidate == baseline:
                errors.append("no NEW completed instance to canary "
                              f"(fleet already on {baseline})")
            replica = None
            if not errors:
                # the LAST ready replica: a stable, predictable pick
                # that keeps r0 (the one operators poke first) on the
                # baseline
                ready = self.ready_replicas()
                replica = ready[-1] if ready else None
                if replica is None:
                    errors.append("no ready replica to canary onto")
            if not errors:
                outcome = self._swap_one(replica, errors, force=force)
                if outcome != "swapped":
                    errors.append(f"{replica.name}: canary deploy did "
                                  "not reach READY on the candidate")
            if errors:
                with self._state_lock:
                    self._canary = {"active": False,
                                    "last": {"outcome": "error",
                                             "errors": errors}}
                log.warning("canary not started: %s", "; ".join(errors))
                return
            # arm the verdict's evidence window BEFORE the canary is
            # visible: once _canary_name is set, routers shadow and the
            # monitor may decide (and end the canary) at once, and a
            # window armed after that would reopen an ended canary and
            # wipe the pairs its verdict read
            quality.STATE.canary_begin(replica.name, baseline,
                                       replica.version or candidate)
            with self._state_lock:
                self._canary = {
                    "active": True,
                    "replica": replica.name,
                    "baseline_version": baseline,
                    "candidate_version": replica.version or candidate,
                    "started_unix": round(time.time(), 3),
                    # a force-started canary (the candidate failed the
                    # memory preflight) must promote with the same
                    # force, or every OTHER replica's 507 would strand
                    # the fleet permanently mixed
                    "forced": bool(force),
                }
            self._canary_name = replica.name
            journal.emit("canary_start", replica=replica.name,
                         baseline=baseline,
                         candidate=replica.version or candidate,
                         forced=bool(force) or None)
            log.info("canary ACTIVE: %s serves candidate %s against "
                     "baseline %s", replica.name, candidate, baseline)

    def _end_canary(self, outcome: str, verdict: Optional[Dict[str, Any]],
                    extra: Optional[Dict[str, Any]] = None) -> None:
        from predictionio_torch.obs import quality

        with self._state_lock:
            last = {**{k: v for k, v in self._canary.items()
                       if k not in ("active", "last", "deciding")},
                    "outcome": outcome, **(extra or {})}
            self._canary = {"active": False, "last": last}
        self._canary_name = None
        journal.emit("canary_verdict", outcome=outcome,
                     replica=last.get("replica"),
                     baseline=last.get("baseline_version"),
                     candidate=last.get("candidate_version"),
                     rejected=last.get("rejected_version"))
        quality.STATE.canary_end(
            outcome, {"verdict": verdict} if verdict else None)

    def promote_canary(self,
                       verdict: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
        """The candidate won: roll the REST of the fleet onto it
        through the ordinary rolling swap (the canary replica's reload
        is an idempotent no-op there). Clears the canary state first so
        the router stops shadow-sampling mid-promotion."""
        info = self.canary()
        if not info.get("active"):
            raise ValueError("no active canary to promote")
        log.info("canary verdict PROMOTE for %s: rolling the fleet onto "
                 "%s", info.get("replica"), info.get("candidate_version"))
        journal.emit("canary_promote", replica=info.get("replica"),
                     candidate=info.get("candidate_version"))
        self._end_canary("promoted", verdict)
        # a force-started canary promotes with the same force — the
        # operator already owned the OOM risk at start
        result = self.rolling_reload(force=bool(info.get("forced")))
        return {"action": "promote", "swap": result}

    def rollback_canary(self,
                        verdict: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
        """The candidate lost: swap the canary replica BACK onto the
        baseline instance (``/reload?instance=``) through the same
        drain→rejoin machinery — clients keep answering from the other
        replicas throughout."""
        info = self.canary()
        if not info.get("active"):
            raise ValueError("no active canary to roll back")
        replica = next((r for r in self.replicas
                        if r.name == info.get("replica")), None)
        baseline = info.get("baseline_version")
        log.warning("canary verdict ROLLBACK for %s: restoring baseline "
                    "%s", info.get("replica"), baseline)
        # stop shadow traffic first, then restore — the rejected
        # candidate version is remembered so the canary-mode watch does
        # not immediately re-canary it (see _maybe_auto_swap)
        journal.emit("canary_rollback", replica=info.get("replica"),
                     baseline=baseline,
                     rejected=info.get("candidate_version"))
        self._end_canary("rolled_back", verdict,
                         extra={"rejected_version":
                                info.get("candidate_version")})
        errors: List[str] = []
        if replica is None:
            errors.append(f"canary replica {info.get('replica')!r} is "
                          "gone")
        elif baseline:
            with self._swap_lock:
                # force=True: restoring the KNOWN-GOOD baseline is the
                # emergency exit from a degraded candidate — the
                # replica's in-use still counts the fat candidate it
                # is about to drop, so a preflight here could 507 the
                # very rollback that frees the memory
                outcome = self._swap_one(replica, errors,
                                         instance_id=baseline,
                                         force=True)
            if outcome != "swapped":
                errors.append(f"{replica.name}: rollback reload did not "
                              "reach READY on the baseline")
        else:
            errors.append("no baseline version recorded — leaving the "
                          "replica on the candidate")
        return {"action": "rollback", "errors": errors,
                "version": self.version()}

    def _maybe_canary_decision(self) -> None:
        """Monitor-loop hook: while a canary is active (and
        ``PIO_CANARY_AUTO`` is on, the default), read the verdict off
        obs/quality.py and act on it — promote/rollback run on a
        background thread (a promotion is a full rolling swap; the
        monitor must keep probing through it)."""
        if self._canary_name is None:
            return
        if metrics.env_int("PIO_CANARY_AUTO", 1) <= 0:
            return
        with self._state_lock:
            if not self._canary.get("active") or self._canary.get(
                    "deciding"):
                return
        from predictionio_torch.obs import quality

        verdict = quality.STATE.canary_verdict()
        action = verdict.get("verdict")
        if action not in ("promote", "rollback"):
            return
        with self._state_lock:
            if not self._canary.get("active") or self._canary.get(
                    "deciding"):
                return
            self._canary["deciding"] = True

        def decide() -> None:
            try:
                if action == "promote":
                    self.promote_canary(verdict)
                else:
                    self.rollback_canary(verdict)
            except Exception:  # noqa: BLE001 — a failed decision must
                # not strand the canary "deciding" forever
                log.exception("canary %s failed", action)
                with self._state_lock:
                    self._canary.pop("deciding", None)

        threading.Thread(target=decide, daemon=True,
                         name="fleet-canary-verdict").start()

    def _maybe_auto_swap(self) -> None:
        """With ``PIO_FLEET_WATCH_SEC`` > 0 and a version source, a new
        COMPLETED instance triggers the rolling swap automatically —
        train-to-serving with no operator in the loop. In canary mode
        the same watch starts a CANARY instead, and a candidate the
        last canary ROLLED BACK is never auto-retried (a fresh retrain
        — a new instance id — re-arms the watch)."""
        watch = metrics.env_float("PIO_FLEET_WATCH_SEC", 0.0)
        if watch <= 0 or self._version_source is None:
            return
        now = time.monotonic()
        if now - self._last_watch < watch:
            return
        self._last_watch = now
        try:
            latest = self._version_source()
        except Exception:  # noqa: BLE001 — storage blips must not kill
            # the monitor; the next watch tick retries
            log.exception("fleet version watch failed")
            return
        # any ready replica NOT on the latest instance means a swap is
        # due — including a mixed-version fleet left by a partial swap
        # (version() would be None there, and requiring it non-None
        # would leave the fleet stuck mixed forever) and replicas whose
        # version read failed (a redundant reload is idempotent)
        versions = {r.version for r in self.ready_replicas()}
        if not (latest and versions and versions != {latest}):
            return
        with self._state_lock:
            canary_active = self._canary.get("active")
            last = self._canary.get("last") or {}
        if last.get("rejected_version") == latest:
            # the quality gate ROLLED THIS INSTANCE BACK: neither watch
            # path may silently redeploy it (in non-canary mode the
            # full rolling swap would undo the rollback one watch tick
            # later) — a human decision or a NEW retrain re-arms
            log.debug("watch: latest instance %s was canary-rejected; "
                      "holding", latest)
            return
        if self.canary_mode():
            if canary_active:
                return  # the mixed fleet IS the canary
            log.info("COMPLETED instance %s vs fleet on %s: starting "
                     "CANARY", latest, sorted(str(v) for v in versions))
            self.start_canary()
            return
        log.info("COMPLETED instance %s vs fleet on %s: starting "
                 "rolling swap", latest,
                 sorted(str(v) for v in versions))
        self.start_rolling_reload()

    # -- introspection -------------------------------------------------------
    def version(self) -> Optional[str]:
        """The fleet's serving version: the version shared by every
        ready replica, else None (mid-swap / mixed)."""
        versions = {r.version for r in self.ready_replicas() if r.version}
        return versions.pop() if len(versions) == 1 else None

    def _fleet_probe(self) -> health.ProbeResult:
        """Informational fleet probe on the process-global registry.
        DEGRADED at worst, never FAILED: in the threaded tier-1 mode
        the replicas SHARE this registry, and a FAILED fleet probe
        would 503 every replica's own /readyz — a bootstrap deadlock
        (no replica can become ready while none is). The hard "cannot
        place a query" verdict lives in the router's readyz override
        (serving/router.py), which only that server reports."""
        ready, size = self.ready_count(), self.size()
        if ready < size:
            return health.degraded(f"{ready}/{size} replicas ready")
        return health.ok(f"{ready}/{size} replicas ready")

    def _timeline_collector(self, _now: float) -> Dict[str, float]:
        return {"fleet.ready": float(self.ready_count()),
                "fleet.size": float(self.size())}

    def snapshot(self) -> Dict[str, Any]:
        with self._state_lock:
            swap = dict(self._swap)
            canary = dict(self._canary)
        return {
            "size": self.size(),
            "ready": self.ready_count(),
            "version": self.version(),
            "replicas": [r.snapshot() for r in self.replicas],
            "swap": swap,
            "canary": canary,
        }

    def apply_admin(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """``POST /admin/fleet`` body -> action. ``{"reload": true}``
        starts a rolling swap (202 from the route; ``started`` False
        when one is already running), ``{"drain": name}`` /
        ``{"readmit": name}`` move a replica out of / back into
        rotation, ``{"canary": "start"|"promote"|"rollback"}`` drives
        the canary lane (start answers 202 and deploys on a background
        thread; promote/rollback run their swap in the background
        too — progress in the snapshot's ``canary`` block).
        ``{"force": true}`` beside ``reload``/``canary: start``
        overrides the replicas' device-memory preflight — the admin
        acknowledgment lane for a 507-refused deploy. Raises
        ValueError on anything else (the route answers 400)."""
        if not isinstance(payload, dict):
            raise ValueError("fleet admin body must be a JSON object")
        force = bool(payload.get("force"))
        requested = [k for k in ("reload", "drain", "readmit", "canary")
                     if payload.get(k)]
        if len(requested) > 1:
            # only the first in precedence would run; silently dropping
            # the rest would leave the operator believing both happened
            raise ValueError("one action per call, got: "
                             + ", ".join(requested))
        if payload.get("canary"):
            action = payload["canary"]
            if action == "start":
                started = self.start_canary(force=force)
                return {"started": started,
                        "message": ("canary deploy started" if started
                                    else "a canary or rolling swap is "
                                         "already running")}
            if action in ("promote", "rollback"):
                if not self.canary().get("active"):
                    raise ValueError("no active canary to " + action)
                runner = (self.promote_canary if action == "promote"
                          else self.rollback_canary)

                def run_decision() -> None:
                    try:
                        runner()
                    except Exception:  # noqa: BLE001 — the operator
                        # reads the outcome off the snapshot; a crashed
                        # decision must be logged, not silent
                        log.exception("canary %s failed", action)

                threading.Thread(target=run_decision, daemon=True,
                                 name="fleet-canary-admin").start()
                return {"started": True,
                        "message": f"canary {action} started"}
            raise ValueError('canary action must be "start", "promote" '
                             'or "rollback"')
        if payload.get("reload"):
            started = self.start_rolling_reload(force=force)
            return {"started": started,
                    "message": ("rolling reload started" if started
                                else "a rolling reload is already "
                                     "running")}
        for action, state in (("drain", DRAINING), ("readmit", EVICTED)):
            name = payload.get(action)
            if name:
                replica = next((r for r in self.replicas
                                if r.name == name), None)
                if replica is None:
                    raise ValueError(f"no replica named {name!r}")
                if action == "drain" and replica.state in (DEAD, STOPPED):
                    # draining a DEAD replica would cancel its pending
                    # restart forever (_tick skips DRAINING) and report
                    # a dead process as deliberately held
                    raise ValueError(
                        f"replica {name!r} is {replica.state}, not in "
                        "rotation — nothing to drain")
                if action == "readmit" and replica.state == DEAD:
                    # flipping a DEAD replica to EVICTED would bypass
                    # the restart branch and trade its almost-due
                    # restart for a fresh (longer) backoff; the
                    # operator's intent is "bring it back NOW" — skip
                    # the remaining wait, the next tick relaunches it
                    replica.next_restart_at = 0.0
                    return {"replica": name, "state": replica.state,
                            "message": "dead replica: restart "
                                       "fast-tracked"}
                if action == "readmit" and replica.state == STOPPED:
                    raise ValueError(
                        f"replica {name!r} is stopped — the fleet is "
                        "shutting down")
                self._set_state(replica, state, deliberate=True)
                if state == EVICTED:
                    self.probe_and_update(replica)  # readmit fast
                return {"replica": name, "state": replica.state}
        raise ValueError('fleet admin body needs "reload", "drain", '
                         '"readmit" or "canary"')


def format_swap(swap: Optional[Dict[str, Any]]) -> str:
    """One operator-facing line for ``snapshot()['swap']`` — the CLI
    and the dashboard render the same state through the same string."""
    swap = swap or {}
    if swap.get("active"):
        return "rolling swap: IN PROGRESS"
    last = swap.get("last")
    if not last:
        return "no rolling swap yet"
    line = (f"last swap: {last.get('outcome')} "
            f"(swapped {', '.join(last.get('swapped') or []) or 'none'}")
    if last.get("errors"):
        line += "; errors: " + "; ".join(last["errors"])
    return line + ")"


def deploy_fleet_argv(engine_json: str, ip: str = "127.0.0.1",
                      device: Optional[str] = None) -> List[str]:
    """The argv template a subprocess fleet spawns per replica: a
    plain single-server port ``cli deploy`` child with a ``{port}``
    placeholder (the supervisor fills an ephemeral port per launch),
    on ``device`` (the parent's ``--device``; None = the card).

    ``--replicas 1`` is explicit and load-bearing: the child inherits
    the parent's environment, so a fleet started via ``PIO_REPLICAS=N``
    would otherwise re-enter the fleet path in every child and spawn
    grandchildren recursively — a fork bomb, not a fleet."""
    argv = [sys.executable, "-m", "predictionio_torch.tools.cli",
            "deploy", "--engine-json", engine_json, "--replicas", "1",
            "--ip", ip, "--port", "{port}"]
    if device is not None:
        argv += ["--device", str(device)]
    return argv
