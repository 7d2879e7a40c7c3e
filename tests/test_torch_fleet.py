"""The port's serving fleet: the replica supervisor, the health-routed
query router, the rolling hot-swap and the canary lane
(``predictionio_torch/serving/{fleet,router}.py``).

Fleets here are threaded fleets of port engine servers on the CPU,
serving a constant engine (``tests/torch_operator_fixtures.py``), in one
process: the router balances them, answers 503 with no replica in
rotation, passes shed and degraded answers through, hedges around a
replica hung by a tagged chaos rule, finishes a rolling reload under
load with no failed query, promotes or rolls back a canary by verdict,
restarts a killed replica on the schedule the JAX supervisor follows
for the same ``Policy``, and gates ``/admin/fleet`` behind the admin
token. One test launches a subprocess replica of the port's CLI. Each
test is named after the JAX test it mirrors in ``tests/test_fleet.py``
or ``tests/test_canary.py``; every fixture stops and joins what it
started, and intervals are set to milliseconds through ``monkeypatch``.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import sys
import threading
import urllib.error
import urllib.request

import pytest

from predictionio_torch.data.storage import Storage
from predictionio_torch.obs import metrics, quality
from predictionio_torch.resilience import chaos
from predictionio_torch.resilience.admission import ShedDecision
from predictionio_torch.resilience.policy import Policy
from predictionio_torch.serving import fleet as fleet_mod
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.serving.fleet import (DEAD, READY, FleetSupervisor,
                                              SubprocessReplica,
                                              deploy_fleet_argv,
                                              subprocess_fleet,
                                              threaded_fleet)
from predictionio_torch.serving.router import QueryRouter
from predictionio_torch.workflow.deploy import latest_completed_instance_id

from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state,
                                           train_const, wait_for)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def post(url, body=b'{"mult": 2}', headers=None, timeout=30):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def counter_value(name, *labels):
    family = metrics.REGISTRY.get(name)
    if family is None:
        return 0.0
    return family.labels(*labels).value if labels else family.value


@pytest.fixture()
def store():
    return Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})


@pytest.fixture(autouse=True)
def _fast_fleet(monkeypatch):
    """Millisecond restart backoff and drain windows; a probe deadline a
    loaded test host cannot miss (a killed replica refuses at once)."""
    monkeypatch.setenv("PIO_FLEET_PROBE_DEADLINE", "10")
    monkeypatch.setenv("PIO_FLEET_BACKOFF_BASE", "0.01")
    monkeypatch.setenv("PIO_FLEET_BACKOFF_CAP", "0.05")
    monkeypatch.setenv("PIO_DRAIN_TIMEOUT", "5")


@contextlib.contextmanager
def running_fleet(storage, engine, n=3, engine_id="const", backoff=None,
                  canary_mode=None, rng_seed=0):
    """N threaded port replicas on the CPU behind a router on an
    ephemeral port; yields (fleet, router, base_url). Everything it
    started is stopped and joined on exit."""
    def factory(name):
        return EngineServer(engine, engine_id, host="127.0.0.1", port=0,
                            storage=storage, device="cpu", max_batch=8,
                            chaos_tag=name)

    with no_thread_left():
        fleet = FleetSupervisor(
            threaded_fleet(n, factory), probe_interval=0.05,
            backoff=backoff, canary_mode=canary_mode,
            version_source=lambda: latest_completed_instance_id(
                storage, engine_id)).start()
        router = None
        try:
            assert fleet.wait_ready(timeout=60), fleet.snapshot()
            router = QueryRouter(fleet, host="127.0.0.1", port=0,
                                 rng=random.Random(rng_seed)).start()
            yield fleet, router, f"http://127.0.0.1:{router.port}"
        finally:
            chaos.clear()
            if router is not None:
                router.stop()
            fleet.stop()


@contextlib.contextmanager
def load(base, failures, results, threads=2):
    """Continuous client load through the router; every answer that is
    not 200 or 429, and every transport error, is a failure."""
    stop = threading.Event()

    def loader():
        # paced, so the load stays continuous without taking every core
        # of a shared test host
        while not stop.wait(0.002):
            try:
                status, body, _ = post(base + "/queries.json")
                results.append(status)
                if status not in (200, 429):
                    failures.append((status, body[:200]))
            except Exception as e:  # noqa: BLE001 — a transport error
                # is the outage the fleet must prevent
                failures.append(("transport", repr(e)))

    workers = [threading.Thread(target=loader) for _ in range(threads)]
    for t in workers:
        t.start()
    try:
        yield
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=60)


# -- routing basics -------------------------------------------------------------

def test_fleet_starts_routes_and_balances(store, monkeypatch):
    monkeypatch.setenv("PIO_HEDGE_QUANTILE", "0")   # exact counts
    engine, _ = train_const(store)
    with running_fleet(store, engine) as (fleet, router, base):
        served = set()
        for _ in range(24):
            status, body, headers = post(base + "/queries.json")
            assert status == 200, body
            assert json.loads(body) == {"result": 6.0}
            served.add(headers["X-PIO-Replica"])
        assert len(served) >= 2, served
        counts = {r.name: r.server.stats.snapshot()["requestCount"]
                  for r in fleet.replicas}
        assert sum(counts.values()) == 24, counts
        status, text, _ = get(base + "/admin/fleet")
        snap = json.loads(text)
        assert status == 200 and snap["ready"] == snap["size"] == 3
        assert {r["state"] for r in snap["replicas"]} == {READY}
        status, text, _ = get(base + "/readyz")
        assert status == 200 and json.loads(text)["status"] == "ok"


def test_router_503_when_nothing_in_rotation(store):
    engine, _ = train_const(store)
    with running_fleet(store, engine, n=1) as (fleet, router, base):
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"drain": "r0"}).encode())
        assert status == 200, body
        status, body, headers = post(base + "/queries.json")
        assert status == 503 and headers["Retry-After"] == "1", body
        assert get(base + "/readyz")[0] == 503
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"readmit": "r0"}).encode())
        assert status == 200, body
        assert fleet.wait_ready(timeout=30)
        assert post(base + "/queries.json")[0] == 200


def test_router_passes_through_shed_and_degraded(store, monkeypatch):
    engine, _ = train_const(store)
    with running_fleet(store, engine) as (fleet, router, base):
        calls = {"n": 0}

        def always_shed():
            calls["n"] += 1
            return ShedDecision("queue_depth", 7, "test shed")

        for r in fleet.replicas:
            monkeypatch.setattr(r.server.admission, "check", always_shed)
        shed_before = counter_value("pio_router_passthrough_total", "shed")
        status, body, headers = post(base + "/queries.json")
        assert status == 429 and headers["Retry-After"] == "7", body
        assert json.loads(body)["reason"] == "queue_depth"
        assert calls["n"] == 1       # the shed was not retried elsewhere
        assert counter_value("pio_router_passthrough_total",
                             "shed") == shed_before + 1
        for r in fleet.replicas:
            monkeypatch.setattr(r.server.admission, "check", lambda: None)
        # open every replica's storage circuit: answers keep coming,
        # stamped degraded through the router hop
        for r in fleet.replicas:
            r.server._storage_breaker.record_failure()
            r.server._storage_breaker.record_failure()
        deg_before = counter_value("pio_router_passthrough_total",
                                   "degraded")
        status, body, headers = post(base + "/queries.json")
        assert status == 200, body
        assert "last-loaded instance" in headers["X-PIO-Degraded"]
        assert counter_value("pio_router_passthrough_total",
                             "degraded") == deg_before + 1


def test_hedge_rescues_hung_replica(store, monkeypatch):
    """A replica whose dispatch is hung by ``batcher@r1:hang`` answers
    no query: the hedge past the trailing-quantile deadline races r0,
    whose answer wins while the hung primary is still in flight."""
    monkeypatch.setenv("PIO_HEDGE_MIN_MS", "40")
    engine, _ = train_const(store)
    with running_fleet(store, engine, n=2) as (fleet, router, base):
        for _ in range(25):   # past HedgeClock.min_samples
            assert post(base + "/queries.json")[0] == 200
        assert router.hedge.deadline() is not None
        hedges = counter_value("pio_router_hedges_total")
        rescues = counter_value("pio_router_hedge_rescues_total")
        chaos.configure("batcher@r1:hang:1.5s")
        answered = []
        for _ in range(40):
            status, body, headers = post(base + "/queries.json")
            assert status == 200, body
            answered.append(headers["X-PIO-Replica"])
            if counter_value("pio_router_hedge_rescues_total") > rescues:
                break
        chaos.clear()
        assert counter_value("pio_router_hedges_total") > hedges
        assert counter_value("pio_router_hedge_rescues_total") > rescues
        # the rescued answer came from the healthy replica
        assert answered[-1] == "r0", answered


# -- acceptance: kill, restart, rolling hot-swap under load ----------------------

def test_fleet_chaos_acceptance(store, monkeypatch):
    """Three replicas under continuous load: one is killed and the
    supervisor restarts it; a rolling hot-swap onto a newly trained
    instance then finishes while queries keep answering, with no answer
    other than 200 (or a 429 shed) and never fewer than two replicas
    in rotation."""
    monkeypatch.setenv("PIO_HEDGE_MIN_MS", "50")
    engine, _ = train_const(store)
    with running_fleet(store, engine) as (fleet, router, base):
        failures, results = [], []
        with load(base, failures, results):
            victim = fleet.replicas[0]
            victim.kill()
            wait_for(lambda: victim.restarts >= 1 and victim.state == READY,
                     60, "the killed replica's restart")
            assert counter_value("pio_fleet_restarts_total", "r0") >= 1
            _, new_instance = train_const(store, value=5.0)
            min_ready = [fleet.size()]
            done = threading.Event()

            def sampler():
                while not done.is_set():
                    min_ready.append(fleet.ready_count())
                    done.wait(0.005)

            sampling = threading.Thread(target=sampler)
            sampling.start()
            try:
                result = fleet.rolling_reload()
            finally:
                done.set()
                sampling.join(timeout=10)
            assert result["outcome"] == "ok", result
            assert sorted(result["swapped"]) == ["r0", "r1", "r2"]
            assert min(min_ready) >= 2, min(min_ready)
            assert fleet.version() == new_instance.id
            n_before_swap_end = len(results)
            wait_for(lambda: len(results) > n_before_swap_end + 10, 30,
                     "queries after the swap")
        assert not failures, failures[:5]
        assert results.count(200) > 20, len(results)
        status, body, _ = post(base + "/queries.json")
        assert status == 200 and json.loads(body) == {"result": 12.0}


# -- the canary lane -------------------------------------------------------------

def _drive_until(base, predicate, what, timeout=60):
    """Send queries, one per poll, until ``predicate`` holds."""
    def step():
        status, body, _ = post(base + "/queries.json")
        assert status in (200, 429), body
        return predicate()
    wait_for(step, timeout, what)


def _canary_env(monkeypatch):
    monkeypatch.setenv("PIO_CANARY_MIN_PAIRS", "4")
    monkeypatch.setenv("PIO_CANARY_SAMPLE_EVERY", "1")
    monkeypatch.setenv("PIO_HEDGE_QUANTILE", "0")
    # the latency gate must not read CPU jitter as a regression: these
    # two tests decide on answers
    monkeypatch.setenv("PIO_SLO_LATENCY_MS", "60000")


def test_good_candidate_is_auto_promoted(store, monkeypatch):
    _canary_env(monkeypatch)
    engine, baseline = train_const(store)
    with running_fleet(store, engine) as (fleet, router, base):
        _, candidate = train_const(store)     # the same answers
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"canary": "start"}).encode())
        assert status == 202, body
        wait_for(lambda: fleet.canary().get("active"), 60, "canary active")
        info = fleet.canary()
        assert info["baseline_version"] == baseline.id
        assert info["candidate_version"] == candidate.id
        assert [r.version for r in fleet.replicas].count(candidate.id) == 1
        _drive_until(base, lambda: (fleet.canary().get("last") or {}).get(
            "outcome") == "promoted", "the auto-promotion")
        wait_for(lambda: fleet.version() == candidate.id, 60,
                 "the fleet on the candidate")
        ended = quality.STATE.canary()
        assert ended["outcome"] == "promoted"
        assert ended["verdict"]["verdict"] == "promote"
        assert ended["verdict"]["pairs"] >= 4


def test_degraded_candidate_is_auto_rolled_back(store, monkeypatch):
    """A candidate whose answers differ fails the verdict's quality
    gate: the canary replica goes back onto the baseline instance."""
    _canary_env(monkeypatch)
    engine, baseline = train_const(store)
    with running_fleet(store, engine) as (fleet, router, base):
        _, candidate = train_const(store, value=9.0)
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"canary": "start"}).encode())
        assert status == 202, body
        wait_for(lambda: fleet.canary().get("active"), 60, "canary active")
        canary_name = fleet.canary_replica_name()
        _drive_until(base, lambda: (fleet.canary().get("last") or {}).get(
            "outcome") == "rolled_back", "the auto-rollback")
        replica = next(r for r in fleet.replicas if r.name == canary_name)
        wait_for(lambda: (replica.state == READY
                          and replica.version == baseline.id), 60,
                 "the canary replica back on the baseline")
        assert fleet.version() == baseline.id
        ended = quality.STATE.canary()
        assert ended["outcome"] == "rolled_back"
        assert ended["verdict"]["verdict"] == "rollback"
        assert any("quality" in r for r in ended["verdict"]["reasons"])
        assert fleet.canary()["last"]["rejected_version"] == candidate.id


@pytest.mark.parametrize("candidate_value", [2.0, 9.0])
def test_a_canary_start_descheduled_after_it_is_visible_still_ends(
        store, monkeypatch, candidate_value):
    """The canary-start thread arms the verdict's evidence window before
    it makes the canary visible, so a start descheduled right after
    (simulated: the journal's ``canary_start`` line takes 2 s) cannot
    reopen a canary the monitor has meanwhile promoted or rolled back.
    Under load that window once ended a promoted canary with its quality
    record still active."""
    _canary_env(monkeypatch)
    real_emit = fleet_mod.journal.emit

    def slow_emit(kind, **fields):
        if kind == "canary_start":
            threading.Event().wait(2.0)
        return real_emit(kind, **fields)

    monkeypatch.setattr(fleet_mod.journal, "emit", slow_emit)
    armed = []
    real_begin = quality.STATE.canary_begin
    engine, baseline = train_const(store)
    with running_fleet(store, engine) as (fleet, router, base):

        def begin(*args, **kwargs):
            armed.append((fleet.canary_replica_name(),
                          fleet.canary().get("active")))
            return real_begin(*args, **kwargs)

        monkeypatch.setattr(quality.STATE, "canary_begin", begin)
        _, candidate = train_const(store, value=candidate_value)
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"canary": "start"}).encode())
        assert status == 202, body
        outcome = "promoted" if candidate_value == 2.0 else "rolled_back"
        wait_for(lambda: fleet.canary().get("active"), 60, "canary active")
        _drive_until(base, lambda: (fleet.canary().get("last") or {}).get(
            "outcome") == outcome, f"the auto verdict ({outcome})")
        wait_for(lambda: quality.STATE.canary().get("outcome") == outcome,
                 60, "the quality record's end")
        assert armed == [(None, False)]
        ended = quality.STATE.canary()
        assert ended["active"] is False
        assert ended["candidate_version"] == candidate.id
        assert ended["baseline_version"] == baseline.id


# -- the supervisor's restart schedule -------------------------------------------

def _restart_schedule(make_fleet, seed):
    """Kill r0 twice; the (attempt, delay) pairs the supervisor asked
    the policy's backoff for, the restarts made, the final state."""
    policy = Policy(deadline=10.0, retries=0, backoff_base=0.01,
                    backoff_cap=0.04)
    rng = random.Random(seed)
    asked = []

    def backoff(attempt):
        delay = policy.backoff_seconds(attempt, rng)
        asked.append((attempt, delay))
        return delay

    fleet = make_fleet(backoff)
    try:
        assert fleet.wait_ready(timeout=60), fleet.snapshot()
        victim = fleet.replicas[0]
        for expected in (1, 2):
            victim.kill()
            wait_for(lambda: victim.restarts >= expected
                     and victim.state == READY, 60, "a restart")
        return asked, victim.restarts, victim.state
    finally:
        fleet.stop()


def test_supervisor_restart_backoff_schedule(store, memory_storage):
    from predictionio_tpu.serving.engine_server import (
        EngineServer as JaxServer)
    from predictionio_tpu.serving.fleet import (
        FleetSupervisor as JaxSupervisor)
    from predictionio_tpu.serving.fleet import threaded_fleet as jax_fleet

    from tests.test_health import train_const as jax_train_const

    port_engine, _ = train_const(store)
    jax_engine, _ = jax_train_const(memory_storage)
    restarts_before = counter_value("pio_fleet_restarts_total", "r0")

    def port_fleet(backoff):
        return FleetSupervisor(threaded_fleet(2, lambda name: EngineServer(
            port_engine, "const", host="127.0.0.1", port=0, storage=store,
            device="cpu", chaos_tag=name)), probe_interval=0.05,
            backoff=backoff).start()

    def jax_fleet_of_two(backoff):
        return JaxSupervisor(jax_fleet(2, lambda name: JaxServer(
            jax_engine, "const", host="127.0.0.1", port=0,
            storage=memory_storage, chaos_tag=name)), probe_interval=0.05,
            backoff=backoff).start()

    with no_thread_left():
        port = _restart_schedule(port_fleet, 17)
        jax = _restart_schedule(jax_fleet_of_two, 17)
    assert port == jax
    assert [a for a, _ in port[0]] == [0, 1] and port[1:] == (2, READY)
    assert counter_value("pio_fleet_restarts_total",
                         "r0") == restarts_before + 2


def test_drained_replica_crash_is_detected(store):
    engine, _ = train_const(store)
    with running_fleet(store, engine, n=2) as (fleet, router, base):
        replica = fleet.replicas[0]
        assert post(base + "/admin/fleet",
                    body=json.dumps({"drain": "r0"}).encode())[0] == 200
        replica.kill()
        wait_for(lambda: replica.restarts >= 1 or replica.state == DEAD,
                 30, "the parked replica's death noticed")


# -- the operator surface ----------------------------------------------------------

def test_admin_fleet_auth_and_reload_control(store, monkeypatch):
    engine, _ = train_const(store)
    with running_fleet(store, engine, n=2) as (fleet, router, base):
        monkeypatch.setenv("PIO_ADMIN_TOKEN", "s3cret")
        assert get(base + "/admin/fleet")[0] == 401
        assert get(base + "/reload")[0] == 401
        status, text, _ = get(base + "/")
        assert status == 200
        assert json.loads(text)["fleet"] == {"size": 2, "ready": 2}
        auth = {"Authorization": "Bearer s3cret"}
        status, text, _ = get(base + "/admin/fleet", headers=auth)
        assert status == 200 and json.loads(text)["size"] == 2
        monkeypatch.delenv("PIO_ADMIN_TOKEN")

        _, new_instance = train_const(store, value=3.0)
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"reload": True}).encode())
        assert status == 202, body
        status, body, _ = post(base + "/admin/fleet",
                               body=json.dumps({"reload": True}).encode())
        assert status == 409, body
        snap = wait_for(lambda: (lambda s: s if (
            not s["swap"]["active"] and s["swap"]["last"] is not None)
            else None)(json.loads(get(base + "/admin/fleet")[1])), 60,
            "the swap's end")
        assert snap["swap"]["last"]["outcome"] == "ok", snap
        assert snap["version"] == new_instance.id
        assert fleet_mod.format_swap(snap["swap"]).startswith(
            "last swap: ok")
        status, body, _ = post(
            base + "/admin/fleet",
            body=json.dumps({"drain": "r0", "readmit": "r1"}).encode())
        assert status == 400 and "one action per call" in body
        # a server that supervises no fleet answers 404
        assert get(f"http://127.0.0.1:{fleet.replicas[0].port}"
                   "/admin/fleet")[0] == 404


def test_fleet_stop_removes_timeline_collector(store):
    """A stopped fleet leaves neither its timeline collector nor its
    ``fleet`` readiness probe behind (a stale probe would read its dead
    replicas as DEGRADED in every later /readyz of the process)."""
    from predictionio_torch.obs import health, timeline

    engine, _ = train_const(store)
    before = len(timeline.TIMELINE._collectors)
    with running_fleet(store, engine, n=1):
        assert len(timeline.TIMELINE._collectors) == before + 1
        assert "fleet" in health.REGISTRY.names()
    assert len(timeline.TIMELINE._collectors) == before
    assert "fleet" not in health.REGISTRY.names()


def test_chaos_clear_site_drops_tagged_rules():
    chaos.configure("batcher:latency:10ms,batcher@r1:hang:5s,"
                    "storage:error:0.5")
    chaos.clear("batcher")
    assert [r.site for r in chaos.active()] == ["storage"]
    chaos.configure("batcher@r1:hang:5s,batcher@r2:hang:5s")
    chaos.clear("batcher@r1")
    assert [r.site for r in chaos.active()] == ["batcher@r2"]
    chaos.clear()


# -- the one subprocess replica ----------------------------------------------------

def test_subprocess_argv_forces_single_server_children(tmp_path, monkeypatch):
    """A fleet of one subprocess replica of the port's CLI on the CPU:
    its argv pins ``--replicas 1`` and the parent's ``--device``, and
    ``PIO_CHAOS_TAG`` reaches the serving process, whose batcher probe
    carries the replica's name."""
    argv = deploy_fleet_argv("engine.json", device="cpu")
    assert argv[:4] == [sys.executable, "-m",
                        "predictionio_torch.tools.cli", "deploy"]
    joined = " ".join(argv)
    assert "--replicas 1" in joined and "--device cpu" in joined
    assert "--device" not in deploy_fleet_argv("engine.json")

    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "FS"
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("PIO_REPLICAS", "3")   # must not recurse
    storage = Storage.from_env(env)
    _, instance = train_const(storage, engine_id="const-sub")
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "default", "engineId": "const-sub",
        "engineFactory": "tests.torch_operator_fixtures.const_engine"}))

    argv = deploy_fleet_argv(str(engine_json), device="cpu")
    members = subprocess_fleet(1, argv)
    assert isinstance(members[0], SubprocessReplica)
    fleet = FleetSupervisor(members, probe_interval=0.05)
    try:
        fleet.start()
        assert fleet.wait_ready(timeout=120), fleet.snapshot()
        replica = members[0]
        base = replica.base_url
        with open(f"/proc/{replica.proc.pid}/cmdline", "rb") as f:
            child_argv = f.read().split(b"\0")
        assert b"predictionio_torch.tools.cli" in child_argv
        assert child_argv[child_argv.index(b"--replicas") + 1] == b"1"
        assert child_argv[child_argv.index(b"--device") + 1] == b"cpu"
        status, text, _ = get(base + "/")
        assert status == 200
        page = json.loads(text)
        assert page["device"] == "cpu"
        assert page["engineInstanceId"] == instance.id
        probes = json.loads(get(base + "/readyz")[1])["probes"]
        assert "serving_queue:r0" in probes
        status, body, _ = post(base + "/queries.json")
        assert status == 200 and json.loads(body) == {"result": 6.0}
    finally:
        fleet.stop()
        proc = members[0].proc
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert members[0].proc is None
