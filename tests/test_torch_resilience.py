"""The port's resilience layer and SLOs against the JAX package's
(``predictionio_torch/resilience/``, ``obs/slo.py``).

The same inputs go through both packages and the outputs must be equal:
``Policy`` backoff schedules drawn from the same ``random.Random(seed)``
and its retry and breaker outcomes, circuit-breaker state sequences on
the same injected clock steps (the JAX module's ``time`` is patched in
the test; nothing in the JAX package changes), chaos spec parsing, rule
descriptions and seeded error draws, ``AdmissionController`` decisions
over a grid of queue-depth, in-flight and burn signals,
``SLOMonitor.report(now=...)`` over the same observations, and the
alert webhook's payloads. Each test is named after the JAX test it
mirrors in ``tests/test_resilience.py``.
"""

from __future__ import annotations

import http.server
import json
import random
import threading

import pytest

from predictionio_torch.obs import health as port_health
from predictionio_torch.obs import metrics as port_metrics
from predictionio_torch.obs import slo as port_slo
from predictionio_torch.resilience import admission as port_admission
from predictionio_torch.resilience import alerts as port_alerts
from predictionio_torch.resilience import chaos as port_chaos
from predictionio_torch.resilience import policy as port_policy
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import slo as jax_slo
from predictionio_tpu.resilience import admission as jax_admission
from predictionio_tpu.resilience import alerts as jax_alerts
from predictionio_tpu.resilience import chaos as jax_chaos
from predictionio_tpu.resilience import policy as jax_policy

from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state, wait_for)

PACKAGES = {"jax": jax_policy, "port": port_policy}


class FakeClock:
    """``time()`` and ``monotonic()`` that move only when told to."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def time(self) -> float:
        return 1.7e9 + self.now

    def monotonic(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


# -- Policy: retry budget + full-jitter backoff --------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("base,cap", [(0.2, 1.0), (0.5, 30.0),
                                      (0.05, 0.05)])
def test_backoff_full_jitter_bounds(seed, base, cap):
    schedules = {}
    for name, mod in PACKAGES.items():
        p = mod.Policy(backoff_base=base, backoff_cap=cap)
        rng = random.Random(seed)
        schedules[name] = [p.backoff_seconds(a % 8, rng) for a in range(64)]
    assert schedules["port"] == schedules["jax"]
    for attempt, d in enumerate(schedules["port"]):
        assert 0.0 <= d <= min(cap, base * 2 ** (attempt % 8))


def _run_policy(mod, scenario: str):
    """One Policy.run scenario: (calls made, outcome, sleeps taken,
    breaker state)."""
    calls = {"n": 0}
    sleeps = []
    breaker = None

    def always_down():
        calls["n"] += 1
        raise ConnectionRefusedError("nope")

    def bad_request():
        calls["n"] += 1
        raise ValueError("your fault, not the network's")

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionResetError("blip")
        return "ok"

    kwargs = {"sleep": sleeps.append}
    if scenario == "exhausted":
        p, fn = mod.Policy(retries=3), always_down
    elif scenario == "exhausted_raise":
        p, fn = mod.Policy(retries=3), always_down
        kwargs["raise_exhausted"] = True
    elif scenario == "non_idempotent":
        p, fn = mod.Policy(retries=3), always_down
        kwargs["idempotent"] = False
    elif scenario == "application_error":
        p, fn = mod.Policy(retries=5), bad_request
    elif scenario == "transient":
        p, fn = mod.Policy(retries=3), flaky
    elif scenario == "open_circuit":
        breaker = mod.CircuitBreaker("parity-fast", failure_threshold=1,
                                     reset_timeout=60.0)
        breaker.record_failure()
        p, fn = mod.Policy(), flaky
    elif scenario == "admitted_keeps_budget":
        breaker = mod.CircuitBreaker("parity-midcall", failure_threshold=2,
                                     reset_timeout=60.0)
        p, fn = mod.Policy(retries=3), flaky
    else:
        raise AssertionError(scenario)
    if breaker is not None:
        kwargs["breaker"] = breaker
    try:
        outcome = ("returned", p.run(fn, **kwargs))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        outcome = ("raised", type(e).__name__,
                   getattr(e, "attempts", None))
    return (calls["n"], outcome, len(sleeps),
            None if breaker is None else breaker.state)


@pytest.mark.parametrize("scenario", [
    "exhausted", "exhausted_raise", "non_idempotent"])
def test_retry_budget_exhaustion(scenario):
    got = {name: _run_policy(mod, scenario) for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]


def test_application_errors_are_not_retried():
    got = {name: _run_policy(mod, "application_error")
           for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"] == (1, ("raised", "ValueError", None),
                                         0, None)


def test_retry_success_after_transient_failures():
    got = {name: _run_policy(mod, "transient")
           for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"] == (3, ("returned", "ok"), 2, None)


def test_policy_fails_fast_while_circuit_open():
    got = {name: _run_policy(mod, "open_circuit")
           for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (0, ("raised", "CircuitOpenError", None))


def test_admitted_call_keeps_its_retry_budget():
    got = {name: _run_policy(mod, "admitted_keeps_budget")
           for name, mod in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (("returned", "ok"), 2, "closed")


# -- circuit breaker lifecycle on an injected clock -----------------------------

SCRIPTS = {
    "lifecycle": [
        "allow", "fail", "state", "fail", "state", "allow", "retry_after",
        ("advance", 0.05), "allow", "retry_after", ("advance", 0.04),
        "allow", "state", "allow", "fail", "state", "allow",
        ("advance", 0.1), "allow", "success", "state", "allow"],
    "half_open_slot_recycles": [
        "fail", "fail", ("advance", 0.2), "allow", "allow",
        ("advance", 0.05), "allow", ("advance", 0.1), "allow", "state",
        "success", "state"],
    "success_resets_count": [
        "fail", "success", "fail", "state", "fail", "state",
        ("advance", 1.0), "retry_after", "allow", "fail", "state",
        "retry_after", ("advance", 0.09), "allow", ("advance", 0.02),
        "allow", "success", "state"],
}


def _run_breaker(mod, script, clock):
    kwargs = {"clock": clock} if mod is port_policy else {}
    br = mod.CircuitBreaker("parity-lifecycle", failure_threshold=2,
                            reset_timeout=0.08, **kwargs)
    out = []
    for step in script:
        if isinstance(step, tuple):
            clock.advance(step[1])
        elif step == "allow":
            out.append(("allow", br.allow()))
        elif step == "fail":
            br.record_failure()
        elif step == "success":
            br.record_success()
        elif step == "state":
            out.append(("state", br.state))
        elif step == "retry_after":
            out.append(("retry_after", round(br.retry_after(), 9)))
    snap = br.snapshot()
    out.append(("snapshot", {k: v for k, v in snap.items()
                             if k != "since_unix"}, snap["since_unix"]))
    return out


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_breaker_open_half_open_close_lifecycle(script, monkeypatch):
    port_clock, jax_clock = FakeClock(), FakeClock()
    monkeypatch.setattr(jax_policy, "time", jax_clock)
    jax = _run_breaker(jax_policy, SCRIPTS[script], jax_clock)
    monkeypatch.undo()
    port = _run_breaker(port_policy, SCRIPTS[script], port_clock)
    assert port == jax
    # the breaker really moved through its states
    assert {v for k, v, *_ in port if k == "state"} >= {"closed"}


def test_breaker_state_gauge_and_health_probe():
    br = port_policy.breaker_for("t-gauge", failure_threshold=1,
                                 reset_timeout=60.0)
    gauge = port_metrics.REGISTRY.get("pio_circuit_state")
    assert gauge.labels("t-gauge").value == 0.0
    br.record_failure()
    assert gauge.labels("t-gauge").value == 2.0
    assert "circuit_breakers" in port_health.REGISTRY.names()
    _, detail = port_health.REGISTRY.run()
    assert detail["circuit_breakers"]["status"] == "degraded"
    assert "t-gauge" in detail["circuit_breakers"]["reason"]
    br.record_success()
    assert gauge.labels("t-gauge").value == 0.0
    _, detail = port_health.REGISTRY.run()
    assert detail["circuit_breakers"]["status"] == "ok"


# -- chaos harness -------------------------------------------------------------

SPECS = [
    "storage:latency:50ms,storage:error:0.25,batcher:hang:2s,train:error",
    "batcher@r1:hang:5s,batcher:latency:10ms,storage:error:0.5",
    "storage:latency:0.5,batcher@r0:error",
    " storage : error : 1 , ",
    "", "storage", "storage:latency", "storage:explode:1",
    "storage:error:1.5", "storage:latency:soon", "storage:error:-1",
    "@r1:error", "batcher@:hang:1s", "batcher:hang:3m",
]


def _parse(mod, spec):
    try:
        rules = mod.parse_spec(spec)
    except ValueError as e:
        return ("error", str(e))
    return ("rules", [r.as_dict() for r in rules],
            [r.spec() for r in rules])


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parsing(spec):
    assert _parse(port_chaos, spec) == _parse(jax_chaos, spec)


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_injection_latency_and_error(seed):
    draws = {}
    for name, mod in (("jax", jax_chaos), ("port", port_chaos)):
        mod.configure("seam:error:0.5,seam:latency:0ms")
        mod._rng.seed(seed)
        got = []
        for _ in range(40):
            try:
                mod.inject("seam")
                got.append(False)
            except mod.ChaosError as e:
                assert isinstance(e, ConnectionError)
                got.append(True)
        mod.inject("other-seam")   # no rules for it: silent
        draws[name] = (got, mod.describe())
        mod.clear()
    assert draws["port"] == draws["jax"]
    assert 0 < sum(draws["port"][0]) < 40


def test_chaos_env_and_admin_mutation(monkeypatch):
    monkeypatch.setenv("PIO_CHAOS", "storage:latency:1ms")
    out = {}
    for name, mod in (("jax", jax_chaos), ("port", port_chaos)):
        mod.reset()
        seen = [[r.site for r in mod.configure_from_env()]]
        for body in ({"add": "batcher:error:0.5"}, {"clear": "storage"},
                     {"add": "batcher@r1:hang:2s,train:error"},
                     {"clear": "batcher"}, {"spec": "storage:error:0.1"},
                     {"clear": True}, {}, {"spec": "nope"}):
            try:
                seen.append(mod.apply_admin(body))
            except ValueError as e:
                seen.append(("400", str(e)))
        seen.append([r.site for r in mod.configure_from_env()])
        out[name] = seen
        mod.reset()
    assert out["port"] == out["jax"]


def test_chaos_tag_scopes_rule_to_one_replica():
    port_chaos.configure("batcher@r1:error:1")
    with pytest.raises(port_chaos.ChaosError):
        port_chaos.inject("batcher", tag="r1")
    port_chaos.inject("batcher", tag="r0")
    port_chaos.inject("batcher")
    port_chaos.configure("batcher:error:1")
    with pytest.raises(port_chaos.ChaosError):
        port_chaos.inject("batcher", tag="r0")
    port_chaos.clear()


# -- admission controller -------------------------------------------------------

GRID = [(depth, inflight, burn)
        for depth in (None, 0, 3, 4, 9, 40, 200)
        for inflight in (0.0, 8.0, 9.0, 130.0)
        for burn in (0.0, 14.3, 14.4, 20.0)]


@pytest.mark.parametrize("limits", [
    {"max_queue_depth": 4, "max_inflight": 8, "max_burn": 14.4},
    {"max_queue_depth": 0, "max_inflight": 0, "max_burn": 0},
    {},
], ids=["tight", "disabled", "env-defaults"])
def test_admission_controller_signals(limits, monkeypatch):
    monkeypatch.setenv("PIO_SHED_QUEUE_DEPTH", "5")
    decisions = {}
    for name, mod in (("jax", jax_admission), ("port", port_admission)):
        signals = {}
        ctl = mod.AdmissionController(
            f"parity-{name}", queue_depth=lambda: signals["depth"],
            inflight=lambda: signals["inflight"],
            burn=lambda: signals["burn"], **limits)
        got = []
        for depth, inflight, burn in GRID:
            signals.update(depth=depth, inflight=inflight, burn=burn)
            d = ctl.check()
            got.append(None if d is None else d.as_dict())
        ctl.configure({"burn": 0, "queue_depth": 2})
        signals.update(depth=2, inflight=0.0, burn=99.0)
        got.append(ctl.check().as_dict())
        snap = ctl.snapshot()
        snap.pop("server")
        decisions[name] = (got, snap)
    assert decisions["port"] == decisions["jax"]
    assert any(d is not None for d in decisions["port"][0])


# -- SLO burn-rate evaluation ---------------------------------------------------

#: per step: latencies observed (seconds) and HTTP statuses answered
SLO_STEPS = [
    ([0.01] * 50, [200] * 50),
    ([0.01] * 40 + [0.3] * 10, [200] * 45 + [500] * 5),
    ([0.5] * 30, [500] * 30),
    ([0.02] * 80, [200] * 80),
    ([], []),
    ([0.2] * 5 + [0.01] * 5, [200] * 9 + [503]),
]


def _slo_reports(mod, metrics_mod):
    """Each package's registry holds its own test-owned families."""
    lat = metrics_mod.histogram("pio_test_slo_latency_seconds",
                                "test-owned latency", ("engine",))
    avail = metrics_mod.counter("pio_test_slo_http_total",
                                "test-owned statuses", ("status",))
    monitor = mod.SLOMonitor(mod.slos_from_config({}))
    monitor.replace([
        mod.SLO(name="serving-latency", kind="latency",
                metric="pio_test_slo_latency_seconds", objective=0.99,
                threshold_ms=100.0),
        mod.SLO(name="http-availability", kind="availability",
                metric="pio_test_slo_http_total", objective=0.999),
    ])
    t0 = 1.79e9
    reports = []
    for step, (latencies, statuses) in enumerate(SLO_STEPS):
        for s in latencies:
            lat.labels("parity").observe(s)
        for code in statuses:
            avail.labels(str(code)).inc()
        reports.append(monitor.report(now=t0 + 61.0 * step))
    # a later read inside the spacing window samples nothing new
    reports.append(monitor.report(now=t0 + 61.0 * len(SLO_STEPS) - 30))
    return reports


def test_declarative_slo_configuration():
    jax_reports = _slo_reports(jax_slo, jax_metrics)
    port_reports = _slo_reports(port_slo, port_metrics)
    assert port_reports == jax_reports
    states = [e["state"] for r in port_reports for e in r["slos"]]
    assert states[:2] == ["no_data", "no_data"] and "firing" in states


@pytest.mark.parametrize("config", [
    {}, {"latency_ms": 50, "latency_objective": 0.999},
    {"availability_objective": 0.995, "shed": {"queue_depth": 3}}])
def test_slo_file_loading(config, tmp_path, monkeypatch):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(config))
    monkeypatch.setenv("PIO_SLO_FILE", str(path))
    got = {}
    for name, mod in (("jax", jax_slo), ("port", port_slo)):
        loaded = mod.configure_from_env()
        got[name] = (loaded, [(s.name, s.kind, s.objective, s.threshold_ms)
                              for s in mod.MONITOR.slos()])
        mod._file_config_path = None
        mod.configure({})
    assert got["port"] == got["jax"]
    assert got["port"][0] == config


# -- the alert webhook ------------------------------------------------------------

class _Sink(http.server.ThreadingHTTPServer):
    daemon_threads = True


def _sink():
    bodies = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            bodies.append(json.loads(self.rfile.read(length)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    server = _Sink(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever)
    thread.start()
    return server, thread, bodies


def test_webhook_fires_on_alert_transitions():
    entry = {"name": "serving-latency", "state": "firing",
             "burn_rates": {"5m": 20.0}}
    payloads = {}
    with no_thread_left():
        server, thread, bodies = _sink()
        url = f"http://127.0.0.1:{server.server_address[1]}/hook"
        try:
            for name, mod in (("jax", jax_alerts), ("port", port_alerts)):
                hook = mod.AlertWebhook(url)
                hook.on_transition("serving-latency", True, entry)
                hook.on_transition("serving-latency", False,
                                   {**entry, "state": "ok"})
                wait_for(lambda: len(bodies) == 2, 30, "two deliveries")
                hook.stop()
                payloads[name] = [{k: v for k, v in b.items()
                                   if k != "at_unix"} for b in bodies]
                bodies.clear()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    assert payloads["port"] == payloads["jax"]
    assert [p["state"] for p in payloads["port"]] == ["firing", "resolved"]


def test_webhook_starts_from_env(monkeypatch):
    monkeypatch.setenv("PIO_ALERT_WEBHOOK_URL", "http://127.0.0.1:9/x")
    sink = port_alerts.start_from_env()
    try:
        assert sink is not None and sink.url.endswith("/x")
        assert port_alerts.start_from_env() is sink   # idempotent
    finally:
        port_alerts.stop()
