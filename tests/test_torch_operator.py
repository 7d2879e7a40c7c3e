"""The port engine server's operator paths on the CPU
(``predictionio_torch/serving/engine_server.py``, ``serving/http.py``).

Admission control answers 429 with ``Retry-After`` before the body is
read; the feedback loop puts a ``predict`` event carrying the answer's
``prId`` into the port's own event server (in process), in the shape
the JAX server's ``_send_feedback`` builds; ``remote_log`` posts on a
query's 500; the storage circuit breaker stamps answers
``X-PIO-Degraded`` and turns ``/readyz`` DEGRADED, and closes again;
the chaos seams (storage, batcher, train) fail what they guard; the
operator admin routes answer behind the admin gate, and the CLI's
``slo`` and ``chaos`` commands read them.
"""

from __future__ import annotations

import contextlib
import http.server
import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

from predictionio_torch.data.storage import Storage
from predictionio_torch.obs import flight, metrics
from predictionio_torch.resilience import chaos
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.serving.event_server import EventServer
from predictionio_torch.tools import cli, commands

from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state,
                                           train_const, wait_for)


def call(url, method="GET", body=None, headers=None):
    req = urllib.request.Request(
        url, method=method, data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


@pytest.fixture()
def store():
    return Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})


@contextlib.contextmanager
def serving(store, **kwargs):
    """A started port engine server of the constant engine on the CPU;
    yields (server, base URL) and stops it, leaving no thread."""
    engine, _ = train_const(store)
    with no_thread_left():
        server = EngineServer(engine, "const", host="127.0.0.1", port=0,
                              storage=store, device="cpu", **kwargs).start()
        try:
            yield server, f"http://127.0.0.1:{server.port}"
        finally:
            server.stop()


@contextlib.contextmanager
def sink():
    """A local HTTP endpoint recording every JSON POST body."""
    bodies = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            bodies.append((self.path, json.loads(self.rfile.read(length))))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", bodies
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


class FakeClock:
    """``time()`` and ``monotonic()`` that move only when told to."""

    def __init__(self, start: float = 1000.0):
        self.now = start

    def time(self) -> float:
        return 1.7e9 + self.now

    def monotonic(self) -> float:
        return self.now


# -- admission control -------------------------------------------------------------

def test_engine_server_sheds_with_429_before_the_body_is_read(store,
                                                              monkeypatch):
    with serving(store) as (server, base):
        assert call(base + "/queries.json", "POST", b'{"mult": 2}')[0] == 200
        shed = metrics.REGISTRY.get("pio_shed_total")
        before = shed.labels("engine", "burn_rate").value
        # the serving-latency SLO's fast-window burn (the controller's
        # third signal), injected: the gauge it reads by default is
        # re-evaluated on the flight recorder's cadence
        monkeypatch.setattr(server.admission, "_burn", lambda: 20.0)
        # a body that does not parse: a parsed body would answer 400
        status, body, headers = call(base + "/queries.json", "POST",
                                     b"{not json", {"X-PIO-Trace-Id":
                                                    "cd" * 16})
        assert status == 429, body
        assert headers["Retry-After"] == "10"
        answer = json.loads(body)
        assert answer["reason"] == "burn_rate"
        assert answer["retryAfterSec"] == 10
        assert shed.labels("engine", "burn_rate").value == before + 1
        # the handler seals its record after the answer went out
        record = wait_for(lambda: next(
            (r for r in flight.RECORDER.dump(50)["records"]
             if r["trace"] == "cd" * 16), None), 10, "the shed's record")
        assert record["shed"] == "burn_rate" and record["status"] == 429
        # a 5 MB announced body that never comes: the 429 goes out
        # without waiting for it (an unread body this large closes the
        # connection instead of being drained)
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=10) as s:
            s.sendall(b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      b"Content-Length: 5000000\r\n\r\n")
            head = s.recv(4096)
        assert head.startswith(b"HTTP/1.1 429"), head[:80]
        assert b"Retry-After: 10" in head
        snap = json.loads(call(base + "/")[1])["admission"]
        assert snap["shedTotal"] == 2
        assert snap["limits"]["queue_depth"] == 64 * 4   # 4 x max_batch
        monkeypatch.setattr(server.admission, "_burn", lambda: 0.0)
        assert call(base + "/queries.json", "POST", b'{"mult": 2}')[0] == 200


def test_admission_limits_from_the_environment_and_slo_file(store, tmp_path,
                                                            monkeypatch):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"latency_ms": 40,
                                "shed": {"inflight": 3, "burn": 9.5}}))
    monkeypatch.setenv("PIO_SLO_FILE", str(path))
    monkeypatch.setenv("PIO_SHED_QUEUE_DEPTH", "6")
    with serving(store, max_batch=8,
                 slo_conf={"availability_objective": 0.99,
                           "shed": {"burn": 12.0}}) as (server, base):
        limits = server.admission.snapshot()["limits"]
        assert limits == {"queue_depth": 6, "inflight": 3, "burn": 12.0}
        report = json.loads(call(base + "/admin/slo")[1])
        by_name = {e["name"]: e for e in report["slos"]}
        # the variant's block is layered over the file's objectives
        assert by_name["serving-latency"]["threshold_ms"] == 40.0
        assert by_name["http-availability"]["objective"] == 0.99


# -- the feedback loop and the remote log -----------------------------------------

def test_feedback_loop_posts_a_predict_event_to_the_event_server(store):
    from predictionio_tpu.serving.engine_server import (
        EngineServer as JaxServer)

    info = commands.app_new("fb", storage=store)
    key = info.access_keys[0].key
    with no_thread_left():
        events = EventServer(storage=store, host="127.0.0.1",
                             port=0).start()
        try:
            feedback_url = f"http://127.0.0.1:{events.port}"
            with serving(store, feedback_url=feedback_url,
                         feedback_access_key=key) as (server, base):
                status, body, _ = call(base + "/queries.json", "POST",
                                       b'{"mult": 3}')
                assert status == 200, body
                answer = json.loads(body)
                assert answer["result"] == 9.0 and len(answer["prId"]) == 32
                found = wait_for(lambda: list(store.events().find(
                    info.app.id, event_names=["predict"])), 30,
                    "the predict event")
                instance_id = server.deployment.instance.id
        finally:
            events.stop()
    (event,) = found
    # the event the JAX server's _send_feedback builds for this answer
    sent = []
    fake = type("S", (), {
        "feedback_url": feedback_url, "feedback_access_key": key,
        "_post_json": staticmethod(lambda url, p, what: sent.append(
            (url, p)))})()
    JaxServer._send_feedback(fake, {"mult": 3}, answer, answer["prId"],
                             instance_id)
    (url, want), = sent
    assert url == f"{feedback_url}/events.json?accessKey={key}"
    got = event.to_dict()
    for field in ("event", "entityType", "entityId", "prId",
                  "properties"):
        assert got[field] == want[field], field


def test_remote_log_posts_on_a_500(store):
    with sink() as (url, bodies):
        with serving(store, log_url=url + "/log") as (server, base):
            chaos.configure("batcher:error:1")
            status, body, _ = call(base + "/queries.json", "POST",
                                   b'{"mult": 2}')
            chaos.clear()
            assert status == 500, body
            wait_for(lambda: bodies, 30, "the remote log line")
            assert call(base + "/queries.json", "POST",
                        b'{"mult": 2}')[0] == 200
            # a bad query is the client's error: no remote log line
            assert call(base + "/queries.json", "POST", b"{}")[0] == 400
    (path, line), = bodies
    assert path == "/log"
    assert line == {"level": "ERROR",
                    "message": "query failed: ChaosError: chaos: injected "
                               "batcher:error:1 fault at the batcher seam",
                    "engineId": "const", "engineVariant": "default"}


# -- the storage circuit and degraded mode -----------------------------------------

def test_degraded_serving_opens_and_closes_the_storage_circuit(store,
                                                               monkeypatch):
    with serving(store, micro_batch=False) as (server, base):
        clock = FakeClock()
        server._storage_breaker._clock = clock
        assert call(base + "/queries.json", "POST",
                    b'{"mult": 2}')[2].get("X-PIO-Degraded") is None
        client = store.client_for("METADATA")
        monkeypatch.setattr(client, "health_check", lambda: False)
        for _ in range(2):
            status, text, _ = call(base + "/readyz")
            assert status == 200
            assert json.loads(text)["probes"]["storage"]["status"] == \
                "degraded"
        assert server._storage_breaker.state == "open"
        status, text, _ = call(base + "/readyz")
        body = json.loads(text)
        assert body["status"] == "degraded"
        assert "storage circuit open" in body["probes"]["storage"]["reason"]
        assert body["probes"]["circuit_breakers"]["status"] == "degraded"
        status, _, headers = call(base + "/queries.json", "POST",
                                  b'{"mult": 2}')
        assert status == 200
        assert "last-loaded instance" in headers["X-PIO-Degraded"]
        circuits = json.loads(call(base + "/admin/resilience")[1])["circuits"]
        assert {c["target"]: c["state"] for c in circuits}[
            "storage:const"] == "open"
        page = json.loads(call(base + "/")[1])
        assert page["storageCircuit"]["state"] == "open"
        monkeypatch.undo()
        # past the reset timeout a half-open probe closes the circuit
        clock.now += server._storage_breaker.reset_timeout + 1.0
        body = json.loads(call(base + "/readyz")[1])
        assert body["probes"]["storage"]["status"] == "ok"
        assert server._storage_breaker.state == "closed"
        assert call(base + "/queries.json", "POST",
                    b'{"mult": 2}')[2].get("X-PIO-Degraded") is None


# -- the chaos seams ----------------------------------------------------------------

def test_chaos_seams_fail_storage_and_train(store):
    from predictionio_torch.resilience.chaos import ChaosError

    chaos.configure("storage:error:1")
    with pytest.raises(ChaosError):
        store.apps()
    chaos.configure("train:error:1")
    with pytest.raises(ChaosError):
        train_const(store, engine_id="const-chaos")
    chaos.clear()
    (failed,) = [i for i in store.engine_instances().get_all()
                 if i.engine_id == "const-chaos"]
    assert failed.status == "FAILED"


# -- the operator admin routes and their CLI commands --------------------------------

def test_admin_chaos_endpoint_and_cli(store, capsys, monkeypatch):
    with serving(store) as (server, base):
        status, text, _ = call(base + "/admin/chaos")
        assert status == 200 and json.loads(text)["enabled"] is False
        status, _, _ = call(base + "/admin/chaos", "POST",
                            json.dumps({"spec": "storage:latency:1ms"})
                            .encode())
        assert status == 200
        assert [r.spec() for r in chaos.active()] == [
            "storage:latency:0.001s"]
        assert call(base + "/admin/chaos", "POST", b'{"spec": "bad"}')[0] \
            == 400
        assert cli.main(["chaos", "--url", base]) == 0
        assert "storage" in capsys.readouterr().out
        assert cli.main(["chaos", "--url", base, "--clear"]) == 0
        assert chaos.active() == []
        assert cli.main(["slo", "--url", base]) == 0
        assert "serving-latency" in capsys.readouterr().out
        for path in ("/admin/timeline", "/admin/quality",
                     "/admin/resilience"):
            status, text, _ = call(base + path)
            assert status == 200, path
        assert "datapath" in json.loads(call(base + "/admin/timeline")[1])
        assert call(base + "/admin/fleet")[0] == 404   # no fleet here
        monkeypatch.setenv("PIO_ADMIN_TOKEN", "s3cret")
        for path in ("/admin/chaos", "/admin/resilience", "/admin/slo",
                     "/admin/quality", "/admin/timeline"):
            assert call(base + path)[0] == 401, path
        auth = {"Authorization": "Bearer s3cret"}
        status, text, _ = call(base + "/admin/resilience", headers=auth)
        assert status == 200 and "circuits" in json.loads(text)
        # the CLI sends the bearer from the environment
        assert cli.main(["slo", "--url", base, "--json"]) == 0
        assert '"slos"' in capsys.readouterr().out


def test_post_quality_report_registers_on_the_quality_surface(store):
    with serving(store) as (server, base):
        report = {"n": 3, "mean_overlap": 1.0, "queries": [{"q": 1}]}
        status, body, _ = call(base + "/admin/quality", "POST",
                               json.dumps({"replay": report}).encode())
        assert status == 200, body
        got = json.loads(call(base + "/admin/quality")[1])["replay"]
        # the per-query examples (raw payloads) stay off this surface
        assert got == {"n": 3, "mean_overlap": 1.0}
        assert call(base + "/admin/quality", "POST", b"{}")[0] == 400
