"""The served operator routes: a JAX engine server and a port engine
server deployed with ``device="cpu"`` from one store.

A tiny ALS model is trained once with the JAX package into a localfs
store (as tests/test_torch_serving.py does), and both packages' engine
servers deploy it. ``/readyz``, ``/admin/memory``, ``/admin/journal``,
``/admin/spans`` and the operator routes (``/admin/{slo,chaos,
resilience,timeline,quality}``) must answer with the same status codes
and the same JSON keys, ``/readyz`` also with the store down (both
serve DEGRADED). Every other admin route of the JAX server answers on
the port with the JAX status and keys, the admin gate answers 401, and
a query's trace shows at ``/admin/trace``. The ``/metrics`` families of
the two packages, every module of each imported in a fresh interpreter,
are equal except for the families named here.
"""

import datetime as _dt
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.event import Event
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine)
from predictionio_tpu.workflow.train import run_train
from predictionio_torch.core.engine import resolve_engine_factory
from predictionio_torch.data.storage import Storage
from predictionio_torch.obs import perfacct
from predictionio_torch.serving.engine_server import deploy

from tests.test_storage import make_storage
from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_ID = "torch_obs_routes"
JAX_FACTORY = "predictionio_tpu.templates.recommendation.recommendation_engine"

#: the JAX families the port replaced: jax.monitoring's compile events
#: and the Pallas flag became the port's kernel families
JAX_ONLY_FAMILIES = {"pio_jax_compile_cache_total",
                     "pio_jax_compile_seconds", "pio_pallas_kernel_enabled"}
#: the port's own: the nvcc builds and the kernel flag (obs/torchmon.py)
PORT_ONLY_FAMILIES = {"pio_kernel_build_total", "pio_kernel_build_seconds",
                      "pio_kernel_enabled"}


def _store_env(tmp_path):
    return {
        "PIO_STORAGE_SOURCES_S_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "store"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "events",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "models",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
    }


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """One JAX training run into a localfs store; both packages' engine
    servers deploy it (no micro-batcher: a lone request path each)."""
    tmp_path = tmp_path_factory.mktemp("torch_obs_routes")
    storage = make_storage("localfs", tmp_path)
    jax_set_storage(storage)
    try:
        app = storage.apps().insert("obsroutes")
        storage.events().init(app.id)
        rng = np.random.default_rng(5)
        now = _dt.datetime.now(tz=_dt.timezone.utc)
        storage.events().insert_batch([
            Event(event="rate", entity_type="user",
                  entity_id=f"u{rng.integers(20)}",
                  target_entity_type="item",
                  target_entity_id=f"i{rng.integers(25)}",
                  properties={"rating": float(rng.integers(1, 11)) / 2},
                  event_time=now)
            for _ in range(300)], app.id)
        engine = jax_recommendation_engine()
        ep = engine.engine_params_from_variant({
            "datasource": {"params": {"app_name": "obsroutes"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": 2, "compute_dtype": "float32",
                "cg_dtype": "float32"}}],
        })
        instance = run_train(engine, ep, engine_id=ENGINE_ID,
                             engine_factory=JAX_FACTORY, storage=storage)
        jax_server = JaxServer(engine, ENGINE_ID, host="127.0.0.1", port=0,
                               storage=storage, micro_batch=False).start()
    finally:
        jax_set_storage(None)
    port_storage = Storage.from_env(_store_env(tmp_path))
    try:
        port_server = deploy(
            resolve_engine_factory(instance.engine_factory)(), ENGINE_ID,
            host="127.0.0.1", port=0, storage=port_storage,
            device="cpu", micro_batch=False)
    except BaseException:
        jax_server.stop()
        raise
    try:
        yield {"jax": jax_server, "port": port_server,
               "stores": {"jax": storage, "port": port_storage}}
    finally:
        port_server.stop()
        jax_server.stop()


def _call(port, path, method="GET", body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw, code, hdrs = resp.read(), resp.status, resp.headers
    except urllib.error.HTTPError as e:
        raw, code, hdrs = e.read(), e.code, e.headers
    try:
        return code, json.loads(raw), hdrs
    except ValueError:
        return code, raw.decode(), hdrs


ROUTES = ["/readyz", "/admin/memory", "/admin/journal?n=5",
          "/admin/spans?n=5", "/admin/slo", "/admin/chaos",
          "/admin/resilience", "/admin/timeline", "/admin/quality"]


@pytest.mark.parametrize("path", ROUTES)
def test_routes_answer_like_jax(servers, path):
    _call(servers["port"].port, "/queries.json", "POST",
          {"user": "u1", "num": 3})
    port_code, port_body, _ = _call(servers["port"].port, path)
    jax_code, jax_body, _ = _call(servers["jax"].port, path)
    assert port_code == jax_code == 200
    assert set(port_body) == set(jax_body)
    if path == "/readyz":
        # the same probe entries; the port checks kernel libraries where
        # the JAX server checks its compile cache
        # (a micro-batching server elsewhere in the process adds its
        # queue's probe to the process registry); the engine server's
        # storage circuit registers the breakers' probe, as in JAX
        assert set(port_body["probes"]) - {"serving_queue"} == {
            "devices", "kernels", "flight_errors", "disk", "device_memory",
            "storage", "circuit_breakers"}
        assert {"devices", "compile_cache", "flight_errors", "disk",
                "device_memory", "storage"} <= set(jax_body["probes"])
        for name, entry in port_body["probes"].items():
            assert set(entry) == {"status", "reason", "latency_ms"}
        assert port_body["probes"]["devices"]["reason"] == "cpu"


def test_readyz_with_the_store_down_is_degraded_in_both(servers,
                                                        monkeypatch):
    for store in servers["stores"].values():
        monkeypatch.setattr(store.client_for("METADATA"), "health_check",
                            lambda: False)
    answers = {name: _call(servers[name].port, "/readyz")
               for name in ("jax", "port")}
    for code, body, _ in answers.values():
        assert code == 200 and body["status"] == "degraded"
        assert body["probes"]["storage"]["status"] == "degraded"
    code, _, hdrs = _call(servers["port"].port, "/queries.json", "POST",
                          {"user": "u1", "num": 3})
    assert code == 200 and "storage unavailable" in hdrs["X-PIO-Degraded"]
    monkeypatch.undo()
    assert _call(servers["port"].port, "/readyz")[1]["status"] == "ok"


#: the JAX server's remaining admin routes: (path, the status both
#: answer on a server without a fleet)
MORE_ADMIN = [
    ("/admin/tail", 200), ("/admin/tail?q=0.5", 200),
    ("/admin/prof", 200), ("/admin/prof?endpoint=/queries.json", 200),
    ("/admin/prof?slow=1", 200), ("/admin/anomaly", 200),
    ("/admin/data", 200), ("/admin/data?top=3", 200),
    ("/admin/trace?id=" + "4c" * 16, 200),
    ("/admin/fleet/metrics", 404), ("/admin/fleet/tail", 404),
    ("/admin/fleet/prof", 404), ("/admin/fleet/journal", 404),
    ("/admin/fleet/anomaly", 404), ("/admin/fleet/data", 404),
    ("/admin/tail?q=x", 400), ("/admin/data?top=x", 400),
]


def test_unported_admin_routes_name_their_item(servers):
    """Every admin route of the JAX server answers on the port, with the
    JAX status and the JAX keys; none answers 501. Enough queries go to
    each that the tail attribution has its cohorts."""
    for name in ("port", "jax"):
        for k in range(perfacct.MIN_TAIL_RECORDS):
            _call(servers[name].port, "/queries.json", "POST",
                  {"user": f"u{k % 25}", "num": 3})
    for path, status in MORE_ADMIN:
        port_code, port_body, _ = _call(servers["port"].port, path)
        jax_code, jax_body, _ = _call(servers["jax"].port, path)
        assert port_code == jax_code == status, path
        assert set(port_body) == set(jax_body), path
    collapsed = _call(servers["port"].port, "/admin/prof?format=collapsed")
    assert collapsed[0] == 200 and isinstance(collapsed[1], str)


def test_admin_gate_and_profile_on_the_cpu(servers, monkeypatch, tmp_path):
    port = servers["port"].port
    monkeypatch.setenv("PIO_ADMIN_TOKEN", "s3cret")
    assert _call(port, "/admin/memory")[0] == 401
    assert _call(port, "/metrics")[0] == 200        # scrapes stay open
    auth = {"Authorization": "Bearer s3cret"}
    assert _call(port, "/admin/memory", headers=auth)[0] == 200
    code, body, _ = _call(port, "/admin/profile?seconds=0", "POST",
                          headers=auth)
    assert code == 501 and body["backend"] == "cpu"
    # the capture path itself, on the CPU's activity
    monkeypatch.setenv("PIO_PROFILE_FORCE", "1")
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    code, body, _ = _call(port, "/admin/profile?seconds=0.05", "POST",
                          headers=auth)
    assert code == 200 and os.path.isfile(body["artifact"])
    assert body["summary"]["kernels"] == {}
    assert body["summary"]["window_ms"] >= 50.0


def test_a_query_trace_shows_in_spans_flight_and_metrics(servers):
    port = servers["port"].port
    trace_id = "ab" * 16
    code, _, hdrs = _call(port, "/queries.json", "POST",
                          {"user": "u2", "num": 4},
                          headers={"X-PIO-Trace-Id": trace_id})
    assert code == 200 and hdrs["X-PIO-Trace-Id"] == trace_id
    doc = _call(port, f"/admin/trace?id={trace_id}")[1]
    assert doc["complete"] and doc["span_count"] == 2
    (root,) = doc["roots"]
    assert root["name"] == "http.engineserver"
    assert [c["name"] for c in root["children"]] == ["serve.query"]
    spans = _call(port, f"/admin/spans?trace={trace_id}")[1]["spans"]
    assert {s["name"] for s in spans} == {"http.engineserver",
                                          "serve.query"}
    records = _call(port, "/admin/flight?n=50")[1]["records"]
    mine = [r for r in records if r["trace"] == trace_id]
    assert len(mine) == 1 and mine[0]["status"] == 200
    assert "dispatch" in mine[0]["stages"]
    text = _call(port, "/metrics")[1]
    assert 'pio_serving_request_seconds_count{engine="torch_obs_routes"}' \
        in text
    assert 'pio_http_requests_in_flight{server="PIOEngineServer"} ' in text
    assert _call(port, "/admin/trace?id=nope")[0] == 400


def test_metrics_families_equal_jax_but_the_named():
    code = (
        "import importlib, json, pkgutil\n"
        "import predictionio_tpu, predictionio_torch\n"
        "for pkg in (predictionio_tpu, predictionio_torch):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "from predictionio_tpu.obs.metrics import REGISTRY as J\n"
        "from predictionio_torch.obs.metrics import REGISTRY as P\n"
        "print(json.dumps([sorted(f.name for f in J.collect()),\n"
        "                  sorted(f.name for f in P.collect())]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_names, port_names = map(set, json.loads(
        proc.stdout.strip().splitlines()[-1]))
    assert jax_names - port_names == JAX_ONLY_FAMILIES
    assert port_names - jax_names == PORT_ONLY_FAMILIES
