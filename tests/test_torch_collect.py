"""The port's federation (``obs/collect.py``) against the JAX package's.

Both packages' registries, fed the same operations, must render the
same Prometheus and OpenMetrics text (exemplars included), and each
package's ``parse_exposition`` must read either text alike; the merge
of two members' documents, its rendering, ``fleet_slo`` and
``quantile_from_flat`` must agree. A trace that crosses two port
engine servers, stitched from their ``/admin/spans``, must have the
tree that the same hops over two JAX servers give; a member that does
not answer degrades every federation, never fails it.
"""

import json
import re
import socket
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.obs import collect as jax_collect
from predictionio_tpu.obs import flight as jax_flight
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_torch.data.storage import Storage
from predictionio_torch.obs import collect, flight, metrics
from predictionio_torch.serving.engine_server import EngineServer

from tests.test_health import train_const as jax_train_const
from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state, train_const)


def _registry(mod, seed: int):
    """A fresh registry fed one seeded sequence of operations."""
    reg = mod.Registry()
    rng = np.random.default_rng(seed)
    c = reg.counter("pio_x_total", "x", ("kind",))
    g = reg.gauge("pio_g", "g", ("slot",))
    h = reg.histogram("pio_serving_request_seconds", "h", ("engine",))
    for k in range(40):
        c.labels("ab"[k % 2]).inc(int(rng.integers(1, 4)))
        h.labels("e").observe(float(rng.exponential(0.05)),
                              exemplar={"trace_id": f"{k:032x}"})
    g.labels("z").set(float(rng.normal()))
    g.labels('q"uote').set(2.5)
    return reg


def _no_exemplar_clock(text: str) -> str:
    """The exposition with each exemplar's wall-clock stamp blanked."""
    return re.sub(r"(# \{[^}]*\} \S+) \S+", r"\1 T", text)


@pytest.mark.parametrize("seed", [1, 2])
def test_exposition_is_byte_equal_and_parses_alike(seed):
    port, jax = _registry(metrics, seed), _registry(jax_metrics, seed)
    assert port.render() == jax.render()
    assert _no_exemplar_clock(port.render_openmetrics()) == \
        _no_exemplar_clock(jax.render_openmetrics())
    assert "trace_id=" in port.render_openmetrics()
    for text in (port.render(), port.render_openmetrics()):
        assert collect.parse_exposition(text) == \
            jax_collect.parse_exposition(text)


def _merged(mod, metrics_mod):
    docs = [(f"r{s}", mod.parse_exposition(
        _registry(metrics_mod, s).render_openmetrics())) for s in (1, 2)]
    return mod.merge_families(docs)


def test_merge_render_slo_and_quantiles_match_jax(monkeypatch):
    monkeypatch.setenv("PIO_SLO_LATENCY_MS", "100")
    monkeypatch.setenv("PIO_SLO_LATENCY_OBJECTIVE", "0.99")
    port = _merged(collect, metrics)
    jax = _merged(jax_collect, jax_metrics)
    assert collect.render_merged(port) == jax_collect.render_merged(jax)
    flat = collect.flat_samples(port)
    assert flat == jax_collect.flat_samples(jax)
    assert collect.fleet_slo(port) == jax_collect.fleet_slo(jax)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert collect.quantile_from_flat(
            flat, "pio_serving_request_seconds", q) == \
            jax_collect.quantile_from_flat(
                flat, "pio_serving_request_seconds", q)
    # counters sum, gauges keep the member label
    assert flat['pio_serving_request_seconds_count{engine="e"}'] == 80.0
    assert 'pio_g{member="r1",slot="z"}' in flat
    assert collect.quantile_from_flat({}, "nope", 0.5) is None


def _dead_member(name="gone", mod=collect):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return mod.Member(name, f"http://127.0.0.1:{port}")


def _post(port, trace_id, parent=None):
    headers = {"Content-Type": "application/json",
               "X-PIO-Trace-Id": trace_id}
    if parent is not None:
        headers["X-PIO-Parent-Span"] = parent
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", method="POST",
        data=json.dumps({"mult": 2}).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _shape(node):
    return {"name": node.get("name"), "missing": bool(node.get("missing")),
            "process": node.get("process"),
            "children": [_shape(c) for c in node["children"]]}


def _two_hops(pkg, tmp_path):
    """Two engine servers of ``pkg``: a query on the first, then one on
    the second carrying the first's edge span as its parent; -> the
    stitched document over both members."""
    if pkg == "port":
        storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
        engine, _ = train_const(storage)

        def serve():
            return EngineServer(engine, "const", host="127.0.0.1", port=0,
                                storage=storage, device="cpu",
                                micro_batch=False).start()
        mod = collect
    else:
        storage = JaxStorage.from_env(
            {"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
        engine, _ = jax_train_const(storage)

        def serve():
            return JaxServer(engine, "const", host="127.0.0.1", port=0,
                             storage=storage, micro_batch=False).start()
        mod = jax_collect
    trace_id = ("5b" if pkg == "port" else "6a") * 16
    servers = [serve(), serve()]
    try:
        assert _post(servers[0].port, trace_id) == {"result": 6.0}
        page = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{servers[0].port}/admin/spans?trace="
            f"{trace_id}", timeout=30).read())
        edge = next(s["span"] for s in page["spans"]
                    if s["name"].startswith("http."))
        assert _post(servers[1].port, trace_id, edge) == {"result": 6.0}
        members = [mod.Member(f"s{j}", f"http://127.0.0.1:{s.port}")
                   for j, s in enumerate(servers)]
        doc = mod.stitch_trace(trace_id, members)
        degraded = mod.stitch_trace(trace_id, members + [_dead_member(
            mod=mod)])
        metrics_report = mod.federate_metrics(members + [_dead_member(
            mod=mod)])
    finally:
        for server in servers:
            server.stop()
    return doc, degraded, metrics_report


def test_a_stitched_trace_over_two_servers_matches_jax(tmp_path):
    with no_thread_left():
        port, port_degraded, port_metrics = _two_hops("port", tmp_path)
    jax, jax_degraded, jax_metrics_report = _two_hops("jax", tmp_path)
    assert port["complete"] and port["span_count"] == jax["span_count"]
    assert [_shape(r) for r in port["roots"]] == \
        [_shape(r) for r in jax["roots"]]
    assert port["processes"] == jax["processes"]
    assert set(port) == set(jax)
    # the dead member degrades the stitch and the metric merge
    for doc in (port_degraded, jax_degraded):
        states = {m["name"]: m["ok"] for m in doc["members"]}
        assert states == {"s0": True, "s1": True, "gone": False}
        assert doc["span_count"] == port["span_count"]
    for report in (port_metrics, jax_metrics_report):
        report.pop("_merged")
        assert [m["ok"] for m in report["members"]] == [True, True, False]
        assert report["merged_from"] == ["s0", "s1"]
    assert set(port_metrics) == set(jax_metrics_report)
    text = collect.format_trace_tree(port)
    assert "COMPLETE" in text and "missing" not in text


@pytest.mark.parametrize("name", ["federate_tail", "federate_prof",
                                  "federate_journal", "federate_anomaly",
                                  "federate_data"])
def test_every_federation_degrades_on_a_dead_member(name):
    # the local member reads this process's flight ring, whose record
    # count shapes the tail report: both packages' rings start empty,
    # whatever an earlier test of the worker served
    flight.RECORDER.clear()
    jax_flight.RECORDER.clear()
    port = getattr(collect, name)([collect.Member("local", None),
                                   _dead_member()])
    jax = getattr(jax_collect, name)([jax_collect.Member("local", None),
                                      _dead_member(mod=jax_collect)])
    assert set(port) == set(jax)
    states = [(m["name"], m["ok"]) for m in port["members"]]
    assert states == [("local", True), ("gone", False)]
    assert port["members"][1]["error"]


def test_members_from_the_environment_and_a_fleet(monkeypatch):
    monkeypatch.setenv("PIO_OBS_MEMBERS",
                       "ev=http://h:7070/, http://h:7071, ,x=")
    got = [(m.name, m.url, m.role) for m in collect.env_members()]
    want = [(m.name, m.url, m.role) for m in jax_collect.env_members()]
    assert got == want == [("ev", "http://h:7070", "configured"),
                           ("h:7071", "http://h:7071", "configured")]

    class Replica:
        def __init__(self, name, state, port):
            self.name, self.state, self.port = name, state, port
            self.base_url = f"http://127.0.0.1:{port}"

    class Fleet:
        replicas = [Replica("r0", "ready", 1), Replica("r1", "dead", 2),
                    Replica("r2", "ready", 0)]

    assert [m.name for m in collect.fleet_members(Fleet())] == ["r0"]
    members = collect.default_members(type("S", (), {"fleet": Fleet()})())
    assert [m.name for m in members] == ["local", "r0", "ev", "h:7071"]
