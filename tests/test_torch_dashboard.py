"""The port's evaluation dashboard (``predictionio_torch/tools/dashboard.py``,
``cli dashboard``) against the JAX package's, on the CPU.

Both servers run over memory stores holding the same evaluation
instances (completed and not, out of time order, with markup in their
fields). The index and every ``evaluator_results.{txt,html,json}`` route
answer the same status, content type, CORS header and bytes; so do an
unknown instance and an unknown route. Every operator view answers 200
with HTML and the JAX view's section headings, and the port's
``/flight`` lists the queries a port engine server answered, by trace
id. ``cli dashboard`` takes the JAX console's arguments.
"""

from __future__ import annotations

import datetime as dt
import re
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.data.metadata import EvaluationInstance as JaxInstance
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.tools.dashboard import DashboardServer as JaxDashboard
from predictionio_torch.data.metadata import EvaluationInstance
from predictionio_torch.data.storage import Storage
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.tools import cli
from predictionio_torch.tools.dashboard import DashboardServer

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401
from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state, train_const)

UTC = dt.timezone.utc
MEMORY = {"PIO_STORAGE_SOURCES_M_TYPE": "memory"}

INSTANCES = [
    dict(id="ev-old", status="EVALCOMPLETED",
         start_time=dt.datetime(2026, 1, 1, tzinfo=UTC),
         end_time=dt.datetime(2026, 1, 1, 1, tzinfo=UTC),
         evaluation_class="my.Eval", batch="b1",
         evaluator_results="best: <x> & y",
         evaluator_results_html="<html><b>r</b></html>",
         evaluator_results_json='{"best": "x", "score": 0.5}'),
    dict(id="ev-new", status="EVALCOMPLETED",
         start_time=dt.datetime(2026, 3, 2, 12, 30, tzinfo=UTC),
         end_time=dt.datetime(2026, 3, 2, 13, tzinfo=UTC),
         evaluation_class="pkg.mod.<Sweep>", batch="lambda \"sweep\"",
         evaluator_results="best: z",
         evaluator_results_html="<html>z</html>",
         evaluator_results_json='{"best": "z"}'),
    dict(id="ev-mid", status="EVALCOMPLETED",
         start_time=dt.datetime(2026, 2, 1, tzinfo=UTC),
         end_time=dt.datetime(2026, 2, 1, 0, 5, tzinfo=UTC),
         evaluation_class="my.Eval", batch="",
         evaluator_results="", evaluator_results_html="",
         evaluator_results_json="{}"),
    dict(id="ev-running", status="EVALUATING",
         start_time=dt.datetime(2026, 4, 1, tzinfo=UTC),
         end_time=dt.datetime(2026, 4, 1, tzinfo=UTC),
         evaluation_class="my.Eval"),
]

EVALUATION_ROUTES = (
    ["/", "/engine_instances/ghost/evaluator_results.txt",
     "/engine_instances/ev-new/evaluator_results.csv", "/no/such/route"]
    + [f"/engine_instances/{i['id']}/evaluator_results.{fmt}"
       for i in INSTANCES for fmt in ("txt", "html", "json")])

OPERATOR_VIEWS = ["/flight", "/flight?slow=1", "/slo", "/resilience",
                  "/timeline", "/quality", "/data", "/memory", "/trace",
                  "/trace?id=not-a-trace-id", "/prof", "/prof?slow=1",
                  "/fleet", "/anomaly"]


def fetch(base, path):
    """(status, content type, CORS header, body bytes)."""
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return (resp.status, resp.headers.get("Content-Type"),
                    resp.headers.get("Access-Control-Allow-Origin"),
                    resp.read())
    except urllib.error.HTTPError as e:
        return (e.code, e.headers.get("Content-Type"),
                e.headers.get("Access-Control-Allow-Origin"), e.read())


def headings(body: bytes):
    return re.findall(r"<h([12])>(.*?)</h\1>", body.decode())


@pytest.fixture(scope="module")
def dashboards():
    """(JAX dashboard URL, port dashboard URL) over equal stores."""
    jax_store = JaxStorage.from_env(MEMORY)
    port_store = Storage.from_env(MEMORY)
    for fields in INSTANCES:
        jax_store.evaluation_instances().insert(JaxInstance(**fields))
        port_store.evaluation_instances().insert(EvaluationInstance(**fields))
    with no_thread_left():
        jax_server = JaxDashboard(storage=jax_store, host="127.0.0.1",
                                  port=0)
        port_server = DashboardServer(storage=port_store, host="127.0.0.1",
                                      port=0)
        jax_server.start()
        port_server.start()
        try:
            yield (f"http://127.0.0.1:{jax_server.port}",
                   f"http://127.0.0.1:{port_server.port}")
        finally:
            port_server.stop()
            jax_server.stop()


@pytest.mark.parametrize("path", EVALUATION_ROUTES)
def test_evaluation_routes_answer_jaxs_bytes(dashboards, path):
    jax_base, port_base = dashboards
    assert fetch(port_base, path) == fetch(jax_base, path)


def test_the_index_lists_completed_instances_newest_first(dashboards):
    _, port_base = dashboards
    status, ctype, cors, body = fetch(port_base, "/")
    assert (status, ctype, cors) == (200, "text/html; charset=UTF-8", "*")
    text = body.decode()
    order = [text.index(f"<td>{name}</td>")
             for name in ("ev-new", "ev-mid", "ev-old")]
    assert order == sorted(order) and "ev-running" not in text
    assert "pkg.mod.&lt;Sweep&gt;" in text


@pytest.mark.parametrize("path", OPERATOR_VIEWS)
def test_operator_views_have_jaxs_sections(dashboards, path):
    jax_base, port_base = dashboards
    jax_status, jax_ctype, _, jax_body = fetch(jax_base, path)
    status, ctype, cors, body = fetch(port_base, path)
    assert (status, ctype, cors) == (200, "text/html; charset=UTF-8", "*")
    assert (jax_status, jax_ctype) == (status, ctype)
    assert body.startswith(b"<!DOCTYPE html>")
    assert headings(body) == headings(jax_body)


def test_flight_lists_the_port_servers_queries(dashboards):
    """A port engine server's answered queries appear in the dashboard's
    flight table, each under its trace id."""
    _, port_base = dashboards
    store = Storage.from_env(MEMORY)
    engine, _ = train_const(store)
    trace_ids = []
    with no_thread_left():
        server = EngineServer(engine, "const", host="127.0.0.1", port=0,
                              storage=store, device="cpu").start()
        try:
            for _ in range(3):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.port}/queries.json",
                    data=b'{"mult": 2}', method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 200
                    trace_ids.append(resp.headers["X-PIO-Trace-Id"])
        finally:
            server.stop()
    body = fetch(port_base, "/flight")[3].decode()
    for trace_id in trace_ids:
        assert f"<td>{trace_id[:16]}</td>" in body
    assert "/queries.json" in body


def test_cli_dashboard_takes_jaxs_arguments():
    for argv in (["dashboard"], ["dashboard", "--ip", "127.0.0.1",
                                 "--port", "9100"]):
        port_args = cli.build_parser().parse_args(argv)
        jax_args = jax_cli.build_parser().parse_args(argv)
        assert (port_args.ip, port_args.port) == (jax_args.ip, jax_args.port)
        assert port_args.func is cli.cmd_dashboard
