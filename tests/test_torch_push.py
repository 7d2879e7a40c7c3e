"""The port's metrics pusher (``obs/push.py``) against the JAX package's.

Each package's pusher posts its registry's OpenMetrics document to a
sink (a stdlib HTTP server here); what the port's pusher posts must be
what its registry renders, readable by ``collect.parse_exposition``
with the same families the JAX parser reads; a sink that fails first
is retried with backoff, a dead sink never raises, ``PIO_PUSH_URL``
starts one pusher per process (every port server's ``start()`` calls
``start_from_env``), and ``stop()`` ends its thread.
"""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from predictionio_tpu.obs import collect as jax_collect
from predictionio_tpu.obs import push as jax_push
from predictionio_torch.obs import collect, metrics, push

from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state, train_const)


class Sink:
    """Answers 503 to the first ``fail_first`` pushes, then 200; keeps
    every body."""

    def __init__(self, fail_first: int = 0):
        self.hits = []
        self.fail_first = fail_first
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                sink.hits.append((self.headers["Content-Type"], body))
                code = 503 if len(sink.hits) <= sink.fail_first else 200
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.httpd.server_address[1]}/push"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def _wait(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pusher_retries_a_flaky_sink_with_backoff(pkg):
    mod = jax_push if pkg == "jax" else push
    sink = Sink(fail_first=1)
    pusher = mod.MetricsPusher(sink.url, interval=0.05, max_backoff=0.2)
    try:
        pusher.start()
        assert _wait(lambda: len(sink.hits) >= 3)
    finally:
        pusher.stop()
        sink.stop()
    assert not pusher._thread.is_alive()
    content_type, body = sink.hits[-1]
    assert content_type == mod.metrics.OPENMETRICS_CONTENT_TYPE
    assert body.rstrip().endswith(b"# EOF")
    family = mod.metrics.REGISTRY.get("pio_push_total")
    assert family.labels("ok").value >= 1
    assert family.labels("error").value >= 1


def test_the_pushed_document_parses_like_jax():
    sink = Sink()
    metrics.REGISTRY.get("pio_push_total").labels("ok")
    try:
        assert push.MetricsPusher(sink.url).push_once() is True
    finally:
        sink.stop()
    _, body = sink.hits[0]
    text = body.decode()
    port = collect.parse_exposition(text)
    assert port == jax_collect.parse_exposition(text)
    # OpenMetrics names a counter family without its _total suffix
    assert port["pio_push"]["kind"] == "counter"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_push_once_never_raises_on_a_dead_sink(pkg):
    mod = jax_push if pkg == "jax" else push
    assert mod.MetricsPusher("http://127.0.0.1:9/push",
                             timeout=0.2).push_once() is False


def test_a_server_start_starts_the_pusher_from_the_environment(monkeypatch):
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.serving.engine_server import EngineServer

    sink = Sink()
    monkeypatch.setenv("PIO_PUSH_URL", sink.url)
    monkeypatch.setenv("PIO_PUSH_INTERVAL_SEC", "0.05")
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    engine, _ = train_const(storage)
    try:
        with no_thread_left():
            server = EngineServer(engine, "const", host="127.0.0.1",
                                  port=0, storage=storage, device="cpu",
                                  micro_batch=False).start()
            try:
                assert push._pusher is not None
                assert push.start_from_env() is push._pusher
                assert _wait(lambda: len(sink.hits) >= 2)
            finally:
                server.stop()
                push.stop()
    finally:
        sink.stop()
    assert metrics.REGISTRY.get("pio_push_total").labels("ok").value >= 2
