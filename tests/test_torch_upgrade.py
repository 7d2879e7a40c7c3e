"""The opt-in version check on the port (``tools/upgrade.py``) against
the JAX package's, on the CPU, over a local HTTP server.

- JAX's two forms (``tests/test_fake_workflow.py``): no
  ``PIO_UPDATE_URL``, no request and no error; a local server's
  ``{"version": ...}``: one GET with ``?component=`` and the same log
  line from both packages. An unreachable URL raises in neither.
- ``start_upgrade_daemon`` without the variable starts no thread in
  either package (JAX's daemon is never started with it set: its thread
  never exits).
- The port's engine server starts the daemon only with the variable
  set; the server sees one GET with ``component=engine-server``, and no
  ``pio-upgrade-check`` thread is left once the engine server stops.

Threads and servers are stopped and joined in each fixture's teardown;
waits poll a condition with a deadline.
"""

import http.server
import json
import logging
import threading

import pytest

from predictionio_tpu.tools import upgrade as jax_upgrade
from predictionio_torch import __version__
from predictionio_torch.data.storage import Storage
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.tools import upgrade

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401
from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state, train_const,
                                           wait_for)


@pytest.fixture()
def version_server():
    """A local server answering ``{"version": "99.0.0"}``; ``paths``
    holds every GET's path."""
    paths = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            paths.append(self.path)
            body = json.dumps({"version": "99.0.0"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    srv.paths = paths
    srv.url = f"http://127.0.0.1:{srv.server_port}/v"
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _upgrade_threads():
    return [t for t in threading.enumerate()
            if t.name == upgrade.THREAD_NAME and t.is_alive()]


@pytest.mark.parametrize("module", [jax_upgrade, upgrade],
                         ids=["jax", "port"])
def test_check_upgrade_is_a_noop_without_url(monkeypatch, version_server,
                                             module):
    monkeypatch.delenv("PIO_UPDATE_URL", raising=False)
    assert module.check_upgrade() is None
    assert version_server.paths == []


def test_check_upgrade_reads_a_local_server_like_jax(monkeypatch, caplog,
                                                     version_server):
    monkeypatch.setenv("PIO_UPDATE_URL", version_server.url)
    lines = {}
    for name, module in (("jax", jax_upgrade), ("port", upgrade)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            assert module.check_upgrade("test") is None
        lines[name] = [r.getMessage() for r in caplog.records
                       if r.name.endswith("tools.upgrade")]
    assert version_server.paths == ["/v?component=test"] * 2
    assert lines["port"] == lines["jax"] == [
        f"a newer version is available: 99.0.0 (running {__version__})"]


@pytest.mark.parametrize("module", [jax_upgrade, upgrade],
                         ids=["jax", "port"])
def test_an_unreachable_url_never_raises(monkeypatch, version_server,
                                         module):
    url = version_server.url
    version_server.shutdown()
    version_server.server_close()
    monkeypatch.setenv("PIO_UPDATE_URL", url)
    assert module.check_upgrade("test", timeout=2.0) is None


@pytest.mark.parametrize("module", [jax_upgrade, upgrade],
                         ids=["jax", "port"])
def test_no_daemon_without_url(monkeypatch, module):
    monkeypatch.delenv("PIO_UPDATE_URL", raising=False)
    before = set(threading.enumerate())
    assert module.start_upgrade_daemon("engine-server") is None
    assert set(threading.enumerate()) == before


def test_the_port_daemon_checks_at_start_and_stops(monkeypatch,
                                                   version_server):
    monkeypatch.setenv("PIO_UPDATE_URL", version_server.url)
    with no_thread_left():
        daemon = upgrade.start_upgrade_daemon("worker", interval_sec=3600)
        try:
            wait_for(lambda: version_server.paths, 30, "the first check")
            assert daemon.thread.name == upgrade.THREAD_NAME
            assert daemon.thread.daemon
        finally:
            assert daemon.stop()
    assert version_server.paths == ["/v?component=worker"]


@pytest.mark.parametrize("with_url", [True, False], ids=["url", "no-url"])
def test_the_engine_server_starts_the_daemon_only_with_the_variable(
        monkeypatch, version_server, with_url):
    if with_url:
        monkeypatch.setenv("PIO_UPDATE_URL", version_server.url)
    else:
        monkeypatch.delenv("PIO_UPDATE_URL", raising=False)
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    engine, _ = train_const(storage, "upgrade-const")
    with no_thread_left():
        server = EngineServer(engine, "upgrade-const", host="127.0.0.1",
                              port=0, storage=storage, device="cpu").start()
        try:
            if with_url:
                wait_for(lambda: version_server.paths, 30,
                         "the engine server's check")
                assert len(_upgrade_threads()) == 1
            else:
                assert server._upgrade is None
                assert _upgrade_threads() == []
        finally:
            server.stop()
        assert _upgrade_threads() == []
    want = ["/v?component=engine-server"] if with_url else []
    assert version_server.paths == want
