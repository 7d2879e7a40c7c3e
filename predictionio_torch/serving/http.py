"""Shared HTTP plumbing: JSON handler, bind retries, thread lifecycle,
liveness, the admin bearer gate and the SIGTERM drain.

Copy of ``JSONRequestHandler``, ``HTTPServerBase``, ``_admin_authorized``,
``drain_timeout`` and ``install_drain_handler`` from
``predictionio_tpu/serving/http.py``, with the operator routes trimmed
to ``GET /healthz`` and the in-flight gauge to a plain per-server
counter (the rest of the observability and admin surface comes with its
own slice). Each server is a stdlib ``ThreadingHTTPServer`` with
HTTP/1.1 keep-alive.
"""

from __future__ import annotations

import functools
import hmac
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import urlparse

log = logging.getLogger(__name__)


def _instrument(fn):
    """Wrap a ``do_METHOD`` handler: answer ``GET /healthz`` before any
    routing or auth, and count the request as in flight on its server
    while the handler runs (what the drain waits for). Applied once to
    every handler class through ``__init_subclass__``."""
    if getattr(fn, "_pio_instrumented", False):
        return fn

    @functools.wraps(fn)
    def wrapper(self):
        if self.command == "GET" and urlparse(self.path).path == "/healthz":
            # liveness: no probes, no locks beyond _send
            self._send(200, {"status": "alive"})
            return
        server = self.server_ref
        if not server._enter():
            # stopped: what it holds (an event log, a batcher) may be
            # closed already
            self.close_connection = True
            self._send(503, {"message": "server is stopping"})
            return
        try:
            fn(self)
        finally:
            server._exit()

    wrapper._pio_instrumented = True
    return wrapper


class JSONRequestHandler(BaseHTTPRequestHandler):
    """Base handler: JSON responses, body parsing, quiet logging,
    ``GET /healthz`` and the in-flight count on every ``do_METHOD``."""

    server_version = "PIOServer/0.1"
    server_ref: Any = None  # set via subclass attribute by each server
    # keep-alive is safe: every response carries Content-Length and
    # _send drains unread request bodies first
    protocol_version = "HTTP/1.1"
    timeout = 120
    # without TCP_NODELAY, Nagle + delayed ACK add ~40 ms per exchange
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        log.debug("%s: " + fmt, self.server_version, *args)

    def handle_one_request(self):
        self._body_consumed = False  # per request, not per connection
        super().handle_one_request()

    def _send(self, status: int, body: Any,
              content_type: str = "application/json; charset=UTF-8",
              extra_headers: Optional[dict] = None) -> None:
        if isinstance(body, bytes):
            data = body
        elif isinstance(body, str):
            data = body.encode()
        else:
            data = json.dumps(body).encode()
        # an unread request body would desynchronize the keep-alive
        # connection: drain it (or close when it is chunked or > 1 MB)
        try:
            unread = int(self.headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            unread = 0
        if not getattr(self, "_body_consumed", False):
            if self.headers.get("Transfer-Encoding") or unread > (1 << 20):
                self.close_connection = True
            elif unread:
                self.rfile.read(unread)
        self._body_consumed = True
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        if self.close_connection:
            self.send_header("Connection", "close")
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        self._body_consumed = True
        return self.rfile.read(length) if length else b""

    def _read_json(self) -> Any:
        """Parsed JSON body; raises json.JSONDecodeError."""
        return json.loads(self._read_body() or b"{}")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in ("do_GET", "do_POST", "do_DELETE"):
            fn = cls.__dict__.get(name)
            if fn is not None:
                setattr(cls, name, _instrument(fn))

    def _not_found(self):
        self._send(404, {"message": "Not Found"})

    # servers without a do_GET / do_POST of their own still answer
    # /healthz and 404 everything else
    do_GET = _instrument(_not_found)
    do_POST = _instrument(_not_found)


def _admin_authorized(handler) -> bool:
    """Bearer-token gate for the routes that change a server (``POST
    /model/patch``): with ``PIO_ADMIN_TOKEN`` unset everything stays
    open (the trusted-network default); once set, requests must carry
    ``Authorization: Bearer <token>`` (constant-time compare)."""
    token = os.environ.get("PIO_ADMIN_TOKEN")
    if not token:
        return True
    supplied = handler.headers.get("Authorization") or ""
    return hmac.compare_digest(supplied, f"Bearer {token}")


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # the stdlib backlog of 5 drops connections under serving bursts
    request_queue_size = 128


class HTTPServerBase:
    """Bind (with retry), run on a daemon thread, stop cleanly.

    Bind-retry contract from the reference engine server
    (CreateServer.scala:340-350): ``bind_retries`` attempts, 1s apart.
    """

    def __init__(self, host: str, port: int, handler_cls: type,
                 bind_retries: int = 1):
        handler = type("Handler", (handler_cls,), {"server_ref": self})
        attempts = max(1, bind_retries)
        for attempt in range(attempts):
            try:
                self.httpd = _ThreadingHTTPServer((host, port), handler)
                break
            except OSError as e:
                log.warning("bind attempt %d failed: %s", attempt + 1, e)
                if attempt + 1 == attempts:
                    raise
                time.sleep(1)
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._stopped = threading.Event()

    def _enter(self) -> bool:
        """Count a request in; False once the server has stopped."""
        with self._inflight_lock:
            if self._stopped.is_set():
                return False
            self._inflight += 1
            return True

    def _exit(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def inflight_count(self) -> int:
        """Requests of this server inside their handlers now."""
        with self._inflight_lock:
            return self._inflight

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self):
        # flag set BEFORE the thread runs, so a racing stop() still calls
        # shutdown() instead of closing the socket under the serve loop
        self._serving = True
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("%s listening on %s", type(self).__name__, self.port)
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self.httpd.serve_forever()

    def wait_stopped(self, timeout: float) -> bool:
        """True once ``stop()`` has run (a SIGTERM drain ends in it)."""
        return self._stopped.wait(timeout)

    def stop(self) -> None:
        """Stop serving and close the socket; the port is free on return.
        Requests that arrive afterwards on open keep-alive connections
        are answered 503."""
        with self._inflight_lock:
            self._stopped.set()
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()

    def drain_stop(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop ACCEPTING first (serve loop halted,
        listening socket closed so new connections are refused instead
        of waiting in the backlog), then wait, up to ``timeout``
        (default ``PIO_DRAIN_TIMEOUT``, 30 s), for the requests in
        flight to write their responses, then ``stop()`` (which also
        stops per-server parts, e.g. the engine server's batcher).
        True when everything drained inside the window."""
        if timeout is None:
            timeout = drain_timeout()
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
        deadline = time.monotonic() + max(0.0, timeout)
        while self.inflight_count() > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        leftover = self.inflight_count()
        if leftover:
            log.warning("%s drain window (%.1fs) expired with %d request(s) "
                        "still in flight; stopping anyway",
                        type(self).__name__, timeout, leftover)
        self.stop()
        return leftover == 0


DEFAULT_DRAIN_TIMEOUT_SEC = 30.0


def drain_timeout() -> float:
    """The SIGTERM drain window: ``PIO_DRAIN_TIMEOUT`` seconds, the
    default when unset or not a number."""
    try:
        value = float(os.environ.get("PIO_DRAIN_TIMEOUT",
                                     DEFAULT_DRAIN_TIMEOUT_SEC))
    except ValueError:
        value = DEFAULT_DRAIN_TIMEOUT_SEC
    return max(0.0, value)


def install_drain_handler(*servers, timeout: Optional[float] = None):
    """SIGTERM -> drain-then-stop for every server of this process.

    On SIGTERM each server stops accepting, finishes what it already
    admitted (bounded by ``PIO_DRAIN_TIMEOUT``) and stops, after which
    ``serve_forever`` returns and the main exits normally. The drain
    runs on its own NON-daemon thread, and both properties matter: the
    signal fires in the main thread, usually the one blocked inside
    ``serve_forever``, so calling ``shutdown()`` there would deadlock
    waiting for a serve loop that cannot advance under the handler; and
    once ``drain_stop`` unblocks that ``serve_forever`` the main returns
    and the interpreter starts exiting, which would kill a daemon drain
    thread (and the daemon handler threads still writing responses)
    mid-drain. Non-daemon, the interpreter waits for the drain.

    Returns the installed handler, so tests can call it directly
    without delivering a signal. Must be called from the main thread
    (CPython's signal contract)."""
    import signal

    def _drain(signum=None, frame=None):
        def run():
            log.info("SIGTERM: draining %d server(s), window %.1fs",
                     len(servers),
                     drain_timeout() if timeout is None else timeout)
            for server in servers:
                try:
                    server.drain_stop(timeout)
                except Exception:  # noqa: BLE001 — one server's failed
                    # drain must not leave its siblings serving
                    log.exception("drain failed for %r", server)

        threading.Thread(target=run, daemon=False, name="pio-drain").start()

    signal.signal(signal.SIGTERM, _drain)
    return _drain
