"""Shared HTTP plumbing: JSON handler, bind retries, thread lifecycle.

Copy of ``JSONRequestHandler`` and ``HTTPServerBase`` from
``predictionio_tpu/serving/http.py``, without the observability and
admin surface (the obs slice brings it). Each server is a stdlib
``ThreadingHTTPServer`` with HTTP/1.1 keep-alive.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

log = logging.getLogger(__name__)


class JSONRequestHandler(BaseHTTPRequestHandler):
    """Base handler: JSON responses, body parsing, quiet logging."""

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

    def do_GET(self):
        self._send(404, {"message": "Not Found"})

    def do_POST(self):
        self._send(404, {"message": "Not Found"})


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

    def stop(self) -> None:
        """Stop serving and close the socket; the port is free on return."""
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
