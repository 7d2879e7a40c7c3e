"""Background OpenMetrics pusher (the push-gateway story).

Copy of ``predictionio_tpu/obs/push.py``: every port server's
``start()`` starts it, as in the JAX package. What follows is the JAX
module's account.

Scrape-based collection assumes the collector can reach every server;
batch trainers behind NAT, short-lived eval jobs and locked-down
serving hosts often cannot be scraped. With ``PIO_PUSH_URL`` set, every
server (and any process that calls :func:`start_from_env`) POSTs the
full OpenMetrics document — exemplars included — to that URL on a
fixed cadence from one daemon thread.

Failure posture: a dead sink must never affect serving, and a dead
pusher thread must never be silent. Each failed push backs off
exponentially (doubling from the base interval up to
``PIO_PUSH_MAX_BACKOFF_SEC``), successes reset the cadence, and every
attempt lands in ``pio_push_total{result="ok"|"error"}`` so the
absence of pushes is itself observable from the server's own
``/metrics``.

Config (all env):
  PIO_PUSH_URL              sink URL (unset = pusher off)
  PIO_PUSH_INTERVAL_SEC     cadence between successful pushes (default 15)
  PIO_PUSH_MAX_BACKOFF_SEC  backoff ceiling after failures (default 300)
"""

from __future__ import annotations

import logging
import os
import threading
import urllib.error
import urllib.request
from typing import Optional

from predictionio_torch.obs import metrics

log = logging.getLogger(__name__)

DEFAULT_INTERVAL_SEC = 15.0
DEFAULT_MAX_BACKOFF_SEC = 300.0

_PUSH_TOTAL = metrics.counter(
    "pio_push_total",
    "OpenMetrics push attempts to PIO_PUSH_URL, by result",
    ("result",),
)


class MetricsPusher:
    """One daemon thread POSTing the registry to a sink with backoff."""

    def __init__(self, url: str, interval: float = DEFAULT_INTERVAL_SEC,
                 max_backoff: float = DEFAULT_MAX_BACKOFF_SEC,
                 timeout: float = 5.0):
        self.url = url
        self.interval = max(0.01, float(interval))
        self.max_backoff = max(self.interval, float(max_backoff))
        self.timeout = timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsPusher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pio-metrics-push", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 1.0)

    def push_once(self) -> bool:
        """One push attempt; True on a 2xx answer. Raises nothing.

        Runs under the resilience policy with retries=0 — the loop's
        cadence backoff IS this call's retry schedule (stacking a
        per-push retry budget under it would multiply the probing of a
        dead sink) — so the push path still gets the explicit deadline
        and the ``push`` circuit breaker's fail-fast + state gauge."""
        from predictionio_torch.resilience.policy import Policy

        body = metrics.REGISTRY.render_openmetrics().encode()
        req = urllib.request.Request(  # graftlint: disable=JT17 — the push gateway is an EXTERNAL metrics sink, not a fleet member: it stitches nothing, and trace ids already ride the exposition as exemplars
            self.url, data=body, method="POST",
            headers={"Content-Type": metrics.OPENMETRICS_CONTENT_TYPE},
        )

        def attempt() -> bool:
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return 200 <= resp.status < 300
            except urllib.error.HTTPError as e:
                # an HTTP error body is an ANSWER: the sink is up but
                # rejecting — no breaker failure, cadence backoff still
                # applies via the False return
                log.debug("metrics push to %s rejected: %d", self.url, e.code)
                return False

        try:
            ok = bool(Policy(deadline=self.timeout, retries=0).run(
                attempt, target="push"))
        except Exception as e:  # noqa: BLE001 — a dead sink must not raise
            log.debug("metrics push to %s failed: %s", self.url, e)
            ok = False
        _PUSH_TOTAL.labels("ok" if ok else "error").inc()
        return ok

    def _loop(self) -> None:
        delay = self.interval
        while not self._stop.is_set():
            try:
                if self.push_once():
                    delay = self.interval
                else:
                    # exponential backoff: a down sink gets probed less
                    # and less, never slower than the ceiling
                    delay = min(delay * 2, self.max_backoff)
            except Exception:  # noqa: BLE001 — a dead pusher is silent forever
                log.exception("metrics pusher iteration failed")
                delay = min(max(delay, self.interval) * 2, self.max_backoff)
            self._stop.wait(delay)


_pusher: Optional[MetricsPusher] = None
_pusher_lock = threading.Lock()


def start_from_env() -> Optional[MetricsPusher]:
    """Start the process-wide pusher when ``PIO_PUSH_URL`` is set
    (idempotent; every server's ``start()`` calls this, so any PIO
    process with an HTTP surface pushes without per-server wiring)."""
    global _pusher
    url = os.environ.get("PIO_PUSH_URL")
    if not url:
        return None
    with _pusher_lock:
        if _pusher is not None and _pusher.url == url:
            return _pusher
        if _pusher is not None:
            _pusher.stop()
        interval = metrics.env_float("PIO_PUSH_INTERVAL_SEC",
                                     DEFAULT_INTERVAL_SEC)
        max_backoff = metrics.env_float("PIO_PUSH_MAX_BACKOFF_SEC",
                                        DEFAULT_MAX_BACKOFF_SEC)
        _pusher = MetricsPusher(url, interval=interval,
                                max_backoff=max_backoff).start()
        log.info("metrics pusher started: %s every %.0fs", url, interval)
        return _pusher


def stop() -> None:
    """Stop the process-wide pusher (tests; clean shutdown)."""
    global _pusher
    with _pusher_lock:
        if _pusher is not None:
            _pusher.stop()
            _pusher = None

