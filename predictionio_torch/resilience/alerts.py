"""SLO alert delivery: webhook POSTs on burn-rate alert transitions.

Copy of ``predictionio_tpu/resilience/alerts.py``.

obs/slo.py computes burn rates and decides when a page SHOULD fire,
but until this module nothing delivered one — the gauges only helped
operators who were already looking. With ``PIO_ALERT_WEBHOOK_URL``
set, every alert transition (ok -> firing, firing -> resolved) POSTs a
JSON document to the sink:

    {"type": "slo_alert", "slo": "serving-latency",
     "state": "firing" | "resolved", "at_unix": ...,
     "slo_report": {... the SLO's full /admin/slo entry ...}}

Delivery posture: transitions are queued and delivered from ONE
supervised daemon thread (never the sampling thread — a slow sink must
not stall SLO evaluation), each POST runs under the resilience
:class:`Policy` (explicit deadline, retry budget with full-jitter
backoff, the ``alert_webhook`` circuit breaker), and every outcome
lands in ``pio_alert_webhook_total{result}``. A transition that
exhausts its retries is dropped WITH a log line — alert delivery is
at-most-once; the SLO gauges remain the source of truth.

Config (env):
  PIO_ALERT_WEBHOOK_URL          sink URL (unset = no delivery)
  PIO_ALERT_WEBHOOK_TIMEOUT_SEC  per-attempt deadline (default 5)
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from predictionio_torch.obs import metrics, slo
from predictionio_torch.resilience.policy import Policy

log = logging.getLogger(__name__)

_WEBHOOK_TOTAL = metrics.counter(
    "pio_alert_webhook_total",
    "SLO alert webhook deliveries, by result",
    ("result",),
)

#: bounded: a dead sink must not grow an unbounded backlog of stale pages
_QUEUE_CAPACITY = 256


class AlertWebhook:
    """One sink URL + the delivery worker; registered as an SLO alert
    listener via :func:`start_from_env` (or directly in tests)."""

    def __init__(self, url: str, policy: Optional[Policy] = None):
        self.url = url
        self.policy = policy or Policy(
            deadline=metrics.env_float("PIO_ALERT_WEBHOOK_TIMEOUT_SEC", 5.0),
            retries=4, backoff_base=0.5, backoff_cap=30.0)
        self._queue: "queue.Queue[Optional[Dict[str, Any]]]" = queue.Queue(
            maxsize=_QUEUE_CAPACITY)
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._stop = threading.Event()

    # -- the slo.add_alert_listener hook ------------------------------------
    def on_transition(self, name: str, firing: bool,
                      entry: Dict[str, Any]) -> None:
        payload = {
            "type": "slo_alert",
            "slo": name,
            "state": "firing" if firing else "resolved",
            "at_unix": round(time.time(), 3),
            "slo_report": entry,
        }
        try:
            self._queue.put_nowait(payload)
        except queue.Full:
            _WEBHOOK_TOTAL.labels("dropped").inc()
            log.warning("alert webhook queue full; dropped %s %s",
                        name, payload["state"])
            return
        self._ensure_worker()

    def _ensure_worker(self) -> None:
        # locked check-then-act: two racing transitions must not spawn
        # two workers (whose competing POSTs could reorder deliveries)
        with self._thread_lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="pio-alert-webhook",
                    daemon=True)
                self._thread.start()

    # -- delivery -----------------------------------------------------------
    def deliver(self, payload: Dict[str, Any]) -> bool:
        """One transition's delivery under the policy; True when the
        sink 2xx'd. Never raises."""
        body = json.dumps(payload).encode()

        def attempt() -> bool:
            req = urllib.request.Request(  # graftlint: disable=JT17 — the alert webhook is an EXTERNAL sink (PagerDuty/Slack bridge), not a fleet member: fleet trace ids mean nothing to it and would leak internal ids outward
                self.url, data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.policy.deadline) as resp:
                    return 200 <= resp.status < 300
            except urllib.error.HTTPError as e:
                if e.code >= 500:
                    # the sink is unhealthy: retryable, breaker-visible
                    raise ConnectionError(
                        f"alert sink answered {e.code}") from e
                log.warning("alert sink rejected the payload (%d): %s",
                            e.code, e.read()[:200])
                return False

        try:
            ok = bool(self.policy.run(attempt, target="alert_webhook"))
        except Exception as e:  # noqa: BLE001 — at-most-once: log + drop
            log.warning("alert webhook delivery to %s failed: %s: %s",
                        self.url, type(e).__name__, e)
            ok = False
        _WEBHOOK_TOTAL.labels("ok" if ok else "error").inc()
        return ok

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                payload = self._queue.get(timeout=0.5)
                if payload is None:
                    break
                self.deliver(payload)
            except queue.Empty:
                continue
            except Exception:  # noqa: BLE001 — a dead worker delivers nothing
                log.exception("alert webhook worker iteration failed")

    def stop(self) -> None:
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)


_sink: Optional[AlertWebhook] = None
_sink_lock = threading.Lock()


def start_from_env() -> Optional[AlertWebhook]:
    """Install the process-wide webhook sink when
    ``PIO_ALERT_WEBHOOK_URL`` is set (idempotent; every server's
    ``start()`` calls this, like the metrics pusher)."""
    import os

    global _sink
    url = os.environ.get("PIO_ALERT_WEBHOOK_URL")
    if not url:
        return None
    with _sink_lock:
        if _sink is not None and _sink.url == url:
            return _sink
        if _sink is not None:
            slo.remove_alert_listener(_sink.on_transition)
            _sink.stop()
        _sink = AlertWebhook(url)
        slo.add_alert_listener(_sink.on_transition)
        log.info("SLO alert webhook sink: %s", url)
        return _sink


def stop() -> None:
    """Tear down the process-wide sink (tests; clean shutdown)."""
    global _sink
    with _sink_lock:
        if _sink is not None:
            slo.remove_alert_listener(_sink.on_transition)
            _sink.stop()
            _sink = None
