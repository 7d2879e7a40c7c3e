"""Admission control: shed load BEFORE latency collapses.

Copy of ``predictionio_tpu/resilience/admission.py``. The port's engine
server reads its in-flight signal from its own count of the requests
inside its handlers (``HTTPServerBase.inflight_count``): a threaded
fleet's replicas share one process, and the gauge is per server class.
What follows is the JAX module's account.

The engine server's failure mode under overload is queueing collapse:
the MicroBatcher's queue grows, every queued request's latency includes
everyone ahead of it, p99 blows through the SLO, and eventually the
dispatch watchdog fires — observing a disaster that already happened.
The admission controller answers 429 + ``Retry-After`` at the door
instead, from three signals read per request (each one cheap — a queue
size, a gauge read):

  queue depth   the MicroBatcher backlog: the direct measure of
                "arrivals outrun dispatches". Default limit 4x
                max_batch — half the depth at which the readiness
                probe turns DEGRADED, so shedding engages first.
  in-flight     requests currently inside this server (the
                ``pio_http_requests_in_flight`` gauge): bounds total
                concurrency even when the batcher is keeping up.
  burn rate     the fast-window burn of the serving-latency SLO
                (``pio_slo_burn_rate{slo="serving-latency",
                window="5m"}``, maintained by obs/slo.py): latency is
                already eating error budget at page-worthy speed, so
                trade availability-for-some to protect latency-for-most.

Every shed lands in ``pio_shed_total{server,reason}`` and the
request's flight record (the handler notes the reason), so "we shed
X% for Y minutes" is reconstructable after the fact.

Config (env; a per-engine ``slo.shed`` block in engine.json overrides
via :meth:`AdmissionController.configure`):
  PIO_SHED_QUEUE_DEPTH   queue depth limit (0 disables; default
                         4x max_batch)
  PIO_SHED_INFLIGHT      in-flight limit (0 disables; default 128)
  PIO_SHED_BURN          fast-window burn-rate limit (0 disables;
                         default 14.4 — the fast-page threshold)
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
from typing import Any, Callable, Dict, Optional

from predictionio_torch.obs import journal, metrics

log = logging.getLogger(__name__)

DEFAULT_INFLIGHT_LIMIT = 128
DEFAULT_BURN_LIMIT = 14.4    # obs/slo.py FAST_BURN: the fast-page rate
BURN_WINDOW = "5m"
SERVING_SLO = "serving-latency"

_SHED_TOTAL = metrics.counter(
    "pio_shed_total",
    "Requests shed by admission control, by server and signal",
    ("server", "reason"),
)


@dataclasses.dataclass(frozen=True)
class ShedDecision:
    """Why a request was turned away, and when to come back."""

    reason: str          # "queue_depth" | "inflight" | "burn_rate"
    retry_after: int     # whole seconds for the Retry-After header
    detail: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _slo_fast_burn() -> float:
    """The serving-latency SLO's fast-window burn, as last evaluated by
    obs/slo.py (the gauge is refreshed on the flight-recorder snapshot
    cadence and on every /admin/slo read)."""
    family = metrics.REGISTRY.get("pio_slo_burn_rate")
    if family is None:
        return 0.0
    return family.labels(SERVING_SLO, BURN_WINDOW).value


class AdmissionController:
    """Per-server load shedder; ``check()`` runs on every query."""

    def __init__(
        self,
        server: str,
        queue_depth: Callable[[], Optional[int]] = lambda: None,
        inflight: Callable[[], float] = lambda: 0.0,
        burn: Callable[[], float] = _slo_fast_burn,
        max_queue_depth: Optional[int] = None,
        max_inflight: Optional[int] = None,
        max_burn: Optional[float] = None,
    ):
        self.server = server
        self._queue_depth = queue_depth
        self._inflight = inflight
        self._burn = burn
        self._lock = threading.Lock()
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else metrics.env_int("PIO_SHED_QUEUE_DEPTH", 0))
        self.max_inflight = int(
            max_inflight if max_inflight is not None
            else metrics.env_int("PIO_SHED_INFLIGHT",
                                 DEFAULT_INFLIGHT_LIMIT))
        self.max_burn = float(
            max_burn if max_burn is not None
            else metrics.env_float("PIO_SHED_BURN", DEFAULT_BURN_LIMIT))
        self._shed_count = 0

    def configure(self, shed: Dict[str, Any]) -> None:
        """Apply a declarative ``shed`` block (engine.json / slo.json):
        ``{"queue_depth": N, "inflight": N, "burn": X}`` — 0 disables a
        signal; absent keys keep their current value."""
        with self._lock:
            if "queue_depth" in shed:
                self.max_queue_depth = int(shed["queue_depth"])
            if "inflight" in shed:
                self.max_inflight = int(shed["inflight"])
            if "burn" in shed:
                self.max_burn = float(shed["burn"])
        log.info("admission limits (%s): queue_depth=%s inflight=%s "
                 "burn=%s", self.server, self.max_queue_depth,
                 self.max_inflight, self.max_burn)

    # -- the per-request decision -------------------------------------------
    def check(self) -> Optional[ShedDecision]:
        """None = admitted; a :class:`ShedDecision` = answer 429.
        Signal order is cheapest-first and most-specific-first: a deep
        queue names the bottleneck better than a generic burn."""
        depth = self._queue_depth()
        if self.max_queue_depth > 0 and depth is not None \
                and depth >= self.max_queue_depth:
            # drain estimate: the further past the limit, the longer the
            # advised retry (bounded — Retry-After: 30 reads as "down")
            overload = depth / self.max_queue_depth
            return self._shed(
                "queue_depth", min(30, max(1, math.ceil(overload))),
                f"serving queue depth {depth} >= {self.max_queue_depth}")
        # strict >: the in-flight gauge already counts THIS request
        # (incremented before the handler dispatched here), so >= would
        # admit only N-1 — and a limit of 1 would shed everything
        inflight = self._inflight()
        if self.max_inflight > 0 and inflight > self.max_inflight:
            return self._shed(
                "inflight", 1,
                f"{int(inflight)} requests in flight (self included) > "
                f"{self.max_inflight}")
        burn = self._burn()
        if self.max_burn > 0 and burn >= self.max_burn:
            # burn moves on the SLO sampling cadence: advise a longer
            # pause than the queue signals do
            return self._shed(
                "burn_rate", 10,
                f"serving-latency fast-window burn {burn:.1f} >= "
                f"{self.max_burn:g}")
        return None

    def _shed(self, reason: str, retry_after: int,
              detail: str) -> ShedDecision:
        _SHED_TOTAL.labels(self.server, reason).inc()
        with self._lock:
            self._shed_count += 1
        # episode tracking, not per-429 spam: the first shed opens a
        # journal episode; the snapshot-cadence close stamps the count
        journal.SHED_EPISODES.note_shed(reason, server=self.server)
        return ShedDecision(reason, retry_after, detail)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            shed = self._shed_count
        return {
            "server": self.server,
            "limits": {
                "queue_depth": self.max_queue_depth,
                "inflight": self.max_inflight,
                "burn": self.max_burn,
            },
            "signals": {
                "queue_depth": self._queue_depth(),
                "inflight": self._inflight(),
                "burn": round(self._burn(), 3),
            },
            "shedTotal": shed,
        }
