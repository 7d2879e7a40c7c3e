"""The Engine Server: deployed-engine query serving, default port 8000.

Counterpart of ``predictionio_tpu/serving/engine_server.py`` for the
serving slice. Behavior contract from the reference
(core/.../workflow/CreateServer.scala):

  - boots from the latest COMPLETED EngineInstance for an engine,
    reloading models from the Models repo (createServerActorWithEngine:190)
    onto the server's device (``DeviceContext``: the card unless the
    caller asks for ``device="cpu"``)
  - ``POST /queries.json`` (:462): JSON query -> every algorithm's
    predict on its model -> Serving combines -> JSON response
  - ``GET /`` status (:433-459), here with each model's retrieval index
    stats: the ``topk_dot`` kernel plan and its launch count
  - ``GET /reload`` hot-swaps to the latest completed instance (:592);
    404 when there is none, 500 when loading or warming it fails
  - ``POST /stop`` stops the server (``pio undeploy``, :600)
  - bind retry x3 with 1s backoff (:340-350)

``POST /model/patch`` is the streaming lane's (``workflow/stream.py``):
a fold-in's rows land in the live models between queries, under the
deployment lock, through each algorithm's ``apply_patch``; it answers
401 without the ``PIO_ADMIN_TOKEN`` bearer (when one is set), 400 for a
malformed or unsupported patch, 409 when the patch names another
instance than the one deployed, 500 when applying it fails.

Concurrent queries are micro-batched as in the JAX package: handler
threads queue payloads and one worker answers whatever is queued. A
lone query goes through ``Deployment.query`` -> ``predict`` -> the
retrieval index -> the kernel; a batch of more than one goes through
``Deployment.query_batch`` -> ``batch_predict`` -> the scorer, and a
failed batch is re-run one query at a time.

Warm-up failures are not swallowed: a deployment whose kernel cannot
build or launch does not go live.

Observability (the JAX package's hooks, ``obs/``): every query lands in
``pio_serving_request_seconds{engine}`` (the status page's p50/p99 read
the same series); a lone dispatch runs under its request's trace
(``serve.query`` / ``serve.dispatch`` spans), a batch under a
``serve.batch`` span naming its members, and each request's flight
record gets its queue and dispatch stages (a failed one its error).
Dispatches run under the ``serving_dispatch`` stall watchdog, and the
batcher's queue depth is a ``/readyz`` probe. ``/readyz``'s storage
probe is :meth:`EngineServer.storage_readyz_probe` (storage loss is
DEGRADED while a model answers, and answers then carry
``X-PIO-Degraded``); the device probe checks the deployment's card.
Loaded models are priced in the device-memory ledger (the model
classes register), ``/reload`` runs the memory preflight first (507
when the instance would not fit, ``?force=1`` overrides) and releases
the old deployment's footprints, ``stop`` releases the live one's.
Reloads and patches go to the ops journal and
``pio_model_patches_total``; ``GET /`` ``patches`` keeps its per-server
counts.

The operator contract (the JAX server's resilience hooks):

  - admission control (``resilience/admission.py``): ``POST
    /queries.json`` is checked BEFORE its body is read; an overloaded
    server answers 429 with ``Retry-After`` from its queue depth, its
    in-flight count or the serving-latency SLO's burn, and notes the
    shed in the request's flight record. Thresholds: the
    ``PIO_SHED_*`` environment, then ``PIO_SLO_FILE``'s ``shed`` block,
    then the engine variant's ``slo.shed`` block (``slo_conf``), whose
    objectives are layered over the file's (``obs/slo.py``);
  - the storage circuit breaker (``breaker_for("storage:<engine>")``)
    behind ``degraded_reason`` and the ``/readyz`` storage probe: two
    failed probes or reloads open it, and while it is open the probe
    fails fast and answers carry ``X-PIO-Degraded``;
  - ``chaos_tag`` (or ``PIO_CHAOS_TAG``) names this server's
    ``batcher`` chaos seam, so a rule can fault one fleet replica;
  - the feedback loop (ref: CreateServer.scala:488-550): with
    ``feedback_url`` and ``feedback_access_key`` every answer object
    gets a ``prId`` and a ``predict`` event goes, on a thread of its
    own, to ``{feedback_url}/events.json?accessKey=...`` with the
    request's trace headers;
  - ``remote_log`` (ref: CreateServer.scala:413-424): a query's 500 and
    a failed reload POST an error line to ``log_url``;
  - query coverage (obs/dataobs.py): each answered query's user and
    item references, and how many of them the served model has never
    seen, feed ``pio_query_unknown_entity_ratio``;
  - the version check (ref: UpgradeActor, CreateServer.scala:246): with
    ``PIO_UPDATE_URL`` set, a ``pio-upgrade-check`` thread
    (``tools/upgrade.py``) checks at start and daily; ``stop`` ends and
    joins it.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import queue as _queue
import threading
import time
import urllib.request
import uuid
import weakref
from typing import Any, Callable, List, Optional
from urllib.parse import parse_qs, urlparse

from predictionio_torch.core.engine import Engine
from predictionio_torch.data.storage import (Storage, StorageError,
                                             get_storage)
from predictionio_torch.obs import (dataobs, flight, health, journal,
                                    memacct, metrics, trace)
from predictionio_torch.obs import slo as slo_mod
from predictionio_torch.parallel.context import DeviceContext, DeviceLike
from predictionio_torch.resilience import chaos
from predictionio_torch.resilience.admission import AdmissionController
from predictionio_torch.resilience.policy import CLOSED as _BREAKER_CLOSED
from predictionio_torch.resilience.policy import breaker_for
from predictionio_torch.serving.http import (HTTPServerBase,
                                             JSONRequestHandler,
                                             _admin_authorized)
from predictionio_torch.tools.upgrade import start_upgrade_daemon
from predictionio_torch.workflow.deploy import Deployment, prepare_deploy

log = logging.getLogger(__name__)

DEFAULT_PORT = 8000  # ref: CreateServer.scala:83
BIND_RETRIES = 3     # ref: CreateServer.scala:340-350
UTC = _dt.timezone.utc


#: the one serving-latency series: the status page's count/avg/p50/p99
#: and the /metrics histogram read the SAME child
_SERVING_SECONDS = metrics.histogram(
    "pio_serving_request_seconds",
    "End-to-end serve time per query (queue wait + dispatch), recorded "
    "inside the engine server",
    ("engine",),
)

#: stall detection over micro-batch dispatches: armed once enough
#: dispatches have built a trailing median, fires when one exceeds
#: PIO_STALL_FACTOR x that median (floor 1s x factor)
_DISPATCH_WATCHDOG = health.Watchdog("serving_dispatch")

#: streaming model patches: applied / stale-instance-rejected /
#: unsupported-or-malformed
_MODEL_PATCHES = metrics.counter(
    "pio_model_patches_total",
    "Streaming model patches received by outcome (applied / stale / "
    "rejected)",
    ("result",),
)


class InstanceNotFound(RuntimeError):
    """No COMPLETED engine instance to deploy: ``GET /reload`` answers
    404, while a failure to load or warm the instance answers 500."""


class ServingStats:
    """Request bookkeeping (ref: CreateServer.scala:552-559). Every
    record lands in the engine-wide ``pio_serving_request_seconds``
    histogram (the status page's percentiles read it); counts and
    totals are per server."""

    def __init__(self, engine_id: str = "default"):
        self._lock = threading.Lock()
        self._hist = _SERVING_SECONDS.labels(engine_id)
        self._count = 0
        self._sum = 0.0
        self._last = 0.0
        self.start_time = _dt.datetime.now(tz=UTC)

    def record(self, seconds: float) -> None:
        # the request's trace id rides along as an OpenMetrics exemplar
        trace_id = trace.current_trace_id()
        self._hist.observe(
            seconds, exemplar={"trace_id": trace_id} if trace_id else None)
        with self._lock:
            self._count += 1
            self._sum += seconds
            self._last = seconds

    def snapshot(self) -> dict:
        with self._lock:
            count, total, last = self._count, self._sum, self._last
        return {"startTime": self.start_time.isoformat(),
                "requestCount": count,
                "avgServingSec": total / count if count else 0.0,
                "lastServingSec": last,
                # bucket-interpolated over the engine-wide series
                "p50ServingSec": self._hist.quantile(0.50),
                "p99ServingSec": self._hist.quantile(0.99)}


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "abandoned",
                 "t_submit", "trace_ctx")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # submitter timed out; skip the work
        self.t_submit = time.perf_counter()
        # contextvars do not cross to the worker thread: the submitter's
        # trace context rides along
        self.trace_ctx = trace.current_context()


class MicroBatcher:
    """Coalesce concurrent queries into one dispatch.

    Handler threads submit; one worker drains whatever is queued (up to
    ``max_batch``) and answers a lone request with ``run_one`` and a
    batch with ``run_batch``. No wait window: a lone request is served
    at once, and batches form while the worker is busy. A failing batch
    falls back to per-item evaluation so one malformed query fails
    alone. Each dispatch runs under the ``serving_dispatch`` watchdog,
    with the ``batcher`` chaos seam (tagged ``chaos_tag``) inside its
    window, and the queue depth is a readiness probe
    (``PIO_QUEUE_DEPTH_LIMIT``, default 8 x ``max_batch``), named per
    replica when tagged."""

    def __init__(self, run_batch: Callable[[List[Any]], List[Any]],
                 run_one: Callable[[Any], Any], max_batch: int = 64,
                 chaos_tag: Optional[str] = None):
        self._run_batch = run_batch
        self._run_one = run_one
        self._max_batch = max_batch
        self._chaos_tag = chaos_tag
        self._queue: "_queue.Queue[_Pending]" = _queue.Queue()
        # readiness probe over the queue depth (weakref: a dropped
        # batcher must not be kept alive by the health registry)
        queue_ref = weakref.ref(self._queue)
        self._queue_probe = health.queue_depth_probe(
            lambda: (q.qsize() if (q := queue_ref()) is not None
                     else None),
            max(1, metrics.env_int("PIO_QUEUE_DEPTH_LIMIT", max_batch * 8)))
        # threaded fleet replicas share the process registry: each
        # tagged batcher registers a probe of its own
        self._probe_name = ("serving_queue" if chaos_tag is None
                            else f"serving_queue:{chaos_tag}")
        health.REGISTRY.register(self._probe_name, self._queue_probe)
        self._hist_lock = threading.Lock()
        self._hist: dict = {}
        self._stop = False
        # orders submit()'s stop-check+enqueue against stop()'s flag+wake
        self._stop_lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="pio-batcher")
        self._worker.start()

    def submit(self, payload, timeout: float = 30.0):
        pending = _Pending(payload)
        with self._stop_lock:
            if self._stop:
                raise RuntimeError("serving batcher is stopped")
            self._queue.put(pending)
        if not pending.event.wait(timeout):
            pending.abandoned = True
            raise TimeoutError("query timed out in the serving batcher")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def stop(self) -> None:
        with self._stop_lock:
            if self._stop:
                return
            self._stop = True
            self._queue.put(_Pending(None))  # wake the worker
        # only OUR probe: a newer batcher's live probe survives this stop
        health.REGISTRY.unregister(self._probe_name, self._queue_probe)
        self._worker.join(timeout=60)

    def _loop(self) -> None:
        leftover: List[_Pending] = []
        while True:
            first = self._queue.get()
            if self._stop:
                leftover.append(first)
                break
            batch = [first]
            try:
                while len(batch) < self._max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except _queue.Empty:
                        break
                with _DISPATCH_WATCHDOG.watch():
                    # chaos seam: an injected hang lands inside the
                    # watchdog's window, an injected error fails this
                    # batch's waiters
                    chaos.inject("batcher", tag=self._chaos_tag)
                    self._answer(batch)
            except Exception as e:  # noqa: BLE001 — a dead worker starves
                # every later submitter; fail THIS batch, keep looping
                log.exception("batch worker iteration failed")
                for p in batch:
                    if not p.event.is_set():
                        p.error = e
                        p.event.set()
        # shutdown drain: answer everything still queued with an error;
        # a failed drain is logged, or its submitters would wait out
        # their whole timeout with no symptom
        try:
            while True:
                try:
                    leftover.append(self._queue.get_nowait())
                except _queue.Empty:
                    break
            for p in leftover:
                if p.payload is not None and not p.event.is_set():
                    p.error = RuntimeError("serving batcher stopped")
                    p.event.set()
        except Exception:  # noqa: BLE001 — see above
            log.exception("batcher shutdown drain failed")

    def queue_depth(self) -> int:
        """Requests waiting for the worker now (the admission
        controller's first shed signal)."""
        return self._queue.qsize()

    def histogram(self) -> dict:
        """Dispatch-size distribution since start: {"1": lone requests,
        "2": two-query dispatches, ...}."""
        with self._hist_lock:
            hist = {str(k): v for k, v in sorted(self._hist.items())}
        return {"maxBatch": self._max_batch,
                "dispatches": sum(hist.values()),
                "batchSizeHistogram": hist}

    def _answer(self, batch: List[_Pending]) -> None:
        batch = [p for p in batch if not p.abandoned]
        if not batch:
            return
        with self._hist_lock:
            self._hist[len(batch)] = self._hist.get(len(batch), 0) + 1
        t_start = time.perf_counter()
        if len(batch) == 1:
            p = batch[0]
            token = (trace.activate_context(p.trace_ctx)
                     if p.trace_ctx is not None else None)
            try:
                with trace.span("serve.dispatch", batch_size=1):
                    p.result = self._run_one(p.payload)
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                p.error = e
            finally:
                if token is not None:
                    trace.deactivate(token)
            self._record_splits(batch, t_start)
            p.event.set()
            return
        # a multi-query dispatch gets its own span, under a minted trace
        # id, naming every member's trace; each member's flight record
        # learns the dispatch size it shared
        members = [p.trace_ctx.trace_id for p in batch
                   if p.trace_ctx is not None]
        for tid in members:
            flight.note_field("batch_size", len(batch), trace_id=tid)
        try:
            batch_token = trace.activate(trace.new_trace_id())
            try:
                with trace.span("serve.batch", batch_size=len(batch),
                                members=members):
                    results = self._run_batch([p.payload for p in batch])
            finally:
                trace.deactivate(batch_token)
            for p, r in zip(batch, results):
                p.result = r
        except BaseException as e:  # noqa: BLE001 — isolate the poison query
            log.warning("batch dispatch of %d queries failed (%s: %s); "
                        "re-running individually", len(batch),
                        type(e).__name__, e)
            for p in batch:
                token = (trace.activate_context(p.trace_ctx)
                         if p.trace_ctx is not None else None)
                try:
                    with trace.span("serve.dispatch", batch_size=1,
                                    fallback=True):
                        p.result = self._run_one(p.payload)
                except BaseException as e1:  # noqa: BLE001
                    p.error = e1
                finally:
                    if token is not None:
                        trace.deactivate(token)
        self._record_splits(batch, t_start)
        for p in batch:
            p.event.set()

    @staticmethod
    def _record_splits(batch: List[_Pending], t_start: float) -> None:
        """Each request's queue wait and dispatch time, attributed to its
        flight record."""
        t_done = time.perf_counter()
        for p in batch:
            if p.abandoned or p.trace_ctx is None:
                continue
            tid = p.trace_ctx.trace_id
            flight.note_stage("queue", t_start - p.t_submit, trace_id=tid)
            flight.note_stage("dispatch", t_done - t_start, trace_id=tid)


class EngineServer(HTTPServerBase):
    """One deployed engine behind HTTP (ref: CreateServer.scala:100,106).

    ``device`` says where the models serve from: ``None`` means the card
    and raises without CUDA; ``"cpu"`` runs the plain versions on the
    CPU. The other arguments are the JAX server's (module docstring)."""

    def __init__(
        self,
        engine: Engine,
        engine_id: str,
        engine_version: str = "0",
        engine_variant: str = "default",
        host: str = "0.0.0.0",
        port: int = DEFAULT_PORT,
        storage: Optional[Storage] = None,
        micro_batch: bool = True,
        device: DeviceLike = None,
        feedback_url: Optional[str] = None,
        feedback_access_key: Optional[str] = None,
        log_url: Optional[str] = None,
        bind_retries: int = BIND_RETRIES,
        max_batch: int = 64,
        slo_conf: Optional[dict] = None,
        chaos_tag: Optional[str] = None,
    ):
        self.engine = engine
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.ctx = DeviceContext(device)
        self.storage = storage or get_storage()
        self.feedback_url = feedback_url
        self.feedback_access_key = feedback_access_key
        self.log_url = log_url
        self.stats = ServingStats(engine_id)
        #: the reason of the last failed /readyz storage probe (None
        #: while storage answers): the server is then serving degraded
        self._storage_down: Optional[str] = None
        # the degraded-mode circuit, fed by the readiness storage probe
        # and by reloads: while it is not closed the last-loaded model
        # answers with X-PIO-Degraded and /readyz says DEGRADED
        self._storage_breaker = breaker_for(f"storage:{engine_id}",
                                            failure_threshold=2)
        self._deployment_lock = threading.Lock()
        #: model patches by outcome (``apply_patch``)
        self.patches = {"applied": 0, "rejected": 0, "stale": 0}
        self._patches_lock = threading.Lock()
        self.deployment: Deployment = self._load(None)
        # a fleet replica is tagged by its supervisor (a subprocess
        # replica through PIO_CHAOS_TAG); a lone server stays untagged
        self.chaos_tag = chaos_tag or os.environ.get("PIO_CHAOS_TAG") or None
        self._batcher: Optional[MicroBatcher] = (
            MicroBatcher(self._query_batch_now, self._query_now,
                         max_batch=max_batch, chaos_tag=self.chaos_tag)
            if micro_batch else None)
        # admission control: the env defaults, then PIO_SLO_FILE's
        # "shed" block, then the variant's "slo.shed" (most specific
        # wins); the variant's objectives are layered over the file's
        file_conf = slo_mod.configure_from_env() or {}
        if slo_conf:
            slo_mod.configure({**file_conf, **slo_conf})
        self.admission = AdmissionController(
            "engine",
            queue_depth=lambda: (self._batcher.queue_depth()
                                 if self._batcher is not None else None),
            inflight=lambda: float(self.inflight_count()),
            max_queue_depth=metrics.env_int("PIO_SHED_QUEUE_DEPTH",
                                            max_batch * 4),
        )
        for conf in (file_conf, slo_conf or {}):
            shed = conf.get("shed") if isinstance(conf, dict) else None
            if shed:
                self.admission.configure(shed)
        super().__init__(host, port, _EngineRequestHandler,
                         bind_retries=bind_retries)
        # the devices probe checks this deployment's card from now on
        health.register_device(self.ctx.device)
        # daily version check, no-op unless PIO_UPDATE_URL is configured
        # (ref: UpgradeActor, CreateServer.scala:163-170,246); started
        # once the port is bound, ended and joined by stop()
        self._upgrade = start_upgrade_daemon("engine-server")

    # -- deployment management ----------------------------------------------
    def _resolve_instance(self, instance_id: Optional[str]):
        if instance_id:
            instance = self.storage.engine_instances().get(instance_id)
            if instance is None or instance.status != "COMPLETED":
                raise InstanceNotFound(f"engine instance {instance_id} not "
                                       "found or not COMPLETED")
            return instance
        instance = self.storage.engine_instances().get_latest_completed(
            self.engine_id, self.engine_version, self.engine_variant)
        if instance is None:
            raise InstanceNotFound(
                f"No valid engine instance found for engine {self.engine_id} "
                f"{self.engine_version} {self.engine_variant}")
        return instance

    def _load(self, instance_id: Optional[str]) -> Deployment:
        """A warm deployment of the latest (or the named) COMPLETED
        instance: models loaded onto the device, every serve shape
        driven once."""
        instance = self._resolve_instance(instance_id)
        deployment = prepare_deploy(self.engine, instance, self.ctx,
                                    self.storage)
        t0 = time.perf_counter()
        for algo, model in zip(deployment.algorithms, deployment.models):
            algo.warmup(model, self.ctx)
        log.info("serve warm-up done in %.2fs", time.perf_counter() - t0)
        return deployment

    def reload(self, instance_id: Optional[str] = None,
               force: bool = False) -> str:
        """Hot-swap to the latest (or the named) completed instance
        (ref: /reload :592); the swap happens once the new deployment is
        warm, so live traffic never waits on it.

        The memory preflight (obs/memacct.py) prices the instance from
        its stored blob first and raises :class:`memacct.
        PreflightRefused` when it would exceed the device's headroom,
        unless ``force``. The swap releases the old deployment's
        ledger footprints. A reload that fails on storage feeds the
        degraded-mode circuit; one that succeeds closes it."""
        try:
            instance = self._resolve_instance(instance_id)
        except (StorageError, ConnectionError):
            self._storage_breaker.record_failure()
            raise
        # a refused preflight is a capacity verdict, not a storage
        # failure: outside the breaker's accounting
        try:
            memacct.preflight_check(instance.id, self.storage, force=force)
        except memacct.PreflightRefused as e:
            journal.emit("preflight_refused", instance=instance.id,
                         detail=str(e)[:200])
            raise
        try:
            deployment = self._load(instance.id)
        except (StorageError, ConnectionError):
            self._storage_breaker.record_failure()
            raise
        self._storage_breaker.record_success()
        with self._deployment_lock:
            old, self.deployment = self.deployment, deployment
        journal.emit("reload", instance=deployment.instance.id,
                     prev=old.instance.id, requested=instance_id,
                     forced=force or None)
        for model in old.models:
            memacct.release_model(model)
        return deployment.instance.id

    # -- streaming model patches (workflow/stream.py) -----------------------
    class StalePatch(RuntimeError):
        """The patch targets an instance this server no longer serves."""

    def _count_patch(self, outcome: str) -> None:
        with self._patches_lock:
            self.patches[outcome] += 1
        _MODEL_PATCHES.labels(outcome).inc()

    def apply_patch(self, payload: dict) -> dict:
        """Apply a streaming fold-in patch to the live deployment: the
        light freshness lane between full reloads. Applied under the
        deployment lock (between queries); each algorithm's
        ``apply_patch`` swaps rows copy-on-write, so in-flight queries
        see old or new tables, never torn rows.

        Raises :class:`StalePatch` when ``instanceId`` names another
        instance (the caller should resync), ValueError on malformed or
        unsupported blocks. Returns {"applied": n_blocks}."""
        instance_id = payload.get("instanceId")
        blocks = payload.get("algorithms")
        if not isinstance(blocks, list) or not blocks:
            self._count_patch("rejected")
            raise ValueError("patch needs a non-empty 'algorithms' list")
        with self._deployment_lock:
            deployment = self.deployment
            if instance_id and instance_id != deployment.instance.id:
                self._count_patch("stale")
                journal.emit("patch", outcome="stale",
                             instance=instance_id,
                             deployed=deployment.instance.id)
                raise self.StalePatch(
                    f"patch targets instance {instance_id} but "
                    f"{deployment.instance.id} is deployed")
            applied = 0
            for block in blocks:
                if not isinstance(block, dict):
                    self._count_patch("rejected")
                    raise ValueError("each algorithm block must be an object")
                idx = block.get("index", 0)
                if not isinstance(idx, int) or not (
                        0 <= idx < len(deployment.algorithms)):
                    self._count_patch("rejected")
                    raise ValueError(f"algorithm index {idx!r} out of range")
                algo = deployment.algorithms[idx]
                model = deployment.models[idx]
                try:
                    ok = algo.apply_patch(model, block)
                except ValueError:
                    self._count_patch("rejected")
                    raise
                if not ok:
                    self._count_patch("rejected")
                    raise ValueError(
                        f"algorithm {type(algo).__name__} does not "
                        "support model patches — use /reload")
                applied += 1
        self._count_patch("applied")
        journal.emit("patch", outcome="ok", applied=applied,
                     instance=instance_id)
        return {"applied": applied}

    # -- degraded mode ------------------------------------------------------
    def degraded_reason(self) -> Optional[str]:
        """Non-None while serving degraded: the storage circuit is not
        closed, or the last storage probe failed, so the last-loaded
        model answers but reloads and feedback cannot be trusted. The
        string is the ``X-PIO-Degraded`` response header."""
        if (self._storage_down is None
                and self._storage_breaker.state == _BREAKER_CLOSED):
            return None
        with self._deployment_lock:
            instance_id = self.deployment.instance.id
        return ("storage unavailable; serving last-loaded instance "
                f"{instance_id}")

    def storage_readyz_probe(self) -> health.ProbeResult:
        """The engine server's ``/readyz`` storage probe: storage loss
        while a model is loaded is DEGRADED, not FAILED — the server can
        still answer queries; it cannot reload. The probe feeds the
        degraded-mode circuit: consecutive failures open it (probes then
        fail fast instead of stalling on a dead backend), and the
        half-open probe's success closes it."""
        breaker = self._storage_breaker
        if not breaker.allow():
            return health.degraded(
                f"storage circuit open (next probe in "
                f"{breaker.retry_after():.0f}s); {self.degraded_reason()}")
        try:
            result = health.storage_probe(self.storage)
        except Exception as e:  # noqa: BLE001 — a raising probe IS the finding
            result = health.failed(f"{type(e).__name__}: {e}")
        if result.status == health.FAILED:
            self._storage_down = result.reason
            breaker.record_failure()
            return health.degraded(
                f"{result.reason}; serving degraded from the last-loaded "
                "model")
        self._storage_down = None
        breaker.record_success()
        return result

    # -- query path ---------------------------------------------------------
    def _query_now(self, payload: Any) -> Any:
        with self._deployment_lock:
            deployment = self.deployment
        return deployment.query(payload)

    def _query_batch_now(self, payloads: List[Any]) -> List[Any]:
        with self._deployment_lock:
            deployment = self.deployment
        return deployment.query_batch(payloads)

    def query(self, payload: Any) -> Any:
        t0 = time.perf_counter()
        with trace.span("serve.query", engine=self.engine_id):
            if self._batcher is not None:
                result = self._batcher.submit(payload)
            else:
                t_disp = time.perf_counter()
                result = self._query_now(payload)
                flight.note_stage("dispatch", time.perf_counter() - t_disp)
        self.stats.record(time.perf_counter() - t0)
        self._note_query_coverage(payload)
        if self.feedback_url and self.feedback_access_key:
            # prId lets follow-up events join back to this prediction
            pr_id = uuid.uuid4().hex
            if isinstance(result, dict):
                result = {**result, "prId": pr_id}
            with self._deployment_lock:
                instance_id = self.deployment.instance.id
            threading.Thread(
                target=self._send_feedback,
                args=(payload, result, pr_id, instance_id,
                      trace.traced_headers()),
                daemon=True, name="pio-feedback").start()
        return result

    def _note_query_coverage(self, payload: Any) -> None:
        """Unknown-entity accounting at the query-decode seam
        (obs/dataobs.py): how many user/item references this query
        named, and how many the served model has never seen. Best
        effort: accounting never breaks serving."""
        try:
            if not isinstance(payload, dict) or not dataobs.DATAOBS.enabled():
                return
            users = [payload["user"]] if payload.get("user") is not None \
                else []
            items = list(payload.get("items") or [])
            if payload.get("item") is not None:
                items.append(payload["item"])
            if not users and not items:
                return
            with self._deployment_lock:
                models = list(self.deployment.models)
            user_maps = [m.user_ids for m in models
                         if getattr(m, "user_ids", None) is not None]
            item_maps = [m.item_ids for m in models
                         if getattr(m, "item_ids", None) is not None]
            refs = unknown = 0
            if users and user_maps:
                refs += len(users)
                unknown += sum(
                    1 for u in users
                    if not any(str(u) in ids for ids in user_maps))
            if items and item_maps:
                refs += len(items)
                unknown += sum(
                    1 for i in items
                    if not any(str(i) in ids for ids in item_maps))
            if refs:
                dataobs.DATAOBS.note_query(refs, unknown)
        except Exception:  # noqa: BLE001
            log.debug("query coverage accounting failed", exc_info=True)

    @staticmethod
    def _post_json(url: str, payload: Any, what: str,
                   headers: dict) -> None:
        """One best-effort JSON POST (the feedback loop and the remote
        error log; failures are logged, never raised). ``headers`` are
        the trace headers of the request it reports on, taken on that
        request's thread."""
        try:
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json", **headers},
                method="POST")
            urllib.request.urlopen(req, timeout=5).close()
        except Exception as e:  # noqa: BLE001 — best-effort
            log.warning("%s POST failed: %s", what, e)

    def remote_log(self, message: str, level: str = "ERROR") -> None:
        """POST an error line to ``log_url`` on a thread of its own
        (fire-and-forget: a dead log endpoint never affects serving)."""
        if not self.log_url:
            return
        payload = {"level": level, "message": message,
                   "engineId": self.engine_id,
                   "engineVariant": self.engine_variant}
        threading.Thread(
            target=self._post_json,
            args=(self.log_url, payload, "remote log",
                  trace.traced_headers()),
            daemon=True, name="pio-remote-log").start()

    def _send_feedback(self, query: Any, prediction: Any, pr_id: str,
                       instance_id: str, headers: dict) -> None:
        """The asynchronous ``predict`` event of the feedback loop."""
        event = {
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": instance_id,
            "prId": pr_id,
            "properties": {"query": query, "prediction": prediction},
        }
        self._post_json(
            f"{self.feedback_url}/events.json?accessKey="
            f"{self.feedback_access_key}", event, "feedback loop",
            headers=headers)

    def stop(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
        # retire this server's residency from the memory ledger and its
        # card from the devices probe
        with self._deployment_lock:
            models = list(self.deployment.models)
        for model in models:
            memacct.release_model(model)
        if not self._stopped.is_set():
            health.unregister_device(self.ctx.device)
        if self._upgrade is not None:
            self._upgrade.stop()
        super().stop()

    def status(self) -> dict:
        """ref: status landing page content (CreateServer.scala:433-459)."""
        with self._deployment_lock:
            instance = self.deployment.instance
            models = list(self.deployment.models)
        return {
            "status": "alive",
            "engineId": self.engine_id,
            "engineVersion": self.engine_version,
            "engineVariant": self.engine_variant,
            "engineInstanceId": instance.id,
            "engineFactory": instance.engine_factory,
            "trainedAt": instance.end_time.isoformat(),
            "device": str(self.ctx.device),
            "algorithms": json.loads(instance.algorithms_params or "[]"),
            "stats": self.stats.snapshot(),
            "batcher": (self._batcher.histogram()
                        if self._batcher is not None else None),
            "patches": dict(self.patches),
            # the resilience surface: shed limits and counts, degraded
            # mode, the storage circuit
            "admission": self.admission.snapshot(),
            "degraded": self.degraded_reason(),
            "storageCircuit": self._storage_breaker.snapshot(),
            # each model's BUILT retrieval index (kernel plan + launches)
            "retrieval": [m.retrieval_stats()
                          if hasattr(m, "retrieval_stats") else None
                          for m in models],
        }


class _EngineRequestHandler(JSONRequestHandler):
    server_version = "PIOEngineServer/0.1"

    def do_GET(self):
        url = urlparse(self.path)
        if url.path == "/":
            self._send(200, self.server_ref.status())
        elif url.path == "/reload":
            params = parse_qs(url.query)
            target = (params.get("instance") or [None])[0]
            force = (params.get("force") or ["0"])[0].lower() in ("1",
                                                                  "true")
            try:
                instance_id = self.server_ref.reload(target, force=force)
            except InstanceNotFound as e:
                self.server_ref.remote_log(f"reload failed: {e}")
                self._send(404, {"message": str(e)})
                return
            except memacct.PreflightRefused as e:
                # 507: the instance would exceed device-memory headroom;
                # refused before any load, the serving model untouched
                self._send(507, {"message": str(e),
                                 "preflight": e.decision})
                return
            except Exception as e:  # noqa: BLE001 — load or warm-up failed
                log.exception("reload failed")
                self.server_ref.remote_log(
                    f"reload failed: {type(e).__name__}: {e}")
                self._send(500, {"message": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"message": "reloaded",
                             "engineInstanceId": instance_id})
        else:
            self._send(404, {"message": "Not Found"})

    def do_POST(self):
        path = urlparse(self.path).path
        if path == "/queries.json":
            self._query()
        elif path == "/model/patch":
            self._patch()
        elif path == "/stop":
            self._send(200, {"message": "stopping"})
            self.server_ref.stop()
        else:
            self._send(404, {"message": "Not Found"})

    def _query(self):
        # admission control first, before the body is read: an
        # overloaded server's cheapest work is saying no
        decision = self.server_ref.admission.check()
        if decision is not None:
            flight.note_field("shed", decision.reason)
            self._send(
                429,
                {"message": "overloaded — retry after the advised delay",
                 "reason": decision.reason, "detail": decision.detail,
                 "retryAfterSec": decision.retry_after},
                extra_headers={"Retry-After": str(decision.retry_after)})
            return
        try:
            payload = self._read_json()
        except json.JSONDecodeError as e:
            self._send(400, {"message": f"invalid JSON: {e}"})
            return
        # opt-in replay capture (PIO_FLIGHT_PAYLOADS)
        flight.record_payload(
            "/queries.json", payload,
            nbytes=int(self.headers.get("Content-Length") or 0))
        try:
            result = self.server_ref.query(payload)
        except (KeyError, TypeError, ValueError) as e:
            # malformed query for this engine (ref: 400 on bad query JSON)
            self._send(400, {"message": f"bad query: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — answer 500, keep serving
            log.exception("query failed")
            # the answered-500 path never raises through the wrapper: the
            # flight record must carry WHAT failed
            flight.note_field("error", f"{type(e).__name__}: {e}")
            self.server_ref.remote_log(
                f"query failed: {type(e).__name__}: {e}")
            self._send(500, {"message": f"{type(e).__name__}: {e}"})
            return
        degraded = self.server_ref.degraded_reason()
        self._send(200, result,
                   extra_headers=({"X-PIO-Degraded": degraded}
                                  if degraded else None))

    def _patch(self):
        # a patch MUTATES the served model: the admin bearer gate
        if not _admin_authorized(self):
            self._send(401, {"message": "missing or invalid bearer "
                                        "token (PIO_ADMIN_TOKEN)"},
                       extra_headers={"WWW-Authenticate": "Bearer"})
            return
        try:
            payload = self._read_json()
        except json.JSONDecodeError as e:
            self._send(400, {"message": f"invalid JSON: {e}"})
            return
        try:
            result = self.server_ref.apply_patch(payload)
        except EngineServer.StalePatch as e:
            self._send(409, {"message": str(e)})
            return
        except (ValueError, TypeError, KeyError) as e:
            self._send(400, {"message": f"bad patch: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — a failing patch must
            # answer 500, never crash the keep-alive connection
            log.exception("model patch failed")
            self._send(500, {"message": str(e)})
            return
        self._send(200, {"message": "patched", **result})


def deploy(engine: Engine, engine_id: str, engine_version: str = "0",
           engine_variant: str = "default", **kwargs) -> EngineServer:
    """Build + start a server for the latest completed instance (the
    `pio deploy` path, Console.scala:830)."""
    return EngineServer(engine, engine_id, engine_version=engine_version,
                        engine_variant=engine_variant, **kwargs).start()
