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
build or launch does not go live. Admission control, SLOs, feedback and
the obs surface come with later slices; the outcomes of model patches
are a plain per-server count (``GET /`` ``patches``).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import queue as _queue
import threading
import time
from typing import Any, Callable, List, Optional
from urllib.parse import parse_qs, urlparse

from predictionio_torch.core.engine import Engine
from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.parallel.context import DeviceContext, DeviceLike
from predictionio_torch.serving.http import (HTTPServerBase,
                                             JSONRequestHandler,
                                             _admin_authorized)
from predictionio_torch.workflow.deploy import Deployment, prepare_deploy

log = logging.getLogger(__name__)

DEFAULT_PORT = 8000  # ref: CreateServer.scala:83
BIND_RETRIES = 3     # ref: CreateServer.scala:340-350
UTC = _dt.timezone.utc


class InstanceNotFound(RuntimeError):
    """No COMPLETED engine instance to deploy: ``GET /reload`` answers
    404, while a failure to load or warm the instance answers 500."""


class ServingStats:
    """Request bookkeeping (ref: CreateServer.scala:552-559)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._last = 0.0
        self.start_time = _dt.datetime.now(tz=UTC)

    def record(self, seconds: float) -> None:
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
                "lastServingSec": last}


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "abandoned")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # submitter timed out; skip the work


class MicroBatcher:
    """Coalesce concurrent queries into one dispatch.

    Handler threads submit; one worker drains whatever is queued (up to
    ``max_batch``) and answers a lone request with ``run_one`` and a
    batch with ``run_batch``. No wait window: a lone request is served
    at once, and batches form while the worker is busy. A failing batch
    falls back to per-item evaluation so one malformed query fails
    alone."""

    def __init__(self, run_batch: Callable[[List[Any]], List[Any]],
                 run_one: Callable[[Any], Any], max_batch: int = 64):
        self._run_batch = run_batch
        self._run_one = run_one
        self._max_batch = max_batch
        self._queue: "_queue.Queue[_Pending]" = _queue.Queue()
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
        self._worker.join(timeout=60)

    def _loop(self) -> None:
        leftover: List[_Pending] = []
        while True:
            first = self._queue.get()
            if self._stop:
                leftover.append(first)
                break
            batch = [first]
            while len(batch) < self._max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except _queue.Empty:
                    break
            try:
                self._answer(batch)
            except Exception as e:  # noqa: BLE001 — a dead worker starves
                # every later submitter; fail THIS batch, keep looping
                log.exception("batch worker iteration failed")
                for p in batch:
                    if not p.event.is_set():
                        p.error = e
                        p.event.set()
        # shutdown drain: answer everything still queued with an error
        while True:
            try:
                leftover.append(self._queue.get_nowait())
            except _queue.Empty:
                break
        for p in leftover:
            if p.payload is not None and not p.event.is_set():
                p.error = RuntimeError("serving batcher stopped")
                p.event.set()

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
        if len(batch) == 1:
            p = batch[0]
            try:
                p.result = self._run_one(p.payload)
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                p.error = e
            p.event.set()
            return
        try:
            results = self._run_batch([p.payload for p in batch])
            for p, r in zip(batch, results):
                p.result = r
        except BaseException as e:  # noqa: BLE001 — isolate the poison query
            log.warning("batch dispatch of %d queries failed (%s: %s); "
                        "re-running individually", len(batch),
                        type(e).__name__, e)
            for p in batch:
                try:
                    p.result = self._run_one(p.payload)
                except BaseException as e1:  # noqa: BLE001
                    p.error = e1
        for p in batch:
            p.event.set()


class EngineServer(HTTPServerBase):
    """One deployed engine behind HTTP (ref: CreateServer.scala:100,106).

    ``device`` says where the models serve from: ``None`` means the card
    and raises without CUDA; ``"cpu"`` runs the plain versions on the
    CPU."""

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
    ):
        self.engine = engine
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.ctx = DeviceContext(device)
        self.storage = storage or get_storage()
        self.stats = ServingStats()
        self._deployment_lock = threading.Lock()
        #: model patches by outcome (``apply_patch``)
        self.patches = {"applied": 0, "rejected": 0, "stale": 0}
        self._patches_lock = threading.Lock()
        self.deployment: Deployment = self._load(None)
        self._batcher: Optional[MicroBatcher] = (
            MicroBatcher(self._query_batch_now, self._query_now)
            if micro_batch else None)
        super().__init__(host, port, _EngineRequestHandler,
                         bind_retries=BIND_RETRIES)

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

    def reload(self, instance_id: Optional[str] = None) -> str:
        """Hot-swap to the latest (or the named) completed instance
        (ref: /reload :592); the swap happens once the new deployment is
        warm, so live traffic never waits on it."""
        deployment = self._load(instance_id)
        with self._deployment_lock:
            self.deployment = deployment
        return deployment.instance.id

    # -- streaming model patches (workflow/stream.py) -----------------------
    class StalePatch(RuntimeError):
        """The patch targets an instance this server no longer serves."""

    def _count_patch(self, outcome: str) -> None:
        with self._patches_lock:
            self.patches[outcome] += 1

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
        return {"applied": applied}

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
        if self._batcher is not None:
            result = self._batcher.submit(payload)
        else:
            result = self._query_now(payload)
        self.stats.record(time.perf_counter() - t0)
        return result

    def stop(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
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
            target = (parse_qs(url.query).get("instance") or [None])[0]
            try:
                instance_id = self.server_ref.reload(target)
            except InstanceNotFound as e:
                self._send(404, {"message": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — load or warm-up failed
                log.exception("reload failed")
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
        try:
            payload = self._read_json()
        except json.JSONDecodeError as e:
            self._send(400, {"message": f"invalid JSON: {e}"})
            return
        try:
            result = self.server_ref.query(payload)
        except (KeyError, TypeError, ValueError) as e:
            # malformed query for this engine (ref: 400 on bad query JSON)
            self._send(400, {"message": f"bad query: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — answer 500, keep serving
            log.exception("query failed")
            self._send(500, {"message": f"{type(e).__name__}: {e}"})
            return
        self._send(200, result)

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
