"""Training workflow: train an engine, persist models + instance metadata.

Counterpart of ``predictionio_tpu/workflow/train.py`` (ref:
workflow/CoreWorkflow.runTrain:42 and CreateWorkflow.scala:232-255):
create an EngineInstance row (INIT), run Engine.train on the context's
device, pickle the per-algorithm models into the Models repo under the
instance id (a ``PersistentModel`` saves itself and leaves a manifest
there), snapshot the full params into the instance, and mark it
COMPLETED — or FAILED on error.

Observability, as in the JAX workflow: the run's data-path stages
accumulate in ``perfacct.LEDGER`` under the instance id (Engine.train
notes read/prepare/fit, the trainers their own stages, this function
the whole ``train``), ``engine.train`` runs under the train-step
deadman watchdog (the trainers beat it through
``torchmon.observe_train_step``), the whole-train wall time lands in
``pio_train_seconds{engine}``, the device-memory gauges refresh after
the train, and a completed instance moves the freshness horizon
(``note_publish``), freezes the data plane's schema profile as the
trained-against baseline (``dataobs.freeze_schemas``) and logs the
stage split in one line. The chaos
harness's ``train`` seam sits just before ``engine.train``. The JAX
package's profiler capture is not ported (ROADMAP.md, queue 1 item 13).

Across processes (``PIO_COORDINATOR_ADDRESS``, ``PIO_NUM_PROCESSES``,
``PIO_PROCESS_ID``; ``parallel.multihost.initialize_from_env`` runs
before any mesh), every process runs the same ``engine.train`` on its
own device, with the context's mesh over the world so the ALS half-step
shards over the ranks, and storage is single-writer: process 0 alone
writes the EngineInstance row and the model blob, the instance id is
broadcast from it, the models are serialized on every process, and a
final barrier makes the COMPLETED row visible to every process before
any of them goes on to deploy. A failure on one process ends that
process; its peers then fail in their next collective (the gloo or NCCL
timeout), as a lost Spark driver fails its executors.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import pickle
import time
import uuid
from typing import Any, List, Optional

from predictionio_torch.core.engine import Engine
from predictionio_torch.core.params import EngineParams
from predictionio_torch.core.persistent_model import (PersistentModel,
                                                      manifest_for)
from predictionio_torch.data.metadata import EngineInstance, Model
from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.obs import dataobs, health, memacct, perfacct, torchmon
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.parallel.mesh import create_mesh
from predictionio_torch.resilience import chaos
from predictionio_torch.workflow.config import WorkflowParams

log = logging.getLogger(__name__)
UTC = _dt.timezone.utc


def _now() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def serialize_models(models: List[Any]) -> bytes:
    """Models -> bytes for the Models repo (ref: CoreWorkflow.scala:69-74).
    The port's models pickle without their device state; the deploy
    loader puts them back on its device."""
    return pickle.dumps(models)


def persisted_models(engine: Engine, engine_params: EngineParams,
                     models: List[Any], instance_id: str,
                     ctx: DeviceContext) -> List[Any]:
    """Each algorithm's persisted form of its model
    (``Algorithm.make_persistent_model``); a ``PersistentModel`` saves
    itself under the instance id and is replaced by its manifest (ref:
    Engine.makeSerializableModels:260, PAlgorithm.makePersistentModel:98)."""
    out = []
    for algo, model in zip(engine.make_algorithms(engine_params), models):
        pm = algo.make_persistent_model(model)
        if isinstance(pm, PersistentModel):
            pm.save(instance_id, algo.params, ctx)
            pm = manifest_for(pm)
        out.append(pm)
    return out


def run_train(engine: Engine, engine_params: EngineParams, engine_id: str,
              engine_version: str = "0", engine_variant: str = "default",
              engine_factory: str = "", batch: str = "",
              ctx: Optional[DeviceContext] = None,
              workflow_params: Optional[WorkflowParams] = None,
              storage: Optional[Storage] = None) -> EngineInstance:
    """ref: CoreWorkflow.runTrain:42. Returns the COMPLETED instance.
    ``ctx`` defaults to the card (the rank's card across processes; a
    ``ctx`` on the CPU makes the ranks join over gloo)."""
    distributed = mh.initialize_from_env(
        device=ctx.device if ctx is not None else None)
    storage = storage or get_storage()
    ctx = ctx or DeviceContext(mh.rank_device() if distributed else None)
    if distributed and ctx.mesh is None:
        ctx.mesh = create_mesh()
    wp = workflow_params or WorkflowParams()
    writer = not distributed or mh.process_index() == 0
    ep_json = engine_params.to_json_dict()
    instance = EngineInstance(
        id=mh.broadcast_string(uuid.uuid4().hex), status="INIT",
        start_time=_now(),
        end_time=_now(), engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant, engine_factory=engine_factory,
        batch=batch or wp.batch,
        data_source_params=json.dumps(ep_json["dataSourceParams"]),
        preparator_params=json.dumps(ep_json["preparatorParams"]),
        algorithms_params=json.dumps(ep_json["algorithmParamsList"]),
        serving_params=json.dumps(ep_json["servingParams"]))
    inserted = False
    if writer:
        storage.engine_instances().insert(instance)
        inserted = True
    log.info("training instance %s (engine %s) on %s", instance.id,
             engine_id, ctx.device)
    perfacct.LEDGER.start_run(instance.id)
    try:
        instance.status = "TRAINING"
        if writer:
            storage.engine_instances().update(instance)
        t0 = time.perf_counter()
        with health.TRAIN_WATCHDOG.deadman():
            # chaos seam: an injected train fault takes the FAILED
            # instance path below; an injected hang sits under the
            # deadman
            chaos.inject("train")
            result = engine.train(ctx, engine_params, wp)
        train_sec = time.perf_counter() - t0
        log.info("engine.train took %.2f s", train_sec)
        torchmon.TRAIN_SECONDS.labels(engine_id).observe(train_sec)
        perfacct.LEDGER.note_stage("train", train_sec)
        memacct.refresh()
        if result.stopped_after:
            # debug interruption (ref: Engine.scala:624-648): no model
            instance.batch = (instance.batch + f" [stopped after "
                              f"{result.stopped_after}]").strip()
        elif wp.save_model:
            # serialized on every process (a save hook may need all of
            # them); only the writer stores
            blob = serialize_models(persisted_models(
                engine, engine_params, result.models, instance.id, ctx))
            if writer:
                storage.models().insert(Model(id=instance.id, models=blob))
        instance.status = "COMPLETED"
        instance.end_time = _now()
        if writer:
            storage.engine_instances().update(instance)
        # the model is servable: move the freshness horizon
        perfacct.LEDGER.note_publish()
        # the live schema profile becomes the trained-against baseline:
        # drift after this point is what schema_change events report
        dataobs.DATAOBS.freeze_schemas(instance.id)
        runs = perfacct.LEDGER.snapshot().get("runs") or []
        if runs:
            stages = runs[-1].get("stages") or {}
            log.info("events->model stages (sec): %s",
                     " ".join(f"{k}={v:.2f}"
                              for k, v in sorted(stages.items())),
                     extra={"pio": {"instance": instance.id,
                                    "datapath_stages": stages}})
        # every process sees the COMPLETED row before any deploys from it
        mh.barrier("pio_train_" + instance.id)
        log.info("training completed: instance %s", instance.id)
        return instance
    except Exception:
        instance.status = "FAILED"
        instance.end_time = _now()
        if inserted:
            # never update a row that was never inserted (the insert
            # itself may be what failed)
            storage.engine_instances().update(instance)
        raise
