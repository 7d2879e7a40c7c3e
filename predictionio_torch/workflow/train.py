"""Training workflow: train an engine, persist models + instance metadata.

Counterpart of ``predictionio_tpu/workflow/train.py`` for one process
(ref: workflow/CoreWorkflow.runTrain:42 and CreateWorkflow.scala:232-255):
create an EngineInstance row (INIT), run Engine.train on the context's
device, pickle the per-algorithm models into the Models repo under the
instance id (a ``PersistentModel`` saves itself and leaves a manifest
there), snapshot the full params into the instance, and mark it
COMPLETED — or FAILED on error. The JAX package's multi-host writer
election, chaos seam, profiler capture and observability hooks are not
ported (ROADMAP.md, queue 1 items 12 and 13).
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
from predictionio_torch.parallel.context import DeviceContext
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
    ``ctx`` defaults to the card."""
    storage = storage or get_storage()
    ctx = ctx or DeviceContext()
    wp = workflow_params or WorkflowParams()
    ep_json = engine_params.to_json_dict()
    instance = EngineInstance(
        id=uuid.uuid4().hex, status="INIT", start_time=_now(),
        end_time=_now(), engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant, engine_factory=engine_factory,
        batch=batch or wp.batch,
        data_source_params=json.dumps(ep_json["dataSourceParams"]),
        preparator_params=json.dumps(ep_json["preparatorParams"]),
        algorithms_params=json.dumps(ep_json["algorithmParamsList"]),
        serving_params=json.dumps(ep_json["servingParams"]))
    storage.engine_instances().insert(instance)
    log.info("training instance %s (engine %s) on %s", instance.id,
             engine_id, ctx.device)
    try:
        instance.status = "TRAINING"
        storage.engine_instances().update(instance)
        t0 = time.perf_counter()
        result = engine.train(ctx, engine_params, wp)
        log.info("engine.train took %.2f s", time.perf_counter() - t0)
        if result.stopped_after:
            # debug interruption (ref: Engine.scala:624-648): no model
            instance.batch = (instance.batch + f" [stopped after "
                              f"{result.stopped_after}]").strip()
        elif wp.save_model:
            storage.models().insert(Model(
                id=instance.id, models=serialize_models(persisted_models(
                    engine, engine_params, result.models, instance.id,
                    ctx))))
        instance.status = "COMPLETED"
        instance.end_time = _now()
        storage.engine_instances().update(instance)
        log.info("training completed: instance %s", instance.id)
        return instance
    except Exception:
        instance.status = "FAILED"
        instance.end_time = _now()
        storage.engine_instances().update(instance)
        raise
