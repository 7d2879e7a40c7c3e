"""Deploy-time model + params reload.

Counterpart of ``predictionio_tpu/workflow/deploy.py`` (ref:
workflow/CreateServer.createServerActorWithEngine:190 +
controller/Engine.prepareDeploy:174 + engineInstanceToEngineParams:387):
given a COMPLETED EngineInstance, rebuild the EngineParams from the
instance's params snapshot, load the model blob from the Models repo,
resolve PersistentModel manifests, and instantiate algorithms + serving
with their models on the deployment's device.

Blobs load across packages. A model trained by the JAX package pickles
``predictionio_tpu.models.als.ALSModel`` (numpy factors,
``predictionio_tpu.data.bimap.BiMap`` id maps); the unpickler here
rewrites the module prefix ``predictionio_tpu.`` to
``predictionio_torch.`` as a string before it resolves a class, so the
blob loads into the port's classes and nothing of the JAX package is
imported. Unpickle only blobs this deployment's own storage holds:
unpickling can run arbitrary code.
"""

from __future__ import annotations

import io
import json
import pickle
from dataclasses import dataclass
from typing import Any, List, Optional

from predictionio_torch.core.controller import Algorithm, Serving
from predictionio_torch.core.engine import (Engine, _declared_params_class,
                                            port_module)
from predictionio_torch.core.params import EngineParams, params_from_dict
from predictionio_torch.core.persistent_model import (PersistentModelManifest,
                                                      load_from_manifest)
from predictionio_torch.data.metadata import EngineInstance
from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.parallel.compile_cache import enable_persistent_cache
from predictionio_torch.parallel.context import DeviceContext


class PortUnpickler(pickle.Unpickler):
    """Resolves every ``predictionio_tpu.*`` class under
    ``predictionio_torch.*`` (a string rewrite: the JAX package is never
    imported)."""

    def find_class(self, module: str, name: str):
        return super().find_class(port_module(module), name)


def load_blob(data: bytes) -> Any:
    return PortUnpickler(io.BytesIO(data)).load()


def engine_params_from_instance(engine: Engine,
                                instance: EngineInstance) -> EngineParams:
    """Instance params snapshot -> EngineParams (ref: Engine.scala:387)."""

    def params_for(classes, block, what):
        name = block.get("name", "")
        cls = classes.get(name)
        if cls is None:
            raise KeyError(f"{what} {name!r} from instance not in engine")
        return (name, params_from_dict(_declared_params_class(cls),
                                       block.get("params")))

    def slot(raw: str, classes):
        block = json.loads(raw) if raw else {"name": "", "params": {}}
        return params_for(classes, block, "component")

    algo_blocks = (json.loads(instance.algorithms_params)
                   if instance.algorithms_params else [])
    return EngineParams(
        data_source_params=slot(instance.data_source_params,
                                engine.data_source_classes),
        preparator_params=slot(instance.preparator_params,
                               engine.preparator_classes),
        algorithm_params_list=[
            params_for(engine.algorithm_classes, b, "algorithm")
            for b in algo_blocks],
        serving_params=slot(instance.serving_params, engine.serving_classes),
    )


@dataclass
class Deployment:
    """Everything the engine server needs to answer /queries.json."""

    instance: EngineInstance
    engine_params: EngineParams
    algorithms: List[Algorithm]
    models: List[Any]
    serving: Serving

    def query(self, q: Any) -> Any:
        """One query through all algorithms + serving
        (ref: CreateServer.scala:472-475)."""
        predictions = [algo.predict(model, q)
                       for algo, model in zip(self.algorithms, self.models)]
        return self.serving.serve(q, predictions)

    def query_batch(self, payloads: List[Any]) -> List[Any]:
        """Many queries through each algorithm's ``batch_predict``, then
        per-query Serving (the micro-batched serve path)."""
        indexed = list(enumerate(payloads))
        per_algo = [dict(algo.batch_predict(model, indexed))
                    for algo, model in zip(self.algorithms, self.models)]
        return [self.serving.serve(q, [preds[i] for preds in per_algo])
                for i, q in indexed]


def latest_completed_instance_id(storage: Storage, engine_id: str,
                                 engine_version: str = "0",
                                 engine_variant: str = "default",
                                 ) -> Optional[str]:
    """The newest COMPLETED instance id for an engine, or None."""
    instance = storage.engine_instances().get_latest_completed(
        engine_id, engine_version, engine_variant)
    return None if instance is None else instance.id


def prepare_deploy(engine: Engine, instance: EngineInstance,
                   ctx: Optional[DeviceContext] = None,
                   storage: Optional[Storage] = None) -> Deployment:
    """ref: Engine.prepareDeploy:174. ``ctx`` defaults to the card. The
    kernel-library cache is checked first (the JAX deploy turns its
    compile cache on here): the warm-up loads the kernels."""
    enable_persistent_cache()
    storage = storage or get_storage()
    ctx = ctx or DeviceContext()
    engine_params = engine_params_from_instance(engine, instance)
    algorithms = engine.make_algorithms(engine_params)
    blob = storage.models().get(instance.id)
    if blob is None:
        raise RuntimeError(f"no model stored for engine instance {instance.id}")
    persisted_list = load_blob(blob.models)
    if len(persisted_list) != len(algorithms):
        raise RuntimeError(
            f"instance {instance.id}: {len(persisted_list)} models for "
            f"{len(algorithms)} algorithms")
    models = []
    for algo, persisted in zip(algorithms, persisted_list):
        if isinstance(persisted, PersistentModelManifest):
            persisted = load_from_manifest(persisted, instance.id,
                                           algo.params, ctx)
        models.append(algo.load_persistent_model(persisted, ctx))
    return Deployment(instance=instance, engine_params=engine_params,
                      algorithms=algorithms, models=models,
                      serving=engine.make_serving(engine_params))
