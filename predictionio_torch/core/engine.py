"""The Engine: named DASE component maps + variant parsing.

Counterpart of ``predictionio_tpu/core/engine.py`` (ref:
controller/Engine.scala): an Engine holds maps of named component
classes per DASE slot; an EngineParams picks one name per slot;
engine.json variants become EngineParams; ``train`` reads, prepares and
fits (ref: object Engine.train:583); ``eval`` does the same per fold of
the DataSource's eval data, batch-predicts each algorithm over the
fold's queries, regroups the predictions per query and serves them
(ref: object Engine.eval:688).

``resolve_engine_factory`` reads factory paths written for either
package: a path under ``predictionio_tpu.`` resolves to the same path
under ``predictionio_torch.`` (a string rewrite, so nothing of the JAX
package is imported), which is how an engine instance trained by the
JAX package deploys here.
"""

from __future__ import annotations

import abc
import importlib
import logging
import time
import typing
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Type, Union

from predictionio_torch.core.controller import (Algorithm, DataSource,
                                                Preparator, SanityCheck,
                                                Serving)
from predictionio_torch.core.params import EngineParams, Params, params_from_dict
from predictionio_torch.obs import perfacct
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.workflow.config import WorkflowParams

log = logging.getLogger(__name__)

ClassMap = Union[type, Dict[str, type]]

JAX_PACKAGE = "predictionio_tpu"
PORT_PACKAGE = "predictionio_torch"


def port_module(name: str) -> str:
    """``predictionio_tpu[.x]`` -> ``predictionio_torch[.x]``; any other
    module name unchanged."""
    if name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + "."):
        return PORT_PACKAGE + name[len(JAX_PACKAGE):]
    return name


def _as_map(classes: ClassMap) -> Dict[str, type]:
    if isinstance(classes, dict):
        return dict(classes)
    return {"": classes}


def _declared_params_class(cls: type) -> Optional[Type[Params]]:
    """The params dataclass a component declares: an explicit
    ``params_class`` attribute, else the annotation of the ctor's
    ``params`` argument (ref: AbstractDoer.scala:24)."""
    pc = getattr(cls, "params_class", None)
    if pc is not None:
        return pc
    try:
        hints = typing.get_type_hints(cls.__init__)
    except Exception as e:  # noqa: BLE001 — user annotations can raise anything
        log.warning("cannot resolve type hints on %s.__init__ (%s: %s); "
                    "params dataclass not auto-detected",
                    cls.__name__, type(e).__name__, e)
        return None
    ann = hints.get("params")
    return ann if isinstance(ann, type) else None


def _sanity(obj: Any, wp: WorkflowParams, stage: str) -> None:
    """ref: Engine.scala:610-666 — check TD/PD/models implementing SanityCheck."""
    if wp.skip_sanity_check:
        return
    if isinstance(obj, SanityCheck):
        log.info("sanity check %s", stage)
        obj.sanity_check()


@dataclass
class TrainResult:
    """Outcome of Engine.train — models plus debug-interruption state."""

    models: Optional[List[Any]] = None
    stopped_after: Optional[str] = None  # None | "read" | "prepare"
    training_data: Any = None
    prepared_data: Any = None


class Engine:
    """ref: controller/Engine.scala:78."""

    def __init__(self, data_source_classes: ClassMap,
                 preparator_classes: ClassMap, algorithm_classes: ClassMap,
                 serving_classes: ClassMap):
        self.data_source_classes = _as_map(data_source_classes)
        self.preparator_classes = _as_map(preparator_classes)
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)

    def _make(self, classes: Dict[str, type], slot: Tuple[str, Params],
              role: str):
        name, params = slot
        if name not in classes:
            raise KeyError(
                f"{role} {name!r} not found (available: {sorted(classes)})")
        return classes[name].create(params)

    def make_data_source(self, ep: EngineParams) -> DataSource:
        return self._make(self.data_source_classes, ep.data_source_params,
                          "DataSource")

    def make_preparator(self, ep: EngineParams) -> Preparator:
        return self._make(self.preparator_classes, ep.preparator_params,
                          "Preparator")

    def make_algorithms(self, ep: EngineParams) -> List[Algorithm]:
        if not ep.algorithm_params_list:
            raise ValueError("EngineParams.algorithm_params_list must not be empty")
        return [self._make(self.algorithm_classes, slot, "Algorithm")
                for slot in ep.algorithm_params_list]

    def make_serving(self, ep: EngineParams) -> Serving:
        return self._make(self.serving_classes, ep.serving_params, "Serving")

    def train(self, ctx: DeviceContext, engine_params: EngineParams,
              workflow_params: Optional[WorkflowParams] = None
              ) -> TrainResult:
        """read -> sanity check -> [stop after read] -> prepare -> sanity
        check -> [stop after prepare] -> train each algorithm -> sanity
        check each model (ref: object Engine.train:583). The read,
        prepare and fit stages go to the data-path ledger
        (obs/perfacct.py), and the freshness horizon is taken at the read's
        START (an event landing mid-read may miss it)."""
        wp = workflow_params or WorkflowParams()
        perfacct.LEDGER.note_train_read()
        t0 = time.perf_counter()
        td = self.make_data_source(engine_params).read_training(ctx)
        perfacct.LEDGER.note_stage("read", time.perf_counter() - t0)
        _sanity(td, wp, "training data")
        if wp.stop_after_read:
            return TrainResult(stopped_after="read", training_data=td)
        t0 = time.perf_counter()
        pd = self.make_preparator(engine_params).prepare(ctx, td)
        perfacct.LEDGER.note_stage("prepare", time.perf_counter() - t0)
        _sanity(pd, wp, "prepared data")
        if wp.stop_after_prepare:
            return TrainResult(stopped_after="prepare", training_data=td,
                               prepared_data=pd)
        models = []
        t0 = time.perf_counter()
        for i, algo in enumerate(self.make_algorithms(engine_params)):
            model = algo.train(ctx, pd)
            _sanity(model, wp, f"model {i}")
            models.append(model)
        perfacct.LEDGER.note_stage("fit", time.perf_counter() - t0)
        return TrainResult(models=models, training_data=td, prepared_data=pd)

    def eval(self, ctx: DeviceContext, engine_params: EngineParams,
             workflow_params: Optional[WorkflowParams] = None
             ) -> List[Tuple[Any, List[Tuple[Any, Any, Any]]]]:
        """Per fold: (eval info, [(query, prediction, actual)])."""
        data_source = self.make_data_source(engine_params)
        preparator = self.make_preparator(engine_params)
        algorithms = self.make_algorithms(engine_params)
        serving = self.make_serving(engine_params)
        results = []
        for td, ei, qa_pairs in data_source.read_eval(ctx):
            pd = preparator.prepare(ctx, td)
            models = [algo.train(ctx, pd) for algo in algorithms]
            indexed_queries = [(i, q) for i, (q, _a) in enumerate(qa_pairs)]
            # one batch predict per algorithm, regrouped per query index
            # (ref: Engine.scala:737-750 union + groupByKey)
            per_query: Dict[int, List[Any]] = {i: [] for i, _ in
                                               indexed_queries}
            for algo, model in zip(algorithms, models):
                for i, p in algo.batch_predict(model, indexed_queries):
                    per_query[i].append(p)
            results.append((ei, [(q, serving.serve(q, per_query[i]), a)
                                 for i, (q, a) in enumerate(qa_pairs)]))
        return results

    # -- variant JSON -> EngineParams (ref: Engine.jValueToEngineParams:328) --
    def engine_params_from_variant(self, variant: Dict[str, Any]) -> EngineParams:
        def default_name(classes):
            return "" if "" in classes else next(iter(sorted(classes)))

        def slot(key: str, classes: Dict[str, type]) -> Tuple[str, Params]:
            block = variant.get(key)
            if block is None:
                name = default_name(classes)
                return (name, _materialize(classes, name, {}))
            name = block.get("name", "")
            return (name, _materialize(classes, name, block.get("params")))

        algo_blocks = variant.get("algorithms")
        if algo_blocks is None:
            name = default_name(self.algorithm_classes)
            algo_list = [(name, _materialize(self.algorithm_classes, name, {}))]
        else:
            algo_list = [(b.get("name", ""),
                          _materialize(self.algorithm_classes,
                                       b.get("name", ""), b.get("params")))
                         for b in algo_blocks]
        return EngineParams(
            data_source_params=slot("datasource", self.data_source_classes),
            preparator_params=slot("preparator", self.preparator_classes),
            algorithm_params_list=algo_list,
            serving_params=slot("serving", self.serving_classes),
        )


def _materialize(classes: Dict[str, type], name: str,
                 params_dict: Optional[dict]) -> Params:
    if name not in classes:
        raise KeyError(f"component {name!r} not found (available: {sorted(classes)})")
    return params_from_dict(_declared_params_class(classes[name]), params_dict)


class EngineFactory(abc.ABC):
    """User entry point (ref: EngineFactory.scala:28)."""

    @abc.abstractmethod
    def apply(self) -> Engine:
        ...


def factory_from_object(obj: Any, name: str) -> Callable[[], Engine]:
    """Resolved attribute -> zero-arg engine factory (an EngineFactory
    subclass or instance, an Engine, or a plain callable;
    ref: WorkflowUtils.getEngine:60)."""
    if isinstance(obj, type) and issubclass(obj, EngineFactory):
        return obj().apply
    if isinstance(obj, EngineFactory):
        return obj.apply
    if isinstance(obj, Engine):
        return lambda: obj
    if callable(obj):
        return obj
    raise TypeError(f"{name} is not an EngineFactory / Engine / callable")


def resolve_engine_factory(dotted: str) -> Callable[[], Engine]:
    """'pkg.module.ObjName' -> zero-arg engine factory; a
    ``predictionio_tpu.`` path resolves under ``predictionio_torch.``."""
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise ValueError(f"engine factory {dotted!r} must be a dotted path")
    obj = getattr(importlib.import_module(port_module(module_name)), attr)
    return factory_from_object(obj, dotted)
