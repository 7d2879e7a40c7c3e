"""Evaluation workflow: run tuning, persist EvaluationInstance + results.

Counterpart of ``predictionio_tpu/workflow/evaluate.py`` for one process
(ref: workflow/CoreWorkflow.runEvaluation:96 + EvaluationWorkflow.scala:31
+ CreateWorkflow eval branch :263-276): create an EvaluationInstance
(INIT -> EVALUATING), run the evaluator over the candidate list, store
the one-liner / JSON / HTML renderings on the instance and mark
EVALCOMPLETED (or FAILED). One process owns the instance, so the JAX
package's multi-host id broadcast and barrier have no counterpart.
"""

from __future__ import annotations

import datetime as _dt
import logging
import uuid
from typing import Optional, Sequence

from predictionio_torch.core.evaluation import (EngineParamsGenerator,
                                                Evaluation, MetricEvaluator,
                                                MetricEvaluatorResult)
from predictionio_torch.core.fast_eval import FastEvalEngineWorkflow
from predictionio_torch.core.params import EngineParams
from predictionio_torch.data.metadata import EvaluationInstance
from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.parallel.compile_cache import enable_persistent_cache
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.workflow.config import WorkflowParams

log = logging.getLogger(__name__)
UTC = _dt.timezone.utc


def _now() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def run_evaluation(
    evaluation: Evaluation,
    engine_params_list: Optional[Sequence[EngineParams]] = None,
    generator: Optional[EngineParamsGenerator] = None,
    evaluation_class: str = "",
    generator_class: str = "",
    batch: str = "",
    ctx: Optional[DeviceContext] = None,
    workflow_params: Optional[WorkflowParams] = None,
    storage: Optional[Storage] = None,
    evaluator: Optional[MetricEvaluator] = None,
    use_fast_eval: bool = True,
) -> MetricEvaluatorResult:
    """ref: CoreWorkflow.runEvaluation:96. Returns the evaluator result.
    ``ctx`` defaults to the card. The kernel-library cache is checked
    first, as the JAX workflow turns its compile cache on here."""
    enable_persistent_cache()
    storage = storage or get_storage()
    ctx = ctx or DeviceContext()
    evaluator = evaluator or MetricEvaluator()
    if engine_params_list is None:
        if generator is None:
            raise ValueError("provide engine_params_list or generator")
        engine_params_list = generator.engine_params_list

    instance = EvaluationInstance(
        id=uuid.uuid4().hex, status="INIT", start_time=_now(),
        end_time=_now(), evaluation_class=evaluation_class,
        engine_params_generator_class=generator_class, batch=batch)
    storage.evaluation_instances().insert(instance)
    try:
        instance.status = "EVALUATING"
        storage.evaluation_instances().update(instance)

        eval_fn = None
        if use_fast_eval:
            # memoize shared DASE prefixes across candidates
            # (ref: FastEvalEngine.scala:38)
            workflow = FastEvalEngineWorkflow(evaluation.engine, ctx)
            # scalar sweeps (ALS reg) train every candidate in one grid
            # run per fold (Algorithm.grid_train). Best-effort, as in
            # the JAX package: a failing grid run (e.g. the [G, n, K]
            # factors out of memory where one at a time fits) falls back
            # to the sequential path; prefetch seeds the cache only
            # after every fold succeeded, so a failure leaves nothing
            # half-seeded
            try:
                workflow.prefetch_grid(engine_params_list)
            except Exception as e:  # noqa: BLE001 — sequential fallback
                log.warning(
                    "grid tuning run failed (%s: %s) — falling back to "
                    "sequential candidate evaluation", type(e).__name__, e)
            eval_fn = lambda c, ep: workflow.eval(ep)  # noqa: E731

        result = evaluator.evaluate(ctx, evaluation, engine_params_list,
                                    workflow_params, eval_fn=eval_fn)
        instance.status = "EVALCOMPLETED"
        instance.end_time = _now()
        # a result carrying no_save (FakeEvalResult, workflow/fake.py)
        # keeps its renderings out of the metadata store
        # (ref: CoreWorkflow checking evaluatorResult.noSave)
        if not getattr(result, "no_save", False):
            instance.evaluator_results = result.to_one_liner()
            instance.evaluator_results_json = result.to_json()
            instance.evaluator_results_html = result.to_html()
        storage.evaluation_instances().update(instance)
        return result
    except Exception:
        instance.status = "FAILED"
        instance.end_time = _now()
        storage.evaluation_instances().update(instance)
        raise
