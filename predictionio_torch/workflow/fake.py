"""FakeWorkflow: run an arbitrary function through the evaluation plumbing.

Counterpart of ``predictionio_tpu/workflow/fake.py``. Behavior contract
from the reference (workflow/FakeWorkflow.scala):

  - ``FakeRun`` (FakeWorkflow.scala:66) wraps a ``SparkContext => Unit``
    function as an Evaluation so tests/templates can exercise the full
    evaluation harness (instance bookkeeping, evaluator dispatch)
    without a real engine.  Here the function takes the SparkContext
    analogue, a :class:`~predictionio_torch.parallel.context.DeviceContext`
    (the card unless the caller passes another).
  - ``FakeEvalResult`` (FakeWorkflow.scala:47) carries ``no_save``
    (:60) so the evaluation workflow skips persisting evaluator results
    (honored in workflow/evaluate.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from predictionio_torch.core.controller import (Algorithm, DataSource,
                                                IdentityPreparator, Serving)
from predictionio_torch.core.engine import Engine
from predictionio_torch.core.evaluation import Evaluation, Metric
from predictionio_torch.core.params import EngineParams
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.workflow.config import WorkflowParams


@dataclass
class FakeEvalResult:
    """ref: FakeWorkflow.scala:47 — result whose no_save keeps it out of
    the metadata store (checked in workflow/evaluate.py)."""

    no_save: bool = True

    def to_one_liner(self) -> str:
        return "FakeEvalResult"

    def to_json(self) -> str:
        return '"FakeEvalResult"'

    def to_html(self) -> str:
        return "FakeEvalResult"


class _FakeDataSource(DataSource):
    def read_training(self, ctx):
        return None

    def read_eval(self, ctx):
        # one empty fold so Engine.eval traverses the full pipeline
        return [(None, None, [])]


class _FakeAlgorithm(Algorithm):
    def train(self, ctx, prepared_data):
        return None

    def predict(self, model, query):
        return None


class _FakeServing(Serving):
    def serve(self, query, predictions):
        return None


class _NullMetric(Metric):
    def calculate(self, ctx, eval_data) -> float:
        return 0.0


class _FakeEvaluator:
    """Evaluator that drives the engine's eval pipeline once, then runs
    the wrapped function (ref: FakeRun routing fn through evaluateBase,
    FakeWorkflow.scala:36). Same call signature as MetricEvaluator."""

    def __init__(self, fn: Callable[[DeviceContext], Any]):
        self.fn = fn
        self.result: Any = None

    def evaluate(self, ctx, evaluation, engine_params_list,
                 workflow_params=None, eval_fn=None):
        wp = workflow_params or WorkflowParams()
        run = eval_fn or (lambda c, ep: evaluation.engine.eval(c, ep, wp))
        for ep in engine_params_list:
            run(ctx, ep)
        self.result = self.fn(ctx)
        return FakeEvalResult()


class FakeRun:
    """ref: FakeWorkflow.scala:66 — evaluation wrapper around a plain function.

    ``run()`` goes through the real evaluation workflow
    (:func:`predictionio_torch.workflow.evaluate.run_evaluation`): an
    EvaluationInstance is created and completed, but — because
    FakeEvalResult.no_save — no evaluator results are persisted.

    Usage::

        out = FakeRun(lambda ctx: do_stuff(ctx)).run(storage=storage)
    """

    def __init__(self, fn: Callable[[DeviceContext], Any]):
        self.evaluator = _FakeEvaluator(fn)
        engine = Engine(
            data_source_classes=_FakeDataSource,
            preparator_classes=IdentityPreparator,
            algorithm_classes=_FakeAlgorithm,
            serving_classes=_FakeServing,
        )
        self.evaluation = Evaluation(engine=engine, metric=_NullMetric())

    def run(self, ctx: Optional[DeviceContext] = None, storage=None) -> Any:
        from predictionio_torch.workflow.evaluate import run_evaluation

        ep = EngineParams(algorithm_params_list=[("", None)])
        run_evaluation(
            self.evaluation,
            engine_params_list=[ep],
            evaluation_class="FakeRun",
            ctx=ctx or DeviceContext(),
            storage=storage,
            evaluator=self.evaluator,
            use_fast_eval=False,
        )
        return self.evaluator.result


def fake_run(
    fn: Callable[[DeviceContext], Any],
    ctx: Optional[DeviceContext] = None,
    storage=None,
) -> Any:
    """Convenience: ``fake_run(lambda ctx: ...)`` — ref FakeWorkflow.scala:36."""
    return FakeRun(fn).run(ctx, storage=storage)
