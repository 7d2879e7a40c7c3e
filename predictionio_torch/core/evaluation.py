"""Metrics + MetricEvaluator: offline evaluation and tuning.

Counterpart of ``predictionio_tpu/core/evaluation.py``: every signature
that took a ``MeshContext`` takes a ``DeviceContext``; the scores,
the ranking and the three renderings are the JAX module's. Behavior
contracts from the reference:

  - Metric family (controller/Metric.scala:36-218): a Metric reduces
    all folds' (query, prediction, actual) triples to one score;
    AverageMetric (mean), OptionAverageMetric (None-scores excluded),
    StdevMetric (population stddev), OptionStdevMetric, SumMetric.
    The reference computes these with RDD mean()/stdev(); here they are
    numpy reductions.
  - MetricEvaluator (controller/MetricEvaluator.scala:90-222):
    evaluates each EngineParams candidate, ranks by the primary metric,
    logs a leaderboard, writes the best params to ``best.json`` and
    yields a result with one-liner / JSON / HTML renderings.
  - Evaluation (controller/Evaluation.scala:32): binds an engine with a
    metric (+ optional secondary metrics).
  - EngineParamsGenerator (controller/EngineParamsGenerator.scala:27):
    the candidate list for grid search.
"""

from __future__ import annotations

import abc
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_torch.core.engine import Engine
from predictionio_torch.core.params import EngineParams
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.workflow.config import WorkflowParams

log = logging.getLogger(__name__)

#: eval data shape: per fold (eval info, [(query, prediction, actual)])
EvalDataSet = List[Tuple[Any, List[Tuple[Any, Any, Any]]]]


class Metric(abc.ABC):
    """ref: Metric.scala:36 — reduces an EvalDataSet to one score.

    ``higher_is_better`` plays the role of the reference's Ordering
    (Metric.scala comparator): MetricEvaluator ranks accordingly.
    """

    higher_is_better: bool = True

    @abc.abstractmethod
    def calculate(self, ctx: DeviceContext, eval_data: EvalDataSet) -> float:
        ...

    def header(self) -> str:
        return type(self).__name__


class QPAMetric(Metric):
    """Marker matching the reference's QPAMetric shape (Metric.scala:216):
    metrics computed pointwise from (Q, P, A) triples."""

    @abc.abstractmethod
    def calculate_qpa(self, q: Any, p: Any, a: Any) -> Optional[float]:
        ...

    def _scores(self, eval_data: EvalDataSet) -> np.ndarray:
        scores = [
            s
            for _ei, qpas in eval_data
            for q, p, a in qpas
            if (s := self.calculate_qpa(q, p, a)) is not None
        ]
        return np.asarray(scores, dtype=np.float64)


class AverageMetric(QPAMetric):
    """Mean of per-triple scores (ref: Metric.scala:87). Subclasses
    implement calculate_qpa returning a float for every triple."""

    def calculate(self, ctx, eval_data) -> float:
        scores = self._scores(eval_data)
        return float(scores.mean()) if scores.size else float("nan")


class OptionAverageMetric(AverageMetric):
    """Mean over triples with non-None scores (ref: Metric.scala:112)."""


class StdevMetric(QPAMetric):
    """Population stddev of scores (ref: Metric.scala:139 — RDD stdev)."""

    def calculate(self, ctx, eval_data) -> float:
        scores = self._scores(eval_data)
        return float(scores.std()) if scores.size else float("nan")


class OptionStdevMetric(StdevMetric):
    """ref: Metric.scala:167."""


class SumMetric(QPAMetric):
    """Sum of scores (ref: Metric.scala:193)."""

    def calculate(self, ctx, eval_data) -> float:
        scores = self._scores(eval_data)
        return float(scores.sum())


class MeanSquareError(AverageMetric):
    """Mean of (prediction - actual)^2 over float-valued triples
    (ref: controller/Evaluator.scala:126 — evaluateSet's
    ``mean((p - a)^2)``); lower is better."""

    higher_is_better = False

    def calculate_qpa(self, q, p, a):
        return (float(p) - float(a)) ** 2


class FunctionMetric(AverageMetric):
    """Sugar: wrap a plain (q, p, a) -> float function as an AverageMetric."""

    def __init__(self, fn: Callable[[Any, Any, Any], Optional[float]], name: str = ""):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "FunctionMetric")

    def calculate_qpa(self, q, p, a):
        return self.fn(q, p, a)

    def header(self) -> str:
        return self.name


class EngineParamsGenerator:
    """ref: EngineParamsGenerator.scala:27 — candidate params for tuning."""

    def __init__(self, engine_params_list: Sequence[EngineParams]):
        if not engine_params_list:
            raise ValueError("engine_params_list must not be empty")
        self.engine_params_list = list(engine_params_list)


@dataclass
class Evaluation:
    """ref: Evaluation.scala:32 — engine + metric(s) binding."""

    engine: Engine
    metric: Metric
    metrics: List[Metric] = field(default_factory=list)  # secondary metrics

    @property
    def all_metrics(self) -> List[Metric]:
        return [self.metric] + list(self.metrics)


@dataclass
class MetricScores:
    engine_params: EngineParams
    score: float
    other_scores: List[float]


@dataclass
class MetricEvaluatorResult:
    """ref: MetricEvaluator.scala:144 result object."""

    best_score: float
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: List[str]
    engine_params_scores: List[MetricScores]

    def to_one_liner(self) -> str:
        return f"[{self.metric_header}: {self.best_score:.4f}] best params idx={self.best_idx}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "metricHeader": self.metric_header,
                "otherMetricHeaders": self.other_metric_headers,
                "bestScore": self.best_score,
                "bestIdx": self.best_idx,
                "bestEngineParams": self.best_engine_params.to_json_dict(),
                "engineParamsScores": [
                    {
                        "engineParams": s.engine_params.to_json_dict(),
                        "score": s.score,
                        "otherScores": s.other_scores,
                    }
                    for s in self.engine_params_scores
                ],
            },
            sort_keys=True,
        )

    def to_html(self) -> str:
        rows = "\n".join(
            f"<tr><td>{i}</td><td>{s.score:.6f}</td>"
            f"<td><pre>{json.dumps(s.engine_params.to_json_dict(), indent=1)}</pre></td></tr>"
            for i, s in enumerate(self.engine_params_scores)
        )
        return (
            f"<h2>Metric: {self.metric_header}</h2>"
            f"<p>Best score: {self.best_score:.6f} (idx {self.best_idx})</p>"
            f"<table border=1><tr><th>#</th><th>score</th><th>params</th></tr>{rows}</table>"
        )


class MetricEvaluator:
    """ref: MetricEvaluator.scala:90 — evaluate candidates, rank, persist best.

    ``best_json_path``: where the winning EngineParams land
    (ref: saveEngineJson writing best.json, MetricEvaluator.scala:152).
    """

    def __init__(self, best_json_path: Optional[str] = None):
        self.best_json_path = best_json_path

    def evaluate(
        self,
        ctx: DeviceContext,
        evaluation: Evaluation,
        engine_params_list: Sequence[EngineParams],
        workflow_params: Optional[WorkflowParams] = None,
        eval_fn: Optional[Callable[[DeviceContext, EngineParams], EvalDataSet]] = None,
    ) -> MetricEvaluatorResult:
        wp = workflow_params or WorkflowParams()
        engine = evaluation.engine
        run_eval = eval_fn or (lambda c, ep: engine.eval(c, ep, wp))
        results: List[MetricScores] = []
        for i, ep in enumerate(engine_params_list):
            eval_data = run_eval(ctx, ep)
            score = evaluation.metric.calculate(ctx, eval_data)
            others = [m.calculate(ctx, eval_data) for m in evaluation.metrics]
            log.info("candidate %d: %s = %s", i, evaluation.metric.header(), score)
            results.append(MetricScores(engine_params=ep, score=score, other_scores=others))

        sign = 1.0 if evaluation.metric.higher_is_better else -1.0

        def rank_key(score: float) -> float:
            # non-finite scores (no eval data) rank worst for BOTH
            # orderings: -inf must be applied after the sign flip
            return sign * score if np.isfinite(score) else -np.inf

        best_idx = int(
            max(range(len(results)), key=lambda i: rank_key(results[i].score))
        )
        best = results[best_idx]
        result = MetricEvaluatorResult(
            best_score=best.score,
            best_engine_params=best.engine_params,
            best_idx=best_idx,
            metric_header=evaluation.metric.header(),
            other_metric_headers=[m.header() for m in evaluation.metrics],
            engine_params_scores=results,
        )
        # leaderboard log (ref: MetricEvaluator printing the ranking)
        order = sorted(results, key=lambda s: rank_key(s.score), reverse=True)
        for rank, s in enumerate(order):
            log.info("leaderboard #%d: score=%s", rank + 1, s.score)
        if self.best_json_path:
            os.makedirs(os.path.dirname(self.best_json_path) or ".", exist_ok=True)
            with open(self.best_json_path, "w") as f:
                json.dump(best.engine_params.to_json_dict(), f, indent=1, sort_keys=True)
        return result
