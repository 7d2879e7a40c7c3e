"""Regression engine template.

Counterpart of ``predictionio_tpu/templates/regression.py``. Behavior
contract from the reference's regression examples
(examples/experimental/scala-parallel-regression/Run.scala,
examples/experimental/scala-local-regression/Run.scala):

  - DataSource reads a whitespace-separated text file where each line
    is ``label feature0 feature1 ...`` (Run.scala:40-44, the MLlib
    ``lr_data.txt`` format), and serves k-fold splits for evaluation
    (the e2 splitData semantics).
  - Engine: SGD linear regression under ``AverageServing``, so several
    algorithm-params variants (the example's three stepSizes,
    Run.scala:88-92) fan out and average, plus the closed-form ridge
    slot.
  - Evaluation: MeanSquareError (Run.scala:101; ``core/evaluation.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from predictionio_torch.core import (AverageServing, DataSource, Engine,
                                     IdentityPreparator)
from predictionio_torch.core.cross_validation import split_data
from predictionio_torch.core.params import EngineParams, Params
from predictionio_torch.models.regression import (RegressionData,
                                                  RidgeRegressionAlgorithm,
                                                  SGDRegressionAlgorithm,
                                                  SGDRegressionParams)
from predictionio_torch.parallel.context import DeviceContext


@dataclass
class RegressionDSParams(Params):
    """ref: DataSourceParams(filepath, k, seed) Run.scala:28-30."""

    filepath: str = ""
    eval_k: int = 3


class FileRegressionDataSource(DataSource):
    """ref: ParallelDataSource.read (Run.scala:36-52)."""

    def __init__(self, params: RegressionDSParams):
        super().__init__(params)

    def _read_points(self) -> List[Tuple[float, List[float]]]:
        points = []
        with open(self.params.filepath) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                points.append((float(parts[0]), [float(v) for v in parts[1:]]))
        return points

    @staticmethod
    def _to_td(points: List[Tuple[float, List[float]]]) -> RegressionData:
        if not points:
            # shape (0, 0) instead of a reshape crash; the engine's
            # sanity check reports "no labeled points found"
            return RegressionData(features=np.zeros((0, 0), dtype=np.float32),
                                  targets=np.zeros((0,), dtype=np.float32))
        return RegressionData(
            features=np.array([f for _l, f in points],
                              dtype=np.float32).reshape(len(points), -1),
            targets=np.array([l for l, _f in points], dtype=np.float32))

    def read_training(self, ctx: DeviceContext) -> RegressionData:
        return self._to_td(self._read_points())

    def read_eval(self, ctx: DeviceContext):
        p: RegressionDSParams = self.params
        if p.eval_k <= 1:
            return []
        return split_data(p.eval_k, self._read_points(), {"k": p.eval_k},
                          training_data_creator=self._to_td,
                          query_creator=lambda d: {"features": d[1]},
                          actual_creator=lambda d: d[0])


def regression_engine() -> Engine:
    """ref: RegressionEngineFactory (Run.scala:74-82)."""
    return Engine(
        data_source_classes=FileRegressionDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"sgd": SGDRegressionAlgorithm,
                           "ridge": RidgeRegressionAlgorithm},
        serving_classes=AverageServing)


def default_engine_params(filepath: str, eval_k: int = 3,
                          step_sizes: Optional[List[float]] = None,
                          ) -> EngineParams:
    """The example's multi-stepSize fan-out (Run.scala:88-92)."""
    return EngineParams(
        data_source_params=("", RegressionDSParams(filepath=filepath,
                                                   eval_k=eval_k)),
        algorithm_params_list=[("sgd", SGDRegressionParams(step_size=s))
                               for s in (step_sizes or [0.1, 0.2, 0.4])])
