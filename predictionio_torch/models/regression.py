"""Linear regression algorithms over numeric feature vectors.

Counterpart of ``predictionio_tpu/models/regression.py``. Behavior
contracts from the reference regression examples
(examples/experimental/scala-parallel-regression/Run.scala:56-70,
examples/experimental/scala-local-regression/Run.scala):

  - ``SGDRegressionAlgorithm`` mirrors MLlib's
    ``LinearRegressionWithSGD.train(data, numIterations, stepSize)``:
    full-batch gradient descent on squared error with MLlib's step-size
    decay ``stepSize / sqrt(t)`` and no intercept (MLlib's default
    ``addIntercept = false``); each step is one ``[N, D] x [D]`` product
    and its transpose on the device.
  - ``RidgeRegressionAlgorithm``: the closed-form normal equations
    ``(X^T X + reg*I) w = X^T y`` — the Gramian on the device in float32,
    the ``D x D`` solve on the host in float64 (``lstsq``: collinear
    columns give the min-norm solution).

Both predict a float from ``{"features": [...]}`` queries (on the host,
as in JAX), so ``AverageServing`` averages multi-algorithm fan-outs as
the reference example's three-stepSize run does (Run.scala:88-92).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np
import torch

from predictionio_torch.core import Algorithm, SanityCheck
from predictionio_torch.core.params import Params
from predictionio_torch.models import batch_predict_dense
from predictionio_torch.parallel.context import (DeviceContext, DeviceLike,
                                                 resolve_device)


@dataclass
class RegressionData(SanityCheck):
    """PD: dense feature matrix + float targets (ref: RDD[LabeledPoint],
    scala-parallel-regression/Run.scala:40-44)."""

    features: np.ndarray  # [N, D] float32
    targets: np.ndarray   # [N] float32

    def sanity_check(self) -> None:
        if len(self.features) == 0:
            raise ValueError("no labeled points found")
        if len(self.features) != len(self.targets):
            raise ValueError("features/targets length mismatch")


@dataclass
class LinearModel:
    weights: np.ndarray    # [D]
    intercept: float

    def predict(self, features: Sequence[float]) -> float:
        return float(np.dot(self.weights, np.asarray(features, dtype=np.float32))
                     + self.intercept)

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        return features @ self.weights + self.intercept


@dataclass
class SGDRegressionParams(Params):
    """ref: AlgorithmParams(numIterations=200, stepSize=0.1) Run.scala:54."""

    iterations: int = 200
    step_size: float = 0.1
    intercept: bool = False  # MLlib LinearRegressionWithSGD default


def _design(pd: RegressionData, intercept: bool):
    x = np.asarray(pd.features, dtype=np.float32)
    y = np.asarray(pd.targets, dtype=np.float32)
    if intercept:
        x = np.concatenate([x, np.ones((len(x), 1), dtype=np.float32)], axis=1)
    return x, y


def _split(w: np.ndarray, intercept: bool) -> LinearModel:
    if intercept:
        return LinearModel(weights=w[:-1], intercept=float(w[-1]))
    return LinearModel(weights=w, intercept=0.0)


def sgd_fit(x: np.ndarray, y: np.ndarray, step_size: float, iterations: int,
            device: DeviceLike = None) -> np.ndarray:
    """Full-batch gradient descent from zero on ``device``; step ``t``
    (from 1) moves by ``step_size / sqrt(t)`` (float32, as in JAX)."""
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    yt = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
    n = xt.shape[0]
    w = torch.zeros(xt.shape[1], dtype=xt.dtype, device=dev)
    for t in range(1, iterations + 1):
        grad = xt.T @ (xt @ w - yt) / n
        w = w - float(np.float32(step_size) / np.sqrt(np.float32(t))) * grad
    return w.cpu().numpy()


def train_sgd_regression(pd: RegressionData, p: SGDRegressionParams,
                         device: DeviceLike = None) -> LinearModel:
    x, y = _design(pd, p.intercept)
    return _split(sgd_fit(x, y, p.step_size, p.iterations, device),
                  p.intercept)


@dataclass
class RidgeRegressionParams(Params):
    reg: float = 1e-6
    intercept: bool = True


def train_ridge_regression(pd: RegressionData, p: RidgeRegressionParams,
                           device: DeviceLike = None) -> LinearModel:
    x, y = _design(pd, p.intercept)
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    yt = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
    gram, xty = (xt.T @ xt).cpu().numpy(), (xt.T @ yt).cpu().numpy()
    d = x.shape[1]
    penalty = np.eye(d)
    if p.intercept:
        penalty[-1, -1] = 0.0  # standard ridge never shrinks the intercept
    a = gram.astype(np.float64) + p.reg * penalty
    w = np.linalg.lstsq(a, xty.astype(np.float64), rcond=None)[0]
    return _split(w.astype(np.float32), p.intercept)


class _RegressionAlgorithmBase(Algorithm):
    def predict(self, model: LinearModel, query: Dict[str, Any]) -> float:
        return model.predict([float(v) for v in query["features"]])

    def batch_predict(self, model, queries):
        return batch_predict_dense(model, queries)


class SGDRegressionAlgorithm(_RegressionAlgorithmBase):
    """ref: ParallelSGDAlgorithm (scala-parallel-regression/Run.scala:56)."""

    def __init__(self, params: SGDRegressionParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: RegressionData) -> LinearModel:
        return train_sgd_regression(pd, self.params, ctx.device)


class RidgeRegressionAlgorithm(_RegressionAlgorithmBase):
    """Closed-form slot (see the module docstring)."""

    def __init__(self, params: RidgeRegressionParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: RegressionData) -> LinearModel:
        return train_ridge_regression(pd, self.params, ctx.device)
