"""Classification algorithms over numeric feature vectors.

Counterpart of ``predictionio_tpu/models/classification.py``. Behavior
contracts:

  - ``NaiveBayesAlgorithm`` mirrors the reference classification
    template (examples/scala-parallel-classification/add-algorithm/
    src/main/scala/NaiveBayesAlgorithm.scala:16-28), MLlib's multinomial
    NaiveBayes with additive smoothing ``lambda``:
      pi(c)     = log((count_c + lambda) / (N + numLabels * lambda))
      theta(c,j)= log((sum_{i in c} x_ij + lambda)
                      / (sum_j sum_{i in c} x_ij + numFeatures * lambda))
      predict(x) = argmax_c pi(c) + theta(c) . x
    Labels are floats, as in MLlib. The counts are a one-hot product on
    the device in float32; the logs are float64 on the host, as in JAX.
  - ``LogisticRegressionAlgorithm`` fills the reference's second
    algorithm slot (RandomForestAlgorithm.scala there) with softmax
    regression: standardized features, zero init, full-batch Adam on the
    mean CE plus ``l2 * sum(w^2)``.

Models keep numpy arrays, as the JAX models do, so a blob of either
package loads in the other. Naive Bayes scores on its device (JAX: a
jitted product); logistic regression scores on the host (JAX: numpy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_torch.core import Algorithm, SanityCheck
from predictionio_torch.core.params import Params
from predictionio_torch.models import batch_predict_dense
from predictionio_torch.parallel.context import (DeviceContext, DeviceLike,
                                                 OnDevice, resolve_device)


@dataclass
class LabeledVectors(SanityCheck):
    """PD: dense feature matrix + float labels (ref: TrainingData w/
    RDD[LabeledPoint], DataSource.scala:58)."""

    features: np.ndarray   # [N, D] float32
    labels: np.ndarray     # [N] float

    def sanity_check(self) -> None:
        if len(self.features) == 0:
            raise ValueError("no labeled points found")
        if len(self.features) != len(self.labels):
            raise ValueError("features/labels length mismatch")


# -- multinomial naive Bayes -------------------------------------------------

def nb_counts(features: np.ndarray, label_idx: np.ndarray, n_classes: int,
              device: DeviceLike = None):
    """(class counts [C], per-class feature sums [C, D]) as float32 on
    ``device``: the one-hot matrix's column sums and its product with
    the features."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
    one_hot = F.one_hot(torch.from_numpy(np.asarray(label_idx, np.int64))
                        .to(dev), n_classes).to(x.dtype)       # [N, C]
    return one_hot.sum(dim=0), one_hot.T @ x


@dataclass
class NaiveBayesModel(OnDevice):
    class_labels: np.ndarray   # [C] float — MLlib label values
    pi: np.ndarray             # [C] log priors
    theta: np.ndarray          # [C, D] log feature likelihoods

    def _scores(self, x: np.ndarray) -> np.ndarray:
        dev = self.serving_device()
        x = torch.from_numpy(np.atleast_2d(np.asarray(x, np.float32))).to(dev)
        pi = torch.from_numpy(np.asarray(self.pi, np.float32)).to(dev)
        theta = torch.from_numpy(np.asarray(self.theta, np.float32)).to(dev)
        return (pi[None, :] + x @ theta.T).cpu().numpy()

    def predict(self, features: Sequence[float]) -> float:
        return float(self.class_labels[
            int(np.argmax(self._scores(np.asarray(features))))])

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        return self.class_labels[np.argmax(self._scores(features), axis=1)]


def train_naive_bayes(pd: LabeledVectors, lambda_: float = 1.0,
                      device: DeviceLike = None) -> NaiveBayesModel:
    class_labels, label_idx = np.unique(pd.labels, return_inverse=True)
    n_classes = len(class_labels)
    class_counts, feature_sums = nb_counts(pd.features, label_idx, n_classes,
                                           device)
    class_counts = class_counts.cpu().numpy().astype(np.float64)
    feature_sums = feature_sums.cpu().numpy().astype(np.float64)
    n, d = len(pd.labels), pd.features.shape[1]
    pi = np.log(class_counts + lambda_) - np.log(n + n_classes * lambda_)
    theta = np.log(feature_sums + lambda_) - np.log(
        feature_sums.sum(axis=1, keepdims=True) + d * lambda_)
    return NaiveBayesModel(class_labels=class_labels,
                           pi=pi.astype(np.float32),
                           theta=theta.astype(np.float32)).to(device)


@dataclass
class NaiveBayesParams(Params):
    lambda_: float = 1.0


class _DenseClassifier(Algorithm):
    """Shared serve surface: ``{"features": [...]}`` -> ``{"label"}``."""

    def predict(self, model, query: Dict[str, Any]) -> Dict[str, Any]:
        return {"label": model.predict([float(v) for v in query["features"]])}

    def batch_predict(self, model, queries):
        return batch_predict_dense(model, queries,
                                   lambda l: {"label": float(l)})


class NaiveBayesAlgorithm(_DenseClassifier):
    """ref: NaiveBayesAlgorithm.scala:16."""

    def __init__(self, params: NaiveBayesParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: LabeledVectors) -> NaiveBayesModel:
        return train_naive_bayes(pd, self.params.lambda_, ctx.device)

    def load_persistent_model(self, persisted: NaiveBayesModel,
                              ctx: DeviceContext) -> NaiveBayesModel:
        return persisted.to(ctx.device)

    def warmup(self, model: NaiveBayesModel, ctx: DeviceContext) -> None:
        """Score one zero vector, so the first live query pays no
        first-touch cost of the device's matmul."""
        model.predict_batch(np.zeros((1, model.theta.shape[1]), np.float32))


# -- softmax regression -------------------------------------------------------

@dataclass
class LogisticRegressionModel:
    class_labels: np.ndarray   # [C] float
    weights: np.ndarray        # [D, C]
    bias: np.ndarray           # [C]
    feature_mean: np.ndarray   # [D] standardization applied at train time
    feature_std: np.ndarray    # [D]

    def _scores(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, dtype=np.float32))
        x = (x - self.feature_mean) / self.feature_std
        return x @ self.weights + self.bias

    def predict(self, features: Sequence[float]) -> float:
        return float(self.class_labels[
            int(np.argmax(self._scores(np.asarray(features))))])

    def predict_batch(self, features: np.ndarray) -> np.ndarray:
        return self.class_labels[np.argmax(self._scores(features), axis=1)]


@dataclass
class LogisticRegressionParams(Params):
    learning_rate: float = 0.1
    iterations: int = 200
    l2: float = 1e-4
    seed: int = 0


def train_logistic_regression(pd: LabeledVectors,
                              p: LogisticRegressionParams,
                              device: DeviceLike = None
                              ) -> LogisticRegressionModel:
    """Full-batch Adam on ``device`` from zero weights."""
    dev = resolve_device(device)
    class_labels, label_idx = np.unique(pd.labels, return_inverse=True)
    n_classes = len(class_labels)
    d = pd.features.shape[1]
    mean = pd.features.mean(axis=0)
    std = np.maximum(pd.features.std(axis=0), 1e-8)
    x = torch.from_numpy(np.ascontiguousarray(
        (pd.features - mean) / std, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(label_idx, np.int64)).to(dev)
    w = torch.zeros((d, n_classes), dtype=torch.float32, device=dev,
                    requires_grad=True)
    b = torch.zeros((n_classes,), dtype=torch.float32, device=dev,
                    requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=p.learning_rate, eps=1e-8)
    for _ in range(p.iterations):
        loss = F.cross_entropy(x @ w + b, y) + p.l2 * (w ** 2).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return LogisticRegressionModel(
        class_labels=class_labels, weights=w.detach().cpu().numpy(),
        bias=b.detach().cpu().numpy(), feature_mean=mean.astype(np.float32),
        feature_std=std.astype(np.float32))


class LogisticRegressionAlgorithm(_DenseClassifier):
    """Second algorithm slot (see the module docstring)."""

    def __init__(self, params: LogisticRegressionParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: LabeledVectors
              ) -> LogisticRegressionModel:
        return train_logistic_regression(pd, self.params, ctx.device)
