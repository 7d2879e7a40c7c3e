"""Categorical naive Bayes (ref: e2/.../engine/CategoricalNaiveBayes.scala:23).

Counterpart of ``predictionio_tpu/models/naive_bayes.py``. Behavior
contract from the reference:

  - ``train`` counts, per label, the occurrences of each categorical
    value in each feature slot (CategoricalNaiveBayes.scala:29-77):
    log prior = log(labelCount / totalCount), log likelihood =
    log(valueCount / labelCount).
  - ``log_score`` returns ``None`` for an unknown label, else
    prior + sum over slots of the value's log likelihood; a value never
    seen with that (label, slot) falls back to a pluggable
    ``default_likelihood`` function of the other likelihoods in that
    slot (CategoricalNaiveBayes.scala:103-141, default -inf).
  - ``predict`` returns the argmax label (CategoricalNaiveBayes.scala:143).

Training bakes the model into dense arrays, as in JAX: a likelihood
table ``L[n_labels, n_slots, vocab+1]`` whose unseen and unknown entries
hold the train-time ``default_likelihood``, so scoring a batch is one
gather and a sum over slots, on the model's device. The tables are
numpy (the stored form); their device copies are made at first use.
As in JAX, the model registers the tables' bytes in the device-memory
ledger (``obs/memacct.py``) when it is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_torch.data.bimap import BiMap
from predictionio_torch.obs import memacct
from predictionio_torch.parallel.context import DeviceLike, OnDevice

DefaultLikelihood = Callable[[Sequence[float]], float]


def _neg_inf_default(_likelihoods: Sequence[float]) -> float:
    """Reference default: unseen feature value scores -inf."""
    return float("-inf")


@dataclass(frozen=True)
class LabeledPoint:
    """A label and its categorical feature values (ref: LabeledPoint, :158)."""

    label: str
    features: Tuple[str, ...]

    def __init__(self, label: str, features: Sequence[str]):
        object.__setattr__(self, "label", label)
        object.__setattr__(self, "features", tuple(features))


def score_batch(feature_ids: torch.Tensor, priors: torch.Tensor,
                likelihoods: torch.Tensor) -> torch.Tensor:
    """``[B, n_labels]`` log scores: ``priors[l] + sum_s
    likelihoods[l, s, feature_ids[b, s]]``."""
    slots = torch.arange(feature_ids.shape[1], device=feature_ids.device)
    gathered = likelihoods[:, slots[None, :], feature_ids.long()]  # [L, B, S]
    return priors[None, :] + gathered.sum(dim=2).T


class CategoricalNaiveBayesModel(OnDevice):
    """Dense NB model; every score path but a custom default's runs on
    the model's device. ``priors``/``likelihoods`` give the reference
    model's map shapes for parity checks."""

    def __init__(self, labels: BiMap, vocabs: List[BiMap],
                 priors_arr: np.ndarray, likelihoods_arr: np.ndarray,
                 seen: np.ndarray):
        self.labels = labels
        self.vocabs = vocabs
        self.n_slots = len(vocabs)
        self._priors = np.asarray(priors_arr, dtype=np.float32)
        self._likelihoods = np.asarray(likelihoods_arr, dtype=np.float32)
        self._seen = seen
        self._unk = likelihoods_arr.shape[-1] - 1  # sentinel column
        self._tables = None
        # long-lived residency: these tables serve every query until the
        # model retires
        memacct.LEDGER.register(
            self, "naive_bayes", "params",
            int(self._priors.nbytes + self._likelihoods.nbytes))

    def to(self, device: DeviceLike) -> "CategoricalNaiveBayesModel":
        self._tables = None
        return super().to(device)

    def __getstate__(self):
        d = super().__getstate__()
        d["_tables"] = None
        return d

    def _device_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        dev = self.serving_device()
        if self._tables is None:
            self._tables = (torch.from_numpy(self._priors).to(dev),
                            torch.from_numpy(self._likelihoods).to(dev))
        return self._tables

    # -- reference-shaped views ----------------------------------------------
    @property
    def priors(self) -> Dict[str, float]:
        return {lbl: float(self._priors[i]) for lbl, i in self.labels.items()}

    @property
    def likelihoods(self) -> Dict[str, List[Dict[str, float]]]:
        arr = self._likelihoods
        return {lbl: [{v: float(arr[li, s, vi])
                       for v, vi in self.vocabs[s].items()
                       if self._seen[li, s, vi]}
                      for s in range(self.n_slots)]
                for lbl, li in self.labels.items()}

    # -- encoding -------------------------------------------------------------
    def encode_features(self, batch: Sequence[Sequence[str]]) -> np.ndarray:
        """String features -> [B, n_slots] vocab indices (UNK sentinel)."""
        ids = np.full((len(batch), self.n_slots), self._unk, dtype=np.int32)
        for b, features in enumerate(batch):
            if len(features) != self.n_slots:
                raise ValueError(
                    f"expected {self.n_slots} features, got {len(features)}")
            for s, v in enumerate(features):
                ids[b, s] = self.vocabs[s].get(v, self._unk)
        return ids

    # -- scoring (ref: logScore :103) -----------------------------------------
    def log_score(self, point: LabeledPoint,
                  default_likelihood: Optional[DefaultLikelihood] = None,
                  ) -> Optional[float]:
        """Log score of (features, label); None if the label is unknown."""
        if point.label not in self.labels:
            return None
        li = self.labels[point.label]
        if default_likelihood is None:
            return float(self.score_batch([point.features])[0, li])
        # a custom default: the fallback entries recomputed on the host
        # (the baked table holds the train-time default)
        arr = self._likelihoods
        total = float(self._priors[li])
        for s, v in enumerate(point.features):
            vi = self.vocabs[s].get(v)
            if vi is not None and self._seen[li, s, vi]:
                total += float(arr[li, s, vi])
            else:
                others = [float(arr[li, s, oi])
                          for oi in range(arr.shape[-1] - 1)
                          if self._seen[li, s, oi]]
                total += default_likelihood(others)
        return total

    def score_batch(self, batch: Sequence[Sequence[str]]) -> np.ndarray:
        """[B, n_labels] log scores, one gather and sum on the device."""
        priors, lik = self._device_tables()
        ids = torch.from_numpy(self.encode_features(batch)).to(priors.device)
        return score_batch(ids, priors, lik).cpu().numpy()

    # -- prediction (ref: predict :143) ---------------------------------------
    def predict(self, features: Sequence[str]) -> str:
        return self.predict_batch([features])[0]

    def predict_batch(self, batch: Sequence[Sequence[str]]) -> List[str]:
        scores = self.score_batch(batch)
        inv = self.labels.inverse()
        return [inv[int(i)] for i in np.argmax(scores, axis=1)]


def train(points: Sequence[LabeledPoint],
          default_likelihood: DefaultLikelihood = _neg_inf_default,
          device: DeviceLike = None) -> CategoricalNaiveBayesModel:
    """Count-based training (ref: CategoricalNaiveBayes.train :29).

    ``default_likelihood`` is evaluated per (label, slot) over that
    slot's seen likelihoods and baked into the dense table's unseen and
    unknown-value entries. The model scores on ``device``."""
    if not points:
        raise ValueError("no training points")
    n_slots = len(points[0].features)
    for p in points:
        if len(p.features) != n_slots:
            raise ValueError("inconsistent feature arity in training points")

    labels = BiMap.string_int(p.label for p in points)
    vocabs = [BiMap.string_int(p.features[s] for p in points)
              for s in range(n_slots)]
    n_labels = len(labels)
    max_v = max((len(v) for v in vocabs), default=0)

    counts = np.zeros((n_labels, n_slots, max_v + 1), dtype=np.int64)
    label_counts = np.zeros(n_labels, dtype=np.int64)
    li_arr = np.fromiter((labels[p.label] for p in points), dtype=np.int64,
                         count=len(points))
    np.add.at(label_counts, li_arr, 1)
    for s in range(n_slots):
        vi_arr = np.fromiter((vocabs[s][p.features[s]] for p in points),
                             dtype=np.int64, count=len(points))
        np.add.at(counts[:, s, :], (li_arr, vi_arr), 1)

    seen = counts > 0
    with np.errstate(divide="ignore"):
        lik = np.where(
            seen, np.log(counts / np.maximum(label_counts[:, None, None], 1)),
            0.0)
    # bake default_likelihood into the unseen + UNK entries per (label, slot)
    for l in range(n_labels):
        for s in range(n_slots):
            seen_vals = lik[l, s, : len(vocabs[s])][seen[l, s, : len(vocabs[s])]]
            d = default_likelihood([float(x) for x in seen_vals])
            lik[l, s, ~seen[l, s]] = d
            lik[l, s, -1] = d

    priors = np.log(label_counts / float(len(points)))
    return CategoricalNaiveBayesModel(labels, vocabs, priors, lik,
                                      seen).to(device)
