"""Algorithm library of the port (counterpart of ``predictionio_tpu.models``).

  als      — matrix factorization (ref: MLlib ALS templates): training
             through ops/als.py, serving, and the prepared ratings
  twotower — two-tower neural retrieval, trained on the card
  similarproduct — item-to-item similarity over implicit ALS factors
             (views and likes; ref: scala-parallel-similarproduct)
  ecommerce — explicit ALS with serve-time business rules (ref:
             scala-parallel-ecommercerecommendation)
  sessionrec — causal-transformer next-item recommendation
  classification — multinomial naive Bayes and softmax regression (ref:
             scala-parallel-classification)
  regression — SGD and ridge linear regression (ref: the regression
             examples)
  naive_bayes — categorical naive Bayes (ref: e2 CategoricalNaiveBayes)
  markov   — top-N transition chains (ref: e2 MarkovChain)
"""

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

from predictionio_torch.obs import torchmon


def batch_predict_dense(
    model: Any,
    queries: Sequence[Tuple[int, Any]],
    wrap: Callable[[float], Any] = float,
) -> List[Tuple[int, Any]]:
    """Shared glue for algorithms over dense ``{"features": [...]}``
    queries: stack the batch into one ``[B, D]`` matrix, score it with
    the model's vectorized ``predict_batch``, and wrap each output.
    Handles the empty fold ``engine.eval`` can produce."""
    if not queries:
        return []
    feats = np.array([q["features"] for _, q in queries], dtype=np.float32)
    torchmon.record_transfer(feats.nbytes, "h2d")
    preds = model.predict_batch(feats)
    torchmon.record_transfer(getattr(preds, "nbytes", None), "d2h")
    return [(i, wrap(p)) for (i, _q), p in zip(queries, preds)]
