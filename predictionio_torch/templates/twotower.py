"""Two-tower neural recommendation engine template.

Counterpart of ``predictionio_tpu/templates/twotower.py``: the
recommendation template's data contract (rate/buy events, ref:
examples/scala-parallel-recommendation DataSource.scala:31) with the
two-tower model in the Algorithm slot. ``twotower_hybrid_engine`` runs
ALS and two-tower and averages their scores at serve time (the
reference's multi-algorithm Serving contract, CreateServer.scala:472–475);
the port trains both of its algorithms, and deploys a hybrid trained by
either package.

Queries: ``{"user": U, "num": k}`` (user -> top-k items through the
model's retrieval index, the ``topk_dot`` kernel on a card) and
``{"item": I, "num": k}`` (item -> similar items, cosine).
"""

from __future__ import annotations

from typing import Any, Dict, List

from predictionio_torch.core import Engine, FirstServing, Serving
from predictionio_torch.models.als import ALSAlgorithm
from predictionio_torch.models.twotower import TwoTowerAlgorithm
from predictionio_torch.templates.recommendation import (RecoDataSource,
                                                         RecoPreparator)


class ItemScoreAverageServing(Serving):
    """Mean per-item score across algorithms (ref: LAverageServing.scala:25
    lifted to itemScores lists): items merge by id, each algorithm
    contributes its score, a missing entry counts as 0."""

    def serve(self, query: Dict[str, Any], predictions: List[Dict[str, Any]]):
        num = int(query.get("num", 10))
        totals: Dict[str, float] = {}
        for pred in predictions:
            for entry in pred.get("itemScores", []):
                totals[entry["item"]] = (totals.get(entry["item"], 0.0)
                                         + entry["score"])
        n = max(len(predictions), 1)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:num]
        return {"itemScores": [{"item": i, "score": s / n}
                               for i, s in ranked]}


def twotower_engine() -> Engine:
    """Engine factory: two-tower retrieval only."""
    return Engine(
        data_source_classes=RecoDataSource,
        preparator_classes=RecoPreparator,
        algorithm_classes={"twotower": TwoTowerAlgorithm},
        serving_classes=FirstServing,
    )


def twotower_hybrid_engine() -> Engine:
    """ALS + two-tower ensemble combined by score averaging."""
    return Engine(
        data_source_classes=RecoDataSource,
        preparator_classes=RecoPreparator,
        algorithm_classes={"als": ALSAlgorithm, "twotower": TwoTowerAlgorithm},
        serving_classes=ItemScoreAverageServing,
    )
