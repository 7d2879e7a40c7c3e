"""Recommendation engine template (ALS): what ``pio deploy`` needs.

Counterpart of ``predictionio_tpu/templates/recommendation.py``. The
params classes keep the JAX package's fields, since an engine instance
stores them and deploy rebuilds them by name; ``recommendation_engine``
is the factory an engine.json names (a ``predictionio_tpu.`` factory
path resolves here). Reading events and preparing ratings come with the
training slice (ROADMAP.md, queue 1 item 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from predictionio_torch.core import (DataSource, Engine, FirstServing,
                                     Preparator)
from predictionio_torch.core.params import Params
from predictionio_torch.models.als import ALSAlgorithm
from predictionio_torch.parallel.context import DeviceContext

_TRAINING_SLICE = ("is not ported to predictionio_torch yet (ROADMAP.md, "
                   "queue 1 item 3); train with predictionio_tpu and "
                   "deploy here")


@dataclass
class RecoDataSourceParams(Params):
    app_name: str = ""
    channel_name: Optional[str] = None
    rate_event: str = "rate"
    buy_event: str = "buy"
    buy_rating: float = 4.0
    eval_k: int = 0
    eval_query_num: int = 10
    columnar: bool = True
    binned: bool = True


class RecoDataSource(DataSource):
    """ref: recommendation template DataSource.scala:31."""

    def __init__(self, params: RecoDataSourceParams):
        super().__init__(params)

    def read_training(self, ctx: DeviceContext):
        raise NotImplementedError(f"reading training events {_TRAINING_SLICE}")


class RecoPreparator(Preparator):
    """String ids -> dense COO (ref: template Preparator)."""

    def prepare(self, ctx: DeviceContext, training_data):
        raise NotImplementedError(f"preparing ratings {_TRAINING_SLICE}")


def recommendation_engine() -> Engine:
    """Engine factory (ref: examples/.../RecommendationEngine object)."""
    return Engine(
        data_source_classes=RecoDataSource,
        preparator_classes=RecoPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
