"""Classification engine template.

Counterpart of ``predictionio_tpu/templates/classification.py``.
Behavior contract from the reference
(examples/scala-parallel-classification/add-algorithm/src/main/scala/):

  - DataSource (DataSource.scala:27-56): aggregate "user" entities that
    have ALL required properties (label ``plan`` + attrs
    ``attr0/attr1/attr2``) into labeled points of numeric features.
  - Engine (Engine.scala:15-24): two algorithms — "naive" (NaiveBayes)
    and a second slot ("logistic" here) — each predicting a float label
    from ``{"features": [...]}``; FirstServing combines.
  - k-fold eval via the e2 splitData semantics
    (e2/.../evaluation/CrossValidation.scala:33).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from predictionio_torch.core import (DataSource, Engine, FirstServing,
                                     IdentityPreparator)
from predictionio_torch.core.cross_validation import split_data
from predictionio_torch.core.params import EngineParams, Params
from predictionio_torch.data import store
from predictionio_torch.models.classification import (
    LabeledVectors, LogisticRegressionAlgorithm, NaiveBayesAlgorithm,
    NaiveBayesParams)
from predictionio_torch.parallel.context import DeviceContext


@dataclass
class ClassificationDSParams(Params):
    app_name: str = ""
    channel_name: Optional[str] = None
    entity_type: str = "user"
    label_property: str = "plan"
    feature_properties: List[str] = field(
        default_factory=lambda: ["attr0", "attr1", "attr2"])
    eval_k: int = 0


class ClassificationDataSource(DataSource):
    """ref: DataSource.scala:27 readTraining."""

    def __init__(self, params: ClassificationDSParams):
        super().__init__(params)

    def _read_points(self) -> List[tuple]:
        p: ClassificationDSParams = self.params
        required = [p.label_property] + list(p.feature_properties)
        props = store.aggregate_properties(p.app_name, p.entity_type,
                                           channel_name=p.channel_name,
                                           required=required)
        return [(float(pm.get(p.label_property)),
                 [float(pm.get(attr)) for attr in p.feature_properties])
                for _entity, pm in sorted(props.items())]

    @staticmethod
    def _to_td(points: List[tuple]) -> LabeledVectors:
        return LabeledVectors(
            features=np.array([f for _l, f in points],
                              dtype=np.float32).reshape(len(points), -1),
            labels=np.array([l for l, _f in points], dtype=np.float64))

    def read_training(self, ctx: DeviceContext) -> LabeledVectors:
        return self._to_td(self._read_points())

    def read_eval(self, ctx: DeviceContext):
        p: ClassificationDSParams = self.params
        if p.eval_k <= 1:
            return []
        return split_data(p.eval_k, self._read_points(), {"k": p.eval_k},
                          training_data_creator=self._to_td,
                          query_creator=lambda d: {"features": d[1]},
                          actual_creator=lambda d: {"label": d[0]})


def classification_engine() -> Engine:
    """ref: ClassificationEngine factory (Engine.scala:15)."""
    return Engine(
        data_source_classes=ClassificationDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"naive": NaiveBayesAlgorithm,
                           "logistic": LogisticRegressionAlgorithm},
        serving_classes=FirstServing)


def default_engine_params(app_name: str, channel_name: Optional[str] = None,
                          eval_k: int = 0,
                          lambda_: float = 1.0) -> EngineParams:
    return EngineParams(
        data_source_params=("", ClassificationDSParams(
            app_name=app_name, channel_name=channel_name, eval_k=eval_k)),
        algorithm_params_list=[("naive", NaiveBayesParams(lambda_=lambda_))])
