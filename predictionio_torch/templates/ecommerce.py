"""E-commerce recommendation engine template.

Counterpart of ``predictionio_tpu/templates/ecommerce.py``. Behavior
contract from the reference
(examples/scala-parallel-ecommercerecommendation/train-with-rate-event/
src/main/scala/DataSource.scala + Engine.scala): the DataSource
aggregates "user" and "item" entities (items carry an optional
``categories`` property) and reads user-rate-item events with a
``rating`` property, in event-time order (the algorithm keeps the
latest rating of a pair); the engine wires one "als" ECommAlgorithm
behind a first-serving combiner. Serve-time business rules (seen items,
unavailable-items constraint, new-user fallback) live in the algorithm
(``models/ecommerce.py``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from predictionio_torch.core import (DataSource, Engine, FirstServing,
                                     IdentityPreparator)
from predictionio_torch.core.params import EngineParams, Params
from predictionio_torch.data import store
from predictionio_torch.models._interactions import Interactions
from predictionio_torch.models.ecommerce import (ECommAlgorithm,
                                                 ECommAlgorithmParams,
                                                 ECommTrainingData)
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates._columnar import read_interactions

log = logging.getLogger(__name__)


@dataclass
class ECommDSParams(Params):
    app_name: str = ""
    channel_name: Optional[str] = None
    rate_event: str = "rate"
    columnar: bool = True     # bulk dict-encoded interaction read; False
                              # reads event rows


class ECommDataSource(DataSource):
    """ref: DataSource.scala:22 readTraining (rate-event variant)."""

    def __init__(self, params: ECommDSParams):
        super().__init__(params)

    def read_training(self, ctx: DeviceContext) -> ECommTrainingData:
        p: ECommDSParams = self.params
        t0 = time.perf_counter()
        users = sorted(store.aggregate_properties(
            p.app_name, "user", channel_name=p.channel_name))
        item_props = store.aggregate_properties(
            p.app_name, "item", channel_name=p.channel_name)
        item_categories = {
            item: props.get_opt("categories")
            for item, props in item_props.items()
            if props.get_opt("categories") is not None}
        t1 = time.perf_counter()
        if p.columnar:
            c = read_interactions(p.app_name, p.channel_name, "user",
                                  [p.rate_event], "item",
                                  value_property="rating",
                                  time_ordered=True)
            rates = Interactions(c.entity_vocab, c.target_vocab,
                                 c.entity_idx, c.target_idx,
                                 values=np.nan_to_num(c.values, nan=0.0))
        else:
            events = store.find(p.app_name, channel_name=p.channel_name,
                                entity_type="user",
                                event_names=[p.rate_event],
                                target_entity_type="item")
            rates = Interactions.from_rows(
                (e.entity_id, e.target_entity_id,
                 float(e.properties.get("rating", 0.0))) for e in events)
        log.info("e-commerce training read: %s", {
            "users": len(users), "items": len(item_props),
            "rates": len(rates), "properties_sec": t1 - t0,
            "interactions_sec": time.perf_counter() - t1})
        return ECommTrainingData(users=users, items=sorted(item_props),
                                 item_categories=item_categories,
                                 rates=rates)


def ecommerce_engine() -> Engine:
    """ref: ECommerceRecommendationEngine factory (Engine.scala:23)."""
    return Engine(
        data_source_classes=ECommDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"als": ECommAlgorithm},
        serving_classes=FirstServing)


def default_engine_params(
    app_name: str, channel_name: Optional[str] = None,
    algo_params: Optional[ECommAlgorithmParams] = None,
) -> EngineParams:
    algo = algo_params or ECommAlgorithmParams(app_name=app_name)
    if not algo.app_name:
        algo.app_name = app_name
    return EngineParams(
        data_source_params=("", ECommDSParams(
            app_name=app_name, channel_name=channel_name)),
        algorithm_params_list=[("als", algo)])
