"""Similar-product engine template.

Counterpart of ``predictionio_tpu/templates/similarproduct.py``.
Behavior contract from the reference template
(examples/scala-parallel-similarproduct/multi/src/main/scala/):

  - DataSource (DataSource.scala:25-128): aggregate "user" entities,
    "item" entities (optional ``categories`` property), read
    user-view-item events and user-like/dislike-item events.
  - Engine (Engine.scala:25-34): TWO algorithms — "als" over views and
    "likealgo" over likes — combined by a custom Serving.
  - Serving (Serving.scala:12-54): z-score standardize each algorithm's
    scores (skip when num == 1; stddev 0 -> score 0), sum scores of the
    same item across algorithms, return top-num.

The interaction reads stay dict-encoded columns (one bulk scan per
family, the likes in event-time order: the model keeps the latest like
or dislike of a pair); ``columnar=False`` reads event rows instead, to
the same training data. Exclusion-only queries run through the model's
retrieval index (the ``topk_dot`` kernel on a card), predicate queries
through the masked scorer.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from predictionio_torch.core import (DataSource, Engine, IdentityPreparator,
                                     Serving)
from predictionio_torch.core.params import EngineParams, Params
from predictionio_torch.data import store
from predictionio_torch.models._interactions import Interactions
from predictionio_torch.models.similarproduct import (LikeAlgorithm,
                                                      SimilarProductAlgorithm,
                                                      SimilarProductData,
                                                      SimilarProductParams)
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates._columnar import read_interactions

log = logging.getLogger(__name__)


@dataclass
class SimilarProductDSParams(Params):
    app_name: str = ""
    channel_name: Optional[str] = None
    columnar: bool = True     # bulk dict-encoded interaction reads;
                              # False reads event rows


class SimilarProductDataSource(DataSource):
    """ref: DataSource.scala:25 readTraining."""

    def __init__(self, params: SimilarProductDSParams):
        super().__init__(params)

    def _interactions(self):
        """(views, likes) as ``Interactions``; a like row's value is +1,
        a dislike's -1."""
        p: SimilarProductDSParams = self.params
        if not p.columnar:
            views = store.find(
                p.app_name, channel_name=p.channel_name, entity_type="user",
                event_names=["view"], target_entity_type="item")
            likes = store.find(
                p.app_name, channel_name=p.channel_name, entity_type="user",
                event_names=["like", "dislike"], target_entity_type="item")
            return (
                Interactions.from_rows((e.entity_id, e.target_entity_id)
                                       for e in views),
                Interactions.from_rows(
                    (e.entity_id, e.target_entity_id,
                     1.0 if e.event == "like" else -1.0) for e in likes))
        vc = read_interactions(p.app_name, p.channel_name, "user",
                               ["view"], "item")
        lc = read_interactions(p.app_name, p.channel_name, "user",
                               ["like", "dislike"], "item",
                               time_ordered=True)
        like_code = lc.names.index("like") if "like" in lc.names else -1
        return (
            Interactions(vc.entity_vocab, vc.target_vocab, vc.entity_idx,
                         vc.target_idx),
            Interactions(lc.entity_vocab, lc.target_vocab, lc.entity_idx,
                         lc.target_idx,
                         values=np.where(lc.name_codes == like_code, 1.0,
                                         -1.0)))

    def read_training(self, ctx: DeviceContext) -> SimilarProductData:
        p: SimilarProductDSParams = self.params
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
        views, likes = self._interactions()
        log.info("similar-product training read: %s", {
            "users": len(users), "items": len(item_props),
            "views": len(views), "likes": len(likes),
            "properties_sec": t1 - t0,
            "interactions_sec": time.perf_counter() - t1})
        return SimilarProductData(users=users, items=sorted(item_props),
                                  item_categories=item_categories,
                                  views=views, likes=likes)


class StandardizingServing(Serving):
    """z-score standardize per algorithm, sum per item (ref:
    Serving.scala:12)."""

    def serve(self, query: Dict[str, Any],
              predictions: Sequence[Dict[str, Any]]):
        num = int(query.get("num", 10))
        score_lists = [p.get("itemScores", []) for p in predictions]
        if num == 1:
            standardized = score_lists
        else:
            standardized = []
            for scores in score_lists:
                vals = np.array([s["score"] for s in scores],
                                dtype=np.float64)
                if len(vals) == 0:
                    standardized.append([])
                    continue
                std = vals.std(ddof=1) if len(vals) > 1 else 0.0
                standardized.append([
                    {"item": s["item"],
                     "score": (0.0 if std == 0
                               else (s["score"] - vals.mean()) / std)}
                    for s in scores])
        combined: Dict[str, float] = {}
        for scores in standardized:
            for s in scores:
                combined[s["item"]] = combined.get(s["item"], 0.0) + s["score"]
        top = sorted(combined.items(), key=lambda kv: -kv[1])[:num]
        return {"itemScores": [{"item": i, "score": v} for i, v in top]}


def similar_product_engine() -> Engine:
    """ref: SimilarProductEngine factory (Engine.scala:25-34)."""
    return Engine(
        data_source_classes=SimilarProductDataSource,
        preparator_classes=IdentityPreparator,
        algorithm_classes={"als": SimilarProductAlgorithm,
                           "likealgo": LikeAlgorithm},
        serving_classes=StandardizingServing)


def default_engine_params(
    app_name: str, channel_name: Optional[str] = None,
    als_params: Optional[SimilarProductParams] = None,
    like_params: Optional[SimilarProductParams] = None,
) -> EngineParams:
    return EngineParams(
        data_source_params=("", SimilarProductDSParams(
            app_name=app_name, channel_name=channel_name)),
        algorithm_params_list=[
            ("als", als_params or SimilarProductParams()),
            ("likealgo", like_params or SimilarProductParams())])
