"""Recommendation engine template (ALS).

Counterpart of ``predictionio_tpu/templates/recommendation.py`` (ref:
examples/scala-parallel-recommendation/custom-serving/src/main/scala/
DataSource.scala:31): the DataSource reads "rate" events (their
"rating" property) and "buy" events (an implicit rating, 4.0) between
user and item entities; the Preparator indexes string ids to dense
rows. The params classes keep the JAX package's fields, since an engine
instance stores them and deploy rebuilds them by name;
``recommendation_engine`` is the factory an engine.json names (a
``predictionio_tpu.`` factory path resolves here).

The port has no native event store, so ``binned=True`` reads through the
columnar path, as the JAX package does when its backend lacks the
zero-copy lane (ROADMAP.md, queue 1 item 2(b)). ``pio train`` then fits
ALS on the prepared COO with ``ALSAlgorithm.train`` (``ops/als.py``) on
the card; the two-tower template trains on the same data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from predictionio_torch.core import (DataSource, Engine, FirstServing,
                                     Preparator, SanityCheck)
from predictionio_torch.core.params import Params
from predictionio_torch.data import store
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.models.als import ALSAlgorithm, PreparedRatings
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates._columnar import read_interactions


@dataclass
class RatingEvent:
    user: str
    item: str
    rating: float


@dataclass
class RatingColumns:
    """Columnar triples: vocab lists + dense code/value arrays (the
    dict-encoded bulk-read product of store.find_columnar)."""

    user_vocab: List[str]
    item_vocab: List[str]
    user_idx: np.ndarray    # int into user_vocab, [n]
    item_idx: np.ndarray    # int into item_vocab, [n]
    ratings: np.ndarray     # float32 [n]


def _resolve_ratings(values: np.ndarray, name_codes: np.ndarray,
                     names: List[str],
                     overrides: Dict[str, float]) -> np.ndarray:
    """The template's one value-resolution rule: NaN -> 0.0, then
    per-event-name constant overrides ("buy" means rating 4.0)."""
    ratings = np.nan_to_num(values, nan=0.0).astype(np.float32)
    for name, val in overrides.items():
        if name in names:
            code = names.index(name)
            ratings = np.where(name_codes == code, np.float32(val), ratings)
    return ratings


@dataclass
class RatingsTD(SanityCheck):
    """Training data: (user, item, rating) triples from the event store,
    as a row list (``columnar=False``) or columnar arrays."""

    ratings: List[RatingEvent] = field(default_factory=list)
    columns: Optional[RatingColumns] = None

    def sanity_check(self) -> None:
        if not self.ratings and (self.columns is None
                                 or not len(self.columns.ratings)):
            raise ValueError("RatingsTD is empty — no rate/buy events found")


@dataclass
class RecoDataSourceParams(Params):
    app_name: str = ""
    channel_name: Optional[str] = None
    rate_event: str = "rate"
    buy_event: str = "buy"
    buy_rating: float = 4.0
    eval_k: int = 0
    eval_query_num: int = 10
    columnar: bool = True     # bulk dict-encoded read; False: event rows
    binned: bool = True       # the native zero-copy lane: not in the
                              # port, which reads columnar instead


class RecoDataSource(DataSource):
    """ref: recommendation template DataSource.scala:31."""

    def __init__(self, params: RecoDataSourceParams):
        super().__init__(params)

    def _read(self) -> List[RatingEvent]:
        p: RecoDataSourceParams = self.params
        events = store.find(p.app_name, channel_name=p.channel_name,
                            entity_type="user",
                            event_names=[p.rate_event, p.buy_event],
                            target_entity_type="item")
        return [RatingEvent(
            user=e.entity_id, item=e.target_entity_id,
            rating=(float(e.properties.get("rating", 0.0))
                    if e.event == p.rate_event else p.buy_rating))
            for e in events]

    def _read_columnar(self) -> RatingColumns:
        """One dict-encoded scan, ratings resolved vectorized (rate ->
        its rating property, buy -> the constant buy_rating)."""
        p: RecoDataSourceParams = self.params
        cols = read_interactions(p.app_name, p.channel_name, "user",
                                 [p.rate_event, p.buy_event], "item",
                                 value_property="rating")
        return RatingColumns(
            user_vocab=cols.entity_vocab, item_vocab=cols.target_vocab,
            user_idx=cols.entity_idx, item_idx=cols.target_idx,
            ratings=_resolve_ratings(cols.values, cols.name_codes,
                                     cols.names,
                                     {p.buy_event: p.buy_rating}))

    def read_training(self, ctx: DeviceContext) -> RatingsTD:
        p: RecoDataSourceParams = self.params
        # no backend of the port has the binned lane
        # (store.supports_bin_columnar), so binned reads columnar
        if p.columnar:
            return RatingsTD(columns=self._read_columnar())
        return RatingsTD(ratings=self._read())


class RecoPreparator(Preparator):
    """String ids -> dense COO (ref: template Preparator + BiMap
    indexing); the columnar TD arrives dict-encoded already."""

    def prepare(self, ctx: DeviceContext, td: RatingsTD) -> PreparedRatings:
        if td.columns is not None:
            c = td.columns
            return PreparedRatings(
                user_ids=BiMap.from_vocab(c.user_vocab),
                item_ids=BiMap.from_vocab(c.item_vocab),
                user_idx=c.user_idx.astype(np.int64, copy=False),
                item_idx=c.item_idx.astype(np.int64, copy=False),
                ratings=c.ratings)
        users = BiMap.string_int(r.user for r in td.ratings)
        items = BiMap.string_int(r.item for r in td.ratings)
        n = len(td.ratings)
        return PreparedRatings(
            user_ids=users, item_ids=items,
            user_idx=np.fromiter((users[r.user] for r in td.ratings),
                                 np.int64, count=n),
            item_idx=np.fromiter((items[r.item] for r in td.ratings),
                                 np.int64, count=n),
            ratings=np.fromiter((r.rating for r in td.ratings), np.float32,
                                count=n))


def recommendation_engine() -> Engine:
    """Engine factory (ref: examples/.../RecommendationEngine object)."""
    return Engine(
        data_source_classes=RecoDataSource,
        preparator_classes=RecoPreparator,
        algorithm_classes={"als": ALSAlgorithm},
        serving_classes=FirstServing,
    )
