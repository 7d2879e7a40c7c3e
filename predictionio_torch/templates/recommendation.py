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

With ``columnar`` and ``binned`` (the defaults) over a store that has
the fused native scan+bin (the ``eventlog`` backend), ``read_training``
reads nothing: it hands the fit stage a ``BinnedReadRequest``, and
``ALSAlgorithm.train`` bins the mmapped log straight into the trainer's
layout with its own knobs, or loads that layout from the cache under the
DataSource's ``data_fingerprint``. Other stores, and every store in a
``torch.distributed`` world of more than one process (each rank reads
its entity-hash shard), read through the columnar path. ``pio train`` then fits ALS (``ops/als.py``) on the
card; the two-tower template trains on the same data. ``read_eval``
gives ``pio eval`` its k folds (``eval_k``) from the row read.
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
from predictionio_torch.parallel import multihost as mh
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
class BinnedReadRequest:
    """A deferred zero-copy training read. The DataSource cannot bin at
    read time, since the layout depends on the algorithm's knobs (rank,
    seg_len, block_size, per-group caps); the fit stage makes the one
    fused native scan+bin call (``store.bin_columnar``) with its own:
    events go from the mmapped log to the trainer's layout with no Event
    objects and no intermediate COO in Python."""

    app_name: str
    channel_name: Optional[str]
    entity_type: str
    event_names: List[str]
    target_entity_type: str
    value_property: Optional[str]
    #: event name -> constant rating (the "buy means 4.0" rule)
    overrides: Dict[str, float]

    def bin(self, **layout_knobs):
        return store.bin_columnar(
            self.app_name, self.channel_name,
            value_property=self.value_property, overrides=self.overrides,
            entity_type=self.entity_type, event_names=list(self.event_names),
            target_entity_type=self.target_entity_type, **layout_knobs)

    def read_prepared(self, fingerprint: Optional[str] = None
                      ) -> PreparedRatings:
        """The request as indexed COO, for algorithms that do not take
        the binned layout (two-tower): read through the columnar path,
        with the same rows, first-seen codes and value resolution as the
        native lane. Memoized, so the algorithms of one engine share one
        read."""
        cached = getattr(self, "_prepared", None)
        if cached is not None:
            return cached
        cols = read_interactions(
            self.app_name, self.channel_name, self.entity_type,
            self.event_names, self.target_entity_type,
            value_property=self.value_property)
        self._prepared = PreparedRatings(
            user_ids=BiMap.from_vocab(cols.entity_vocab),
            item_ids=BiMap.from_vocab(cols.target_vocab),
            user_idx=cols.entity_idx.astype(np.int64, copy=False),
            item_idx=cols.target_idx.astype(np.int64, copy=False),
            ratings=_resolve_ratings(cols.values, cols.name_codes,
                                     cols.names, self.overrides),
            fingerprint=fingerprint)
        return self._prepared


@dataclass
class RatingsTD(SanityCheck):
    """Training data: (user, item, rating) triples from the event store,
    as a row list (``columnar=False``), columnar arrays, or a deferred
    ``binned_request`` (nothing read yet). ``fingerprint`` identifies the
    data and its derivation where the store has a cheap fingerprint."""

    ratings: List[RatingEvent] = field(default_factory=list)
    columns: Optional[RatingColumns] = None
    binned_request: Optional[BinnedReadRequest] = None
    fingerprint: Optional[str] = None

    def sanity_check(self) -> None:
        if self.binned_request is not None:
            return   # emptiness shows at the fit stage's native read
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
    binned: bool = True       # the native scan+bin lane where the store
                              # has it; columnar reads elsewhere


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

    def data_fingerprint(self) -> Optional[str]:
        """O(1) fingerprint of what ``read_training`` would produce: the
        store's content fingerprint (None where it has none) and every
        param that shapes the derived ratings. A layout cached under it
        lets the read be skipped."""
        p: RecoDataSourceParams = self.params
        fp = store.data_fingerprint(p.app_name, p.channel_name)
        if fp is None:
            return None
        return (f"{fp}|reco|{p.rate_event}|{p.buy_event}|{p.buy_rating}"
                f"|{p.columnar}")

    def _binned_supported(self) -> bool:
        """The fused native lane needs a store that has it and a
        single-process run: in a world of more than one, each rank reads
        its entity-hash shard through the columnar path, and two ranks
        would both take the event log's writer lock."""
        p: RecoDataSourceParams = self.params
        if mh.process_count() > 1:
            return False
        return store.supports_bin_columnar(p.app_name, p.channel_name)

    def read_training(self, ctx: DeviceContext) -> RatingsTD:
        p: RecoDataSourceParams = self.params
        fp = self.data_fingerprint()
        if p.columnar and p.binned and self._binned_supported():
            return RatingsTD(
                binned_request=BinnedReadRequest(
                    app_name=p.app_name, channel_name=p.channel_name,
                    entity_type="user",
                    event_names=[p.rate_event, p.buy_event],
                    target_entity_type="item", value_property="rating",
                    overrides={p.buy_event: p.buy_rating}),
                fingerprint=fp)
        if p.columnar:
            return RatingsTD(columns=self._read_columnar(), fingerprint=fp)
        return RatingsTD(ratings=self._read(), fingerprint=fp)

    def read_eval(self, ctx: DeviceContext):
        """k folds split by row index ``% eval_k`` over the row read
        (ref: CrossValidation.scala:33); each held-out rating is a
        ``{"user", "num"}`` query with its ``{"item", "rating"}``."""
        p: RecoDataSourceParams = self.params
        if p.eval_k <= 1:
            return []
        all_ratings = self._read()
        folds = []
        for fold in range(p.eval_k):
            train = [r for i, r in enumerate(all_ratings)
                     if i % p.eval_k != fold]
            qa = [({"user": r.user, "num": p.eval_query_num},
                   {"item": r.item, "rating": r.rating})
                  for i, r in enumerate(all_ratings) if i % p.eval_k == fold]
            folds.append((RatingsTD(ratings=train), {"fold": fold}, qa))
        return folds


class RecoPreparator(Preparator):
    """String ids -> dense COO (ref: template Preparator + BiMap
    indexing); the columnar TD arrives dict-encoded already."""

    def prepare(self, ctx: DeviceContext, td: RatingsTD) -> PreparedRatings:
        if td.binned_request is not None:
            # nothing to index: the fit stage's native call dict-encodes
            # the ids in its one pass
            return PreparedRatings(binned_request=td.binned_request,
                                   fingerprint=td.fingerprint)
        if td.columns is not None:
            c = td.columns
            return PreparedRatings(
                user_ids=BiMap.from_vocab(c.user_vocab),
                item_ids=BiMap.from_vocab(c.item_vocab),
                user_idx=c.user_idx.astype(np.int64, copy=False),
                item_idx=c.item_idx.astype(np.int64, copy=False),
                ratings=c.ratings, fingerprint=td.fingerprint)
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
