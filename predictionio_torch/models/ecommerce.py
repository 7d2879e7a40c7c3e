"""E-commerce recommendation: explicit ALS + serve-time business-rule filters.

Counterpart of ``predictionio_tpu/models/ecommerce.py``. Behavior
contract from the reference template
(examples/scala-parallel-ecommercerecommendation/train-with-rate-event/
src/main/scala/ALSAlgorithm.scala):

  - ``train`` (:63-146): index users/items, dedupe (user, item) rate
    events keeping the LATEST rating, explicit ALS, model keeps BOTH
    user and item ("product") factors plus item metadata.
  - ``predict`` (:148-277): build a final blacklist from the query's
    blackList + the user's "seen" events (live event-store lookup when
    ``unseen_only``) + the latest ``$set`` of the special
    ``constraint/unavailableItems`` entity; known users score
    user_vec . item_vec; users unseen at train time fall back to summed
    cosine similarity against their recently viewed items' factors
    (predictNewUser :286-363); apply category/whiteList candidate
    predicates; keep score > 0; top-``num``.

Both query paths are one masked top-k on the model's device
(``TopKScorer.score_masked``; the new-user path over the row-normalized
factors, ``cos_scorer``); candidate predicates are boolean masks, the
category part cached per category. The serve-time event lookups sit
behind bounded TTL caches (``lookup_ttl_sec``; 0 restores the
reference's lookup per request). The latest-rating dedupe is numpy over
dict-encoded rows (``models/_interactions.py``); ALS trains on the
context's device (``ops/als.py``).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from predictionio_torch.core import Algorithm, SanityCheck
from predictionio_torch.core.params import Params
from predictionio_torch.data import store
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.storage import StorageError
from predictionio_torch.models._interactions import (Interactions,
                                                     latest_pairs)
from predictionio_torch.ops.als import ALSConfig, ALSTrainer
from predictionio_torch.ops.topk import TopKScorer, cosine_normalize
from predictionio_torch.parallel.context import (DeviceContext, DeviceLike,
                                                 resolve_device)

log = logging.getLogger(__name__)


@dataclass
class ECommTrainingData(SanityCheck):
    users: List[str] = field(default_factory=list)
    items: List[str] = field(default_factory=list)
    item_categories: Dict[str, List[str]] = field(default_factory=dict)
    #: (user, item) rows with the rating as value, in event-time order
    rates: Interactions = field(
        default_factory=lambda: Interactions.from_rows([]))

    @property
    def rate_events(self) -> List[Tuple[str, str, float]]:
        """The JAX package's form: (user, item, rating) triples."""
        return self.rates.rows()

    def sanity_check(self) -> None:
        if not len(self.rates):
            raise ValueError("rateEvents cannot be empty")
        if not self.users:
            raise ValueError("users cannot be empty")
        if not self.items:
            raise ValueError("items cannot be empty")


@dataclass
class ECommAlgorithmParams(Params):
    app_name: str = ""
    unseen_only: bool = False
    seen_events: List[str] = field(default_factory=lambda: ["buy", "view"])
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: int = 3
    block_size: int = 4096
    # serve-time lookup caching (the reference scans the event store
    # inside every request, :148-251); the TTL bounds staleness, 0
    # disables caching
    lookup_ttl_sec: float = 3.0
    seen_cache_size: int = 10_000


class ECommModel:
    """User + item factors, id maps, item metadata (ref: ALSModel :29),
    with the serving state on the model's device."""

    def __init__(self, user_factors: np.ndarray, item_factors: np.ndarray,
                 user_ids: BiMap, item_ids: BiMap,
                 item_categories: Dict[str, List[str]],
                 rated_users: Optional[np.ndarray] = None,
                 rated_items: Optional[np.ndarray] = None):
        self.user_factors = np.asarray(user_factors, dtype=np.float32)
        self.item_factors = np.asarray(item_factors, dtype=np.float32)
        self.user_ids = user_ids
        self.item_ids = item_ids
        self.item_categories = item_categories
        # MLlib's factor maps cover only the entities present in the
        # ratings (userFeatures.get -> None drives the new-user path,
        # :225-231; productFeatures feature.isDefined gates candidates,
        # :235): track which rows were actually trained
        self.rated_users = (rated_users if rated_users is not None
                            else np.ones(len(user_ids), dtype=bool))
        self.rated_items = (rated_items if rated_items is not None
                            else np.ones(len(item_ids), dtype=bool))
        self._normalized: Optional[np.ndarray] = None
        self._init_device_state()

    def _init_device_state(self) -> None:
        self.device: Optional[torch.device] = None
        self._scorer: Optional[TopKScorer] = None
        self._cos_scorer: Optional[TopKScorer] = None
        self._category_index: Optional[Dict[str, np.ndarray]] = None
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        for key in ("device", "_scorer", "_cos_scorer", "_category_index",
                    "_lock"):
            d.pop(key, None)   # device state never pickles
        d["_normalized"] = None
        return d

    def __setstate__(self, d):
        # a JAX-trained pickle carries its serving slots as None
        self.__dict__.update(d)
        self._init_device_state()

    def to(self, device: DeviceLike) -> "ECommModel":
        device = resolve_device(device)
        with self._lock:
            self.device = device
            self._scorer = None
            self._cos_scorer = None
        return self

    def _serving_device(self) -> torch.device:
        if self.device is None:
            self.to(None)   # the card, or RuntimeError without CUDA
        return self.device

    def scorer(self) -> TopKScorer:
        device = self._serving_device()
        with self._lock:
            if self._scorer is None:
                self._scorer = TopKScorer(self.item_factors, device=device)
            return self._scorer

    def cos_scorer(self) -> TopKScorer:
        """The scorer over the row-normalized item factors (the new-user
        path's sum of cosines)."""
        device = self._serving_device()
        with self._lock:
            if self._cos_scorer is None:
                if self._normalized is None:
                    self._normalized = cosine_normalize(self.item_factors)
                self._cos_scorer = TopKScorer(self._normalized,
                                              device=device)
            return self._cos_scorer

    def normalized(self) -> np.ndarray:
        self.cos_scorer()
        return self._normalized

    def _category_mask(self, categories: Set[str]) -> np.ndarray:
        with self._lock:
            if self._category_index is None:
                per_cat: Dict[str, List[int]] = {}
                for item, cats in self.item_categories.items():
                    row = self.item_ids.get(item)
                    if row is not None:
                        for c in cats:
                            per_cat.setdefault(c, []).append(row)
                index = {}
                for c, rows in per_cat.items():
                    m = np.zeros(len(self.item_ids), dtype=bool)
                    m[rows] = True
                    index[c] = m
                self._category_index = index
            index = self._category_index
        mask = np.zeros(len(self.item_ids), dtype=bool)
        for c in categories:
            if c in index:
                mask |= index[c]
        return mask

    def candidate_mask(self, categories: Optional[Set[str]],
                       white_list: Optional[Set[str]],
                       black_list: Set[str]) -> np.ndarray:
        """Vectorized isCandidateItem + feature.isDefined (ref:
        :380-398, :235)."""
        n = len(self.item_ids)
        mask = self.rated_items.copy()
        if white_list is not None:
            wl = np.zeros(n, dtype=bool)
            wl[[self.item_ids[i] for i in white_list
                if i in self.item_ids]] = True
            mask &= wl
        if black_list:
            mask[[self.item_ids[i] for i in black_list
                  if i in self.item_ids]] = False
        if categories:
            mask &= self._category_mask(categories)  # uncategorized: out
        return mask


class ECommAlgorithm(Algorithm):
    """ref: ALSAlgorithm (train-with-rate-event variant)."""

    def __init__(self, params: ECommAlgorithmParams):
        super().__init__(params)
        # bounded TTL caches for the per-request event-store lookups
        self._cache_lock = threading.Lock()
        self._seen_cache: "collections.OrderedDict[str, Tuple[Set[str], float]]" = (
            collections.OrderedDict())
        self._recent_cache: "collections.OrderedDict[str, Tuple[List[str], float]]" = (
            collections.OrderedDict())
        self._unavail_cache: Optional[Tuple[Set[str], float]] = None

    def _cached(self, cache_get, cache_put, compute):
        ttl = getattr(self.params, "lookup_ttl_sec", 0.0)
        if ttl <= 0:
            return compute()
        now = time.monotonic()
        with self._cache_lock:
            hit = cache_get()
            if hit is not None and hit[1] > now:
                return hit[0]
        value = compute()
        with self._cache_lock:
            cache_put((value, now + ttl))
        return value

    @staticmethod
    def als_config(p: ECommAlgorithmParams) -> ALSConfig:
        return ALSConfig(rank=p.rank, iterations=p.num_iterations,
                         reg=p.lambda_, implicit=False,
                         block_size=p.block_size, seed=p.seed)

    def training_coo(self, pd: ECommTrainingData):
        """(user_ids, item_ids, (u, i, r)): the latest rating of each
        (user, item) pair (ref: :96-107); unknown ids are dropped."""
        user_ids = BiMap.string_int(pd.users)
        item_ids = BiMap.string_int(pd.items)
        u, i, r = pd.rates.indexed(user_ids, item_ids)
        return user_ids, item_ids, latest_pairs(u, i, r, len(item_ids))

    def train(self, ctx: DeviceContext, pd: ECommTrainingData) -> ECommModel:
        """The latest-rating fold, then ALS on the context's device;
        ``last_train`` holds the host seconds of each stage."""
        t0 = time.perf_counter()
        user_ids, item_ids, (u, i, r) = self.training_coo(pd)
        fold_sec = time.perf_counter() - t0
        if not len(u):
            raise ValueError(
                "ratings cannot be empty — check that events contain valid "
                "user and item IDs")
        trainer = ALSTrainer((u, i, r), len(user_ids), len(item_ids),
                             self.als_config(self.params), device=ctx.device)
        t0 = time.perf_counter()
        factors = trainer.run()
        self.last_train = {"pairs": len(u), "fold_sec": fold_sec,
                           "bin_sec": trainer.bin_sec,
                           "put_sec": trainer.put_sec,
                           "train_sec": time.perf_counter() - t0}
        log.info("%s trained: %s", type(self).__name__, self.last_train)
        rated_users = np.zeros(len(user_ids), dtype=bool)
        rated_items = np.zeros(len(item_ids), dtype=bool)
        rated_users[u] = True
        rated_items[i] = True
        return ECommModel(factors.user_factors, factors.item_factors,
                          user_ids, item_ids, pd.item_categories,
                          rated_users=rated_users,
                          rated_items=rated_items).to(ctx.device)

    # -- serve-time event lookups (ref: lEventsDb.findSingleEntity calls;
    # cached with a bounded TTL, see ECommAlgorithmParams) ----------------
    def _seen_items(self, user: str) -> Set[str]:
        p: ECommAlgorithmParams = self.params
        if not p.unseen_only:
            return set()

        def compute() -> Set[str]:
            try:
                events = store.find_by_entity(
                    p.app_name, "user", user,
                    event_names=list(p.seen_events),
                    target_entity_type="item")
            except StorageError:
                return set()
            return {e.target_entity_id for e in events if e.target_entity_id}

        def put(entry):
            self._seen_cache[user] = entry
            self._seen_cache.move_to_end(user)
            while len(self._seen_cache) > p.seen_cache_size:
                self._seen_cache.popitem(last=False)

        return self._cached(lambda: self._seen_cache.get(user), put, compute)

    def _unavailable_items(self) -> Set[str]:
        """Latest constraint/unavailableItems $set (ref: :195-215)."""
        p: ECommAlgorithmParams = self.params

        def compute() -> Set[str]:
            try:
                events = store.find_by_entity(
                    p.app_name, "constraint", "unavailableItems",
                    event_names=["$set"], limit=1, latest=True)
            except StorageError:
                return set()
            if not events:
                return set()
            items = events[0].properties.get_opt("items")
            return set(items) if items else set()

        def put(entry):
            self._unavail_cache = entry

        return self._cached(lambda: self._unavail_cache, put, compute)

    def _recent_items(self, user: str) -> List[str]:
        """Latest 10 viewed items (ref: predictNewUser :293-322)."""
        p: ECommAlgorithmParams = self.params

        def compute() -> List[str]:
            try:
                events = store.find_by_entity(
                    p.app_name, "user", user, event_names=["view"],
                    target_entity_type="item", limit=10, latest=True)
            except StorageError:
                return []
            return [e.target_entity_id for e in events if e.target_entity_id]

        def put(entry):
            self._recent_cache[user] = entry
            self._recent_cache.move_to_end(user)
            while len(self._recent_cache) > p.seen_cache_size:
                self._recent_cache.popitem(last=False)

        return self._cached(lambda: self._recent_cache.get(user), put,
                            compute)

    def load_persistent_model(self, persisted: ECommModel,
                              ctx: DeviceContext) -> ECommModel:
        return persisted.to(ctx.device)

    def warmup(self, model: ECommModel, ctx: DeviceContext) -> None:
        """Drive both masked scorers at the k buckets 8 and 16 — no
        storage lookups, no side effects."""
        if len(model.item_ids) == 0 or len(model.user_ids) == 0:
            return
        mask = np.ones(len(model.item_ids), dtype=bool)
        normalized = model.normalized()
        for k in (5, 10):
            model.scorer().score_masked(model.user_factors[0], k, mask)
            model.cos_scorer().score_masked(normalized[0], k, mask)

    def predict(self, model: ECommModel,
                query: Dict[str, Any]) -> Dict[str, Any]:
        user = str(query["user"])
        num = int(query.get("num", 10))
        categories = (set(query["categories"]) if query.get("categories")
                      else None)
        white_list = (set(query["whiteList"]) if query.get("whiteList")
                      else None)
        black_list = set(query.get("blackList") or ())

        final_black = (black_list | self._seen_items(user)
                       | self._unavailable_items())
        mask = model.candidate_mask(categories, white_list, final_black)

        row = model.user_ids.get(user)
        if row is not None and not model.rated_users[row]:
            row = None   # indexed but never rated -> new-user path (:225)
        if row is not None:
            if not mask.any():
                return {"itemScores": []}
            scores, idx = model.scorer().score_masked(
                model.user_factors[row], num, mask)
        else:
            # new user: summed cosine vs recently viewed items (:286)
            recent_rows = [model.item_ids[i]
                           for i in self._recent_items(user)
                           if i in model.item_ids]
            if not recent_rows or not mask.any():
                return {"itemScores": []}
            qvec = model.normalized()[recent_rows].sum(axis=0)
            scores, idx = model.cos_scorer().score_masked(qvec, num, mask)

        inv = model.item_ids.inverse()
        return {"itemScores": [
            {"item": inv[int(i)], "score": float(s)}
            for s, i in zip(scores[0], idx[0])
            if s > 0.0]}   # ref keeps score > 0 only (:252)

    def batch_predict(self, model, queries):
        return [(i, self.predict(model, q)) for i, q in queries]
