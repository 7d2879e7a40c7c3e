"""Similar-product algorithms: item-to-item similarity over ALS factors.

Counterpart of ``predictionio_tpu/models/similarproduct.py``. Behavior
contract from the reference similarproduct template
(examples/scala-parallel-similarproduct/multi/src/main/scala/
ALSAlgorithm.scala + LikeAlgorithm.scala):

  - ``SimilarProductAlgorithm.train`` indexes users/items, aggregates
    duplicate (user, item) view events into counts, trains *implicit*
    ALS, keeps the item ("product") factors + item metadata (:74-144).
  - ``LikeAlgorithm.train`` does the same over like/dislike events with
    rating +1 / -1, the latest event of a pair winning
    (LikeAlgorithm.scala:27-99).
  - ``predict``: look up the query items' factor vectors, score every
    item by the SUM of cosine similarities to the query vectors, drop
    the query items themselves, apply whiteList/blackList/categories
    candidate predicates, return top-``num`` with score > 0 (:146-207,
    239-263).

With row-normalized factors F, sum_q cos(f_q, f_i) = (sum_q F[q]) . F[i],
so a query is one vector sum plus one top-k by dot product. An
exclusion-only query (no whitelist or category predicate) is candidate
generation: it goes through the model's retrieval index
(``index.make_index`` -> ``ExactIndex``, the ``topk_dot`` kernel on a
card). A whitelist or category query scores through the masked
``TopKScorer`` on the same device. The training folds are numpy over
dict-encoded rows (``models/_interactions.py``), and ALS trains on the
context's device (``ops/als.py``).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from predictionio_torch.core import Algorithm, SanityCheck
from predictionio_torch.core.params import Params
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.models._interactions import (Interactions,
                                                     count_pairs,
                                                     latest_pairs)
from predictionio_torch.ops.als import ALSConfig, ALSTrainer
from predictionio_torch.ops.topk import TopKScorer, cosine_normalize
from predictionio_torch.parallel.context import (DeviceContext, DeviceLike,
                                                 resolve_device)

log = logging.getLogger(__name__)


@dataclass
class SimilarProductData(SanityCheck):
    """TD/PD: users, items (with optional categories), the view rows and
    the like/dislike rows (value +1 / -1, in event-time order)."""

    users: List[str] = field(default_factory=list)
    items: List[str] = field(default_factory=list)
    item_categories: Dict[str, List[str]] = field(default_factory=dict)
    views: Interactions = field(
        default_factory=lambda: Interactions.from_rows([]))
    likes: Interactions = field(
        default_factory=lambda: Interactions.from_rows([]))

    @property
    def view_events(self) -> List[Tuple[str, str]]:
        """The JAX package's form: (user, item) view pairs."""
        return self.views.rows()

    @property
    def like_events(self) -> List[Tuple[str, str, bool]]:
        """The JAX package's form: (user, item, like?) triples."""
        return [(u, i, v > 0) for u, i, v in self.likes.rows()]

    def sanity_check(self) -> None:
        if not self.users:
            raise ValueError("users cannot be empty")
        if not self.items:
            raise ValueError("items cannot be empty")
        if not len(self.views) and not len(self.likes):
            raise ValueError("no view/like events found")


@dataclass
class SimilarProductParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lambda_: float = 0.01
    seed: int = 3
    block_size: int = 4096


class SimilarProductModel:
    """Row-normalized item factors + item metadata; the serving state
    (retrieval index, masked scorer) lives on the model's device."""

    def __init__(self, item_factors: np.ndarray, item_ids: BiMap,
                 item_categories: Dict[str, List[str]]):
        self.item_factors = np.asarray(item_factors, dtype=np.float32)
        self.item_ids = item_ids
        self.item_categories = item_categories
        self._normalized = cosine_normalize(self.item_factors)
        self._init_device_state()

    def _init_device_state(self) -> None:
        self.device: Optional[torch.device] = None
        self._scorer: Optional[TopKScorer] = None
        self._index = None
        self._category_index: Optional[Dict[str, np.ndarray]] = None
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        for key in ("device", "_scorer", "_index", "_category_index",
                    "_lock"):
            d.pop(key, None)   # device state never pickles
        return d

    def __setstate__(self, d):
        # a JAX-trained pickle carries its serving slots as None
        self.__dict__.update(d)
        self._init_device_state()

    def to(self, device: DeviceLike) -> "SimilarProductModel":
        """Serve from ``device``: the index and the scorer are (re)built
        there on first use."""
        device = resolve_device(device)
        with self._lock:
            self.device = device
            self._scorer = None
            self._index = None
        return self

    def _serving_device(self) -> torch.device:
        if self.device is None:
            self.to(None)   # the card, or RuntimeError without CUDA
        return self.device

    def scorer(self) -> TopKScorer:
        device = self._serving_device()
        with self._lock:
            if self._scorer is None:
                self._scorer = TopKScorer(self._normalized, device=device)
            return self._scorer

    def retrieval_index(self):
        """The retrieval index over the row-normalized item table (dot
        == cosine here), on the serving device: the exclusion-only
        queries go through it; whitelist/category predicates keep the
        masked scorer (a mask is not an index surface)."""
        device = self._serving_device()
        with self._lock:
            if self._index is None:
                from predictionio_torch.index import make_index

                self._index = make_index(self._normalized, device=device)
            return self._index

    def retrieval_stats(self) -> Optional[dict]:
        return self._index.stats() if self._index is not None else None

    def _category_mask(self, categories: Set[str]) -> np.ndarray:
        """[I] bool — items sharing >=1 category with the query. Items
        without categories are discarded when a category filter is given
        (ref: isCandidateItem .getOrElse(false))."""
        if self._category_index is None:
            per_cat: Dict[str, List[int]] = {}
            for item, cats in self.item_categories.items():
                row = self.item_ids.get(item)
                if row is None:
                    continue
                for c in cats:
                    per_cat.setdefault(c, []).append(row)
            n = len(self.item_ids)
            idx: Dict[str, np.ndarray] = {}
            for c, rows in per_cat.items():
                m = np.zeros(n, dtype=bool)
                m[rows] = True
                idx[c] = m
            self._category_index = idx
        mask = np.zeros(len(self.item_ids), dtype=bool)
        for c in categories:
            m = self._category_index.get(c)
            if m is not None:
                mask |= m
        return mask

    def similar(self, items: Sequence[str], num: int,
                categories: Optional[Set[str]] = None,
                white_list: Optional[Set[str]] = None,
                black_list: Optional[Set[str]] = None,
                ) -> List[Tuple[str, float]]:
        """Top-num items by summed cosine similarity to ``items``."""
        query_rows = [self.item_ids[i] for i in items if i in self.item_ids]
        if not query_rows:
            return []
        qvec = self._normalized[query_rows].sum(axis=0)
        inv = self.item_ids.inverse()

        if white_list is None and not categories:
            excl_rows = set(query_rows)
            if black_list:
                excl_rows |= {self.item_ids[i] for i in black_list
                              if i in self.item_ids}
            index = self.retrieval_index()
            if len(excl_rows) <= getattr(index, "max_exclude", 64):
                scores, idx = index.search(
                    qvec, num,
                    np.fromiter(excl_rows, np.int32, count=len(excl_rows)))
                return [(inv[int(i)], float(s))
                        for s, i in zip(scores[0], idx[0])
                        if s > 0.0 and int(i) >= 0]   # ref: score > 0 (:174)

        n = len(self.item_ids)
        mask = np.ones(n, dtype=bool)
        mask[query_rows] = False                     # discard query items
        if white_list is not None:
            wl = np.zeros(n, dtype=bool)
            wl[[self.item_ids[i] for i in white_list
                if i in self.item_ids]] = True
            mask &= wl
        if black_list:
            mask[[self.item_ids[i] for i in black_list
                  if i in self.item_ids]] = False
        if categories:
            mask &= self._category_mask(set(categories))
        if not mask.any():
            return []
        scores, idx = self.scorer().score_masked(qvec, num, mask)
        return [(inv[int(i)], float(s))
                for s, i in zip(scores[0], idx[0])
                if s > 0.0]   # ref keeps score > 0 only (:174)


class SimilarProductAlgorithm(Algorithm):
    """Implicit ALS over view counts (ref: ALSAlgorithm.scala:69)."""

    def __init__(self, params: SimilarProductParams):
        super().__init__(params)

    @staticmethod
    def als_config(p: SimilarProductParams) -> ALSConfig:
        return ALSConfig(rank=p.rank, iterations=p.num_iterations,
                         reg=p.lambda_, implicit=True, alpha=1.0,
                         block_size=p.block_size, seed=p.seed)

    def _pairs(self, pd: SimilarProductData, user_ids: BiMap,
               item_ids: BiMap):
        """(user rows, item rows, value) of each distinct pair: its view
        count."""
        u, i, _ = pd.views.indexed(user_ids, item_ids)
        return count_pairs(u, i, len(item_ids))

    def training_coo(self, pd: SimilarProductData):
        """(user_ids, item_ids, (u, i, r)): the id maps and the COO the
        trainer fits."""
        user_ids = BiMap.string_int(pd.users)
        item_ids = BiMap.string_int(pd.items)
        return user_ids, item_ids, self._pairs(pd, user_ids, item_ids)

    def train(self, ctx: DeviceContext, pd: SimilarProductData
              ) -> SimilarProductModel:
        """Fold the rows into pairs, then ALS on the context's device;
        ``last_train`` holds the host seconds of each stage."""
        t0 = time.perf_counter()
        user_ids, item_ids, coo = self.training_coo(pd)
        fold_sec = time.perf_counter() - t0
        if not len(coo[0]):
            raise ValueError(
                "ratings cannot be empty — check that events contain valid "
                "user and item IDs")
        trainer = ALSTrainer(coo, len(user_ids), len(item_ids),
                             self.als_config(self.params), device=ctx.device)
        t0 = time.perf_counter()
        factors = trainer.run()
        self.last_train = {"pairs": len(coo[0]), "fold_sec": fold_sec,
                           "bin_sec": trainer.bin_sec,
                           "put_sec": trainer.put_sec,
                           "train_sec": time.perf_counter() - t0}
        log.info("%s trained: %s", type(self).__name__, self.last_train)
        return SimilarProductModel(factors.item_factors, item_ids,
                                   pd.item_categories).to(ctx.device)

    def load_persistent_model(self, persisted: SimilarProductModel,
                              ctx: DeviceContext) -> SimilarProductModel:
        return persisted.to(ctx.device)

    def warmup(self, model: SimilarProductModel, ctx: DeviceContext) -> None:
        """Drive the serve path before the deployment goes live: the
        exclusion-only call builds the retrieval index (and loads the
        kernel), the category call warms the masked scorer."""
        first = next(iter(model.item_ids.keys()), None)
        if first is None:
            return
        for num in (5, 10):
            model.similar([first], num)
        cats = next(iter(model.item_categories.values()), None)
        if cats:
            model.similar([first], 10, categories=set(cats[:1]))

    def predict(self, model: SimilarProductModel,
                query: Dict[str, Any]) -> Dict[str, Any]:
        recs = model.similar(
            [str(i) for i in query["items"]],
            int(query.get("num", 10)),
            categories=(set(query["categories"])
                        if query.get("categories") else None),
            white_list=(set(query["whiteList"])
                        if query.get("whiteList") else None),
            black_list=(set(query["blackList"])
                        if query.get("blackList") else None))
        return {"itemScores": [{"item": i, "score": s} for i, s in recs]}

    def batch_predict(self, model, queries):
        return [(i, self.predict(model, q)) for i, q in queries]


class LikeAlgorithm(SimilarProductAlgorithm):
    """The same ALS over like/dislike = +1/-1 (ref: LikeAlgorithm.scala:27);
    duplicate (user, item) pairs keep the LATEST event's polarity."""

    def _pairs(self, pd: SimilarProductData, user_ids: BiMap,
               item_ids: BiMap):
        u, i, v = pd.likes.indexed(user_ids, item_ids)
        return latest_pairs(u, i, v, len(item_ids))
