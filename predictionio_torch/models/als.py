"""ALS matrix factorization as a DASE Algorithm — the serving half.

Counterpart of ``predictionio_tpu/models/als.py``. Behavior contract
from the reference's recommendation template
(examples/scala-parallel-recommendation/custom-serving/src/main/scala/
ALSAlgorithm.scala): model = user/item factor matrices, predict =
top-``num`` item scores for a user (``{"user": "1", "num": 4}`` ->
``{"itemScores": [{"item": ..., "score": ...}]}``), and ``{"item": ...}``
asks for similar items.

The factors stay numpy arrays, as in the JAX package's pickled models;
``ALSAlgorithm.load_persistent_model`` places the serving state on the
deployment's device: the user table as a tensor, and the retrieval
index, whose item table the ``topk_dot`` kernel streams. Pickles drop
every device-side piece. ``enable_sharded_serving`` swaps in the
sharded scorer (``ops.topk.ShardedTopKScorer``: one item slab per rank
of a mesh axis); the model pickles that choice as ``sharded_axis``, and
``load_persistent_model`` re-enables it where the deployment's mesh has
that axis at a size above 1 and clears it otherwise.
``als_model_from_arrays`` builds a model from the factors and
vocabularies of a JAX-trained one (as numpy arrays).

``PreparedRatings`` is the prepared data both factor models train on:
indexed COO ratings, or on the binned lane a deferred read
(``binned_request``) that ``ALSAlgorithm.train`` performs itself as one
fused native scan+bin with its own layout knobs, so no COO exists.
Either way the layout cache (``ops/bincache.py``), keyed by the data
fingerprint, lets a retrain on unchanged events skip the read and the
binning. ALS trains through ``ops/als.py`` on the context's device; the
two-tower model (``models/twotower.py``) trains on the same data.
``ALSAlgorithm.grid_train`` trains the candidates of a ``pio eval``
sweep that differ only in ``lambda_``, ``alpha``, ``num_iterations`` and
``cg_iters`` at once (``ops.als.ALSGridTrainer``).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_torch.core import Algorithm, SanityCheck
from predictionio_torch.core.params import Params
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.obs import memacct, perfacct
from predictionio_torch.ops.als import (ALSConfig, ALSGridTrainer,
                                        ALSTrainer, data_shards,
                                        als_row_cost_slots,
                                        layout_cache_key, load_layout,
                                        save_layout, side_layout_from_binned)
from predictionio_torch.ops.topk import ShardedTopKScorer, TopKScorer
from predictionio_torch.parallel.context import (DeviceContext, DeviceLike,
                                                 resolve_device)
from predictionio_torch.parallel.mesh import axis_size, mesh_size

log = logging.getLogger(__name__)


@dataclass
class PreparedRatings(SanityCheck):
    """Prepared data of the factor models: indexed COO ratings, or on
    the binned lane a deferred ``binned_request``
    (``templates.recommendation.BinnedReadRequest``; the COO fields are
    then None): the layout depends on the algorithm's knobs, so the fit
    stage makes the one native scan+bin call."""

    user_ids: Optional[BiMap] = None         # user id str -> row
    item_ids: Optional[BiMap] = None         # item id str -> row
    user_idx: Optional[np.ndarray] = None    # [nnz] int
    item_idx: Optional[np.ndarray] = None    # [nnz] int
    ratings: Optional[np.ndarray] = None     # [nnz] float32
    #: data + derivation fingerprint from the DataSource (None when the
    #: store has no cheap one): keys the layout cache
    fingerprint: Optional[str] = None
    #: the deferred native read of the binned lane
    binned_request: Optional[Any] = None

    @property
    def n_users(self) -> int:
        return len(self.user_ids)

    @property
    def n_items(self) -> int:
        return len(self.item_ids)

    def sanity_check(self) -> None:
        if self.binned_request is not None:
            return   # the fit stage's native read checks for emptiness
        if self.user_idx is None or len(self.user_idx) == 0:
            raise ValueError("PreparedRatings is empty — no rating events "
                             "found")
        if not len(self.user_idx) == len(self.item_idx) == len(self.ratings):
            raise ValueError("COO arrays length mismatch")


@dataclass
class ALSParams(Params):
    """The JAX package's ALS params, field for field: an engine
    instance trained there stores all of them, and deploy rebuilds them
    by name. The training knobs are ``ops.als.ALSConfig``'s."""

    rank: int = 32
    num_iterations: int = 10
    lambda_: float = 0.1
    implicit_prefs: bool = False
    alpha: float = 1.0
    block_size: int = 4096
    seed: int = 3
    seg_len: object = "auto"
    solver: str = "cg"
    cg_iters: int = 6
    cg_unroll: bool = True    # kept so JAX-trained instances load; unused
    cg_precond: str = "jacobi"
    cg_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    max_ratings_per_user: Optional[int] = None
    max_ratings_per_item: Optional[int] = None
    # retrieval index: backend "auto"/"exact" (PIO_INDEX_BACKEND
    # overrides) and the exact backend's topk_dot flag "auto"/"on"/"off"
    # (PIO_INDEX_KERNEL overrides; read on the CPU only — on a card the
    # kernel always serves)
    index_backend: str = "auto"
    index_kernel: str = "auto"


class ALSModel:
    """Factor matrices + id maps, with device-side serving state. Its
    tables are priced in the device-memory ledger (obs/memacct.py) at
    construction, load (unpickle) and every patch, under
    :attr:`memacct_model`, which the index it builds shares."""

    #: ledger attribution label; TwoTowerModel overrides
    memacct_model = "als"

    def __init__(self, user_factors: np.ndarray, item_factors: np.ndarray,
                 user_ids: BiMap, item_ids: BiMap,
                 index_backend: str = "auto", index_kernel: str = "auto"):
        self.user_factors = np.asarray(user_factors, np.float32)
        self.item_factors = np.asarray(item_factors, np.float32)
        self.user_ids = user_ids
        self.item_ids = item_ids
        self.index_backend = index_backend
        self.index_kernel = index_kernel
        #: the mesh axis the item table is served sharded over (None:
        #: one device); the mesh itself never pickles
        self.sharded_axis: Optional[str] = None
        self._init_device_state()
        self._register_memory()

    def _register_memory(self) -> None:
        """(Re-)price the factor tables and (an estimate of) the id maps
        under this owner; a grown table re-prices itself."""
        memacct.LEDGER.register(
            self, self.memacct_model, "factors",
            int(self.user_factors.nbytes + self.item_factors.nbytes))
        # id maps: a structural estimate (dict slot + key + inverse list
        # entry), attribution rather than malloc truth
        memacct.LEDGER.register(
            self, self.memacct_model, "id_maps",
            (len(self.user_ids) + len(self.item_ids)) * 24)

    def _init_device_state(self) -> None:
        self.device: Optional[torch.device] = None
        self._scorer = None
        self._index = None
        self._user_table: Optional[torch.Tensor] = None
        self._mesh = None
        self._lock = threading.Lock()

    def __getstate__(self):
        d = dict(self.__dict__)
        for key in ("device", "_scorer", "_index", "_user_table", "_mesh",
                    "_lock"):
            d.pop(key, None)  # device state never pickles
        return d

    def __setstate__(self, d):
        d.setdefault("sharded_axis", None)  # pickled before the field
        d.setdefault("index_backend", "auto")
        d.setdefault("index_kernel", "auto")
        self.__dict__.update(d)
        self._init_device_state()
        self._register_memory()

    def to(self, device: DeviceLike) -> "ALSModel":
        """Serve from ``device``: the user table is put there now; the
        index and the scorer are (re)built there on first use."""
        device = resolve_device(device)
        with self._lock:
            self.device = device
            self._scorer = None
            self._index = None
            self._user_table = torch.as_tensor(self.user_factors,
                                               device=device)
        return self

    def _serving_device(self) -> torch.device:
        if self.device is None:
            self.to(None)   # the card, or RuntimeError without CUDA
        return self.device

    def user_rows(self, rows: np.ndarray) -> torch.Tensor:
        """User factor rows ``[len(rows), K]`` gathered on the device."""
        device = self._serving_device()
        with self._lock:
            table = self._user_table
            if table is None:
                table = torch.as_tensor(self.user_factors, device=device)
                self._user_table = table
        return table[torch.as_tensor(np.asarray(rows, np.int64),
                                     device=device)]

    def scorer(self):
        """The batch scorer on the serving device: a ``TopKScorer``, or,
        with sharded serving on, the ``ShardedTopKScorer`` over the
        enabling mesh."""
        device = self._serving_device()
        with self._lock:
            if self._scorer is None:
                if self.sharded_axis is not None and self._mesh is not None:
                    self._scorer = ShardedTopKScorer(
                        self.item_factors, self._mesh, axis=self.sharded_axis,
                        device=device)
                else:
                    self._scorer = TopKScorer(self.item_factors,
                                              device=device)
            return self._scorer

    def enable_sharded_serving(self, mesh, axis: str = "data") -> None:
        """Serve through a ``ShardedTopKScorer``: the item table split
        into slabs over ``mesh[axis]``, each rank's top-k merged over the
        axis (``ops.topk``): serving for a catalog larger than one card.
        The same answers as the single-device scorer. ``recommend`` and
        ``similar_items`` then go through it, and every rank of the axis
        must call them with the same queries."""
        with self._lock:
            self._mesh = mesh
            self.sharded_axis = axis
            self._scorer = None   # made over the mesh on first use

    def retrieval_index(self):
        """The model's retrieval index over the item factor table, on the
        serving device: built lazily (the engine server's warm-up builds
        it at model load), kept fresh by ``upsert_rows``."""
        device = self._serving_device()
        with self._lock:
            if self._index is None:
                from predictionio_torch.index import make_index

                self._index = make_index(self.item_factors,
                                         backend=self.index_backend,
                                         kernel=self.index_kernel,
                                         device=device,
                                         mem_model=self.memacct_model)
            return self._index

    def retrieval_stats(self) -> Optional[dict]:
        """Stats of the built index, or None (a status page never
        triggers a build)."""
        return self._index.stats() if self._index is not None else None

    def upsert_rows(
        self,
        user_rows: Sequence[Tuple[str, np.ndarray]] = (),
        item_rows: Sequence[Tuple[str, np.ndarray]] = (),
    ) -> Tuple[int, int]:
        """Apply a streaming fold-in patch: overwrite (or append) named
        factor rows, copy-on-write — new arrays are built and swapped in
        last, factors before id maps, so a concurrent ``predict`` sees
        old or new tables, never torn rows. Item rows land in the live
        index as an upsert; the device copies of changed tables are
        dropped and re-made on use. Returns (n_new_users, n_new_items)."""
        rank = self.user_factors.shape[1] if self.user_factors.size else (
            self.item_factors.shape[1])
        if item_rows and self.sharded_axis is not None:
            # the slabs live on every rank of the mesh, which a patch on
            # one process cannot reach; quietly serving from one device
            # instead would change capacity. A rolling /reload swaps them
            raise ValueError(
                "item-row patches are not supported on a sharded-serving "
                "model; use the rolling /reload")

        def patched(ids: BiMap, factors: np.ndarray, rows, what: str):
            fresh = [key for key, _ in rows if key not in ids]
            if fresh:
                ids = BiMap.from_vocab(list(ids.keys()) + fresh)
                factors = np.vstack(
                    [factors, np.zeros((len(fresh), rank), np.float32)])
            else:
                factors = factors.copy()
            for key, vec in rows:
                vec = np.asarray(vec, np.float32)
                if vec.shape != (rank,):
                    raise ValueError(
                        f"{what} row {key!r}: expected a length-{rank} "
                        f"vector, got shape {vec.shape}")
                factors[ids[key]] = vec
            return ids, factors, len(fresh)

        new_users = new_items = 0
        if user_rows:
            ids, factors, new_users = patched(self.user_ids, self.user_factors,
                                              user_rows, "user")
            with self._lock:
                self.user_factors = factors
                self._user_table = None
                self.user_ids = ids
        if item_rows:
            ids, factors, new_items = patched(self.item_ids, self.item_factors,
                                              item_rows, "item")
            with self._lock:
                self.item_factors = factors
                self.item_ids = ids
                self._scorer = None
                index = self._index
            if index is not None:
                touched = np.fromiter((ids[iid] for iid, _ in item_rows),
                                      np.int64, count=len(item_rows))
                index.upsert(touched, factors[touched])
        if user_rows or item_rows:
            self._register_memory()
        return new_users, new_items

    def recommend(self, user_id: str, num: int,
                  exclude_items: Sequence[str] = (),
                  candidate_items: Optional[Sequence[str]] = None,
                  ) -> List[Tuple[str, float]]:
        row = self.user_ids.get(user_id)
        if row is None:
            return []
        exclude = {self.item_ids[i] for i in exclude_items if i in self.item_ids}
        if candidate_items is not None:
            # a whitelist scores on the host, as in the JAX package
            cand = np.array(
                sorted({self.item_ids[i] for i in candidate_items
                        if i in self.item_ids} - exclude), dtype=np.int64)
            if len(cand) == 0:
                return []
            scores = self.item_factors[cand] @ self.user_factors[row]
            top_s, top_j = TopKScorer._host_topk(scores[None, :], num)
            inv = self.item_ids.inverse()
            return [(inv[int(cand[j])], float(s))
                    for s, j in zip(top_s[0], top_j[0])]
        excl = np.fromiter(exclude, dtype=np.int32) if exclude else None
        if self.sharded_axis is not None:
            # sharded serving keeps the mesh scorer: no single-device
            # index over a sharded catalog
            scores, idx = self.scorer().score(self.user_rows([row]), num,
                                              excl)
        else:
            scores, idx = self.retrieval_index().search(
                self.user_rows([row]), num, excl)
        inv = self.item_ids.inverse()
        return [(inv[int(i)], float(s))
                for s, i in zip(scores[0], idx[0])
                if s > -1e29 and int(i) >= 0]

    def similar_items(self, item_id: str, num: int,
                      exclude_items: Sequence[str] = (),
                      ) -> List[Tuple[str, float]]:
        """item -> top-``num`` similar items by dot product through the
        retrieval index, the query item excluded."""
        row = self.item_ids.get(item_id)
        if row is None:
            return []
        exclude = {self.item_ids[i] for i in exclude_items
                   if i in self.item_ids} - {row}
        # self-exclusion goes LAST: the index caps exclusion lists at
        # max_exclude keeping the newest (rightmost) entries, so an
        # oversize blacklist may drop itself but never the query item;
        # the result filter below backstops even that
        excl = np.fromiter(list(exclude) + [row], dtype=np.int32,
                           count=len(exclude) + 1)
        if self.sharded_axis is not None:
            scores, idx = self.scorer().score(self.item_factors[row], num,
                                              excl)
        else:
            scores, idx = self.retrieval_index().search(
                self.item_factors[row], num, excl)
        inv = self.item_ids.inverse()
        return [(inv[int(i)], float(s))
                for s, i in zip(scores[0], idx[0])
                if s > -1e29 and int(i) >= 0 and int(i) != row]


def als_model_from_arrays(user_factors: np.ndarray, item_factors: np.ndarray,
                          user_vocab: Sequence[str], item_vocab: Sequence[str],
                          **params) -> ALSModel:
    """An ``ALSModel`` from factor arrays and id vocabularies (row ``j``
    of a table belongs to ``vocab[j]``): how the JAX package's weights,
    as numpy arrays, cross over. ``params`` are ``ALSParams`` fields."""
    p = ALSParams(**params)
    user_factors = np.asarray(user_factors, np.float32)
    item_factors = np.asarray(item_factors, np.float32)
    if user_factors.ndim != 2 or item_factors.ndim != 2 or (
            user_factors.shape[1] != item_factors.shape[1]):
        raise ValueError(f"factor tables {user_factors.shape} and "
                         f"{item_factors.shape} are not [n, rank] of one rank")
    if len(user_vocab) != len(user_factors) or (
            len(item_vocab) != len(item_factors)):
        raise ValueError("each vocabulary must name every row of its table")
    return ALSModel(user_factors, item_factors,
                    BiMap.from_vocab(list(user_vocab)),
                    BiMap.from_vocab(list(item_vocab)),
                    index_backend=p.index_backend,
                    index_kernel=p.index_kernel)


def apply_rows_patch(model: ALSModel, patch: dict) -> bool:
    """``patch`` carries ``userRows`` / ``itemRows`` as ``[[id,
    [floats...]], ...]`` and lands via :meth:`ALSModel.upsert_rows`.
    Malformed rows raise ValueError."""

    def rows(key):
        out = []
        for entry in patch.get(key) or ():
            if (not isinstance(entry, (list, tuple)) or len(entry) != 2
                    or not isinstance(entry[0], str)):
                raise ValueError(f"{key}: each row must be [id, [floats...]]")
            out.append((entry[0], np.asarray(entry[1], np.float32)))
        return out

    model.upsert_rows(user_rows=rows("userRows"), item_rows=rows("itemRows"))
    return True


class ALSAlgorithm(Algorithm):
    """DASE wrapper (ref template: ALSAlgorithm.scala)."""

    def __init__(self, params: ALSParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: PreparedRatings) -> ALSModel:
        """Fit ALS on the context's device: from the deferred binned read
        (``_train_binned``), or from the prepared COO, whose layout the
        cache keeps under ``pd.fingerprint``. ``last_train`` then holds
        the lane taken and its one-time costs in seconds."""
        p: ALSParams = self.params
        cfg = self._config(p)
        if pd.binned_request is not None:
            return self._train_binned(ctx, pd, cfg)
        trainer = ALSTrainer(
            (pd.user_idx, pd.item_idx, pd.ratings), pd.n_users, pd.n_items,
            cfg, device=ctx.device,
            max_ratings_per_user=p.max_ratings_per_user,
            max_ratings_per_item=p.max_ratings_per_item,
            cache_key=pd.fingerprint, mesh=ctx.mesh)
        return self._fit(trainer, "coo", pd.user_ids, pd.item_ids)

    @staticmethod
    def _config(p: ALSParams) -> ALSConfig:
        return ALSConfig(rank=p.rank, iterations=p.num_iterations,
                         reg=p.lambda_, implicit=p.implicit_prefs,
                         alpha=p.alpha, block_size=p.block_size, seed=p.seed,
                         seg_len=p.seg_len, solver=p.solver,
                         cg_iters=p.cg_iters, cg_precond=p.cg_precond,
                         cg_dtype=p.cg_dtype, compute_dtype=p.compute_dtype)

    #: the params grid candidates may differ in
    GRID_SCALARS = ("lambda_", "alpha", "num_iterations", "cg_iters")

    @classmethod
    def grid_train(cls, ctx: DeviceContext, pd: PreparedRatings,
                   params_list: Sequence[ALSParams]
                   ) -> Optional[List[ALSModel]]:
        """Train every candidate at once when they differ only in
        ``GRID_SCALARS`` (iteration counts and CG steps ride as
        per-candidate budgets: the grid runs to the largest and freezes
        a candidate once its budget is spent), on the context's device
        (``ops.als.ALSGridTrainer``); the tuning path behind
        MetricEvaluator (ref role: MetricEvaluator over engineParamsList,
        MetricEvaluator.scala:177, which trains each candidate).

        Returns one model per candidate, or None where the grid does not
        apply: fewer than 2 candidates, the binned lane (no COO to build
        the grid's layout from; sequential trains share the cached
        layout instead), per-row rating caps (the grid's sides are
        uncapped, and a grid must not train other data than the
        sequential path), params that differ in anything else, or a
        context mesh of more than one rank (the grid axis takes the
        batch dimension, and the grid trainer runs on one device), as in
        the JAX package."""
        if len(params_list) < 2 or pd.binned_request is not None:
            return None
        if mesh_size(ctx.mesh) > 1:
            return None
        base = params_list[0]
        for p in params_list:
            if not isinstance(p, ALSParams):
                return None
            a, b = dict(vars(p)), dict(vars(base))
            for k in cls.GRID_SCALARS:
                a.pop(k), b.pop(k)
            if a != b:
                return None
        if (base.max_ratings_per_user is not None
                or base.max_ratings_per_item is not None):
            return None
        t0 = time.perf_counter()
        trainer = ALSGridTrainer(
            (pd.user_idx, pd.item_idx, pd.ratings), pd.n_users, pd.n_items,
            cls._config(base), regs=[p.lambda_ for p in params_list],
            alphas=[p.alpha for p in params_list],
            iterations=[p.num_iterations for p in params_list],
            cg_iters=[p.cg_iters for p in params_list], device=ctx.device)
        t1 = time.perf_counter()
        factors = trainer.run()
        log.info("ALS grid of %d candidates trained: %s", len(params_list),
                 {"bin_sec": trainer.bin_sec, "put_sec": trainer.put_sec,
                  "setup_sec": t1 - t0,
                  "train_sec": time.perf_counter() - t1})
        return [ALSModel(f.user_factors, f.item_factors, pd.user_ids,
                         pd.item_ids, index_backend=base.index_backend,
                         index_kernel=base.index_kernel).to(trainer.device)
                for f in factors]

    def _train_binned(self, ctx: DeviceContext, pd: PreparedRatings,
                      cfg: ALSConfig) -> ALSModel:
        """The zero-copy lane. A cache hit loads both sides and their
        vocabularies as views over the entry's file; otherwise one fused
        native scan+bin (``req.bin``: no COO, no Event objects) builds
        them, and they are saved with the vocabularies so the next
        retrain on unchanged events skips the read. Either way the sides
        go to ``ALSTrainer.from_sides``."""
        p: ALSParams = self.params
        n_shards = data_shards(ctx.mesh)
        key = None
        if pd.fingerprint:
            # the COO lane's derivation: either lane's entry serves both
            key = layout_cache_key(pd.fingerprint, cfg, n_shards,
                                   p.max_ratings_per_user,
                                   p.max_ratings_per_item)
            cached = load_layout(key)
            # an entry the COO lane saved has no vocabularies: bin
            # again below and overwrite it
            if cached is not None and cached.vocabs is not None:
                trainer = ALSTrainer.from_cache(cached, cfg,
                                                device=ctx.device,
                                                mesh=ctx.mesh)
                return self._fit(trainer, "binned",
                                 BiMap.from_vocab(cached.vocabs[0]),
                                 BiMap.from_vocab(cached.vocabs[1]))
        binned = pd.binned_request.bin(
            seg_len=cfg.seg_len, max_len_user=p.max_ratings_per_user,
            max_len_item=p.max_ratings_per_item, n_shards=n_shards,
            block_size=cfg.block_size,
            row_cost_slots=als_row_cost_slots(cfg.rank))
        if binned.n_rows == 0:
            raise ValueError(
                "PreparedRatings is empty — no rating events found")
        user_side = side_layout_from_binned(binned.user_side)
        item_side = side_layout_from_binned(binned.item_side)
        users, items = binned.entity_vocab, binned.target_vocab
        if key is not None:
            save_layout(key, user_side, item_side, len(users), len(items),
                        binned.n_rows, vocabs=(users, items))
        trainer = ALSTrainer.from_sides(user_side, item_side, len(users),
                                        len(items), binned.n_rows, cfg,
                                        device=ctx.device, mesh=ctx.mesh)
        # the native bytes are on the device now; release them
        del user_side, item_side
        scan = {"scan_sec": binned.scan_sec, "native_bin_sec": binned.bin_sec}
        # data-path ledger: the native call's scan and fill shares
        perfacct.LEDGER.note_stage("read", binned.scan_sec)
        perfacct.LEDGER.note_stage("bin", binned.bin_sec)
        del binned
        return self._fit(trainer, "binned", BiMap.from_vocab(users),
                         BiMap.from_vocab(items), **scan)

    def _fit(self, trainer: ALSTrainer, lane: str, user_ids: BiMap,
             item_ids: BiMap, **costs) -> ALSModel:
        p: ALSParams = self.params
        t0 = time.perf_counter()
        factors = trainer.run()
        self.last_train = {
            "lane": lane, "cache_hit": trainer.cache_hit,
            "ratings": trainer.total_entries, **costs,
            "bin_sec": trainer.bin_sec, "load_sec": trainer.load_sec,
            "put_sec": trainer.put_sec,
            "train_sec": time.perf_counter() - t0}
        log.info("ALS trained on the %s lane: %s", lane, self.last_train)
        # the model serves from the device it trained on (Engine.eval
        # scores it there) until a deploy moves it
        return ALSModel(factors.user_factors, factors.item_factors,
                        user_ids, item_ids, index_backend=p.index_backend,
                        index_kernel=p.index_kernel).to(trainer.device)

    def apply_patch(self, model: ALSModel, patch: dict) -> bool:
        return apply_rows_patch(model, patch)

    def load_persistent_model(self, persisted: ALSModel,
                              ctx: DeviceContext) -> ALSModel:
        """Put the serving tables on the deployment's device, and
        re-enable sharded serving when the model was served sharded and
        the context's mesh (``ctx.require_mesh()``) has that axis at a
        size above 1; otherwise clear it (a deployment on one device)."""
        model = persisted.to(ctx.device)
        axis = model.sharded_axis
        if axis is not None:
            mesh = ctx.require_mesh()
            if axis_size(mesh, axis) > 1:
                model.enable_sharded_serving(mesh, axis=axis)
            else:
                model.sharded_axis = None
        return model

    def warmup(self, model: ALSModel, ctx: DeviceContext) -> None:
        """Drive every shape bucket the server dispatches before the
        deployment goes live: the scorer at B in 1..64 (the micro-batch
        path) and k buckets 8 and 16, then the index (built here, which
        also builds and loads the kernel) at B 1 and 8 and the item
        query's one self-exclusion."""
        if len(model.user_ids) == 0 or len(model.item_ids) == 0:
            return
        for b in (1, 2, 4, 8, 16, 32, 64):
            rows = model.user_rows(np.arange(b) % len(model.user_ids))
            for k in (5, 10):
                model.scorer().score(rows, k)
        index = model.retrieval_index()
        for b in (1, 8):
            rows = model.user_rows(np.arange(b) % len(model.user_ids))
            for k in (5, 10):
                index.search(rows, k)
        index.search(model.item_factors[:1], min(10, len(model.item_ids)),
                     exclude=np.array([[0]], np.int32))

    def predict(self, model: ALSModel, query: Dict[str, Any]) -> Dict[str, Any]:
        num = int(query.get("num", 10))
        if "user" not in query and "item" in query:
            sims = model.similar_items(str(query["item"]), num,
                                       exclude_items=query.get("blacklist") or ())
            return {"itemScores": [{"item": i, "score": s} for i, s in sims]}
        recs = model.recommend(str(query["user"]), num,
                               exclude_items=query.get("blacklist") or (),
                               candidate_items=query.get("whitelist"))
        return {"itemScores": [{"item": i, "score": s} for i, s in recs]}

    def batch_predict(self, model: ALSModel, queries):
        """Known users scored as one batched product + top-k through the
        scorer; unknown users get empty results. As in the JAX package,
        this path ignores ``blacklist``/``whitelist`` and raises
        KeyError on item-only queries (ROADMAP.md §3)."""
        known = [(i, q) for i, q in queries if str(q["user"]) in model.user_ids]
        unknown = [(i, q) for i, q in queries
                   if str(q["user"]) not in model.user_ids]
        out = [(i, {"itemScores": []}) for i, q in unknown]
        if known:
            rows = np.array([model.user_ids[str(q["user"])] for _, q in known],
                            dtype=np.int64)
            num = max(int(q.get("num", 10)) for _, q in known)
            scores, idx = model.scorer().score(model.user_rows(rows), num)
            inv = model.item_ids.inverse()
            for (qi, q), s_row, i_row in zip(known, scores, idx):
                n = int(q.get("num", 10))
                out.append((qi, {"itemScores": [
                    {"item": inv[int(i)], "score": float(s)}
                    for s, i in zip(s_row[:n], i_row[:n])]}))
        return out
