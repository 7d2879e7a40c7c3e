"""Streaming events -> model: the delta tailer and fold-in updates.

Counterpart of ``predictionio_tpu/workflow/stream.py``. A deployed ALS
or two-tower engine takes new events into its answers without a
retrain:

  tail     ``EventStore.find_columnar_since(cursor)`` (the native
           sequence-offset columnar read, ``native/eventlog.cpp``)
           returns exactly the rows appended since the last fold,
           dict-encoded, in arrival order: no re-scan of the log, no
           re-binning.
  fold     ALS: per-touched-user/item fold-in solves against the fixed
           opposite factor (``ops.als.fold_in_solve``, one exact
           half-step per touched group). Two-tower: a few online SGD
           steps on the delta (``ops.twotower.online_delta_step``).
           Both compute on the updater's device (the card unless the
           caller asks for the CPU).
  publish  the updated rows go to live engine servers through the
           model-patch lane (``EngineServer.apply_patch`` in process,
           ``POST /model/patch`` over HTTP), applied between queries
           under the deployment lock; ``GET /reload`` stays the lane of
           full retrains.

Drive it with ``pio stream`` (one cycle with ``--once``, or a daemon
polling every ``PIO_STREAM_INTERVAL_SEC``), or embed a
:class:`StreamUpdater`.

What fold-in is and is not:

  - a NEW user/item's fold-in factor is the exact conditional ALS
    optimum given the fixed opposite factors (the textbook fold-in);
  - an EXISTING group re-solves over its FULL history (fetched once per
    group by a targeted columnar scan, then kept in a bounded history
    cache that later deltas extend), so the result matches a half-step
    of the full train, not a drifted approximation;
  - existing items with more than ``PIO_STREAM_MAX_GROUP`` rows are
    SKIPPED (their factor moves negligibly per event and re-solving
    them re-reads the world); a user's history is truncated to its
    newest rows instead; both are counted (``groups_skipped``);
  - a rebased cursor (compaction renumbered records, or a crash
    truncated appends) means the delta cannot be trusted: the fold is
    skipped, the cursor resets to the tail, and a full retrain owns
    what was missed.

Every ``PIO_STREAM_RECALL_EVERY`` applied folds the updater measures
recall@k of its PATCHED retrieval index against brute force over the
current factor tables (``probe_recall``).

Observability, as in the JAX updater: the ``pio_stream_*`` counters
and gauges (folds by outcome, folded events, the last fold's seconds,
patch failures, skipped groups by reason, the probe's recall and its
breaches), ``journal`` events (``resync``, ``fold`` by outcome), the
freshness horizon (``perfacct.LEDGER.note_train_read`` at a delta
read's start, ``note_publish`` after a published fold, withheld while a
truncated or rebased delta leaves staleness debt that only a newly
bound instance clears), a fresh trace per cycle and its headers on the
HTTP patch lane. The counters are process-wide; the updater also keeps
its own counts as attributes (``folds``, ``fold_events``,
``groups_skipped``, ``patch_failures``, ``index_recall``,
``recall_breaches``, ``last_fold_seconds``). The delta tail refreshes
the data plane's entity sketches (``dataobs.observe_tail``), and
``run_forever`` holds the continuous profiler while it runs.

Every ``PIO_QUALITY_EVERY`` applied folds the updater scores each live
model against its shadow, a snapshot of the last full-retrain
COMPLETED instance taken at bind time before any fold
(``probe_quality``; ``obs/quality.py`` computes the report, and on a
card the live top-k goes through ``topk_dot``). The worst case across
algorithms feeds the ``pio_model_quality_*`` gauges and is pushed to
each ``patch_urls`` target's ``/admin/quality``. A breach of the
``PIO_QUALITY_DRIFT_BAND`` fires the reload lane once per bound
instance (``reload_trigger``, else ``GET /reload`` on each of
``reload_urls``: ``pio stream --reload-url``), journals
``drift_breach`` and ``auto_reload``, and resyncs the updater.

Config (env), the JAX package's names and defaults:
  PIO_STREAM_INTERVAL_SEC   daemon poll cadence (1.0)
  PIO_STREAM_MAX_GROUP      max history rows re-solved per group (8192)
  PIO_STREAM_HISTORY_CACHE  groups kept in the history cache (100000)
  PIO_STREAM_MAX_DELTA      max delta rows folded per cycle (200000)
  PIO_STREAM_TT_LR          two-tower online step size (0.05)
  PIO_STREAM_TT_STEPS       two-tower SGD steps per fold (4)
  PIO_STREAM_PATCH_TIMEOUT  per-target HTTP patch timeout sec (10)
  PIO_STREAM_RECALL_EVERY   applied folds between recall probes (20)
  PIO_STREAM_RECALL_FLOOR   breach threshold for the probe (0.95)
  PIO_STREAM_RECALL_SAMPLE  probe query sample size (16)
  PIO_STREAM_RECALL_K       probe k (10)
  PIO_QUALITY_EVERY         applied folds between quality probes (20)
  PIO_QUALITY_DRIFT_BAND    the drift band a probe breaches (obs/quality.py)
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.data.store import resolve_app
from predictionio_torch.index.recall import recall_at_k
from predictionio_torch.models.als import ALSAlgorithm
from predictionio_torch.models.twotower import TwoTowerAlgorithm
from predictionio_torch.obs import (contprof, dataobs, journal, metrics,
                                    perfacct, quality, trace)
from predictionio_torch.ops.als import ALSConfig, fold_in_solve
from predictionio_torch.ops.twotower import online_delta_step
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.workflow.deploy import prepare_deploy

log = logging.getLogger(__name__)

_FOLDS = metrics.counter(
    "pio_stream_folds_total",
    "Streaming fold cycles by outcome (ok / empty / rebased / "
    "patch_failed)",
    ("result",),
)
_FOLD_EVENTS = metrics.counter(
    "pio_stream_fold_events_total",
    "Delta events folded into the live model without a full retrain",
)
_FOLD_SECONDS = metrics.gauge(
    "pio_stream_fold_seconds",
    "Wall seconds of the last fold cycle (delta read + solves + patch)",
)
_PATCH_FAILURES = metrics.counter(
    "pio_stream_patch_failures_total",
    "Model-patch deliveries that failed (per target per cycle)",
)
_GROUPS_SKIPPED = metrics.counter(
    "pio_stream_groups_skipped_total",
    "Touched groups not re-solved, by reason (oversize = history "
    "beyond PIO_STREAM_MAX_GROUP; truncated = user history capped to "
    "the newest rows)",
    ("reason",),
)
_INDEX_RECALL = metrics.gauge(
    "pio_stream_index_recall",
    "Last measured recall@k of the patched retrieval index vs brute "
    "force over the current factors (worst across fold-capable "
    "algorithms)",
)
_RECALL_BREACHES = metrics.counter(
    "pio_stream_recall_breaches_total",
    "Recall probes that landed below PIO_STREAM_RECALL_FLOOR",
)


class StreamUnsupported(RuntimeError):
    """The deployed engine or storage backend cannot stream: no
    sequence-offset delta reads, or no fold-capable algorithm."""


def _max_group() -> int:
    return metrics.env_int("PIO_STREAM_MAX_GROUP", 8192)


def _history_cache_cap() -> int:
    return metrics.env_int("PIO_STREAM_HISTORY_CACHE", 100_000)


def _buy_code(cols, ds) -> int:
    """Dict-code of the buy event in this columnar block (-1: absent)."""
    return (cols.names.index(ds.buy_event)
            if ds.buy_event in cols.names else -1)


def _decode_value(cols, k: int, buy_code: int, buy_rating: float) -> float:
    """One event's rating value: buy events carry the configured
    implicit rating; a NaN rating property decodes to 0.0 (the rules of
    the template's batch read). Shared by the delta tail and the
    targeted history scans, so the two lanes never disagree about the
    same event."""
    if int(cols.name_codes[k]) == buy_code:
        return buy_rating
    v = float(cols.values[k])
    if v != v:
        return 0.0
    return v


class _HistoryCache:
    """Bounded per-group rating history: ``("u"|"i", id) -> (ids,
    values)`` parallel lists. Filled once per group by a targeted
    columnar scan; later deltas EXTEND cached entries (the fetch at fill
    time already includes the delta that triggered it, so the two paths
    never double-count)."""

    def __init__(self, cap: int):
        self._cap = cap
        self._d: "collections.OrderedDict[Tuple[str, str], Tuple[List[str], List[float]]]" = (
            collections.OrderedDict())

    def get(self, key):
        got = self._d.get(key)
        if got is not None:
            self._d.move_to_end(key)
        return got

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self._cap:
            self._d.popitem(last=False)

    def __contains__(self, key) -> bool:
        return key in self._d


class ALSFoldIn:
    """Per-touched-group ALS fold-in against the fixed opposite factor.

    Owns the updater's LOCAL authoritative model copy (an
    :class:`~predictionio_torch.models.als.ALSModel`); each ``fold``
    solves users -> items -> users (the final user pass sees freshly
    solved new-item factors) on ``device`` and applies the rows in
    place, returning the patch block for the serving side.
    ``groups_skipped`` is the updater's count of groups not re-solved,
    by reason."""

    def __init__(self, index: int, params, model, events, app_id: int,
                 channel_id: Optional[int], ds_params, device,
                 groups_skipped: Dict[str, int]):
        self.index = index
        self.model = model
        self.device = device
        self._events = events
        self._app_id = app_id
        self._channel_id = channel_id
        self._ds = ds_params
        self._skipped = groups_skipped
        self._hist = _HistoryCache(_history_cache_cap())
        solver = getattr(params, "solver", "cg")
        self.cfg = ALSConfig(
            rank=int(params.rank),
            reg=float(params.lambda_),
            implicit=bool(getattr(params, "implicit_prefs", False)),
            alpha=float(getattr(params, "alpha", 1.0)),
            solver=solver if solver in ("cg", "direct") else "cg",
            cg_iters=int(getattr(params, "cg_iters", 6)),
        )

    # -- history -------------------------------------------------------------
    def _fetch_history(self, side: str, gid: str) -> Tuple[List[str], List[float]]:
        """One targeted columnar scan for a group's complete rating
        history (includes any rows already appended this cycle)."""
        ds = self._ds
        filters: Dict[str, Any] = {
            "entity_type": ds.entity_type,
            "event_names": [ds.rate_event, ds.buy_event],
            "target_entity_type": ds.target_entity_type,
        }
        if side == "u":
            filters["entity_id"] = gid
        else:
            filters["target_entity_id"] = gid
        cols = self._events.find_columnar(
            self._app_id, self._channel_id,
            value_property=ds.value_property, time_ordered=False, **filters)
        ids: List[str] = []
        vals: List[float] = []
        buy_code = _buy_code(cols, ds)
        for k in range(len(cols)):
            tc = int(cols.target_codes[k])
            if tc < 0:
                continue
            other = (cols.target_vocab[tc] if side == "u"
                     else cols.entity_vocab[int(cols.entity_codes[k])])
            ids.append(other)
            vals.append(_decode_value(cols, k, buy_code,
                                      float(ds.buy_rating)))
        return ids, vals

    def invalidate_history(self) -> None:
        """Drop every cached group history. Required whenever delta rows
        were DROPPED without folding (a truncated backlog, or a fold
        that failed mid-way): cached entries extended past that gap
        would re-solve groups against incomplete histories; the next
        touch re-fetches the full history from the log."""
        self._hist = _HistoryCache(_history_cache_cap())

    def _group_rows(self, side: str, gid: str,
                    delta: List[Tuple[str, float]],
                    known_new: bool = False) -> Tuple[List[str], List[float]]:
        """The group's full history AFTER this delta (cache-extend, or
        one targeted fetch, which already includes the delta rows: they
        were appended to the log before the tailer read them). Called at
        most once per (side, gid) per fold, so cached lists are extended
        exactly once per delta.

        ``known_new`` (group absent from the model vocab): the delta IS
        the history, with no targeted scan. Pre-cursor events of such a
        group sit in the blind window between the trained instance's
        read and the stream bind, which the cursor contract assigns to
        a full retrain."""
        key = (side, gid)
        cached = self._hist.get(key)
        if cached is not None:
            ids, vals = cached
            for other, v in delta:
                ids.append(other)
                vals.append(v)
            return ids, vals
        if known_new:
            ids = [other for other, _ in delta]
            vals = [v for _, v in delta]
        else:
            ids, vals = self._fetch_history(side, gid)
        self._hist.put(key, (ids, vals))
        return ids, vals

    # -- the fold ------------------------------------------------------------
    def fold(self, users: List[str], items: List[str],
             ratings: np.ndarray) -> Optional[dict]:
        if not users:
            return None
        model = self.model
        cap = _max_group()
        delta_by_user: Dict[str, List[Tuple[str, float]]] = {}
        delta_by_item: Dict[str, List[Tuple[str, float]]] = {}
        for u, i, r in zip(users, items, ratings):
            delta_by_user.setdefault(u, []).append((i, float(r)))
            delta_by_item.setdefault(i, []).append((u, float(r)))

        # vocab extension FIRST: every touched new id gets a zero row so
        # index maps are stable for all three solve passes below (the
        # zero factors are transient: the patch publishes only after the
        # passes complete)
        new_users = [u for u in delta_by_user if u not in model.user_ids]
        new_items = [i for i in delta_by_item if i not in model.item_ids]
        rank = self.cfg.rank
        if new_users or new_items:
            zero = np.zeros(rank, np.float32)
            model.upsert_rows(
                user_rows=[(u, zero) for u in new_users],
                item_rows=[(i, zero) for i in new_items])
        new_user_set = set(new_users)
        new_item_set = set(new_items)

        # each touched group's post-delta history, EXACTLY once per fold
        # (the user side solves twice below; re-reading the
        # cache-extending _group_rows there would double-append)
        hist_u = {gid: self._group_rows("u", gid, delta,
                                        known_new=gid in new_user_set)
                  for gid, delta in delta_by_user.items()}
        hist_i = {gid: self._group_rows("i", gid, delta,
                                        known_new=gid in new_item_set)
                  for gid, delta in delta_by_item.items()}

        def solve_side(side: str, hist: Dict[str, Tuple[List[str], List[float]]],
                       new_set: set) -> List[Tuple[str, np.ndarray]]:
            if side == "u":
                group_map, other_map = model.user_ids, model.item_ids
                group_factors, Y = model.user_factors, model.item_factors
            else:
                group_map, other_map = model.item_ids, model.user_ids
                group_factors, Y = model.item_factors, model.user_factors
            gids: List[str] = []
            rows: List[Tuple[np.ndarray, np.ndarray]] = []
            x0: List[np.ndarray] = []
            for gid, (ids, vals) in hist.items():
                if len(ids) > cap:
                    if gid not in new_set and side == "i":
                        # a popular item's factor moves negligibly per
                        # event; re-solving it re-reads the world
                        self._skipped["oversize"] += 1
                        _GROUPS_SKIPPED.labels("oversize").inc()
                        continue
                    self._skipped["truncated"] += 1
                    _GROUPS_SKIPPED.labels("truncated").inc()
                    ids, vals = ids[-cap:], vals[-cap:]
                # rows whose opposite id the model has never seen (and
                # this delta does not introduce) carry zero factors:
                # dropping them changes the Gramian by nothing
                pairs = [(other_map.get(o), v) for o, v in zip(ids, vals)]
                kept = [(c, v) for c, v in pairs if c is not None]
                if not kept:
                    continue
                gids.append(gid)
                rows.append((
                    np.fromiter((c for c, _ in kept), np.int32,
                                count=len(kept)),
                    np.fromiter((v for _, v in kept), np.float32,
                                count=len(kept)),
                ))
                x0.append(group_factors[group_map[gid]])
            if not gids:
                return []
            solved = fold_in_solve(Y, rows, self.cfg, x0=np.stack(x0),
                                   device=self.device)
            return [(gid, solved[k]) for k, gid in enumerate(gids)]

        # users -> items -> users: the final user pass sees the freshly
        # solved item factors (a new user who only rated new items would
        # otherwise keep a zero factor)
        user_rows = solve_side("u", hist_u, new_user_set)
        if user_rows:
            model.upsert_rows(user_rows=user_rows)
        item_rows = solve_side("i", hist_i, new_item_set)
        if item_rows:
            model.upsert_rows(item_rows=item_rows)
            user_rows = solve_side("u", hist_u, new_user_set)
            if user_rows:
                model.upsert_rows(user_rows=user_rows)
        if not user_rows and not item_rows:
            return None
        return {
            "index": self.index,
            "userRows": [[gid, vec.tolist()] for gid, vec in user_rows],
            "itemRows": [[gid, vec.tolist()] for gid, vec in item_rows],
        }


class TwoTowerOnline:
    """Bounded online mini-batch steps on the delta buffer, the
    two-tower lane (``ops.twotower.online_delta_step``) on ``device``.
    Updates only the touched serving-embedding rows."""

    def __init__(self, index: int, params, model, ds_params, device):
        self.index = index
        self.model = model
        self.device = device
        self._params = params
        self._ds = ds_params
        self._rng = np.random.default_rng(
            int(getattr(params, "seed", 11)) + 0x5EED)

    def fold(self, users: List[str], items: List[str],
             ratings: np.ndarray) -> Optional[dict]:
        p = self._params
        min_rating = float(getattr(p, "min_rating", 0.0))
        keep = [(u, i, r) for u, i, r in zip(users, items, ratings)
                if r >= min_rating]
        if not keep:
            return None
        model = self.model
        rank = model.user_factors.shape[1]

        def fresh_row() -> np.ndarray:
            v = self._rng.normal(size=rank).astype(np.float32)
            return v / max(float(np.linalg.norm(v)), 1e-8)

        new_u = {u for u, _, _ in keep if u not in model.user_ids}
        new_i = {i for _, i, _ in keep if i not in model.item_ids}
        if new_u or new_i:
            model.upsert_rows(
                user_rows=[(u, fresh_row()) for u in sorted(new_u)],
                item_rows=[(i, fresh_row()) for i in sorted(new_i)])
        u_rows = np.fromiter((model.user_ids[u] for u, _, _ in keep),
                             np.int32, count=len(keep))
        i_rows = np.fromiter((model.item_ids[i] for _, i, _ in keep),
                             np.int32, count=len(keep))
        weight = None
        if getattr(p, "weight_by_rating", False):
            weight = np.fromiter((r for _, _, r in keep), np.float32,
                                 count=len(keep))
        uu, new_uvecs, ii, new_ivecs, _losses = online_delta_step(
            model.user_factors, model.item_factors, u_rows, i_rows,
            weight=weight,
            lr=metrics.env_float("PIO_STREAM_TT_LR", 0.05),
            steps=metrics.env_int("PIO_STREAM_TT_STEPS", 4),
            temp=float(getattr(p, "temperature", 0.07)),
            device=self.device,
        )
        inv_u = model.user_ids.inverse()
        inv_i = model.item_ids.inverse()
        user_rows = [(inv_u[int(r)], new_uvecs[k]) for k, r in enumerate(uu)]
        item_rows = [(inv_i[int(r)], new_ivecs[k]) for k, r in enumerate(ii)]
        model.upsert_rows(user_rows=user_rows, item_rows=item_rows)
        return {
            "index": self.index,
            "userRows": [[gid, vec.tolist()] for gid, vec in user_rows],
            "itemRows": [[gid, vec.tolist()] for gid, vec in item_rows],
        }


class _DSView:
    """The datasource facts the tailer needs, lifted off the deployed
    engine's datasource params (the rate/buy interaction schema of
    ``RecoDataSourceParams``, which every factor template shares)."""

    def __init__(self, params):
        self.app_name = getattr(params, "app_name", None)
        if not self.app_name:
            raise StreamUnsupported(
                "deployed datasource has no app_name — streaming needs "
                "an event-store-backed datasource")
        self.channel_name = getattr(params, "channel_name", None)
        self.rate_event = getattr(params, "rate_event", "rate")
        self.buy_event = getattr(params, "buy_event", "buy")
        self.buy_rating = float(getattr(params, "buy_rating", 4.0))
        self.entity_type = "user"
        self.target_entity_type = "item"
        self.value_property = "rating"


class StreamUpdater:
    """The streaming events -> model loop: tail the log since the
    cursor, fold the delta into the local model, publish patches.

    ``ctx`` (a :class:`DeviceContext`, the card by default) is where the
    updater's models live and its folds compute. ``patch_servers`` are
    in-process :class:`~predictionio_torch.serving.engine_server.
    EngineServer` objects; ``patch_urls`` are remote engine-server base
    URLs (``pio stream --url``). With neither, the local model copy is
    still folded: the embedding caller owns serving. A drift-band
    breach of the quality probe calls ``reload_trigger`` when given,
    else ``GET /reload`` on each of ``reload_urls`` (bearer-authed when
    ``PIO_ADMIN_TOKEN`` is set).
    """

    def __init__(
        self,
        engine,
        engine_id: str,
        engine_version: str = "0",
        engine_variant: str = "default",
        storage: Optional[Storage] = None,
        ctx: Optional[DeviceContext] = None,
        instance=None,
        patch_urls: Sequence[str] = (),
        patch_servers: Sequence[Any] = (),
        reload_urls: Sequence[str] = (),
        reload_trigger: Optional[Any] = None,
    ):
        self.storage = storage or get_storage()
        self._ctx = ctx or DeviceContext()
        self.engine = engine
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.patch_urls = [u.rstrip("/") for u in patch_urls]
        self.patch_servers = list(patch_servers)
        self.reload_urls = [u.rstrip("/") for u in reload_urls]
        self.reload_trigger = reload_trigger
        #: fold cycles by outcome
        self.folds = {"ok": 0, "empty": 0, "rebased": 0, "patch_failed": 0}
        #: delta events folded into the live model
        self.fold_events = 0
        #: touched groups not re-solved, by reason (oversize: an
        #: existing item's history beyond PIO_STREAM_MAX_GROUP;
        #: truncated: a history capped to its newest rows)
        self.groups_skipped = {"oversize": 0, "truncated": 0}
        #: model-patch deliveries that failed (per target per cycle)
        self.patch_failures = 0
        #: wall seconds of the last fold cycle that folded events
        self.last_fold_seconds = 0.0
        #: the last probe's recall@k, and the probes below the floor
        self.index_recall: Optional[float] = None
        self.recall_breaches = 0
        #: a truncated or rebased delta left work no fold may credit to
        #: the freshness horizon; a newly bound instance clears it
        self._staleness_debt = False
        self.instance_id: Optional[str] = None

        if instance is None:
            instance = self.storage.engine_instances().get_latest_completed(
                engine_id, engine_version, engine_variant)
            if instance is None:
                raise StreamUnsupported(
                    f"no COMPLETED instance for engine {engine_id} — "
                    "train once before streaming")
        self._bind_instance(instance)

    @property
    def device(self):
        return self._ctx.device

    # -- binding to a trained instance --------------------------------------
    def _bind_instance(self, instance) -> None:
        deployment = prepare_deploy(self.engine, instance, self._ctx,
                                    self.storage)
        ds = _DSView(deployment.engine_params.data_source_params[1])
        app_id, channel_id = resolve_app(ds.app_name, ds.channel_name,
                                         self.storage)
        events = self.storage.events()
        if not hasattr(events, "find_columnar_since"):
            raise StreamUnsupported(
                f"event store {type(events).__name__} has no "
                "sequence-offset delta reads (find_columnar_since) — "
                "streaming needs the eventlog backend")
        folders: List[Any] = []
        for idx, (algo, model) in enumerate(
                zip(deployment.algorithms, deployment.models)):
            if isinstance(algo, TwoTowerAlgorithm):
                folders.append(TwoTowerOnline(idx, algo.params, model, ds,
                                              self.device))
            elif isinstance(algo, ALSAlgorithm):
                folders.append(ALSFoldIn(
                    idx, algo.params, model, events, app_id, channel_id,
                    ds, self.device, self.groups_skipped))
        if not folders:
            raise StreamUnsupported(
                "no fold-capable algorithm in the deployed engine "
                "(ALS fold-in / two-tower online steps)")
        if instance.id != self.instance_id:
            self._staleness_debt = False
            # the drift reload re-arms only for a new instance: one
            # reload per breach episode, none while the retrain that
            # fixes the drift is still running
            self._quality_reload_fired = False
        self.instance_id = instance.id
        self._ds = ds
        self._app_id, self._channel_id = app_id, channel_id
        self._events = events
        self._folders = folders
        # the tail from HERE: the loaded instance covers everything up
        # to its train read; rows between that horizon and this call are
        # already-ingested work a full retrain owns (the cursor cannot
        # be rewound to an instant the log does not index by time)
        self.cursor = events.delta_cursor(app_id, channel_id)
        self._folds_since_probe = 0
        self._folds_since_quality = 0
        # the shadow: the freshly loaded instance, snapshotted before any
        # fold touches it (drift is distance from the last full retrain)
        self._shadows: Dict[int, quality.ShadowRef] = {
            folder.index: quality.ShadowRef(folder.model, instance.id)
            for folder in folders
            if quality.ShadowRef.supports(getattr(folder, "model", None))}

    def resync(self) -> None:
        """Rebind to the newest COMPLETED instance (after a retrain or
        a 409 from a patched server) and reset the cursor to the tail."""
        instance = self.storage.engine_instances().get_latest_completed(
            self.engine_id, self.engine_version, self.engine_variant)
        if instance is None:
            raise StreamUnsupported(
                f"no COMPLETED instance for engine {self.engine_id}")
        self._bind_instance(instance)
        journal.emit("resync", instance=self.instance_id)

    def _count_fold(self, outcome: str) -> None:
        self.folds[outcome] += 1
        _FOLDS.labels(outcome).inc()

    def _patch_failed(self) -> None:
        self.patch_failures += 1
        _PATCH_FAILURES.inc()

    # -- one cycle -----------------------------------------------------------
    def poll_once(self) -> Dict[str, Any]:
        """One tail -> fold -> publish cycle; returns its stats dict.
        Each cycle runs under its own trace, which the HTTP patch lane
        carries to the servers it patches."""
        with trace.new_trace():
            return self._poll_once_traced()

    def _poll_once_traced(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        # freshness horizon at read START, as in Engine.train
        perfacct.LEDGER.note_train_read()
        cols, new_cursor, rebased = self._events.find_columnar_since(
            self._app_id, self._channel_id,
            cursor=self.cursor,
            value_property=self._ds.value_property,
            entity_type=self._ds.entity_type,
            event_names=[self._ds.rate_event, self._ds.buy_event],
            target_entity_type=self._ds.target_entity_type,
        )
        if rebased:
            # the returned rows are a RESYNC of the whole live set, not
            # a delta: folding them would re-solve the world off-cursor.
            # Reset to the tail; a full retrain (rolling /reload) owns
            # reconciling what happened before it
            self.cursor = new_cursor
            self._staleness_debt = True
            self._count_fold("rebased")
            journal.emit("fold", outcome="rebased")
            log.warning(
                "delta cursor rebased (compaction or truncated appends): "
                "skipping fold; run a full retrain to reconcile")
            return {"events": 0, "rebased": True,
                    "seconds": time.perf_counter() - t0}
        prev_cursor = self.cursor
        self.cursor = new_cursor
        if len(cols):
            # the tail refreshes the entity sketches of THIS process;
            # the insert lane already counted these events
            dataobs.DATAOBS.observe_tail(self._app_id, cols)
        max_delta = metrics.env_int("PIO_STREAM_MAX_DELTA", 200_000)
        n = len(cols)
        truncated = n > max_delta
        if truncated:
            # fold only the newest rows (recent activity stays fresh);
            # the dropped backlog is work only a full retrain
            # reconciles, so no later fold may credit the horizon
            # either. Cached histories go too: the dropped rows
            # never extended them, so every entry past this gap would
            # re-solve against missing data
            self._staleness_debt = True
            for folder in self._folders:
                if hasattr(folder, "invalidate_history"):
                    folder.invalidate_history()
            log.warning("delta of %d rows exceeds PIO_STREAM_MAX_DELTA=%d; "
                        "folding the newest %d — run a full retrain to "
                        "reconcile the rest", n, max_delta, max_delta)
        users: List[str] = []
        items: List[str] = []
        vals: List[float] = []
        buy_code = _buy_code(cols, self._ds)
        start = max(0, n - max_delta)
        for k in range(start, n):
            tc = int(cols.target_codes[k])
            if tc < 0:
                continue
            users.append(cols.entity_vocab[int(cols.entity_codes[k])])
            items.append(cols.target_vocab[tc])
            vals.append(_decode_value(cols, k, buy_code,
                                      self._ds.buy_rating))
        if not users:
            self._count_fold("empty")
            return {"events": 0, "rebased": False,
                    "seconds": time.perf_counter() - t0}

        ratings = np.asarray(vals, np.float32)
        try:
            blocks = []
            for folder in self._folders:
                block = folder.fold(users, items, ratings)
                if block is not None:
                    blocks.append(block)
            published = self._publish(blocks)
        except Exception:
            # the delta was NOT folded: rewind so the next tick retries
            # it (run_forever's contract), and drop cached histories: a
            # folder that died mid-fold may have extended them already,
            # so the retry's cache-extend would double-count the delta
            self.cursor = prev_cursor
            for folder in self._folders:
                if hasattr(folder, "invalidate_history"):
                    folder.invalidate_history()
            raise
        seconds = time.perf_counter() - t0
        self.last_fold_seconds = seconds
        _FOLD_SECONDS.set(seconds)
        if published and not self._staleness_debt:
            # the fold is servable and covers the whole delta: move the
            # freshness horizon as run_train's publish does
            perfacct.LEDGER.note_publish()
        if published:
            self._count_fold("ok")
            self.fold_events += len(users)
            _FOLD_EVENTS.inc(len(users))
            journal.emit("fold", outcome="ok", events=len(users),
                         seconds=round(seconds, 3),
                         truncated=truncated or None)
        else:
            self._count_fold("patch_failed")
            journal.emit("fold", outcome="patch_failed",
                         events=len(users))
        out = {
            "events": len(users),
            "rebased": False,
            "truncated": truncated,
            "touched_users": len(set(users)),
            "touched_items": len(set(items)),
            "published": published,
            "seconds": seconds,
        }
        self._folds_since_probe += 1
        if self._folds_since_probe >= metrics.env_int(
                "PIO_STREAM_RECALL_EVERY", 20):
            self._folds_since_probe = 0
            recall = self.probe_recall()
            if recall is not None:
                out["index_recall"] = recall
        self._folds_since_quality += 1
        if self._folds_since_quality >= metrics.env_int(
                "PIO_QUALITY_EVERY", 20):
            self._folds_since_quality = 0
            report = self.probe_quality()
            if report is not None:
                out["quality"] = {
                    k: report.get(k)
                    for k in ("recall_vs_retrain", "rmse_drift",
                              "factor_drift", "breached")}
        return out

    # -- retrieval drift probe -----------------------------------------------
    def probe_recall(self) -> Optional[float]:
        """Recall@k of the PATCHED retrieval index against brute force
        over the current factor tables. The local models' indexes take
        the same ``upsert_rows`` the serving patches do, so a fold that
        corrupts index freshness shows here before users see it.
        Returns the worst recall across fold-capable algorithms, or None
        when nothing is probeable."""
        sample_n = metrics.env_int("PIO_STREAM_RECALL_SAMPLE", 16)
        k_cfg = metrics.env_int("PIO_STREAM_RECALL_K", 10)
        rng = np.random.default_rng(0x5CA1E)
        worst: Optional[float] = None
        for folder in self._folders:
            model = getattr(folder, "model", None)
            if model is None or not hasattr(model, "retrieval_index"):
                continue
            n_users = len(model.user_ids)
            n_items = len(model.item_ids)
            if n_users == 0 or n_items == 0:
                continue
            rows = rng.choice(n_users, min(sample_n, n_users),
                              replace=False)
            recall = recall_at_k(
                model.retrieval_index(), model.user_factors[rows],
                min(k_cfg, n_items), vectors=model.item_factors)
            worst = recall if worst is None else min(worst, recall)
        if worst is None:
            return None
        self.index_recall = worst
        _INDEX_RECALL.set(worst)
        floor = metrics.env_float("PIO_STREAM_RECALL_FLOOR", 0.95)
        if worst < floor:
            self.recall_breaches += 1
            _RECALL_BREACHES.inc()
            log.warning(
                "patched retrieval index recall@k %.3f fell below the "
                "floor %.2f — the fold-in lane is drifting from the "
                "factor tables; run a full retrain (rolling /reload)",
                worst, floor)
        return worst

    # -- shadow-retrain drift probe ------------------------------------------
    def probe_quality(self) -> Optional[Dict[str, Any]]:
        """Score every fold-capable live model against its shadow and
        publish the worst case to the ``pio_model_quality_*`` gauges and
        ``GET /admin/quality`` (obs/quality.py computes it). A
        drift-band breach fires the reload lane once per bound instance
        and resyncs the updater. Returns the published report, or None
        when nothing was probeable."""
        reports = []
        for folder in self._folders:
            shadow = self._shadows.get(folder.index)
            if shadow is None:
                continue
            report = quality.drift_report(folder.model, shadow)
            if report.get("recall_vs_retrain") is not None:
                reports.append(report)
        if not reports:
            return None
        # the most pessimistic verdict across algorithms: a healthy ALS
        # must not mask a drifted two-tower
        merged = dict(min(reports, key=lambda r: r["recall_vs_retrain"]))
        merged["recall_vs_retrain"] = min(r["recall_vs_retrain"]
                                          for r in reports)
        for name in ("rmse_drift", "factor_drift"):
            values = [r[name] for r in reports if r.get(name) is not None]
            if values:
                merged[name] = max(values)
        merged["algorithms_probed"] = len(reports)
        merged = quality.publish_drift(merged)
        # this daemon's quality state is not the servers': push the
        # report onto each patch target's /admin/quality (in-process
        # patch_servers share this process's state already)
        if self.patch_urls:
            self._push_drift(merged)
        if merged["breached"] and not self._quality_reload_fired:
            self._quality_reload_fired = True
            quality.note_auto_reload()
            journal.emit("drift_breach", band=merged["band"],
                         breached=merged["breached"],
                         recall=merged.get("recall_vs_retrain"),
                         rmse_drift=merged.get("rmse_drift"),
                         factor_drift=merged.get("factor_drift"))
            journal.emit("auto_reload", reason="drift_breach")
            log.warning(
                "model-quality drift breached the band %.2f (%s: "
                "recall_vs_retrain=%s rmse_drift=%s factor_drift=%s): "
                "triggering the rolling /reload lane and resyncing; a "
                "full retrain owns closing the episode",
                merged["band"], ",".join(merged["breached"]),
                merged.get("recall_vs_retrain"), merged.get("rmse_drift"),
                merged.get("factor_drift"))
            self._trigger_reload()
            try:
                # the updater's own model is the drifted one: rebind to
                # the instance serving rolled back onto
                self.resync()
            except Exception:  # noqa: BLE001 — resync is advisory
                log.exception("post-breach stream resync failed")
        return merged

    def _push_drift(self, report: Dict[str, Any]) -> None:
        """POST the drift report to each patch target's
        ``/admin/quality``; failures are logged, never raised (drift
        delivery is telemetry)."""
        body = json.dumps({"drift": report}).encode()
        headers = trace.traced_headers({"Content-Type": "application/json"})
        token = os.environ.get("PIO_ADMIN_TOKEN")
        if token:
            headers["Authorization"] = f"Bearer {token}"
        timeout = metrics.env_float("PIO_STREAM_PATCH_TIMEOUT", 10.0)
        for url in self.patch_urls:
            try:
                req = urllib.request.Request(
                    url + "/admin/quality", data=body, headers=headers,
                    method="POST")
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    resp.read()
            except Exception as e:  # noqa: BLE001 — telemetry delivery
                # must not break the fold loop
                log.warning("drift report push to %s failed: %s", url, e)

    def _trigger_reload(self) -> None:
        """Fire the rolling-reload lane: ``reload_trigger`` when given,
        else ``GET /reload`` on every reload URL (a router answers 202
        and rolls its fleet; an engine server reloads in place)."""
        if self.reload_trigger is not None:
            try:
                self.reload_trigger()
            except Exception:  # noqa: BLE001 — operator plumbing; its
                # failure must not kill the fold loop
                log.exception("drift reload trigger failed")
            return
        if not self.reload_urls:
            log.warning("drift band breached but no reload lane is "
                        "configured (pio stream --reload-url): run a "
                        "full retrain and a rolling /reload")
            return
        headers = trace.traced_headers()
        token = os.environ.get("PIO_ADMIN_TOKEN")
        if token:
            headers["Authorization"] = f"Bearer {token}"
        timeout = metrics.env_float("PIO_STREAM_PATCH_TIMEOUT", 10.0)
        for url in self.reload_urls:
            try:
                req = urllib.request.Request(url + "/reload",
                                             headers=headers)
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    resp.read()
                log.warning("drift breach: rolling reload triggered at "
                            "%s", url)
            except Exception as e:  # noqa: BLE001 — logged; the daemon
                # keeps folding either way
                log.warning("drift-breach reload trigger to %s failed: "
                            "%s", url, e)

    # -- patch delivery ------------------------------------------------------
    def _publish(self, blocks: List[dict]) -> bool:
        if not blocks:
            return True
        payload = {"instanceId": self.instance_id, "algorithms": blocks}
        ok = True
        resync_needed = False
        for server in self.patch_servers:
            try:
                server.apply_patch(payload)
            except EngineServer.StalePatch:
                # the server rolled to a newer instance: the same
                # contract as the HTTP lane's 409, rebind and tail from
                # there
                log.warning("in-process model patch rejected (stale "
                            "instance); resyncing to the latest "
                            "COMPLETED instance")
                self._patch_failed()
                ok = False
                resync_needed = True
            except Exception:  # noqa: BLE001 — one dead target must not
                # stop the others; the failure is counted and logged
                log.exception("in-process model patch failed")
                self._patch_failed()
                ok = False
        if resync_needed:
            try:
                self.resync()
            except Exception:  # noqa: BLE001 — resync is advisory
                log.exception("stream resync failed")
        if not self.patch_urls:
            return ok
        body = json.dumps(payload).encode()
        # the cycle's trace rides along: the patched server's spans join
        headers = trace.traced_headers({"Content-Type": "application/json"})
        token = os.environ.get("PIO_ADMIN_TOKEN")
        if token:
            headers["Authorization"] = f"Bearer {token}"
        timeout = metrics.env_float("PIO_STREAM_PATCH_TIMEOUT", 10.0)
        for url in self.patch_urls:
            try:
                req = urllib.request.Request(
                    url + "/model/patch", data=body, headers=headers,
                    method="POST")
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    resp.read()
            except urllib.error.HTTPError as e:
                e.read()
                self._patch_failed()
                ok = False
                if e.code == 409:
                    # the server moved to a newer instance (a retrain
                    # published and rolled): rebind and tail from there
                    log.warning("model patch rejected (409: stale "
                                "instance) by %s; resyncing to the "
                                "latest COMPLETED instance", url)
                    try:
                        self.resync()
                    except Exception:  # noqa: BLE001 — resync is advisory
                        log.exception("stream resync failed")
                else:
                    log.warning("model patch to %s failed: HTTP %s",
                                url, e.code)
            except Exception as e:  # noqa: BLE001 — a network failure is
                # a counted outcome, not a crash of the fold loop
                log.warning("model patch to %s failed: %s", url, e)
                self._patch_failed()
                ok = False
        return ok

    # -- daemon --------------------------------------------------------------
    def run_forever(self, interval: Optional[float] = None,
                    stop: Optional[threading.Event] = None) -> None:
        """Poll until ``stop`` is set (the ``pio stream`` daemon)."""
        interval = (interval if interval is not None
                    else metrics.env_float("PIO_STREAM_INTERVAL_SEC", 1.0))
        stop = stop or threading.Event()
        # the daemon holds the continuous profiler while it runs
        # (refcounted: one beside a server shares its sampler)
        owner = f"StreamUpdater:{id(self):#x}"
        contprof.retain(owner)
        try:
            while not stop.is_set():
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — the daemon must
                    # survive a transient storage/serving failure; the
                    # error is logged and the next tick retries from the
                    # same cursor
                    log.exception("stream fold cycle failed")
                stop.wait(interval)
        finally:
            contprof.release(owner)
