"""Sequential (next-item) recommendation as a DASE Algorithm.

Counterpart of ``predictionio_tpu/models/sessionrec.py``. The query
surface is the recommendation template's (top-``num`` itemScores) over
ORDERED histories: ``{"user": u, "num": n}`` encodes the user's stored
history, ``{"items": [...], "num": n}`` an explicit session (anonymous
users too), and ``"excludeSeen": true`` leaves the history's items out.
Compute core: ``ops/sessionrec.py`` (the causal transformer, trained on
the context's device; serving through the retrieval index, the
``topk_dot`` kernel on a card).

A model blob the JAX package wrote holds numpy only (the flax params
tree, the histories, the id maps), so it unpickles here and serves
after ``to(device)``. ``seq_axis`` (ring attention over a mesh) raises
in training (ROADMAP.md, queue 1 item 12); a model trained with it by
the JAX package serves here through blockwise attention, as in JAX.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_torch.core import Algorithm, SanityCheck
from predictionio_torch.core.params import Params
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.ops.sessionrec import (SessionRecConfig,
                                               SessionRecModelState,
                                               SessionRecTrainer,
                                               SessionScorer)
from predictionio_torch.ops.topk import NEG_INF
from predictionio_torch.parallel.context import (DeviceContext, DeviceLike,
                                                 OnDevice)

log = logging.getLogger(__name__)


@dataclass
class PreparedSequences(SanityCheck):
    """PD for sequence models: indexed, timestamped interaction triples."""

    user_ids: BiMap
    item_ids: BiMap
    user_idx: np.ndarray     # [n] int
    item_idx: np.ndarray     # [n] int
    times: np.ndarray        # [n] float64 (epoch seconds)

    @property
    def n_users(self) -> int:
        return len(self.user_ids)

    @property
    def n_items(self) -> int:
        return len(self.item_ids)

    def sanity_check(self) -> None:
        if len(self.user_idx) == 0:
            raise ValueError("PreparedSequences is empty — no events found")
        if not (len(self.user_idx) == len(self.item_idx) == len(self.times)):
            raise ValueError("sequence arrays length mismatch")


@dataclass
class SessionRecParams(Params):
    dim: int = 64
    heads: int = 2
    layers: int = 2
    ffn_mult: int = 4
    max_len: int = 64
    dropout: float = 0.1
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    epochs: int = 5
    batch_size: int = 256
    seed: int = 13
    attn_block: int = 0              # >0: flash-style blockwise attention
    seq_axis: Optional[str] = None   # mesh axis for ring attention (SP)
    checkpoint_dir: Optional[str] = None   # mid-training checkpoint/resume
    checkpoint_every: int = 1


def _kept(scores, idx) -> List[Tuple[int, float]]:
    """(id, score) pairs that are real answers: no pad, no excluded or
    unfillable slot (``-inf`` in the JAX package, ``<= NEG_INF`` here)."""
    return [(int(i), float(s)) for s, i in zip(scores, idx)
            if i >= 0 and np.isfinite(s) and s > NEG_INF]


class SessionRecModel(OnDevice):
    """Params + per-user histories + id maps; the scorer is built on the
    serving device at first use."""

    def __init__(self, state: SessionRecModelState, user_ids: BiMap,
                 item_ids: BiMap):
        self.state = state
        self.user_ids = user_ids
        self.item_ids = item_ids
        self._scorer: Optional[SessionScorer] = None
        self._lock = threading.Lock()

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("_lock", None)
        d["_scorer"] = None          # device state never pickles
        return d

    def __setstate__(self, d):
        # a JAX-trained pickle carries its scorer slot as None
        self.__dict__.update(d)
        self._scorer = None
        self._lock = threading.Lock()

    def to(self, device: DeviceLike) -> "SessionRecModel":
        """Serve from ``device``; the scorer is (re)built there."""
        with self._lock:
            super().to(device)
            self._scorer = None
        return self

    def scorer(self) -> SessionScorer:
        device = self.serving_device()
        with self._lock:
            if self._scorer is None:
                self._scorer = SessionScorer(self.state, device=device)
            return self._scorer

    def retrieval_stats(self) -> Optional[dict]:
        scorer = self._scorer
        return scorer.index.stats() if scorer is not None else None

    def _sequence_for(self, query: Dict[str, Any]) -> Optional[np.ndarray]:
        """The history to encode: an explicit ``items`` list wins over the
        stored training history."""
        max_len = self.state.cfg.max_len
        items = query.get("items")
        if items is not None:
            idx = [self.item_ids[i] + 1 for i in map(str, items)
                   if i in self.item_ids]
            if not idx:
                return None
            row = np.zeros(max_len, np.int32)
            tail = idx[-max_len:]
            row[: len(tail)] = tail
            return row
        row_id = self.user_ids.get(str(query.get("user", "")))
        if row_id is None:
            return None
        row = self.state.sequences[row_id]
        return row if (row > 0).any() else None

    def recommend(self, query: Dict[str, Any]) -> List[Tuple[str, float]]:
        seq = self._sequence_for(query)
        if seq is None:
            return []
        num = int(query.get("num", 10))
        scores, idx = self.scorer().top_k(
            seq[None, :], num,
            exclude_seen=bool(query.get("excludeSeen", False)))
        inv = self.item_ids.inverse()
        return [(inv[i], s) for i, s in _kept(scores[0], idx[0])]


class SessionRecAlgorithm(Algorithm):
    """DASE wrapper over ``ops/sessionrec.py``."""

    def __init__(self, params: SessionRecParams):
        super().__init__(params)

    def config(self) -> SessionRecConfig:
        p: SessionRecParams = self.params
        return SessionRecConfig(
            dim=p.dim, heads=p.heads, layers=p.layers, ffn_mult=p.ffn_mult,
            max_len=p.max_len, dropout=p.dropout,
            learning_rate=p.learning_rate, weight_decay=p.weight_decay,
            epochs=p.epochs, batch_size=p.batch_size, seed=p.seed,
            attn_block=p.attn_block, seq_axis=p.seq_axis,
            checkpoint_dir=p.checkpoint_dir,
            checkpoint_every=p.checkpoint_every)

    def train(self, ctx: DeviceContext, pd: PreparedSequences
              ) -> SessionRecModel:
        """Train on the context's device; ``last_train`` holds the
        sequence build's and each epoch's seconds, the losses and, on a
        card, the peak device memory."""
        cfg = self.config()
        if ctx.device.type == "cuda":
            torch.cuda.init()   # the allocator exists before its stats reset
            torch.cuda.reset_peak_memory_stats(ctx.device)
        t0 = time.perf_counter()
        trainer = SessionRecTrainer((pd.user_idx, pd.item_idx, pd.times),
                                    pd.n_users, pd.n_items, cfg,
                                    device=ctx.device)
        setup_sec = time.perf_counter() - t0
        losses = trainer.run()
        steps = trainer.steps_per_epoch
        self.last_train = {
            "events": int(len(pd.user_idx)), "users": pd.n_users,
            "items": pd.n_items, "device": str(ctx.device),
            "sequence_sec": trainer.sequence_seconds, "setup_sec": setup_sec,
            "epoch_sec": list(trainer.epoch_seconds),
            "steps_per_epoch": steps,
            "step_ms": (1e3 * sum(trainer.epoch_seconds[1:])
                        / max(steps * (len(trainer.epoch_seconds) - 1), 1)
                        if len(trainer.epoch_seconds) > 1 else None),
            "losses": losses,
            "peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                           if ctx.device.type == "cuda" else None)}
        log.info("sessionrec trained: %s", self.last_train)
        return SessionRecModel(trainer.state(losses), pd.user_ids,
                               pd.item_ids).to(ctx.device)

    def load_persistent_model(self, persisted: SessionRecModel,
                              ctx: DeviceContext) -> SessionRecModel:
        return persisted.to(ctx.device)

    def warmup(self, model: SessionRecModel, ctx: DeviceContext) -> None:
        """Drive the B=1 encoder and top-k with and without exclusions,
        so the first live query pays no build or first-touch cost."""
        if len(model.item_ids) == 0:
            return
        seq = np.zeros((1, model.state.cfg.max_len), np.int32)
        seq[0, 0] = 1
        for exclude_seen in (False, True):
            model.scorer().top_k(seq, 10, exclude_seen=exclude_seen)

    def predict(self, model: SessionRecModel,
                query: Dict[str, Any]) -> Dict[str, Any]:
        return {"itemScores": [{"item": i, "score": s}
                               for i, s in model.recommend(query)]}

    def batch_predict(self, model: SessionRecModel, queries):
        """Resolve every query's history, then score each excludeSeen
        group as one batch at its largest ``num``."""
        groups: Dict[bool, list] = {False: [], True: []}
        out = []
        for qi, q in queries:
            seq = model._sequence_for(q)
            if seq is None:
                out.append((qi, {"itemScores": []}))
            else:
                groups[bool(q.get("excludeSeen", False))].append((qi, q, seq))
        inv = model.item_ids.inverse()
        for exclude_seen, resolved in groups.items():
            if not resolved:
                continue
            batch = np.stack([seq for _, _, seq in resolved])
            num = max(int(q.get("num", 10)) for _, q, _ in resolved)
            scores, idx = model.scorer().top_k(batch, num,
                                               exclude_seen=exclude_seen)
            for (qi, q, _), s_row, i_row in zip(resolved, scores, idx):
                n = int(q.get("num", 10))
                out.append((qi, {"itemScores": [
                    {"item": inv[i], "score": s}
                    for i, s in _kept(s_row[:n], i_row[:n])]}))
        return out
