"""Exact retrieval over a device-resident table: the ``topk_dot`` kernel.

Counterpart of ``predictionio_tpu/index/exact.py``. The item table is
held as a numpy array (the copy-on-write source of truth) and as a
tensor on the index's device, which the ``topk_dot`` Hopper kernel
(``ops/kernels/topk_dot.py``) streams; the ``[B, I]`` logits never
exist in device memory.

Selection: on a CUDA device the kernel always serves, whatever the
per-index ``kernel`` flag (the model params' ``index_kernel``, which
JAX-trained blobs and engine.json files still carry, with the
``PIO_INDEX_KERNEL`` override) says. On the CPU the flag chooses: "on"
runs the kernel's plain version (the counterpart of Pallas interpret
mode, which the tests use), "auto" and "off" take the scorer. Shapes
outside the kernel's caps (B, k <= 128, E <= 64, k <= I) go to
``ops.topk.TopKScorer``, as the JAX index goes to its XLA scorer; on a
card that scorer's device route runs on the card. There is no probe and
no degrade: on CUDA an eligible search launches the kernel or raises.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from predictionio_torch.index import MEASURED_RECALL, AnnIndex
from predictionio_torch.ops.kernels import resolve_flag
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.ops.topk import (TopKScorer, _as_numpy,
                                         _prepare_score_inputs)
from predictionio_torch.parallel.context import DeviceLike, resolve_device

log = logging.getLogger(__name__)


class ExactIndex(AnnIndex):
    """Exact top-k by dot product over the full table. Results match
    ``ops.topk.TopKScorer.score`` under the one total order (score
    descending, index ascending), up to f32 summation order."""

    backend = "exact"

    def __init__(self, kernel: str = "auto", max_exclude: int = 64,
                 device: DeviceLike = None):
        self.kernel_flag = kernel
        self.max_exclude = int(max_exclude)
        self.device = resolve_device(device)
        self._scorer: Optional[TopKScorer] = None   # lazy, ineligible shapes
        self._vectors = np.zeros((0, 1), np.float32)
        self._table: Optional[torch.Tensor] = None  # device copy, lazy
        self._lock = threading.Lock()
        self.kernel_plan: Dict[str, object] = {"engaged": False,
                                               "reason": "no build yet"}
        self.build_seconds = 0.0
        self.searches = 0

    # -- build / upsert -------------------------------------------------------
    def build(self, item_vectors) -> None:
        t0 = time.perf_counter()
        with self._lock:
            self._vectors = np.ascontiguousarray(_as_numpy(item_vectors),
                                                 dtype=np.float32)
            self._scorer = None
            self._table = None
            self._plan_kernel()
        self._device_table()   # the table lives on the device from build on
        self.build_seconds = time.perf_counter() - t0
        self._note_build(self.build_seconds)
        self._register_mem(self._mem_nbytes())
        MEASURED_RECALL.labels(self.backend).set(1.0)  # exact by design

    def upsert(self, rows: np.ndarray, vectors: np.ndarray) -> None:
        """Overwrite/append rows copy-on-write: readers see the old or
        the new table, never torn rows. The device copies of the old
        table are dropped and re-made on the next search."""
        rows = np.asarray(rows, np.int64).ravel()
        vectors = np.atleast_2d(np.asarray(vectors, np.float32))
        if len(rows) == 0:
            return
        with self._lock:
            table = self._vectors
            n, d = table.shape if table.size else (0, vectors.shape[1])
            grow = int(rows.max()) + 1 - n
            if grow > 0:
                table = np.vstack([table.reshape(n, d),
                                   np.zeros((grow, d), np.float32)])
            else:
                table = table.copy()
            table[rows] = vectors
            self._vectors = table
            self._scorer = None
            self._table = None
            self._note_build(self.build_seconds)
        self._register_mem(self._mem_nbytes())

    def __len__(self) -> int:
        return int(self._vectors.shape[0])

    def _mem_nbytes(self) -> int:
        """Resident bytes this index owns: the host table plus, once
        made, its device copy."""
        table = self._table
        on_device = table is not None and table.device.type != "cpu"
        return int(self._vectors.nbytes
                   + (table.numel() * table.element_size()
                      if on_device else 0))

    @property
    def vectors(self) -> np.ndarray:
        """The host table (what ``index.recall.recall_at_k`` reads)."""
        return self._vectors

    # -- kernel selection -----------------------------------------------------
    def _plan_kernel(self) -> None:
        flag = resolve_flag(self.kernel_flag, "PIO_INDEX_KERNEL")
        if self._vectors.shape[0] == 0:
            engaged, why = False, "empty table"
        elif self.device.type == "cuda":
            if flag == "off":
                log.info("index kernel flag 'off' ignored on %s: the "
                         "kernel serves every eligible search on a card",
                         self.device)
            engaged, why = True, "cuda device"
        elif flag == "on":
            engaged, why = True, "forced on"
        else:
            engaged, why = False, ("the CPU takes the scorer unless the "
                                   "flag is 'on'")
        self.kernel_plan = {"engaged": engaged, "reason": why,
                            "device": str(self.device)}

    def _kernel_eligible(self, B: int, E: int, k: int, n: int) -> bool:
        return (bool(self.kernel_plan.get("engaged"))
                and B <= tkd.MAX_BATCH and E <= tkd.MAX_EXCLUDE
                and k <= tkd.MAX_K and k <= n)

    def _device_table(self) -> torch.Tensor:
        with self._lock:
            table = self._table
            if table is None:
                table = torch.as_tensor(self._vectors, device=self.device)
                self._table = table
            else:
                return table
        # a new long-lived device allocation: re-price the ledger
        self._register_mem(self._mem_nbytes())
        return table

    def _fallback(self) -> TopKScorer:
        with self._lock:
            if self._scorer is None:
                self._scorer = TopKScorer(self._vectors,
                                          max_exclude=self.max_exclude,
                                          device=self.device)
            return self._scorer

    # -- search ---------------------------------------------------------------
    def search(self, query_vecs, k: int, exclude: Optional[np.ndarray] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        self._note_query()
        self.searches += 1
        table = self._device_table()   # one consistent (old-or-new) table
        n = int(table.shape[0])
        if n == 0:
            B = 1 if np.ndim(_as_numpy(query_vecs)) < 2 else len(query_vecs)
            return (np.zeros((B, 0), np.float32),
                    np.zeros((B, 0), np.int32))
        q2, excl, k_eff, k_bucket, B = _prepare_score_inputs(
            query_vecs, k, exclude, n, self.max_exclude, self.device)
        if not self._kernel_eligible(q2.shape[0], excl.shape[1], k_bucket, n):
            return self._fallback().score(query_vecs, k, exclude)
        scores, idx = tkd.topk_dot(q2, table, excl, k_bucket)
        return (scores[:B, :k_eff].cpu().numpy(),
                idx[:B, :k_eff].cpu().numpy())

    def stats(self) -> Dict[str, object]:
        out = super().stats()
        out.update({
            "kernel": dict(self.kernel_plan),
            "kernel_launches": tkd.launches.value,
            "build_seconds": round(self.build_seconds, 4),
            "searches": self.searches,
            "max_exclude": self.max_exclude,
        })
        return out
