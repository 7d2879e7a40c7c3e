"""Top-k scoring for serving, with latency-aware placement.

Counterpart of ``predictionio_tpu/ops/topk.py`` (its single-device
parts; the sharded scorer waits for the multi-device slice). A query is
an embedding-row lookup plus a ``[B, K] x [K, I]`` product and a top-k.
``TopKScorer`` routes each call either to the HOST (numpy matvec +
partial sort, the reference's driver-side scan) or to the DEVICE
(``torch.matmul`` + mask + ``torch.topk`` on the scorer's device — the
counterpart of the XLA ``_topk_scores``, which is no Pallas kernel),
by a cost model against the measured dispatch latency of the device.
``PIO_SERVE_PLACEMENT=device|host|auto`` overrides. That choice exists
for a scorer on the CPU only: a scorer on a CUDA device always takes the
device route, so no query leaves the card for the host while the card
holds the tables.

One total order everywhere: score descending, then item index
ascending. The host route gets it from a stable sort of the
canonicalized partition (as in the JAX package); the device route gets
it by running ``torch.topk`` over one 64-bit key per item that holds
both (``torch.topk`` alone does not promise an order among ties).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from predictionio_torch.parallel.context import DeviceLike, resolve_device

NEG_INF = np.float32(-1e30)

# assumed throughputs for the routing cost model; only the crossover
# matters, so order-of-magnitude is enough
_HOST_FLOPS = 5e9
_DEVICE_FLOPS = 5e13

_dispatch_latency: Dict[str, float] = {}


def measured_dispatch_latency(device: torch.device) -> float:
    """Seconds for one tiny op + scalar readback on ``device`` — the
    serving latency floor of the device route. Measured once per
    process and device."""
    key = str(device)
    if key not in _dispatch_latency:
        x = torch.zeros((8, 128), dtype=torch.float32, device=device)

        def once():
            v = float(x.sum())
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return v

        once()  # first-touch costs outside the timed region
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            once()
            best = min(best, time.perf_counter() - t0)
        _dispatch_latency[key] = best
    return _dispatch_latency[key]


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rows(x) -> int:
    """Batch size of a [B, K] or [K] query (numpy or tensor)."""
    shape = x.shape if isinstance(x, torch.Tensor) else np.shape(x)
    return 1 if len(shape) < 2 else int(shape[0])


def ordered_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Top-``k`` of each row of ``scores`` [B, I] under (score
    descending, index ascending): ``(values [B, k], idx [B, k] int64)``.

    Each entry becomes one int64 key — the score's bits mapped so that
    signed order is float order (high 32 bits) over ``2^32 - 1 - index``
    (low 32 bits) — so ``torch.topk`` sees no ties at all."""
    s = scores + 0.0  # -0.0 ranks as +0.0
    bits = s.view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.arange(s.shape[1], device=s.device, dtype=torch.int64)
    key = ordered * (1 << 32) + ((1 << 32) - 1 - idx)
    top = torch.topk(key, k, dim=1).indices
    return torch.gather(scores, 1, top), top


def mask_excluded(scores: torch.Tensor, exclude_idx: torch.Tensor) -> None:
    """Set ``scores[b, e]`` to NEG_INF, in place, for every id ``e`` of
    row ``b`` of ``exclude_idx [B, E]`` inside ``[0, I)``; -1 pads and
    stale ids outside the table are dropped."""
    excl = exclude_idx.long()
    keep = (excl >= 0) & (excl < scores.shape[1])
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    scores[rows.expand_as(excl)[keep], excl[keep]] = float(NEG_INF)


def _topk_scores(user_vecs: torch.Tensor, item_factors: torch.Tensor,
                 exclude_idx: torch.Tensor, k: int):
    """``user_vecs [B, K] @ item_factors.T``, exclusions masked, then the
    ordered top-k."""
    scores = user_vecs @ item_factors.T
    mask_excluded(scores, exclude_idx)
    return ordered_topk(scores, k)


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < min(n, hi):
        b *= 2
    return b


def _prepare_score_inputs(user_vecs, k: int, exclude_idx, n_items: int,
                          max_exclude: int, device: torch.device):
    """Serve-path shape discipline shared with the JAX package: bucket
    the batch to a power of two (zero-row padding), default/broadcast/
    bucket the exclusion lists (capped at ``max_exclude``, oldest
    dropped first), bucket k to powers of two. Identical bucketing keeps
    the two packages' kernels on the same shapes. Returns (user_vecs
    [B_bucket, K] f32, exclude [B_bucket, E_bucket] int32 — both on
    ``device`` — k, k_bucket, true_batch)."""
    if isinstance(user_vecs, torch.Tensor):
        user_vecs = user_vecs.to(device=device, dtype=torch.float32)
    else:
        user_vecs = torch.tensor(np.asarray(user_vecs, np.float32),
                                 device=device)
    user_vecs = torch.atleast_2d(user_vecs)
    B = user_vecs.shape[0]
    if exclude_idx is None:
        exclude_idx = np.full((B, 1), -1, dtype=np.int32)
    exclude_idx = np.asarray(exclude_idx, dtype=np.int32)
    if exclude_idx.ndim == 1:
        exclude_idx = np.broadcast_to(exclude_idx, (B, exclude_idx.shape[0]))
    exclude_idx = exclude_idx[:, -max_exclude:]
    e_bucket = _pow2_bucket(exclude_idx.shape[1], 1, max_exclude)
    if exclude_idx.shape[1] < e_bucket:
        pad = np.full((B, e_bucket - exclude_idx.shape[1]), -1, dtype=np.int32)
        exclude_idx = np.concatenate([exclude_idx, pad], axis=1)
    b_bucket = _pow2_bucket(B, 1, 1 << 30)
    if B < b_bucket:
        user_vecs = torch.cat([
            user_vecs,
            user_vecs.new_zeros((b_bucket - B, user_vecs.shape[1]))])
        exclude_idx = np.concatenate(
            [exclude_idx,
             np.full((b_bucket - B, exclude_idx.shape[1]), -1, np.int32)])
    k = min(k, n_items)
    k_bucket = min(_pow2_bucket(k, 8, 1 << 20), n_items)
    excl = torch.tensor(exclude_idx, dtype=torch.int32, device=device)
    return user_vecs.contiguous(), excl, k, k_bucket, B


class TopKScorer:
    """Scorer over a fixed item-factor matrix.

    Shape discipline as in the JAX package: ``k``, the exclusion width
    and the batch size are bucketed to powers of two, exclusions capped
    at ``max_exclude``. ``device`` is where the device route runs
    (``None`` means the card). ``placement``: "device", "host" or "auto"
    (default, ``PIO_SERVE_PLACEMENT`` overrides) — "auto" routes per
    call by the cost model in the module docstring. On a CUDA device the
    placement is always "device": "host" there raises, and the
    environment override does not apply."""

    def __init__(self, item_factors, max_exclude: int = 64,
                 placement: Optional[str] = None, device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if placement not in (None, "auto", "device"):
                raise ValueError(
                    f"placement {placement!r} on {self.device}: a scorer on "
                    "a CUDA device scores there (use device='cpu' for the "
                    "host route)")
            self.placement = "device"
        else:
            self.placement = (placement
                              or os.environ.get("PIO_SERVE_PLACEMENT", "auto"))
            if self.placement not in ("auto", "device", "host"):
                raise ValueError(f"bad placement {self.placement!r}")
        self._host_factors = np.ascontiguousarray(_as_numpy(item_factors),
                                                  dtype=np.float32)
        # device copy made lazily: a host-routed deployment never pays
        # device memory for the catalog
        self._device_factors: Optional[torch.Tensor] = None
        self.max_exclude = max_exclude

    @property
    def item_factors(self) -> torch.Tensor:
        factors = self._device_factors
        if factors is None:
            factors = torch.as_tensor(self._host_factors, device=self.device)
            self._device_factors = factors
        return factors

    def _route(self, batch: int) -> str:
        if self.placement != "auto":
            return self.placement
        n_items, rank = self._host_factors.shape
        flops = 2.0 * batch * n_items * rank
        host_est = flops / _HOST_FLOPS + batch * n_items * 1e-9
        device_est = (measured_dispatch_latency(self.device)
                      + flops / _DEVICE_FLOPS)
        return "host" if host_est < device_est else "device"

    @staticmethod
    def _host_topk(scores: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Partial-sort top-k over host scores [B, I] -> ([B,k], [B,k]).

        ``k >= n_items`` clamps, ``k == 0`` and empty tables return
        [B, 0], and the final sort is stable over a canonicalized
        partition, so exact ties rank by lowest index."""
        n_items = scores.shape[1]
        k = min(k, n_items)
        if k < n_items:
            part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
            part.sort(axis=1)
        else:
            part = np.broadcast_to(np.arange(n_items), scores.shape).copy()
        part_scores = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-part_scores, axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1)
        return np.take_along_axis(part_scores, order, axis=1), idx

    def _score_host(self, user_vecs, k, exclude_idx):
        uv = np.atleast_2d(np.asarray(_as_numpy(user_vecs), dtype=np.float32))
        scores = uv @ self._host_factors.T             # [B, I]
        if exclude_idx is not None:
            excl = np.asarray(exclude_idx, dtype=np.int64)
            if excl.ndim == 1:
                excl = np.broadcast_to(excl, (uv.shape[0], excl.shape[0]))
            excl = excl[:, -self.max_exclude:]
            rows = np.repeat(np.arange(uv.shape[0]), excl.shape[1])
            cols = excl.reshape(-1)
            keep = (cols >= 0) & (cols < scores.shape[1])
            scores[rows[keep], cols[keep]] = float(NEG_INF)
        return self._host_topk(scores, k)

    def score(self, user_vecs, k: int, exclude_idx: Optional[np.ndarray] = None,
              ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [B, k], item_indices [B, k]) as numpy; exclude_idx
        [B, E] or [E] with -1 padding, entries beyond ``max_exclude``
        dropped oldest first."""
        if self._route(_rows(user_vecs)) == "host":
            return self._score_host(user_vecs, k, exclude_idx)
        user_vecs, excl, k, k_bucket, B = _prepare_score_inputs(
            user_vecs, k, exclude_idx, self._host_factors.shape[0],
            self.max_exclude, self.device)
        scores, idx = _topk_scores(user_vecs, self.item_factors, excl,
                                   k_bucket)
        return (scores[:B, :k].cpu().numpy(),
                idx[:B, :k].to(torch.int32).cpu().numpy())

    def score_masked(self, user_vecs, k: int, mask: np.ndarray,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores, item_indices) over candidates where ``mask`` ([I] or
        [B, I] bool) is True; unfillable slots come back at
        ``score <= NEG_INF``."""
        uv = np.atleast_2d(np.asarray(_as_numpy(user_vecs), dtype=np.float32))
        m = np.asarray(mask, dtype=bool)
        if self._route(uv.shape[0]) == "host":
            scores = uv @ self._host_factors.T
            scores = np.where(m if m.ndim == 2 else m[None, :],
                              scores, float(NEG_INF))
            return self._host_topk(scores, k)
        B = uv.shape[0]
        b_bucket = _pow2_bucket(B, 1, 1 << 30)
        if B < b_bucket:   # batch bucketing (see _prepare_score_inputs)
            uv = np.concatenate([uv, np.zeros((b_bucket - B, uv.shape[1]),
                                              np.float32)])
            if m.ndim == 2:
                m = np.concatenate([m, np.zeros((b_bucket - B, m.shape[1]),
                                                bool)])
        n_items = self._host_factors.shape[0]
        k = min(k, n_items)
        k_bucket = min(_pow2_bucket(k, 8, 1 << 20), n_items)
        scores = torch.as_tensor(uv, device=self.device) @ self.item_factors.T
        scores = torch.where(torch.as_tensor(m, device=self.device), scores,
                             float(NEG_INF))
        s, i = ordered_topk(scores, k_bucket)
        return (s[:B, :k].cpu().numpy(),
                i[:B, :k].to(torch.int32).cpu().numpy())


def cosine_normalize(m: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Row-normalize so dot products become cosine similarities."""
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    return m / np.maximum(norms, eps)
