"""Ragged -> static-shape conversion (host side).

Counterpart of ``predictionio_tpu/ops/ragged.py``. Event streams
produce ragged per-entity lists (each user rates a different number of
items); the device wants fixed shapes, so the COO ratings are binned
into fixed-length *virtual rows* (the segmented layout the ALS trainer
reads):

  COO (group_idx, item_idx, value)  ->
      idx  [R, L]  int32   (0 where padded)
      val  [R, L]  float32 (0 where padded)
      mask [R, L]  float32 1/0
      seg  [R]     int32   the group each row belongs to
      counts [G]   int32   group sizes (after the optional cap)

A group with c entries takes ceil(c / L) rows, so no rating is dropped
unless ``max_len`` caps the group (keeping its latest entries).

Two routes give the same bits as the JAX package's: at or above
``_NATIVE_MIN_NNZ`` ratings the fill is one native pass
(``native/raggedbin.cpp``), below it numpy sorts and scatters.
``build_compressed_segmented`` plans and fills the transfer-compressed
wire streams in one native call. ``PIO_NATIVE_RAGGED=0`` takes the numpy
route everywhere; otherwise a native library that fails to build raises
``NativeBuildError``.

``build_padded_groups`` gives the per-group padded layout (one row a
group, ``[G, L]`` with ``counts`` capped at L) through numpy alone, the
same bits as either of the JAX package's routes: a group longer than
``max_len`` keeps its latest entries, and the group axis pads to
``group_multiple``. Nothing of the port reads it at the sizes where a
native fill would pay.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from predictionio_torch import native

#: below this many ratings the numpy route wins (no call overhead)
_NATIVE_MIN_NNZ = 200_000


def _native_lib(nnz: int) -> Optional[ctypes.CDLL]:
    """The native binning library for an input of ``nnz`` ratings, or
    None for the numpy route (below the cutover, or PIO_NATIVE_RAGGED=0).
    A build failure raises NativeBuildError."""
    if nnz < _NATIVE_MIN_NNZ or os.environ.get("PIO_NATIVE_RAGGED",
                                                 "1") == "0":
        return None
    lib = native.load_library("raggedbin")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.rb_fill_segmented.restype = ctypes.c_int
    lib.rb_fill_segmented.argtypes = [
        i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, f32p, f32p, i32p]
    lib.rb_bin_compressed.restype = ctypes.c_int
    lib.rb_bin_compressed.argtypes = [
        i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.POINTER(native.CSide)]
    lib.rb_free.restype = None
    lib.rb_free.argtypes = [ctypes.c_void_p]
    return lib


@dataclass
class PaddedGroups:
    """Static-shape view of ragged per-group data (row == group)."""

    idx: np.ndarray     # [G, L] int32
    val: np.ndarray     # [G, L] float32
    mask: np.ndarray    # [G, L] float32
    counts: np.ndarray  # [G] int32 (capped at L)
    n_groups: int       # true number of groups (before group-axis padding)

    @property
    def max_len(self) -> int:
        return self.idx.shape[1]


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple if multiple > 1 else n


@dataclass
class SegmentedGroups:
    """Static-shape view of ragged data as fixed-length virtual rows.

    Rows carry their group via ``seg``, so per-row partial results (ALS
    partial Gramians, which are additive) can be segment-summed back to
    groups. Groups are split contiguously into ``n_shards`` ranges; each
    shard's rows are padded to the common ``rows_per_shard``, and
    ``seg`` holds the group index local to the shard.
    """

    idx: np.ndarray      # [S*R_s, L] int32 (0 where padded)
    val: np.ndarray      # [S*R_s, L] float32
    mask: np.ndarray     # [S*R_s, L] float32 1/0
    seg: np.ndarray      # [S*R_s] int32, nondecreasing within each shard
                         # (padded rows carry the shard's last local id;
                         # their mask is all zero)
    counts: np.ndarray   # [S*G_s] int32 group sizes (post-cap)
    n_groups: int        # true number of groups (before padding)
    n_shards: int
    rows_per_shard: int
    groups_per_shard: int
    row_block: int       # rows the half-step takes at once (divides R_s)
    group_block: int     # groups solved at once (divides G_s)

    @property
    def seg_len(self) -> int:
        return self.idx.shape[1]

    @property
    def total_rows(self) -> int:
        return self.idx.shape[0]


def auto_seg_len(
    counts: np.ndarray, row_cost_slots: float = 16.0,
    lo: int = 16, hi: int = 512,
) -> int:
    """The virtual-row length minimizing the estimated cost
    ``rows(L) * (L + row_cost_slots)``: every slot, padded or not, is
    gathered and multiplied, and every row adds a [K, K] partial
    Gramian (``row_cost_slots`` prices it in slots). Evaluated exactly
    from the group-size histogram."""
    c = counts[counts > 0]
    if len(c) == 0:
        return lo
    best_L, best_cost = lo, None
    for L in range(lo, hi + 1, 16):
        rows = int(np.sum(-(-c // L)))
        cost = rows * (L + row_cost_slots)
        if best_cost is None or cost < best_cost:
            best_L, best_cost = L, cost
    return best_L


def build_segmented_groups(
    group_idx: np.ndarray,
    item_idx: np.ndarray,
    values: np.ndarray,
    n_groups: int,
    seg_len="auto",
    max_len: Optional[int] = None,
    n_shards: int = 1,
    block_size: int = 4096,
    row_cost_slots: float = 16.0,
) -> SegmentedGroups:
    """Bin COO triples into fixed-length virtual rows with segment ids.

    ``seg_len`` is the virtual-row length, or ``"auto"`` to size it from
    the group-size distribution (``auto_seg_len``). ``block_size`` bounds
    the row and group blocks; both axes of each shard are padded to
    exact multiples of the chosen blocks (returned on the result).
    ``max_len`` optionally caps a group's entries (keeping the latest)
    before row splitting; None keeps everything.
    """
    group_idx = np.asarray(group_idx, dtype=np.int64)
    item_idx = np.asarray(item_idx, dtype=np.int64)
    values = np.asarray(values, dtype=np.float32)
    if not (len(group_idx) == len(item_idx) == len(values)):
        raise ValueError("COO arrays must have equal length")
    nnz = len(group_idx)

    counts_true = np.bincount(group_idx, minlength=n_groups).astype(np.int64)
    if isinstance(seg_len, str):
        if seg_len != "auto":
            raise ValueError(f"seg_len must be an int or 'auto', got {seg_len!r}")
        capped = (counts_true if max_len is None
                  else np.minimum(counts_true, max_len))
        seg_len = auto_seg_len(capped, row_cost_slots)
    L = max(pad_to_multiple(seg_len, 8), 8)
    g_raw = pad_to_multiple(max(1, -(-n_groups // n_shards)), 8)
    group_block = min(block_size, g_raw)
    g_per_shard = pad_to_multiple(g_raw, group_block)
    G = g_per_shard * n_shards
    counts_pad = np.zeros(G, dtype=np.int64)
    counts_pad[:n_groups] = counts_true
    kept_counts = counts_pad if max_len is None else np.minimum(counts_pad, max_len)
    rows_per_group = -(-kept_counts // L)          # ceil; 0 for empty groups

    shard_of_group = np.arange(G) // g_per_shard
    rows_by_shard = np.bincount(
        shard_of_group, weights=rows_per_group, minlength=n_shards
    ).astype(np.int64)
    rows_max = max(int(rows_by_shard.max()), 1)
    row_block = min(block_size, pad_to_multiple(rows_max, 8))
    R_s = pad_to_multiple(rows_max, row_block)

    # first row (global, shard-padded layout) of each group: a per-shard
    # exclusive cumsum of rows per group
    rpg = rows_per_group.reshape(n_shards, g_per_shard)
    start_in_shard = np.cumsum(rpg, axis=1) - rpg
    group_row_start = (
        start_in_shard + np.arange(n_shards)[:, None] * R_s
    ).reshape(G)

    idx = np.zeros((n_shards * R_s, L), dtype=np.int32)
    val = np.zeros((n_shards * R_s, L), dtype=np.float32)
    mask = np.zeros((n_shards * R_s, L), dtype=np.float32)
    # padded (all-zero-mask) rows point at the shard's last local group,
    # so seg stays nondecreasing per shard; real rows overwrite below
    seg = np.full(n_shards * R_s, g_per_shard - 1, dtype=np.int32)

    lib = _native_lib(nnz)
    if nnz and lib is not None:
        # one cursor walk in arrival order: no argsort, no scattered
        # fancy-index writes
        rc = lib.rb_fill_segmented(
            np.ascontiguousarray(group_idx), np.ascontiguousarray(item_idx),
            np.ascontiguousarray(values), nnz, n_groups,
            np.ascontiguousarray(group_row_start[:n_groups]),
            np.ascontiguousarray(counts_true[:n_groups]),
            -1 if max_len is None else max_len, L, g_per_shard,
            idx.reshape(-1), val.reshape(-1), mask.reshape(-1), seg)
        if rc != 0:
            raise ValueError("group index out of range in native binning")
    elif nnz:
        order = np.argsort(group_idx, kind="stable")
        g_sorted = group_idx[order]
        i_sorted = item_idx[order]
        v_sorted = values[order]
        starts = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(counts_true, out=starts[1:])
        pos_in_group = np.arange(nnz, dtype=np.int64) - starts[g_sorted]
        if max_len is not None:
            # keep the LAST max_len entries (recency wins)
            keep_from = counts_true[g_sorted] - max_len
            kept = pos_in_group >= keep_from
            g_sorted = g_sorted[kept]
            i_sorted = i_sorted[kept]
            v_sorted = v_sorted[kept]
            pos_in_group = pos_in_group[kept] - np.maximum(keep_from[kept], 0)
        row = group_row_start[g_sorted] + pos_in_group // L
        slot = pos_in_group % L
        idx[row, slot] = i_sorted.astype(np.int32)
        val[row, slot] = v_sorted
        mask[row, slot] = 1.0
        seg[row] = (g_sorted % g_per_shard).astype(np.int32)

    counts_out = kept_counts.astype(np.int32)
    return SegmentedGroups(
        idx=idx, val=val, mask=mask, seg=seg, counts=counts_out,
        n_groups=n_groups, n_shards=n_shards, rows_per_shard=R_s,
        groups_per_shard=g_per_shard, row_block=row_block,
        group_block=group_block,
    )


def build_compressed_segmented(
    group_idx: np.ndarray,
    item_idx: np.ndarray,
    values: np.ndarray,
    n_groups: int,
    seg_len="auto",
    max_len: Optional[int] = None,
    n_shards: int = 1,
    block_size: int = 4096,
    row_cost_slots: float = 16.0,
):
    """One native pass from COO to the transfer-compressed segmented
    layout (``rb_bin_compressed``): it plans the blocks and fills the
    wire streams (uint16 idx_lo [+ uint8 idx_hi], uint8 affine value
    codes or f32 + mask) into aligned buffers, bit-identical to
    ``ops.als.compress_side(build_segmented_groups(...))`` without the
    [R, L] float32 val/mask and int32 idx intermediates.

    Returns a ``data.storage.BinnedSide`` of zero-copy views over the
    native buffers, or None where ``_native_lib`` picks the numpy route
    (the caller then takes the two-stage route)."""
    from predictionio_torch.data.storage import BinnedSide

    group_idx = np.ascontiguousarray(group_idx, dtype=np.int64)
    item_idx = np.ascontiguousarray(item_idx, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float32)
    if not (len(group_idx) == len(item_idx) == len(values)):
        raise ValueError("COO arrays must have equal length")
    nnz = len(group_idx)
    lib = _native_lib(nnz)
    if lib is None:
        return None
    if isinstance(seg_len, str):
        if seg_len != "auto":
            raise ValueError(
                f"seg_len must be an int or 'auto', got {seg_len!r}")
        seg_len_i = -1
    else:
        seg_len_i = int(seg_len)
    out = native.CSide()
    rc = lib.rb_bin_compressed(
        group_idx, item_idx, values, nnz, n_groups, seg_len_i,
        -1 if max_len is None else int(max_len), int(n_shards),
        int(block_size), float(row_cost_slots), ctypes.byref(out))
    if rc == -1:
        raise ValueError("group index out of range in native binning")
    if rc == -3:
        raise ValueError("vocab exceeds the 24-bit index wire format "
                         "(widen idx_hi before raising this cap)")
    if rc != 0:
        raise MemoryError("native compressed binning could not allocate")
    return BinnedSide(**native.unpack_cside(out, native.NativeOwner(
        lib.rb_free)))


def build_padded_groups(
    group_idx: np.ndarray,
    item_idx: np.ndarray,
    values: np.ndarray,
    n_groups: int,
    max_len: Optional[int] = None,
    group_multiple: int = 1,
    len_multiple: int = 8,
) -> PaddedGroups:
    """Bin COO triples into per-group padded blocks.

    ``max_len`` caps a group's entries, keeping its latest (None sizes L
    to the longest group); ``group_multiple`` pads the group axis;
    ``len_multiple`` rounds L up. A group id outside ``[0, n_groups)``
    raises ValueError.
    """
    group_idx = np.asarray(group_idx, dtype=np.int64)
    item_idx = np.asarray(item_idx, dtype=np.int64)
    values = np.asarray(values, dtype=np.float32)
    if not (len(group_idx) == len(item_idx) == len(values)):
        raise ValueError("COO arrays must have equal length")
    nnz = len(group_idx)
    if nnz and (group_idx.min() < 0 or group_idx.max() >= n_groups):
        raise ValueError("group index out of range")

    counts_true = np.bincount(group_idx, minlength=n_groups).astype(np.int64)
    longest = int(counts_true.max()) if nnz else 0
    L = longest if max_len is None else min(max_len, longest) if longest else 0
    L = max(pad_to_multiple(max(L, 1), len_multiple), len_multiple)
    G = pad_to_multiple(max(n_groups, 1), group_multiple)

    idx = np.zeros((G, L), dtype=np.int32)
    val = np.zeros((G, L), dtype=np.float32)
    mask = np.zeros((G, L), dtype=np.float32)

    if nnz:
        # a stable sort by group keeps each group's arrival (time) order,
        # so keeping its last L entries keeps the latest
        order = np.argsort(group_idx, kind="stable")
        g_sorted = group_idx[order]
        starts = np.zeros(n_groups + 1, dtype=np.int64)
        np.cumsum(counts_true, out=starts[1:])
        pos_in_group = np.arange(nnz, dtype=np.int64) - starts[g_sorted]
        kept = pos_in_group >= counts_true[g_sorted] - L
        slot = pos_in_group - np.maximum(counts_true[g_sorted] - L, 0)
        g_k, s_k = g_sorted[kept], slot[kept]
        idx[g_k, s_k] = item_idx[order][kept].astype(np.int32)
        val[g_k, s_k] = values[order][kept]
        mask[g_k, s_k] = 1.0

    counts_out = np.zeros(G, dtype=np.int32)
    counts_out[:n_groups] = np.minimum(counts_true, L).astype(np.int32)
    return PaddedGroups(idx=idx, val=val, mask=mask, counts=counts_out,
                        n_groups=n_groups)
