"""Fused dot + top-k: exact retrieval's hot path as a Hopper kernel.

Replaces ``predictionio_tpu/ops/pallas/topk_dot.py::_topk_dot_kernel``
(built by ``make_topk_dot``, called through ``topk_dot``). Per query
row, the top-k of ``q . item^T`` over an item table, never writing the
``[B, I]`` logits to device memory. The kernel is CUDA C++ in
``csrc/topk_dot.cu``; its header says how it is laid out.

What bounds it on the card: it must read the table once, ``I*D*4``
bytes (6.8 MB at MovieLens-20M, rank 64: about 2 us at 3.35 TB/s), and
do ``2*B*I*D`` f32 operations, far below the card's f32 rate at
``B <= 128``. At ``B = 1`` (a lone query) the launch dominates. The
design spreads the table over enough blocks that the read runs in
parallel, keeps every candidate list in shared memory, and merges the
per-tile lists in a second pass; one 64-bit key per candidate carries
the whole order.

Order: score descending, then item id ascending, in the kernel and in
``topk_dot_reference`` alike. The port agrees with itself exactly, and
with the JAX package up to exact ties (``jax.lax.top_k`` and the Pallas
kernel both prefer the lowest index too, but the Pallas contract only
promises "identical indices modulo exact ties").

Contract of :func:`topk_dot`: CUDA tensors launch the kernel or raise;
CPU tensors take :func:`topk_dot_reference`. ``items`` is the unpadded
table (the kernel masks the ragged tail itself). Unfillable slots
cannot occur because ``k <= I`` is required; excluded ids score
``NEG_INF`` and still fill slots when nothing better is left.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from predictionio_torch.ops.kernels import LaunchCounter, load_library
from predictionio_torch.ops.topk import mask_excluded

#: eligibility caps, the same as the TPU kernel's
MAX_K = 128
MAX_EXCLUDE = 64
MAX_BATCH = 128

#: keys per row in one pass-1 sort: the running top-K2 plus a chunk of
#: 256 - K2 items (csrc/topk_dot.cu kSlots)
SLOTS = 256
#: candidate keys per query row that pass 2 merges in shared memory
#: (32 KB); bounds the number of tiles
MAX_CANDIDATES = 4096

#: kernel launches (one per call that reaches the card)
launches = LaunchCounter("topk_dot")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def plan_tiles(n_items: int, k: int) -> Tuple[int, int, int, int]:
    """The kernel's work split for ``n_items`` items and top-``k``:
    ``(K2, chunk, chunks_per_tile, n_tiles)``. ``K2`` is ``k`` rounded
    up to a power of two, ``chunk = SLOTS - K2`` items per sort, and as
    many tiles as keep ``n_tiles * K2 <= MAX_CANDIDATES``."""
    k2 = _next_pow2(k)
    chunk = SLOTS - k2
    n_chunks = -(-n_items // chunk)
    max_tiles = max(1, MAX_CANDIDATES // k2)
    per_tile = -(-n_chunks // max_tiles)
    return k2, chunk, per_tile, -(-n_chunks // per_tile)


def _check(q: torch.Tensor, items: torch.Tensor, excl: torch.Tensor,
           k: int) -> None:
    if q.dim() != 2 or items.dim() != 2 or excl.dim() != 2:
        raise ValueError("topk_dot wants q [B, D], items [I, D], "
                         "exclude [B, E]")
    if q.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError("topk_dot wants float32 q and items")
    if excl.dtype != torch.int32:
        raise TypeError("topk_dot wants int32 exclusions")
    if not (q.device == items.device == excl.device):
        raise ValueError(f"topk_dot inputs on different devices: "
                         f"{q.device}, {items.device}, {excl.device}")
    if not (q.is_contiguous() and items.is_contiguous()
            and excl.is_contiguous()):
        raise ValueError("topk_dot wants contiguous inputs")
    B, D = q.shape
    I = items.shape[0]
    if items.shape[1] != D or excl.shape[0] != B:
        raise ValueError(f"topk_dot shapes disagree: q {tuple(q.shape)}, "
                         f"items {tuple(items.shape)}, "
                         f"exclude {tuple(excl.shape)}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"topk_dot batch {B} outside [1, {MAX_BATCH}]")
    if excl.shape[1] > MAX_EXCLUDE:
        raise ValueError(f"topk_dot exclusion width {excl.shape[1]} > "
                         f"{MAX_EXCLUDE}")
    if not 1 <= k <= min(MAX_K, I):
        raise ValueError(f"topk_dot k={k} outside [1, min({MAX_K}, I={I})]")
    if I >= 2 ** 31 - 1 or D < 1:
        raise ValueError(f"topk_dot table shape {tuple(items.shape)} "
                         "not supported")


def topk_dot_reference(q: torch.Tensor, items: torch.Tensor,
                       exclude_idx: torch.Tensor, k: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``q @ items.T`` in f32, exclusions
    (ids inside ``[0, I)``) set to ``NEG_INF``, then a stable descending
    sort — score descending, id ascending. Returns ``(scores [B, k]
    f32, idx [B, k] int32)``."""
    scores = q @ items.T
    mask_excluded(scores, exclude_idx)
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32).contiguous()


def _launcher():
    lib = load_library("topk_dot")
    fn = lib.topk_dot_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.topk_dot_error_string.argtypes = [ctypes.c_int]
        lib.topk_dot_error_string.restype = ctypes.c_char_p
    return lib, fn


def topk_dot(q: torch.Tensor, items: torch.Tensor,
             exclude_idx: torch.Tensor, k: int,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores [B, k] f32, idx [B, k] int32)``: the top-``k`` of
    ``q @ items.T`` per row, ``exclude_idx`` ids (-1 pads) masked.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation) or raise; CPU tensors take the plain version."""
    _check(q, items, exclude_idx, k)
    if q.device.type == "cpu":
        return topk_dot_reference(q, items, exclude_idx, k)
    if q.device.type != "cuda":
        raise ValueError(f"topk_dot has no kernel for device {q.device}")
    B, D = q.shape
    I, E = items.shape[0], exclude_idx.shape[1]
    k2, _chunk, per_tile, n_tiles = plan_tiles(I, k)
    dev = q.device
    cand = torch.empty((B, n_tiles, k2), dtype=torch.int64, device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    vec4 = int(D % 4 == 0 and items.data_ptr() % 16 == 0)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), items.data_ptr(), exclude_idx.data_ptr(),
                 cand.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                 B, I, D, E, k, k2, per_tile, n_tiles, vec4, stream)
    if err != 0:
        raise RuntimeError(
            f"topk_dot launch failed (B={B}, I={I}, D={D}, E={E}, k={k}): "
            f"CUDA error {err}: "
            f"{lib.topk_dot_error_string(err).decode(errors='replace')}")
    launches.add()
    return out_s, out_i
