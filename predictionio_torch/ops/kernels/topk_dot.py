"""Fused dot + top-k: exact retrieval's hot path as a Hopper kernel.

Replaces ``predictionio_tpu/ops/pallas/topk_dot.py::_topk_dot_kernel``
(built by ``make_topk_dot``, called through ``topk_dot``). Per query
row, the top-k of ``q . item^T`` over an item table, never writing the
``[B, I]`` logits to device memory. The kernel is CUDA C++ in
``csrc/topk_dot.cu``; its header says how it is laid out.

What bounds it on the card: it must read the table once, ``I*D*4``
bytes (6.8 MB at MovieLens-20M, rank 64: about 2 us at 3.35 TB/s), and
do ``2*B*I*D`` f32 operations, far below the card's f32 rate at
``B <= 128``. At ``B = 1`` (a lone query) the launch, the dependent
load rounds and the merge dominate. The design is one launch: blocks
scan item ranges with their loads kept in flight, keep a running top-K2
per row in shared memory behind a threshold filter, and the last block
to finish merges every block's list through the same filter. One 64-bit
key per candidate carries the whole order.

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
import functools
import threading
from typing import Dict, Optional, Tuple

import torch

from predictionio_torch.ops.kernels import LaunchCounter, load_library
from predictionio_torch.ops.topk import mask_excluded

#: eligibility caps, the same as the TPU kernel's
MAX_K = 128
MAX_EXCLUDE = 64
MAX_BATCH = 128

#: the grid's default: this many blocks per SM, each with at least
#: MIN_ITEMS items, and at most MERGE_KEYS keys per row for the last
#: block to merge
BLOCKS_PER_SM = 2
MIN_ITEMS = 128
MERGE_KEYS = 8192

#: kernel launches (one per call that reaches the card)
launches = LaunchCounter("topk_dot")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def query_rows(batch: int) -> int:
    """Query rows a block scores at once (csrc/topk_dot.cu ``QB``)."""
    return 8 if batch >= 8 else 4 if batch >= 4 else 2 if batch >= 2 else 1


def lanes_per_item(dim: int, vec4: bool) -> int:
    """Lanes of a warp that load one item row: one load unit (16 bytes,
    or 4 without ``vec4``) each, a power of two in [8, 32]."""
    units = dim // 4 if vec4 else dim
    return min(32, max(8, _next_pow2(units)))


def plan_blocks(n_items: int, k: int, batch: int, sm_count: int,
                blocks: Optional[int] = None) -> Tuple[int, int, int]:
    """The kernel's grid for ``n_items`` items, top-``k`` and ``batch``
    query rows: ``(K2, n_blocks, per_block)``. ``K2`` is ``k`` rounded
    up to a power of two; block ``x`` scans items ``[x * per_block,
    min(n_items, (x + 1) * per_block))``, and every block has at least
    one. ``blocks`` asks for a block count; by default there are
    ``BLOCKS_PER_SM`` per SM over all query blocks, with at least
    ``MIN_ITEMS`` items each and at most ``MERGE_KEYS // K2`` blocks."""
    k2 = _next_pow2(k)
    if blocks is None:
        q_blocks = -(-batch // query_rows(batch))
        blocks = min(max(1, BLOCKS_PER_SM * sm_count // q_blocks),
                     -(-n_items // MIN_ITEMS), max(1, MERGE_KEYS // k2))
    per_block = -(-n_items // max(1, min(blocks, n_items)))
    return k2, -(-n_items // per_block), per_block


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
        fn.argtypes = [p] * 7 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
        lib.topk_dot_error_string.argtypes = [ctypes.c_int]
        lib.topk_dot_error_string.restype = ctypes.c_char_p
    return lib, fn


_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_tickets_lock = threading.Lock()


def _stream_tickets(dev: torch.device, stream: int) -> torch.Tensor:
    """The kernel's per-query-block counters for one stream: zeros made
    once (the kernel's last block puts each back to 0), never shared by
    two streams."""
    key = (dev.index, stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None:
            t = _tickets[key] = torch.zeros(MAX_BATCH, dtype=torch.int32,
                                            device=dev)
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cuda_device(t: torch.Tensor) -> torch.device:
    return (t.device if t.device.index is not None
            else torch.device("cuda", torch.cuda.current_device()))


def topk_dot(q: torch.Tensor, items: torch.Tensor,
             exclude_idx: torch.Tensor, k: int,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores [B, k] f32, idx [B, k] int32)``: the top-``k`` of
    ``q @ items.T`` per row, ``exclude_idx`` ids (-1 pads) masked.

    CUDA tensors launch the kernel on the current stream (one kernel, no
    synchronisation) on the planner's grid, or raise; CPU tensors take
    the plain version."""
    _check(q, items, exclude_idx, k)
    if q.device.type == "cpu":
        return topk_dot_reference(q, items, exclude_idx, k)
    if q.device.type != "cuda":
        raise ValueError(f"topk_dot has no kernel for device {q.device}")
    plan = plan_blocks(items.shape[0], k, q.shape[0],
                       _sm_count(_cuda_device(q).index))
    return _launch(q, items, exclude_idx, k, plan)


def _launch(q: torch.Tensor, items: torch.Tensor, exclude_idx: torch.Tensor,
            k: int, plan: Tuple[int, int, int],
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on checked CUDA inputs over ``plan``, a
    :func:`plan_blocks` grid ``(K2, n_blocks, per_block)``. Every grid
    gives the same bits."""
    B, D = q.shape
    I, E = items.shape[0], exclude_idx.shape[1]
    dev = _cuda_device(q)
    k2, n_blocks, per_block = plan
    qb = query_rows(B)
    lists = torch.empty((-(-B // qb), k2, n_blocks, qb), dtype=torch.int64,
                        device=dev)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    vec4 = (D % 4 == 0 and items.data_ptr() % 16 == 0
            and q.data_ptr() % 16 == 0)
    lib, fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _stream_tickets(dev, stream)
        err = fn(q.data_ptr(), items.data_ptr(), exclude_idx.data_ptr(),
                 lists.data_ptr(), tickets.data_ptr(), out_s.data_ptr(),
                 out_i.data_ptr(), B, I, D, E, k, k2, n_blocks, per_block,
                 lanes_per_item(D, vec4), int(vec4), stream)
    if err != 0:
        raise RuntimeError(
            f"topk_dot launch failed (B={B}, I={I}, D={D}, E={E}, k={k}): "
            f"CUDA error {err}: "
            f"{lib.topk_dot_error_string(err).decode(errors='replace')}")
    launches.add()
    return out_s, out_i
