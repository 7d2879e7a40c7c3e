"""Fused embedding update: the table half of rowwise Adagrad as a Hopper
kernel.

Replaces ``predictionio_tpu/ops/pallas/embed_update.py``
(``_scatter_apply``, whose ``pallas_call`` runs ``_apply_kernel``,
called by ``pallas_rowwise_adagrad``). The kernel is CUDA C++ in
``csrc/embed_update.cu``; its header says how it is laid out and what
bounds it.

``embed_update(table, idx, grad, scale)`` computes ``table[idx[b]] +=
-scale[b] * grad[b]`` for every batch row, safe under duplicate indices,
and updates ``table`` IN PLACE: the JAX package donates the table
buffer to the same effect (``input_output_aliases``); here the caller's
tensor is the one that changes. Duplicates are summed with float
atomics on the card, so their order (and the last bits of a row that
several batch rows touch) may change from run to run.

:func:`rowwise_adagrad` is the caller: the accumulator ``index_add_``,
the read-after-add ``scale = lr / sqrt(acc[idx] + eps)`` and ``g2 =
mean(grad^2)`` stay torch ops, as they stay XLA in the JAX package.

Contract of :func:`embed_update`: CUDA tensors launch the kernel or
raise; CPU tensors take :func:`embed_update_reference`. Indices must lie
in ``[0, N)``; the kernel skips a row outside, the plain version raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from predictionio_torch.ops.kernels import LaunchCounter, load_library

#: kernel launches (one per table update that reaches the card)
launches = LaunchCounter("embed_update")


def _check(table, idx, grad, scale) -> None:
    if table.dim() != 2 or grad.dim() != 2 or idx.dim() != 1 or (
            scale.dim() != 1):
        raise ValueError("embed_update wants table [N, E], idx [B], "
                         "grad [B, E], scale [B]")
    B, E = grad.shape
    if table.shape[1] != E or idx.shape[0] != B or scale.shape[0] != B:
        raise ValueError(f"embed_update shapes disagree: table "
                         f"{tuple(table.shape)}, idx {tuple(idx.shape)}, "
                         f"grad {tuple(grad.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if table.dtype != torch.float32 or grad.dtype != torch.float32 or (
            scale.dtype != torch.float32):
        raise TypeError("embed_update wants float32 table, grad and scale")
    if idx.dtype != torch.int64:
        raise TypeError("embed_update wants int64 indices")
    if len({t.device for t in (table, idx, grad, scale)}) != 1:
        raise ValueError("embed_update inputs on different devices")
    if not table.is_contiguous():
        raise ValueError("embed_update updates a contiguous table in place")


def embed_update_reference(table: torch.Tensor, idx: torch.Tensor,
                           grad: torch.Tensor, scale: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version: an accumulating ``index_put_`` of the scaled
    gradient rows (the JAX package's ``table.at[idx].add``), in place."""
    table.index_put_((idx,), -scale[:, None] * grad, accumulate=True)
    return table


def _launcher():
    lib = load_library("embed_update")
    fn = lib.embed_update_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
        lib.embed_update_error_string.argtypes = [ctypes.c_int]
        lib.embed_update_error_string.restype = ctypes.c_char_p
    return lib, fn


def embed_update(table: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``table[idx[b]] += -scale[b] * grad[b]`` in place; returns
    ``table``. CUDA tensors launch the kernel on the current stream (no
    synchronisation) or raise; CPU tensors take the plain version."""
    _check(table, idx, grad, scale)
    if table.device.type == "cpu":
        return embed_update_reference(table, idx, grad, scale)
    if table.device.type != "cuda":
        raise ValueError(f"embed_update has no kernel for device "
                         f"{table.device}")
    idx, grad, scale = (t.contiguous() for t in (idx, grad, scale))
    B, E = grad.shape
    lib, fn = _launcher()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), grad.data_ptr(),
                 scale.data_ptr(), B, E, table.shape[0], stream)
    if err != 0:
        raise RuntimeError(
            f"embed_update launch failed (B={B}, E={E}, "
            f"N={table.shape[0]}): CUDA error {err}: "
            f"{lib.embed_update_error_string(err).decode(errors='replace')}")
    launches.add()
    return table


def adagrad_scale(acc: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
                  lr: float, eps: float = 1e-8) -> torch.Tensor:
    """The accumulator half of rowwise Adagrad, in place: ``acc[idx] +=
    mean(grad^2)`` (duplicates accumulate), then the per-row step
    ``lr / sqrt(acc[idx] + eps)`` read AFTER the whole add."""
    acc.index_add_(0, idx, torch.mean(grad * grad, dim=-1))
    return lr / torch.sqrt(acc[idx] + eps)


def rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor,
                    idx: torch.Tensor, grad: torch.Tensor, lr: float,
                    eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rowwise Adagrad with the table update in :func:`embed_update`
    (the counterpart of both ``pallas_rowwise_adagrad`` and the XLA
    ``_rowwise_adagrad``: on a CPU tensor the kernel's plain version is
    that torch form); ``table`` and ``acc`` are updated in place and
    returned."""
    scale = adagrad_scale(acc, idx, grad, lr, eps)
    return embed_update(table, idx, grad, scale), acc
