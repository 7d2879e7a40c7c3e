"""Retrieval indexes: top-k by dot product over an item table.

Counterpart of ``predictionio_tpu/index/__init__.py``. This slice ports
the exact backend (``index/exact.py``: the ``topk_dot`` Hopper kernel,
with ``ops.topk.TopKScorer`` for shapes outside the kernel's caps). The
IVF backend and the Prometheus gauges wait for later slices.
"""

from __future__ import annotations

import abc
import os
from typing import Dict, Optional, Tuple

import numpy as np

BACKENDS = ("exact", "ivf")


class AnnIndex(abc.ABC):
    """One retrieval index over a ``[I, D]`` float32 vector table.

    ``search`` scores by dot product and returns ``(scores [B, k], idx
    [B, k])`` as numpy, masked / unfillable slots at ``score <=
    NEG_INF``; ``exclude`` entries are row indices (-1 padded) or None;
    ``upsert`` overwrites existing rows and appends new ones without a
    rebuild; ``stats()`` is the operator surface."""

    backend: str = "abstract"

    @abc.abstractmethod
    def build(self, item_vectors: np.ndarray) -> None:
        """(Re)build over the full table."""

    @abc.abstractmethod
    def search(self, query_vecs, k: int, exclude: Optional[np.ndarray] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-``k`` rows by dot product -> (scores [B,k], idx [B,k])."""

    @abc.abstractmethod
    def upsert(self, rows: np.ndarray, vectors: np.ndarray) -> None:
        """Overwrite (or append, when ``rows == len(index)``) rows."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    def stats(self) -> Dict[str, object]:
        return {"backend": self.backend, "size": len(self)}


def resolve_backend(backend: Optional[str] = None) -> str:
    """``PIO_INDEX_BACKEND`` beats the argument; ``auto`` -> exact."""
    value = os.environ.get("PIO_INDEX_BACKEND") or backend or "auto"
    value = str(value).strip().lower()
    if value in ("auto", ""):
        return "exact"
    if value not in BACKENDS:
        raise ValueError(
            f"unknown index backend {value!r} — one of auto/exact/ivf")
    return value


def make_index(item_vectors: Optional[np.ndarray] = None,
               backend: Optional[str] = None, kernel: str = "auto",
               **kwargs) -> AnnIndex:
    """Build an index over ``item_vectors`` (or an empty one to fill
    later). ``kernel`` is the exact backend's ``topk_dot`` flag
    (on/off/auto, ``PIO_INDEX_KERNEL`` overrides; it chooses on the CPU
    only, since on a card the kernel always serves); ``kwargs`` go to
    the backend (``device``, ``max_exclude``)."""
    name = resolve_backend(backend)
    if name != "exact":
        raise NotImplementedError(
            f"index backend {name!r} is not ported yet (ROADMAP.md); "
            "use 'exact'")
    from predictionio_torch.index.exact import ExactIndex

    index = ExactIndex(kernel=kernel, **kwargs)
    if item_vectors is not None:
        index.build(item_vectors)
    return index


__all__ = ["AnnIndex", "BACKENDS", "make_index", "resolve_backend"]
