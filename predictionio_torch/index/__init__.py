"""Retrieval indexes: top-k by dot product over an item table.

Counterpart of ``predictionio_tpu/index/__init__.py``:

  ``index/exact.py``   exact retrieval: the ``topk_dot`` Hopper kernel,
                       with ``ops.topk.TopKScorer`` for shapes outside
                       the kernel's caps.
  ``index/ivf.py``     approximate host retrieval: a copy of the JAX
                       package's IVF (k-means coarse quantizer, the
                       recall-gated ``nprobe`` autotune, int8 with a
                       full-precision re-rank, upsert). It stays numpy
                       on the host, as in the JAX package.
  ``index/recall.py``  recall@k against brute force.

Both backends export the JAX families ``pio_index_build_seconds``,
``pio_index_size_items``, ``pio_index_queries_total`` and
``pio_index_recall`` (``MEASURED_RECALL``), and price their tables in
the device-memory ledger under their owning model's label.
"""

from __future__ import annotations

import abc
import os
from typing import Dict, Optional, Tuple

import numpy as np

from predictionio_torch.obs import metrics

BUILD_SECONDS = metrics.gauge(
    "pio_index_build_seconds",
    "Wall seconds of the last ANN index build, per backend",
    ("backend",),
)
SIZE_ITEMS = metrics.gauge(
    "pio_index_size_items",
    "Items currently held by the ANN index, per backend",
    ("backend",),
)
QUERIES_TOTAL = metrics.counter(
    "pio_index_queries_total",
    "ANN index search calls, per backend",
    ("backend",),
)
MEASURED_RECALL = metrics.gauge(
    "pio_index_recall",
    "Last measured recall@k of the index against brute force, per "
    "backend (exact backends pin 1.0; IVF measures at build)",
    ("backend",),
)

BACKENDS = ("exact", "ivf")


class AnnIndex(abc.ABC):
    """One retrieval index over a ``[I, D]`` float32 vector table.

    ``search`` scores by dot product and returns ``(scores [B, k], idx
    [B, k])`` as numpy, masked / unfillable slots at ``score <=
    NEG_INF``; ``exclude`` entries are row indices (-1 padded) or None;
    ``upsert`` overwrites existing rows and appends new ones without a
    rebuild; ``stats()`` is the operator surface."""

    backend: str = "abstract"

    #: device-memory ledger attribution (obs/memacct.py): the owning
    #: model sets this to ITS label before build, so the index's bytes
    #: land under pio_model_device_bytes{model=<owner>,component=index}
    mem_model: Optional[str] = None

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

    # -- shared bookkeeping ---------------------------------------------------
    def _note_build(self, seconds: float) -> None:
        BUILD_SECONDS.labels(self.backend).set(seconds)
        SIZE_ITEMS.labels(self.backend).set(float(len(self)))

    def _register_mem(self, nbytes: int) -> None:
        """Price this index's resident tables in the device-memory
        ledger, re-pricing under the same owner."""
        from predictionio_torch.obs import memacct

        memacct.LEDGER.register(
            self, self.mem_model or f"index:{self.backend}", "index",
            int(nbytes))

    def _note_query(self) -> None:
        QUERIES_TOTAL.labels(self.backend).inc()


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
    the backend: ``device`` and ``max_exclude`` to the exact one (the
    IVF index lives on the host and takes neither), ``mem_model`` (the
    ledger label) to both, the rest (``nlist``, ``nprobe``,
    ``quantize``, ...) to IVF."""
    name = resolve_backend(backend)
    mem_model = kwargs.pop("mem_model", None)
    if name == "exact":
        from predictionio_torch.index.exact import ExactIndex

        index: AnnIndex = ExactIndex(kernel=kernel, **kwargs)
    else:
        from predictionio_torch.index.ivf import IVFIndex

        kwargs.pop("device", None)
        kwargs.pop("max_exclude", None)
        index = IVFIndex(**kwargs)
    index.mem_model = mem_model
    if item_vectors is not None:
        index.build(np.asarray(item_vectors, np.float32))
    return index


__all__ = [
    "AnnIndex",
    "BACKENDS",
    "make_index",
    "resolve_backend",
    "BUILD_SECONDS",
    "SIZE_ITEMS",
    "QUERIES_TOTAL",
    "MEASURED_RECALL",
]
