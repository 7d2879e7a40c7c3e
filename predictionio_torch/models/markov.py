"""Top-N Markov chain transition model (ref: e2/.../engine/MarkovChain.scala:25).

Counterpart of ``predictionio_tpu/models/markov.py``. Behavior contract
from the reference:

  - ``train`` takes a tally of state transitions (a sparse coordinate
    matrix), normalizes each row by its *full* row total, keeps the
    top-N entries per row (MarkovChain.scala:32-55).
  - ``predict`` multiplies a current-state probability vector through
    the kept transitions: next[j] = sum_i current[i] * P[i, j]
    (MarkovChain.scala:72-90).

The ragged per-row top-N lists are fixed-shape padded arrays
``indices[S, N]`` / ``probs[S, N]`` (pad prob = 0, a no-op in the sum),
built on the host with numpy as in JAX; ``predict`` is one
broadcast-multiply and ``index_add_`` on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from predictionio_torch.parallel.context import DeviceLike, OnDevice


@dataclass
class MarkovChainModel(OnDevice):
    """Padded top-N transition table; ``predict`` runs on the device."""

    indices: np.ndarray   # [n_states, top_n] int32 destination states
    probs: np.ndarray     # [n_states, top_n] float32 (0 = padding)
    top_n: int

    @property
    def n_states(self) -> int:
        return self.indices.shape[0]

    def predict(self, current_state: Sequence[float]) -> List[float]:
        """Next-state probabilities (ref: MarkovChainModel.predict :72)."""
        current = np.asarray(current_state, dtype=np.float32)
        if current.shape[0] != self.n_states:
            raise ValueError(
                f"current_state has {current.shape[0]} entries, "
                f"model has {self.n_states} states")
        dev = self.serving_device()
        cur = torch.from_numpy(current).to(dev)
        probs = torch.from_numpy(np.asarray(self.probs, np.float32)).to(dev)
        idx = torch.from_numpy(np.asarray(self.indices, np.int64)).to(dev)
        weighted = probs * cur[:, None]
        out = torch.zeros(self.n_states, dtype=probs.dtype, device=dev)
        out.index_add_(0, idx.reshape(-1), weighted.reshape(-1))
        return [float(x) for x in out.cpu().numpy()]

    def transition_row(self, state: int) -> List[Tuple[int, float]]:
        """Kept (destination, probability) pairs of one row, by destination."""
        pairs = [(int(j), float(p))
                 for j, p in zip(self.indices[state], self.probs[state])
                 if p > 0.0]
        return sorted(pairs)


def train(entries: Tuple[np.ndarray, np.ndarray, np.ndarray], n_states: int,
          top_n: int, device: DeviceLike = None) -> MarkovChainModel:
    """Build the model from COO transition tallies (ref: MarkovChain.train
    :32): ``entries`` is (row, col, value) arrays of the tally matrix;
    each row is normalized by its full total and only its ``top_n``
    largest entries are kept (dropped mass is discarded, not
    renormalized). The model predicts on ``device``."""
    rows = np.asarray(entries[0], dtype=np.int64)
    cols = np.asarray(entries[1], dtype=np.int64)
    vals = np.asarray(entries[2], dtype=np.float64)
    if top_n < 1:
        raise ValueError("top_n must be >= 1")
    if len(rows) and (rows.min() < 0 or rows.max() >= n_states
                      or cols.min() < 0 or cols.max() >= n_states):
        raise ValueError("COO entries reference states outside [0, n_states)")

    indices = np.zeros((n_states, top_n), dtype=np.int32)
    probs = np.zeros((n_states, top_n), dtype=np.float32)
    if not len(rows):
        return MarkovChainModel(indices=indices, probs=probs,
                                top_n=top_n).to(device)

    # combine duplicate (row, col) tallies
    flat = rows * n_states + cols
    uniq, inverse = np.unique(flat, return_inverse=True)
    summed = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(summed, inverse, vals)
    rows_u, cols_u = uniq // n_states, uniq % n_states

    totals = np.zeros(n_states, dtype=np.float64)
    np.add.at(totals, rows_u, summed)

    # per-row top-N: sort by (row asc, value desc), keep the first top_n
    # of each row, then re-sort the kept entries by (row, col)
    # (the reference stores them column-sorted, MarkovChain.scala:45)
    order = np.lexsort((-summed, rows_u))
    rows_s, cols_s, vals_s = rows_u[order], cols_u[order], summed[order]
    row_starts = np.searchsorted(rows_s, rows_s)
    rank = np.arange(len(rows_s)) - row_starts
    keep = rank < top_n
    rows_k, cols_k, vals_k = rows_s[keep], cols_s[keep], vals_s[keep]

    order2 = np.lexsort((cols_k, rows_k))
    rows_k, cols_k, vals_k = rows_k[order2], cols_k[order2], vals_k[order2]
    slot = np.arange(len(rows_k)) - np.searchsorted(rows_k, rows_k)
    indices[rows_k, slot] = cols_k
    probs[rows_k, slot] = (vals_k / totals[rows_k]).astype(np.float32)
    return MarkovChainModel(indices=indices, probs=probs,
                            top_n=top_n).to(device)
