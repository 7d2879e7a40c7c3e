"""Interaction rows as dict-encoded columns, and the host reductions the
ALS-family templates train on.

The JAX package's similar-product and e-commerce algorithms build
``(user, item)`` tuples and fold them into dicts in a Python loop over
every event (JAX ``models/similarproduct.py:234-256``,
``models/ecommerce.py:191-210``): tens of seconds at 20M events. Here
the rows stay codes into two vocabularies, and the folds are numpy:
``count_pairs`` (views -> a count per pair) and ``latest_pairs`` (the
last row of each pair in read order wins). They give the same
``(user, item, value)`` set as the JAX dicts; the pairs come out sorted
by ``(user row, item row)`` instead of in first-seen order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np

from predictionio_torch.data.bimap import BiMap


@dataclass
class Interactions:
    """(entity -> target) rows as codes into two vocabularies, in the
    order they were read (event-time order where the read asked for it),
    with one optional value per row."""

    entity_vocab: List[str]
    target_vocab: List[str]
    entity_idx: np.ndarray            # int [n] into entity_vocab
    target_idx: np.ndarray            # int [n] into target_vocab
    values: Optional[np.ndarray] = None  # float [n]

    @classmethod
    def from_rows(cls, rows: Iterable[tuple]) -> "Interactions":
        """``(entity, target)`` or ``(entity, target, value)`` tuples
        (the per-event row read) -> columns."""
        rows = list(rows)
        ents = BiMap.string_int(r[0] for r in rows)
        tgts = BiMap.string_int(r[1] for r in rows)
        n = len(rows)
        values = None
        if rows and len(rows[0]) > 2:
            values = np.fromiter((r[2] for r in rows), np.float64, count=n)
        return cls(entity_vocab=list(ents.keys()),
                   target_vocab=list(tgts.keys()),
                   entity_idx=np.fromiter((ents[r[0]] for r in rows),
                                          np.int64, count=n),
                   target_idx=np.fromiter((tgts[r[1]] for r in rows),
                                          np.int64, count=n),
                   values=values)

    def __len__(self) -> int:
        return len(self.entity_idx)

    def rows(self) -> List[tuple]:
        """The rows as ``(entity, target[, value])`` tuples, in order."""
        ents = [self.entity_vocab[j] for j in self.entity_idx]
        tgts = [self.target_vocab[j] for j in self.target_idx]
        if self.values is None:
            return list(zip(ents, tgts))
        return list(zip(ents, tgts, (float(v) for v in self.values)))

    def indexed(self, entity_ids: BiMap, target_ids: BiMap
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(entity rows, target rows, values) of the rows whose entity
        and target both have a row in the id maps; the others are
        dropped (the reference logs and drops unknown ids)."""
        emap = np.fromiter((entity_ids.get(v, -1) for v in self.entity_vocab),
                           np.int64, count=len(self.entity_vocab))
        tmap = np.fromiter((target_ids.get(v, -1) for v in self.target_vocab),
                           np.int64, count=len(self.target_vocab))
        u = emap[np.asarray(self.entity_idx, np.int64)]
        i = tmap[np.asarray(self.target_idx, np.int64)]
        keep = (u >= 0) & (i >= 0)
        vals = (np.ones(len(u), np.float64) if self.values is None
                else np.asarray(self.values, np.float64))
        return u[keep], i[keep], vals[keep]


def count_pairs(u: np.ndarray, i: np.ndarray, n_targets: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each distinct (u, i) pair once, with its row count as a float32
    value."""
    codes, counts = np.unique(u * np.int64(n_targets) + i,
                              return_counts=True)
    return (codes // n_targets, codes % n_targets,
            counts.astype(np.float32))


def latest_pairs(u: np.ndarray, i: np.ndarray, values: np.ndarray,
                 n_targets: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each distinct (u, i) pair once, with the value of its last row
    (rows are in event-time order: the latest event wins)."""
    codes = u * np.int64(n_targets) + i
    n = len(codes)
    uniq, first_from_end = np.unique(codes[::-1], return_index=True)
    last = n - 1 - first_from_end
    return (uniq // n_targets, uniq % n_targets,
            np.asarray(values, np.float64)[last].astype(np.float32))
