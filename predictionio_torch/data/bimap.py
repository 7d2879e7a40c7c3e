"""Bidirectional id maps for string-id <-> dense-index conversion.

Copy of ``predictionio_tpu/data/bimap.py`` trimmed to ``BiMap`` (the
port imports nothing of the JAX package). Pickled JAX models hold
``predictionio_tpu.data.bimap.BiMap`` objects; the deploy loader maps
them onto this class, so the two must keep the same attributes
(``_f``, ``_i``).

Behavior contract from the reference's BiMap
(data/.../storage/BiMap.scala:25,96+): an immutable bidirectional map
from string keys to contiguous integers 0..n-1 — the bridge between
entity ids and dense factor-matrix rows: lookups both ways, the
keys, values and items views, ``string_int`` (first-seen order) and
``from_vocab``.
"""

from __future__ import annotations

from typing import (Dict, Generic, Hashable, Iterable, Optional, Sequence,
                    TypeVar)

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    """Immutable bidirectional map; values must be unique."""

    def __init__(self, forward: Dict[K, V], _inverse: Optional[Dict[V, K]] = None):
        if _inverse is None:
            self._f = dict(forward)
            _inverse = {v: k for k, v in self._f.items()}
            if len(_inverse) != len(self._f):
                raise ValueError("BiMap values must be unique")
        else:
            # private fast path (inverse()): both dicts already exist and
            # stay immutable — no O(n) copy
            self._f = forward
        self._i = _inverse

    # -- access -------------------------------------------------------------
    def __getitem__(self, key: K) -> V:
        return self._f[key]

    def get(self, key: K, default=None):
        return self._f.get(key, default)

    def __contains__(self, key: K) -> bool:
        return key in self._f

    def __len__(self) -> int:
        return len(self._f)

    def inverse(self) -> "BiMap[V, K]":
        return BiMap(self._i, self._f)

    def keys(self):
        return self._f.keys()

    def values(self):
        return self._f.values()

    def items(self):
        return self._f.items()

    # -- constructors (ref: BiMap.scala stringInt) ---------------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Index distinct keys to 0..n-1 in first-seen order."""
        forward: Dict[str, int] = {}
        for k in keys:
            if k not in forward:
                forward[k] = len(forward)
        return BiMap(forward)

    @staticmethod
    def from_vocab(vocab: Sequence[str]) -> "BiMap[str, int]":
        """Already-distinct keys -> their positions (the dict-encoded
        bulk path: storage.EventColumns vocabularies index directly)."""
        forward = {k: i for i, k in enumerate(vocab)}
        if len(forward) != len(vocab):
            raise ValueError("from_vocab requires distinct keys")
        return BiMap(forward, {i: k for k, i in forward.items()})
