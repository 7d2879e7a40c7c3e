"""Bidirectional id maps for string-id <-> dense-index conversion.

Copy of ``predictionio_tpu/data/bimap.py`` (the port imports nothing
of the JAX package). Pickled JAX models hold
``predictionio_tpu.data.bimap.BiMap`` objects; the deploy loader maps
them onto this class, so the two must keep the same attributes
(``_f``, ``_i``).

Behavior contract from the reference's BiMap
(data/.../storage/BiMap.scala:25,96+): an immutable bidirectional map
from string keys to contiguous integers 0..n-1 — the bridge between
entity ids and dense factor-matrix rows: lookups both ways, the
keys, values and items views, sub-maps, vectorized id -> index
conversion, ``string_int``/``string_long`` (first-seen order) and
``from_vocab``. ``EntityIdIxMap`` and ``EntityMap`` (ref:
storage/EntityMap.scala:27,68) pair the index with per-entity data.
"""

from __future__ import annotations

import itertools
import operator
from typing import (Dict, Generic, Hashable, Iterable, List, Optional,
                    Sequence, TypeVar)

import numpy as np

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

    def contains_value(self, value: V) -> bool:
        return value in self._i

    def to_dict(self) -> Dict[K, V]:
        return dict(self._f)

    def keys(self):
        return self._f.keys()

    def values(self):
        return self._f.values()

    def items(self):
        return self._f.items()

    # -- batch conversion ---------------------------------------------------
    def take(self, keys: Iterable[K]) -> "BiMap[K, V]":
        """Sub-map restricted to ``keys`` (ref: BiMap.scala take)."""
        return BiMap({k: self._f[k] for k in keys if k in self._f})

    def map_values(self, keys: Sequence[K]) -> List[V]:
        return [self._f[k] for k in keys]

    def to_index_array(self, keys: Sequence[K]) -> np.ndarray:
        """Vectorized key->int conversion (requires an int-valued BiMap)."""
        return np.fromiter((self._f[k] for k in keys), dtype=np.int64,
                           count=len(keys))

    def take_n(self, n: int) -> "BiMap[K, V]":
        """Sub-map of the first ``n`` entries (ref: BiMap.scala take(n))."""
        return BiMap(dict(itertools.islice(self._f.items(), n)))

    # -- constructors (ref: BiMap.scala stringInt) ---------------------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        """Index distinct keys to 0..n-1 in first-seen order."""
        forward: Dict[str, int] = {}
        for k in keys:
            if k not in forward:
                forward[k] = len(forward)
        return BiMap(forward)

    string_long = string_int

    @staticmethod
    def from_vocab(vocab: Sequence[str]) -> "BiMap[str, int]":
        """Already-distinct keys -> their positions (the dict-encoded
        bulk path: storage.EventColumns vocabularies index directly)."""
        forward = {k: i for i, k in enumerate(vocab)}
        if len(forward) != len(vocab):
            raise ValueError("from_vocab requires distinct keys")
        return BiMap(forward, {i: k for k, i in forward.items()})


class EntityIdIxMap:
    """Entity-id <-> dense-index map (ref: storage/EntityMap.scala:27
    ``EntityIdIxMap``): a thin wrapper around an int-valued BiMap that
    answers lookups in both directions through one object."""

    def __init__(self, id_to_ix: BiMap):
        self.id_to_ix = id_to_ix
        self.ix_to_id = id_to_ix.inverse()

    @staticmethod
    def from_keys(keys: Iterable[str]) -> "EntityIdIxMap":
        return EntityIdIxMap(BiMap.string_long(keys))

    @staticmethod
    def _as_ix(key) -> int:
        """Strict integer coercion: floats/None are lookup bugs, not
        indices — reject instead of truncating."""
        return operator.index(key)

    def __call__(self, key):
        """id -> ix for str keys, ix -> id for int keys (the reference's
        overloaded ``apply``)."""
        if isinstance(key, str):
            return self.id_to_ix[key]
        return self.ix_to_id[self._as_ix(key)]

    def __contains__(self, key) -> bool:
        if isinstance(key, str):
            return key in self.id_to_ix
        try:
            return self._as_ix(key) in self.ix_to_id
        except TypeError:
            return False

    def get(self, key, default=None):
        if isinstance(key, str):
            return self.id_to_ix.get(key, default)
        try:
            return self.ix_to_id.get(self._as_ix(key), default)
        except TypeError:
            return default

    def to_dict(self) -> Dict[str, int]:
        return self.id_to_ix.to_dict()

    def __len__(self) -> int:
        return len(self.id_to_ix)

    def take(self, n: int) -> "EntityIdIxMap":
        return EntityIdIxMap(self.id_to_ix.take_n(n))


class EntityMap(EntityIdIxMap, Generic[V]):
    """EntityIdIxMap + per-entity payload (ref: storage/EntityMap.scala:68
    ``EntityMap[A]``): id->data plus the dense index, so factor-matrix
    rows and entity payloads stay aligned. Used by engines that need
    per-entity features next to the index (experimental
    scala-parallel-recommendation-entitymap example)."""

    def __init__(self, id_to_data: Dict[str, V],
                 id_to_ix: Optional[BiMap] = None):
        if id_to_ix is None:
            id_to_ix = BiMap.string_long(id_to_data.keys())
        super().__init__(id_to_ix)
        self.id_to_data = dict(id_to_data)

    def data(self, key) -> V:
        if isinstance(key, str):
            return self.id_to_data[key]
        return self.id_to_data[self.ix_to_id[self._as_ix(key)]]

    def get_data(self, key, default=None):
        if isinstance(key, str):
            return self.id_to_data.get(key, default)
        try:
            rid = self.ix_to_id.get(self._as_ix(key))
        except TypeError:
            return default
        return default if rid is None else self.id_to_data.get(rid, default)

    def take(self, n: int) -> "EntityMap[V]":
        sub = self.id_to_ix.take_n(n)
        return EntityMap(
            {k: self.id_to_data[k] for k in sub.keys()}, sub
        )
