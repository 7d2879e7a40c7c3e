"""Typed JSON property bags.

Copy of ``predictionio_tpu/data/datamap.py`` (ref:
data/.../storage/DataMap.scala:38, PropertyMap.scala): ``DataMap`` is an
immutable map of field name -> JSON value with typed accessors — ``get``
raising on a missing field, ``get_opt`` returning None — and merges in
which the right-hand side wins per key; ``PropertyMap`` adds the first
and last update times that folding an entity's
``$set``/``$unset``/``$delete`` events gives (``data/aggregation.py``).
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Any, Iterator, Mapping, Optional

_MISSING = object()


class DataMapError(KeyError):
    """Raised when a required field is missing (ref: DataMap.scala getException)."""


def _freeze(value: Any):
    """Hashable, ==-consistent view of a JSON value (1 and 1.0 freeze equal)."""
    if isinstance(value, dict):
        return frozenset((k, _freeze(v)) for k, v in value.items())
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


class DataMap:
    """Immutable JSON property bag with typed accessors.

    Deliberately NOT a collections.abc.Mapping: the reference contract
    (DataMap.scala ``get[T]`` raising on a missing field) conflicts with
    ``Mapping.get``'s return-default semantics, so DataMap implements
    the read-only dict protocol itself.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: dict = dict(fields) if fields else {}

    # -- dict protocol ------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        try:
            return self._fields[key]
        except KeyError:
            raise DataMapError(f"The field {key} is required.")

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def keys(self):
        return self._fields.keys()

    def values(self):
        return self._fields.values()

    def items(self):
        return self._fields.items()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self):
        return hash(frozenset((k, _freeze(v)) for k, v in self._fields.items()))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- typed accessors ----------------------------------------------------
    def get(self, key: str, expected_type: Optional[type] = None, default: Any = _MISSING) -> Any:
        """Return the field value; raise DataMapError if absent (ref: get[T]).

        If ``expected_type`` is given, coerce compatible primitives
        (int->float) and raise TypeError on mismatch. For dict.get
        compatibility, a non-type second positional argument is treated
        as a default instead.
        """
        if expected_type is not None and not isinstance(expected_type, type):
            default, expected_type = expected_type, None
        if key not in self._fields:
            if default is not _MISSING:
                return default
            raise DataMapError(f"The field {key} is required.")
        value = self._fields[key]
        if expected_type is not None:
            value = _coerce(key, value, expected_type)
        return value

    def get_opt(self, key: str, expected_type: Optional[type] = None, default: Any = None) -> Any:
        if key not in self._fields:
            return default
        return self.get(key, expected_type)

    def get_or_else(self, key: str, default: Any) -> Any:
        return self._fields.get(key, default)

    # -- transformation -----------------------------------------------------
    def merge(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """Right-biased merge (ref: DataMap.scala ``++``)."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def remove(self, keys) -> "DataMap":
        """Drop the given keys (ref: DataMap.scala ``--``)."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def keyset(self) -> set:
        return set(self._fields)

    def to_dict(self) -> dict:
        return dict(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        return cls(json.loads(s))


def _coerce(key: str, value: Any, expected_type: type) -> Any:
    if expected_type is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if expected_type is int and isinstance(value, bool):
        raise TypeError(f"field {key}: expected int, got bool")
    if not isinstance(value, expected_type):
        raise TypeError(
            f"field {key}: expected {expected_type.__name__}, got {type(value).__name__}"
        )
    return value


class PropertyMap(DataMap):
    """DataMap + first/last update times (ref: PropertyMap.scala)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.to_dict()!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.to_dict() == other.to_dict()
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__
