"""Typed JSON property bags.

Copy of ``predictionio_tpu/data/datamap.py`` trimmed to ``DataMap``
(ref: data/.../storage/DataMap.scala:38): an immutable map of field
name -> JSON value with typed accessors — ``get`` raising on a missing
field, ``get_opt`` returning None.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Optional

_MISSING = object()


class DataMapError(KeyError):
    """Raised when a required field is missing (ref: DataMap.scala
    getException)."""


class DataMap:
    """Immutable JSON property bag with typed accessors (not a
    ``Mapping``: ``get`` raises on a missing field, as the reference's
    ``get[T]`` does)."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        self._fields: dict = dict(fields) if fields else {}

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

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    def get(self, key: str, expected_type: Optional[type] = None,
            default: Any = _MISSING) -> Any:
        """The field's value; DataMapError when absent (ref: get[T]).
        ``expected_type`` coerces int -> float and raises TypeError on a
        mismatch; a non-type second argument is a default, as for
        ``dict.get``."""
        if expected_type is not None and not isinstance(expected_type, type):
            default, expected_type = expected_type, None
        if key not in self._fields:
            if default is not _MISSING:
                return default
            raise DataMapError(f"The field {key} is required.")
        value = self._fields[key]
        if expected_type is float and isinstance(value, int) and (
                not isinstance(value, bool)):
            return float(value)
        if expected_type is not None and not isinstance(value, expected_type):
            raise TypeError(f"field {key}: expected "
                            f"{expected_type.__name__}, got "
                            f"{type(value).__name__}")
        return value

    def get_opt(self, key: str, expected_type: Optional[type] = None,
                default: Any = None) -> Any:
        if key not in self._fields:
            return default
        return self.get(key, expected_type)

    def to_dict(self) -> dict:
        return dict(self._fields)
