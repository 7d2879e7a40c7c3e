"""The append-only Event model.

Copy of ``predictionio_tpu/data/event.py`` trimmed to what the training
read needs (ref: data/.../storage/Event.scala:37): an event has a name,
entityType/entityId, an optional targetEntityType/Id, a properties
DataMap, eventTime, tags, an optional prId and creationTime. The JSON
form (``to_dict`` / ``from_dict``) is the event stores' on-disk format,
shared with the JAX package.
"""

from __future__ import annotations

import datetime as _dt
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional

from predictionio_torch.data.datamap import DataMap

UTC = _dt.timezone.utc


class EventValidationError(ValueError):
    """Raised when an event violates the validation contract."""


def _now() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


@dataclass(frozen=True)
class Event:
    """One immutable event (ref: Event.scala:37)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_now)
    tags: tuple = ()
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=_now)

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))
        if isinstance(self.tags, list):
            object.__setattr__(self, "tags", tuple(self.tags))
        for attr in ("event_time", "creation_time"):
            t = getattr(self, attr)
            if t.tzinfo is None:
                object.__setattr__(self, attr, t.replace(tzinfo=UTC))

    def with_id(self, event_id: Optional[str] = None) -> "Event":
        return replace(self, event_id=event_id or uuid.uuid4().hex)

    def to_dict(self, api_format: bool = True) -> dict:
        """JSON-ready dict (ref: EventJson4sSupport.scala API format)."""
        d: dict = {
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
        }
        if self.event_id is not None:
            d["eventId"] = self.event_id
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if len(self.properties):
            d["properties"] = self.properties.to_dict()
        d["eventTime"] = _iso(self.event_time)
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        if not api_format:
            d["creationTime"] = _iso(self.creation_time)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Event":
        try:
            event = d["event"]
            entity_type = d["entityType"]
            entity_id = d["entityId"]
        except KeyError as e:
            raise EventValidationError(
                f"field {e.args[0]} is required") from None
        return cls(
            event=event,
            entity_type=entity_type,
            entity_id=entity_id,
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(d.get("properties") or {}),
            event_time=(_parse_time(d["eventTime"]) if "eventTime" in d
                        else _now()),
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            event_id=d.get("eventId"),
            creation_time=(_parse_time(d["creationTime"])
                           if "creationTime" in d else _now()),
        )


def _iso(t: _dt.datetime) -> str:
    return t.astimezone(UTC).isoformat().replace("+00:00", "Z")


def _parse_time(s: Any) -> _dt.datetime:
    if isinstance(s, _dt.datetime):
        return s if s.tzinfo else s.replace(tzinfo=UTC)
    if isinstance(s, (int, float)):
        return _dt.datetime.fromtimestamp(s / 1000.0, tz=UTC)
    s = str(s)
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    t = _dt.datetime.fromisoformat(s)
    return t if t.tzinfo else t.replace(tzinfo=UTC)
