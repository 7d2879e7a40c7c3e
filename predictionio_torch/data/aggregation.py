"""Entity-property materialization from $set/$unset/$delete streams.

Copy of ``predictionio_tpu/data/aggregation.py``. Behavior contract
from the reference's EventOp monoid
(data/.../storage/PEventAggregator.scala:87-209 and
LEventAggregator.scala:24-123): folding an entity's special events in
event-time order yields the entity's current PropertyMap:

  - ``$set``:   merge properties, later event time wins per key
  - ``$unset``: remove the given property keys
  - ``$delete``: drop the entity entirely (a later $set recreates it)

Entities whose fold ends with no live properties-map are excluded from
the aggregate result. first_updated / last_updated track the earliest
and latest contributing special-event times since the last $delete.

The reference computes this as a Spark ``aggregateByKey`` with a
commutative-enough monoid; here the fold is a host-side linear pass per
entity (events pre-sorted by event time), which is the same result.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterable, Optional

from predictionio_torch.data.datamap import PropertyMap
from predictionio_torch.data.event import Event


class _EntityState:
    """Mutable fold state for one entity (the EventOp monoid's meaning)."""

    __slots__ = ("props", "prop_times", "first_updated", "last_updated", "exists")

    def __init__(self):
        self.props: dict = {}
        self.prop_times: dict = {}
        self.first_updated: Optional[_dt.datetime] = None
        self.last_updated: Optional[_dt.datetime] = None
        self.exists = False

    def _touch(self, t: _dt.datetime) -> None:
        if self.first_updated is None or t < self.first_updated:
            self.first_updated = t
        if self.last_updated is None or t > self.last_updated:
            self.last_updated = t

    def apply(self, e: Event) -> None:
        t = e.event_time
        if e.event == "$set":
            for k, v in e.properties.items():
                # later event time wins per key (ref: PEventAggregator.scala:95)
                prev = self.prop_times.get(k)
                if prev is None or t >= prev:
                    self.props[k] = v
                    self.prop_times[k] = t
            self.exists = True
            self._touch(t)
        elif e.event == "$unset":
            for k in e.properties.keyset():
                prev = self.prop_times.get(k)
                if prev is None or t >= prev:
                    self.props.pop(k, None)
                    self.prop_times[k] = t
            self._touch(t)
        elif e.event == "$delete":
            self.props.clear()
            self.prop_times.clear()
            self.first_updated = None
            self.last_updated = None
            self.exists = False

    def result(self) -> Optional[PropertyMap]:
        if not self.exists or self.first_updated is None:
            return None
        return PropertyMap(self.props, self.first_updated, self.last_updated)


def aggregate_properties_from_events(
    events: Iterable[Event],
    required: Optional[Iterable[str]] = None,
) -> Dict[str, PropertyMap]:
    """Fold special events (for a single entityType) into entityId -> PropertyMap.

    ``required``: keep only entities having all the listed property keys
    (ref: PEventStore.aggregateProperties ``required`` filter).
    """
    states: Dict[str, _EntityState] = {}
    for e in sorted(events, key=lambda ev: (ev.event_time, ev.creation_time)):
        if e.event not in ("$set", "$unset", "$delete"):
            continue
        states.setdefault(e.entity_id, _EntityState()).apply(e)
    out: Dict[str, PropertyMap] = {}
    req = list(required) if required else None
    for entity_id, st in states.items():
        pm = st.result()
        if pm is None:
            continue
        if req is not None and not all(k in pm for k in req):
            continue
        out[entity_id] = pm
    return out
