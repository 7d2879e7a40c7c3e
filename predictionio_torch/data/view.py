"""Batch views: filter/fold helpers over event lists (legacy surface).

Copy of ``predictionio_tpu/data/view.py``; what follows is the JAX
module's account.

Behavior contract from the reference's deprecated-but-shipped view API
(data/.../view/LBatchView.scala): `EventSeq` with predicate filtering
(event name, entity type, time window), per-entity time-ordered folds
(`aggregateByEntityOrdered`, LBatchView.scala:120), and the
$set/$unset/$delete DataMap aggregator (ViewAggregators,
LBatchView.scala:69). `BatchView` binds an app (+ channel) and reads
once through the Storage layer (LBatchView.scala:135).

One deliberate divergence: the reference's start-time predicate drops
events AT the start instant (LBatchView.scala:36 excludes isEqual —
inconsistent with its own find API); here the window is the same
half-open [start, until) used everywhere else in this framework.
"""

from __future__ import annotations

import datetime as _dt
from typing import Callable, Dict, List, Optional, TypeVar

from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.data.store import resolve_app

T = TypeVar("T")


def datamap_aggregator() -> Callable[[Optional[dict], Event], Optional[dict]]:
    """Fold step materializing entity properties from $set/$unset/$delete
    (ref: ViewAggregators.getDataMapAggregator, LBatchView.scala:69)."""

    def op(props: Optional[dict], e: Event) -> Optional[dict]:
        if e.event == "$set":
            merged = dict(props) if props else {}
            merged.update(e.properties.to_dict())
            return merged
        if e.event == "$unset":
            if props is None:
                return None
            return {k: v for k, v in props.items()
                    if k not in e.properties.to_dict()}
        if e.event == "$delete":
            return None
        return props

    return op


class EventSeq:
    """A filterable, foldable event list (ref: EventSeq, LBatchView.scala:105)."""

    def __init__(self, events: List[Event]):
        self.events = list(events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def filter(
        self,
        event: Optional[str] = None,
        entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        predicate: Optional[Callable[[Event], bool]] = None,
    ) -> "EventSeq":
        out = self.events
        if event is not None:
            out = [e for e in out if e.event == event]
        if entity_type is not None:
            out = [e for e in out if e.entity_type == entity_type]
        if start_time is not None:
            out = [e for e in out if e.event_time >= start_time]
        if until_time is not None:
            out = [e for e in out if e.event_time < until_time]
        if predicate is not None:
            out = [e for e in out if predicate(e)]
        return EventSeq(out)

    def aggregate_by_entity_ordered(
        self, init: T, op: Callable[[T, Event], T]
    ) -> Dict[str, T]:
        """Per-entity fold in event-time order
        (ref: aggregateByEntityOrdered, LBatchView.scala:120)."""
        by_entity: Dict[str, List[Event]] = {}
        for e in self.events:
            by_entity.setdefault(e.entity_id, []).append(e)
        out: Dict[str, T] = {}
        for eid, evs in by_entity.items():
            acc = init
            for e in sorted(evs, key=lambda e: e.event_time):
                acc = op(acc, e)
            out[eid] = acc
        return out

    def aggregate_properties(self) -> Dict[str, dict]:
        """Materialized property map per entity, dropping deleted ones
        (ref: LBatchView.aggregateProperties, LBatchView.scala:144)."""
        folded = self.aggregate_by_entity_ordered(None, datamap_aggregator())
        return {k: v for k, v in folded.items() if v is not None}


class BatchView:
    """One-shot event snapshot of an app (ref: LBatchView, LBatchView.scala:131)."""

    def __init__(
        self,
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        storage: Optional[Storage] = None,
    ):
        st = storage or get_storage()
        app_id, channel_id = resolve_app(app_name, channel_name, st)
        self.events = EventSeq(
            st.events().find(
                app_id, channel_id=channel_id,
                start_time=start_time, until_time=until_time,
            )
        )

    def filter(self, **kwargs) -> EventSeq:
        return self.events.filter(**kwargs)

    def aggregate_properties(self, entity_type: Optional[str] = None) -> Dict[str, dict]:
        seq = self.events if entity_type is None else self.events.filter(
            entity_type=entity_type
        )
        return seq.aggregate_properties()
