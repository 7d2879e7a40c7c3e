"""Engine-facing event-store API.

Copy of ``predictionio_tpu/data/store.py`` (ref: store/PEventStore.scala:30,
store/LEventStore.scala:60, store/Common.scala:28): engines address
data by app name (+ optional channel name); the store resolves the
(app id, channel id) pair from metadata and raises if the app or
channel does not exist. ``find``, ``find_columnar``, ``bin_columnar``,
``aggregate_properties`` and ``extract_entity_map`` are the training
read; ``find_by_entity`` is the serve-time lookup.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional

from predictionio_torch.data.bimap import EntityMap
from predictionio_torch.data.datamap import PropertyMap
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import (UNSET, BinnedInteractions,
                                             EventColumns, Storage,
                                             StorageError, get_storage)


def resolve_app(app_name: str, channel_name: Optional[str] = None,
                storage: Optional[Storage] = None):
    """app name (+channel name) -> (app_id, channel_id); the errors are
    the reference's (ref: store/Common.scala:28)."""
    storage = storage or get_storage()
    app = storage.apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"App name {app_name} is not valid.")
    channel_id = None
    if channel_name is not None:
        channels = storage.channels().get_by_app_id(app.id)
        ch = next((c for c in channels if c.name == channel_name), None)
        if ch is None:
            raise StorageError(f"Channel name {channel_name} is not valid.")
        channel_id = ch.id
    return app.id, channel_id


def find(app_name: str, channel_name: Optional[str] = None,
         start_time: Optional[_dt.datetime] = None,
         until_time: Optional[_dt.datetime] = None,
         entity_type: Optional[str] = None,
         entity_id: Optional[str] = None,
         event_names: Optional[List[str]] = None,
         target_entity_type: Any = UNSET, target_entity_id: Any = UNSET,
         limit: Optional[int] = None, reversed: bool = False,
         storage: Optional[Storage] = None) -> List[Event]:
    """ref: PEventStore.find:30."""
    storage = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, storage)
    return storage.events().find(
        app_id, channel_id=channel_id, start_time=start_time,
        until_time=until_time, entity_type=entity_type, entity_id=entity_id,
        event_names=event_names, target_entity_type=target_entity_type,
        target_entity_id=target_entity_id, limit=limit, reversed=reversed)


def find_columnar(app_name: str, channel_name: Optional[str] = None,
                  value_property: Optional[str] = None,
                  time_ordered: bool = True,
                  shard_index: Optional[int] = None,
                  shard_count: Optional[int] = None,
                  storage: Optional[Storage] = None,
                  **find_kwargs) -> EventColumns:
    """Bulk training read as dict-encoded columns (storage.EventColumns).
    ``shard_index``/``shard_count`` select this process's entity-hash
    read shard: N training processes each fetch ~1/N of the rows."""
    storage = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, storage)
    return storage.events().find_columnar(
        app_id, channel_id=channel_id, value_property=value_property,
        time_ordered=time_ordered, shard_index=shard_index,
        shard_count=shard_count, **find_kwargs)


def supports_bin_columnar(app_name: str, channel_name: Optional[str] = None,
                          storage: Optional[Storage] = None) -> bool:
    """Whether the app's event store offers the fused native ingest->bin
    lane: exactly when it has ``bin_columnar`` (the eventlog backend,
    whose native library was built when the store was made, or raised).
    Raises StorageError for an unknown app or channel, like every other
    entry point."""
    storage = storage or get_storage()
    resolve_app(app_name, channel_name, storage)
    return callable(getattr(storage.events(), "bin_columnar", None))


def bin_columnar(app_name: str, channel_name: Optional[str] = None,
                 storage: Optional[Storage] = None,
                 **kwargs) -> BinnedInteractions:
    """The zero-copy training read: one native call scans the mmapped
    log and bins both sides into the ALS trainer's compressed layout
    (``storage.BinnedInteractions``); no Event objects, no Python row
    loop, no intermediate COO. Check :func:`supports_bin_columnar`
    first: other stores have no such call."""
    storage = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, storage)
    return storage.events().bin_columnar(app_id, channel_id=channel_id,
                                         **kwargs)


def data_fingerprint(app_name: str, channel_name: Optional[str] = None,
                     storage: Optional[Storage] = None) -> Optional[str]:
    """O(1) content fingerprint of an app's event data, or None when the
    store has no cheap one (only the native event log has one). It
    changes whenever the data does; the layout cache (``ops.bincache``)
    keys on it, so a retrain on unchanged events skips the read."""
    storage = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, storage)
    fn = getattr(storage.events(), "data_fingerprint", None)
    return None if fn is None else fn(app_id, channel_id)


def aggregate_properties(app_name: str, entity_type: str,
                         channel_name: Optional[str] = None,
                         start_time: Optional[_dt.datetime] = None,
                         until_time: Optional[_dt.datetime] = None,
                         required: Optional[List[str]] = None,
                         storage: Optional[Storage] = None
                         ) -> Dict[str, PropertyMap]:
    """ref: PEventStore.aggregateProperties."""
    storage = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, storage)
    return storage.events().aggregate_properties(
        app_id, entity_type, channel_id=channel_id, start_time=start_time,
        until_time=until_time, required=required)


def extract_entity_map(app_name: str, entity_type: str, extract,
                       channel_name: Optional[str] = None,
                       start_time: Optional[_dt.datetime] = None,
                       until_time: Optional[_dt.datetime] = None,
                       required: Optional[List[str]] = None,
                       storage: Optional[Storage] = None) -> EntityMap:
    """Aggregate properties, then index entities into an EntityMap whose
    payload is ``extract(PropertyMap)`` per entity
    (ref: PEvents.extractEntityMap:109)."""
    props = aggregate_properties(
        app_name, entity_type, channel_name=channel_name,
        start_time=start_time, until_time=until_time, required=required,
        storage=storage)
    return EntityMap({eid: extract(pm) for eid, pm in props.items()})


def find_by_entity(app_name: str, entity_type: str, entity_id: str,
                   channel_name: Optional[str] = None,
                   event_names: Optional[List[str]] = None,
                   target_entity_type: Any = UNSET,
                   target_entity_id: Any = UNSET,
                   start_time: Optional[_dt.datetime] = None,
                   until_time: Optional[_dt.datetime] = None,
                   limit: Optional[int] = None, latest: bool = True,
                   storage: Optional[Storage] = None) -> List[Event]:
    """Serve-time entity lookup, newest first unless ``latest`` is
    False (ref: LEventStore.findByEntity:60)."""
    return find(app_name, channel_name=channel_name, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                entity_id=entity_id, event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id, limit=limit,
                reversed=latest, storage=storage)
