"""Engine-facing event-store API.

Copy of ``predictionio_tpu/data/store.py`` trimmed to the training read
(ref: store/PEventStore.scala:30, store/Common.scala:28): engines
address data by app name (+ optional channel name); the store resolves
the (app id, channel id) pair from metadata and raises if the app or
channel does not exist.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, List, Optional

from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import (UNSET, EventColumns, Storage,
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
                  storage: Optional[Storage] = None,
                  **find_kwargs) -> EventColumns:
    """Bulk training read as dict-encoded columns (storage.EventColumns)."""
    storage = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, storage)
    return storage.events().find_columnar(
        app_id, channel_id=channel_id, value_property=value_property,
        time_ordered=time_ordered, **find_kwargs)


def supports_bin_columnar(app_name: str, channel_name: Optional[str] = None,
                          storage: Optional[Storage] = None) -> bool:
    """Whether the app's store offers the fused native ingest->bin lane:
    never in the port yet (the native eventlog backend is a later
    slice). Raises StorageError for an unknown app or channel, like
    every other entry point."""
    resolve_app(app_name, channel_name, storage or get_storage())
    return False
