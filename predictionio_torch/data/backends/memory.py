"""In-memory storage backend: events, apps, engine instances and model
blobs.

Copy of the corresponding parts of
``predictionio_tpu/data/backends/memory.py``: plain dicts under one
lock, records deep-copied at the repo boundary so callers mutating a
record after insert do not change what is stored.
"""

from __future__ import annotations

import copy
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from predictionio_torch.data import storage as S
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import App, EngineInstance, Model


def table_key(app_id: int, channel_id: Optional[int]
              ) -> Tuple[int, Optional[int]]:
    return (int(app_id), channel_id if channel_id is None else int(channel_id))


class MemoryEventStore(S.EventStore):
    def __init__(self):
        self._lock = threading.RLock()
        # (app_id, channel_id) -> {event_id: Event}
        self._tables: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}

    def _table(self, app_id, channel_id) -> Dict[str, Event]:
        tbl = self._tables.get(table_key(app_id, channel_id))
        if tbl is None:
            # strict reads: an un-init()ed table is an error, like a
            # missing HBase table in the reference (hbase/HBLEvents.scala)
            raise S.StorageError(f"event table for app {app_id} channel "
                                 f"{channel_id} not initialized")
        return tbl

    def init(self, app_id, channel_id=None):
        with self._lock:
            self._tables.setdefault(table_key(app_id, channel_id), {})

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        with self._lock:
            e = event if event.event_id else event.with_id()
            self._table(app_id, channel_id)[e.event_id] = e
            return e.event_id

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=S.UNSET, target_entity_id=S.UNSET,
             limit=None, reversed=False) -> List[Event]:
        with self._lock:
            events = list(self._table(app_id, channel_id).values())
        out = [e for e in events
               if _matches(e, start_time, until_time, entity_type, entity_id,
                           event_names, target_entity_type,
                           target_entity_id)]
        out.sort(key=lambda e: (e.event_time, e.creation_time),
                 reverse=reversed)
        if limit is not None and limit >= 0:
            out = out[:limit]
        return out


def _matches(e: Event, start_time, until_time, entity_type, entity_id,
             event_names, target_entity_type, target_entity_id) -> bool:
    """Filter semantics of PEvents.find (ref: PEvents.scala:70): a
    half-open ``[start_time, until_time)`` window; the target filters
    take the UNSET sentinel so callers can ask for "no target"."""
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if (target_entity_type is not S.UNSET
            and e.target_entity_type != target_entity_type):
        return False
    if (target_entity_id is not S.UNSET
            and e.target_entity_id != target_entity_id):
        return False
    return True


class MemoryAppsRepo(S.AppsRepo):
    def __init__(self, lock: threading.RLock):
        self._records: Dict[int, App] = {}
        self._lock = lock

    def insert(self, name, description=None) -> App:
        with self._lock:
            if any(a.name == name for a in self._records.values()):
                raise S.StorageError(f"app name {name!r} already exists")
            app = App(id=max(self._records, default=0) + 1, name=name,
                      description=description)
            self._records[app.id] = app
            return copy.deepcopy(app)

    def get_all(self):
        with self._lock:
            return [copy.deepcopy(a) for a in sorted(
                self._records.values(), key=lambda a: a.id)]


class MemoryChannelsRepo(S.ChannelsRepo):
    """A memory store holds no channels: the port creates none."""

    def get_all(self):
        return []


class MemoryEngineInstancesRepo(S.EngineInstancesRepo):
    def __init__(self, lock: threading.RLock):
        self._records: Dict[str, EngineInstance] = {}
        self._lock = lock

    def insert(self, instance) -> str:
        with self._lock:
            if not instance.id:
                instance.id = uuid.uuid4().hex
            self._records[instance.id] = copy.deepcopy(instance)
            return instance.id

    def get(self, id):
        with self._lock:
            rec = self._records.get(id)
            return copy.deepcopy(rec) if rec is not None else None

    def get_all(self):
        with self._lock:
            return [copy.deepcopy(r) for r in self._records.values()]


class MemoryModelsRepo(S.ModelsRepo):
    def __init__(self, lock: threading.RLock):
        self._models: Dict[str, Model] = {}
        self._lock = lock

    def insert(self, model):
        with self._lock:
            self._models[model.id] = Model(id=model.id,
                                           models=bytes(model.models))

    def get(self, id):
        with self._lock:
            m = self._models.get(id)
            return Model(id=m.id, models=m.models) if m is not None else None


class MemoryStorageClient(S.StorageClient):
    def __init__(self, config: Dict[str, str]):
        lock = threading.RLock()
        self._events = MemoryEventStore()
        self._apps = MemoryAppsRepo(lock)
        self._channels = MemoryChannelsRepo()
        self._engine_instances = MemoryEngineInstancesRepo(lock)
        self._models = MemoryModelsRepo(lock)

    def events(self): return self._events
    def apps(self): return self._apps
    def channels(self): return self._channels
    def engine_instances(self): return self._engine_instances
    def models(self): return self._models


S.register_backend("memory", MemoryStorageClient)
