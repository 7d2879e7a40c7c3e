"""In-memory storage backend: events, apps, access keys, channels,
engine and evaluation instances and model blobs.

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
from predictionio_torch.data.metadata import (AccessKey, App, Channel,
                                              EngineInstance,
                                              EvaluationInstance, Model)


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

    def remove(self, app_id, channel_id=None):
        with self._lock:
            self._tables.pop(table_key(app_id, channel_id), None)

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        with self._lock:
            e = event if event.event_id else event.with_id()
            self._table(app_id, channel_id)[e.event_id] = e
            return e.event_id

    def get(self, event_id, app_id, channel_id=None):
        with self._lock:
            return self._table(app_id, channel_id).get(event_id)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        with self._lock:
            return self._table(app_id, channel_id).pop(event_id,
                                                       None) is not None

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


class _Sequences:
    """Auto-increment ids (ref: elasticsearch/ESSequences.scala)."""

    def __init__(self):
        self._counters: Dict[str, int] = {}

    def next(self, name: str) -> int:
        self._counters[name] = self._counters.get(name, 0) + 1
        return self._counters[name]


class _RecordRepo:
    """A dict of records under the client's lock, copied at the
    boundary."""

    def __init__(self, lock: threading.RLock):
        self._records: Dict = {}
        self._lock = lock

    def _put(self, key, record) -> None:
        self._records[key] = copy.deepcopy(record)

    def _get(self, key):
        rec = self._records.get(key)
        return copy.deepcopy(rec) if rec is not None else None


class MemoryAppsRepo(_RecordRepo, S.AppsRepo):
    def __init__(self, sequences: _Sequences, lock: threading.RLock):
        super().__init__(lock)
        self._seq = sequences

    def insert(self, name, description=None) -> App:
        with self._lock:
            if any(a.name == name for a in self._records.values()):
                raise S.StorageError(f"app name {name!r} already exists")
            app = App(id=self._seq.next("apps"), name=name,
                      description=description)
            self._put(app.id, app)
            return copy.deepcopy(app)

    def get(self, app_id):
        with self._lock:
            return self._get(int(app_id))

    def get_by_name(self, name):
        with self._lock:
            rec = next((a for a in self._records.values() if a.name == name),
                       None)
            return copy.deepcopy(rec) if rec is not None else None

    def get_all(self):
        with self._lock:
            return [copy.deepcopy(a) for a in sorted(
                self._records.values(), key=lambda a: a.id)]

    def update(self, app):
        with self._lock:
            self._put(app.id, app)

    def delete(self, app_id):
        with self._lock:
            self._records.pop(int(app_id), None)


class MemoryAccessKeysRepo(_RecordRepo, S.AccessKeysRepo):
    def insert(self, access_key: AccessKey) -> str:
        with self._lock:
            if not access_key.key:
                access_key = AccessKey.generate(access_key.appid,
                                                access_key.events)
            self._put(access_key.key, access_key)
            return access_key.key

    def get(self, key):
        with self._lock:
            return self._get(key)

    def get_all(self):
        with self._lock:
            return [copy.deepcopy(k) for k in self._records.values()]

    def get_by_app_id(self, app_id):
        with self._lock:
            return [copy.deepcopy(k) for k in self._records.values()
                    if k.appid == int(app_id)]

    def update(self, access_key):
        with self._lock:
            self._put(access_key.key, access_key)

    def delete(self, key):
        with self._lock:
            self._records.pop(key, None)


class MemoryChannelsRepo(_RecordRepo, S.ChannelsRepo):
    def __init__(self, sequences: _Sequences, lock: threading.RLock):
        super().__init__(lock)
        self._seq = sequences

    def insert(self, name, app_id) -> Channel:
        with self._lock:
            if not Channel.is_valid_name(name):
                raise S.StorageError(
                    f"invalid channel name {name!r} (must match "
                    "[a-zA-Z0-9-]{1,16})")
            if any(c.name == name and c.appid == int(app_id)
                   for c in self._records.values()):
                raise S.StorageError(
                    f"channel {name!r} already exists for app {app_id}")
            ch = Channel(id=self._seq.next("channels"), name=name,
                         appid=int(app_id))
            self._put(ch.id, ch)
            return copy.deepcopy(ch)

    def get(self, channel_id):
        with self._lock:
            return self._get(int(channel_id))

    def get_by_app_id(self, app_id):
        with self._lock:
            return sorted((copy.deepcopy(c) for c in self._records.values()
                           if c.appid == int(app_id)), key=lambda c: c.id)

    def delete(self, channel_id):
        with self._lock:
            self._records.pop(int(channel_id), None)


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


class MemoryEvaluationInstancesRepo(_RecordRepo, S.EvaluationInstancesRepo):
    def insert(self, instance: EvaluationInstance) -> str:
        with self._lock:
            if not instance.id:
                instance.id = uuid.uuid4().hex
            self._put(instance.id, instance)
            return instance.id

    def get(self, id):
        with self._lock:
            return self._get(id)

    def get_all(self):
        with self._lock:
            return [copy.deepcopy(r) for r in self._records.values()]

    def delete(self, id):
        with self._lock:
            self._records.pop(id, None)


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
        sequences = _Sequences()
        self._events = MemoryEventStore()
        self._apps = MemoryAppsRepo(sequences, lock)
        self._access_keys = MemoryAccessKeysRepo(lock)
        self._channels = MemoryChannelsRepo(sequences, lock)
        self._engine_instances = MemoryEngineInstancesRepo(lock)
        self._evaluation_instances = MemoryEvaluationInstancesRepo(lock)
        self._models = MemoryModelsRepo(lock)

    def events(self): return self._events
    def apps(self): return self._apps
    def access_keys(self): return self._access_keys
    def channels(self): return self._channels
    def engine_instances(self): return self._engine_instances
    def evaluation_instances(self): return self._evaluation_instances
    def models(self): return self._models


S.register_backend("memory", MemoryStorageClient)
