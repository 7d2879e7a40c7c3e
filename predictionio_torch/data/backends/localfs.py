"""Local-filesystem storage backend: events, apps, channels, engine
instances and model blobs.

The on-disk format is ``predictionio_tpu/data/backends/localfs.py``'s,
so the port reads what the JAX package wrote and the other way round:

  - events   -> append-only JSONL logs ``<root>/events/events_<app>[_<ch>]
                .jsonl``, one event per line in its stored JSON form, a
                deletion as a ``{"__tombstone__": id}`` line (ref: hbase
                tables ``events_<appId>[_<channelId>]``)
  - metadata -> one JSON document ``<root>/metadata.json``; apps,
                channels and engine instances are its ``"apps"``,
                ``"channels"`` and ``"engine_instances"`` lists, id
                counters its ``"sequences"`` (ref: elasticsearch indices)
  - models   -> blob files ``<root>/models/pio_<id>``
                (ref: localfs/LocalFSModels.scala:29)

Every other section of the metadata document (access keys, manifests,
...) is written back as it was read. Reads and writes hold the same
exclusive ``flock`` on ``<root>/.metadata.lock`` as the JAX backend, so
processes of both packages can share one root; writes are atomic
renames. An event log is read once per process and table and then kept
in memory, as in the JAX backend.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import threading
import uuid
from typing import Dict, List, Optional

from predictionio_torch.data import storage as S
from predictionio_torch.data.backends.memory import MemoryEventStore, table_key
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import (App, Channel, EngineInstance,
                                              Model, dict_to_record,
                                              record_to_dict)

log = logging.getLogger(__name__)


class LocalFSEventStore(MemoryEventStore):
    """JSONL event logs with an in-memory replay cache."""

    def __init__(self, basedir: str):
        super().__init__()
        self._dir = os.path.join(basedir, "events")
        os.makedirs(self._dir, exist_ok=True)
        self._loaded: set = set()

    def _path(self, app_id: int, channel_id: Optional[int]) -> str:
        name = f"events_{int(app_id)}"
        if channel_id is not None:
            name += f"_{int(channel_id)}"
        return os.path.join(self._dir, name + ".jsonl")

    def _ensure_loaded(self, app_id, channel_id) -> None:
        key = table_key(app_id, channel_id)
        path = self._path(app_id, channel_id)
        if key in self._loaded or not os.path.exists(path):
            return
        tbl: Dict[str, Event] = {}
        with open(path) as f:
            lines = f.readlines()
        for lineno, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                # a torn final line (crash mid-append) is recoverable;
                # corruption earlier in the log is not
                if lineno == len(lines) - 1:
                    log.warning("%s: dropping torn final line", path)
                    continue
                raise S.StorageError(
                    f"{path}:{lineno + 1}: corrupt event log line")
            if "__tombstone__" in d:
                tbl.pop(d["__tombstone__"], None)
            else:
                e = Event.from_dict(d)
                tbl[e.event_id] = e
        self._tables[key] = tbl
        self._loaded.add(key)

    def init(self, app_id, channel_id=None):
        with self._lock:
            self._ensure_loaded(app_id, channel_id)
            super().init(app_id, channel_id)
            self._loaded.add(table_key(app_id, channel_id))
            open(self._path(app_id, channel_id), "a").close()

    def insert(self, event, app_id, channel_id=None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: List[Event], app_id,
                     channel_id=None) -> List[str]:
        """Append the events to the table and to its log in one write."""
        with self._lock:
            self._ensure_loaded(app_id, channel_id)
            ids = [super(LocalFSEventStore, self).insert(e, app_id,
                                                         channel_id)
                   for e in events]
            tbl = self._table(app_id, channel_id)
            lines = "".join(
                json.dumps(tbl[i].to_dict(api_format=False), sort_keys=True)
                + "\n" for i in ids)
            with open(self._path(app_id, channel_id), "a") as f:
                f.write(lines)
            return ids

    def remove(self, app_id, channel_id=None):
        with self._lock:
            super().remove(app_id, channel_id)
            self._loaded.discard(table_key(app_id, channel_id))
            try:
                os.remove(self._path(app_id, channel_id))
            except FileNotFoundError:
                pass

    def get(self, event_id, app_id, channel_id=None):
        with self._lock:
            self._ensure_loaded(app_id, channel_id)
            return super().get(event_id, app_id, channel_id)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        """Drop the event and append its tombstone line."""
        with self._lock:
            self._ensure_loaded(app_id, channel_id)
            found = super().delete(event_id, app_id, channel_id)
            if found:
                with open(self._path(app_id, channel_id), "a") as f:
                    f.write(json.dumps({"__tombstone__": event_id},
                                       sort_keys=True) + "\n")
            return found

    def find(self, app_id, channel_id=None, **kwargs):
        with self._lock:
            self._ensure_loaded(app_id, channel_id)
        return super().find(app_id, channel_id=channel_id, **kwargs)


class LocalFSModelsRepo(S.ModelsRepo):
    """ref: localfs/LocalFSModels.scala:29 — blob per model id."""

    def __init__(self, basedir: str):
        self._dir = os.path.join(basedir, "models")
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, id: str) -> str:
        return os.path.join(self._dir, f"pio_{id}")

    def insert(self, model: Model) -> None:
        with open(self._path(model.id), "wb") as f:
            f.write(model.models)

    def get(self, id: str) -> Optional[Model]:
        try:
            with open(self._path(id), "rb") as f:
                return Model(id=id, models=f.read())
        except FileNotFoundError:
            return None


class _MetadataDoc:
    """``metadata.json`` under the cross-process ``flock``: each change
    reads the document, edits one section and writes it back whole."""

    def __init__(self, basedir: str):
        self._path = os.path.join(basedir, "metadata.json")
        self._lock_path = os.path.join(basedir, ".metadata.lock")
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def _flocked(self):
        with self._lock, open(self._lock_path, "a+") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def _read(self) -> dict:
        try:
            with open(self._path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    @contextlib.contextmanager
    def changing(self):
        """The document, locked, written back (atomically) when the
        block ends without an error."""
        with self._flocked():
            doc = self._read()
            yield doc
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(doc, indent=1, sort_keys=True))
            os.replace(tmp, self._path)

    def records(self, section: str, cls) -> list:
        with self._flocked():
            rows = self._read().get(section, [])
        return [dict_to_record(cls, rd) for rd in rows]

    @staticmethod
    def next_id(doc: dict, sequence: str) -> int:
        """The next value of an id counter (ref: ESSequences)."""
        seqs = doc.setdefault("sequences", {})
        seqs[sequence] = int(seqs.get(sequence, 0)) + 1
        return seqs[sequence]


class LocalFSAppsRepo(S.AppsRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def insert(self, name, description=None) -> App:
        with self._doc.changing() as doc:
            if any(rd["name"] == name for rd in doc.get("apps", [])):
                raise S.StorageError(f"app name {name!r} already exists")
            app = App(id=self._doc.next_id(doc, "apps"), name=name,
                      description=description)
            doc.setdefault("apps", []).append(record_to_dict(app))
        return app

    def get_all(self):
        return sorted(self._doc.records("apps", App), key=lambda a: a.id)


class LocalFSChannelsRepo(S.ChannelsRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def get_all(self):
        return self._doc.records("channels", Channel)


class LocalFSEngineInstancesRepo(S.EngineInstancesRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def insert(self, instance: EngineInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        with self._doc.changing() as doc:
            rows = [rd for rd in doc.get("engine_instances", [])
                    if rd["id"] != instance.id]
            doc["engine_instances"] = rows + [record_to_dict(instance)]
        return instance.id

    def get(self, id: str) -> Optional[EngineInstance]:
        return next((r for r in self.get_all() if r.id == id), None)

    def get_all(self) -> List[EngineInstance]:
        return self._doc.records("engine_instances", EngineInstance)


class LocalFSStorageClient(S.StorageClient):
    """Directory-rooted storage source; ``PATH`` config key sets the root."""

    def __init__(self, config: Dict[str, str]):
        basedir = os.path.expanduser(config.get("PATH") or "~/.pio_store")
        os.makedirs(basedir, exist_ok=True)
        doc = _MetadataDoc(basedir)
        self._events = LocalFSEventStore(basedir)
        self._apps = LocalFSAppsRepo(doc)
        self._channels = LocalFSChannelsRepo(doc)
        self._engine_instances = LocalFSEngineInstancesRepo(doc)
        self._models = LocalFSModelsRepo(basedir)

    def events(self): return self._events
    def apps(self): return self._apps
    def channels(self): return self._channels
    def engine_instances(self): return self._engine_instances
    def models(self): return self._models


S.register_backend("localfs", LocalFSStorageClient)
