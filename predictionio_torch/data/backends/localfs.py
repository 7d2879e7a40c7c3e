"""Local-filesystem storage backend: events, apps, access keys,
channels, engine and evaluation instances and model blobs.

The on-disk format is ``predictionio_tpu/data/backends/localfs.py``'s,
so the port reads what the JAX package wrote and the other way round:

  - events   -> append-only JSONL logs ``<root>/events/events_<app>[_<ch>]
                .jsonl``, one event per line in its stored JSON form, a
                deletion as a ``{"__tombstone__": id}`` line (ref: hbase
                tables ``events_<appId>[_<channelId>]``)
  - metadata -> one JSON document ``<root>/metadata.json``; apps,
                access keys, channels, engine and evaluation instances
                are its ``"apps"``, ``"access_keys"``, ``"channels"``,
                ``"engine_instances"`` and ``"evaluation_instances"``
                lists, id counters its ``"sequences"`` (ref:
                elasticsearch indices)
  - models   -> blob files ``<root>/models/pio_<id>``
                (ref: localfs/LocalFSModels.scala:29)

Every other section of the metadata document (engine manifests) is
written back as it was read. Reads and writes hold the same
exclusive ``flock`` on ``<root>/.metadata.lock`` as the JAX backend, so
processes of both packages can share one root; writes are atomic
renames. An event log is read once per process and table and then kept
in memory, as in the JAX backend.
"""

from __future__ import annotations

import contextlib
import copy
import fcntl
import json
import logging
import os
import threading
import uuid
from typing import Dict, List, Optional, Tuple

from predictionio_torch.data import storage as S
from predictionio_torch.data.backends.memory import MemoryEventStore, table_key
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import (AccessKey, App, Channel,
                                              EngineInstance,
                                              EvaluationInstance, Model,
                                              dict_to_record, record_to_dict)

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
    reads the document, edits one section and writes it back whole.
    Reads are served from a parsed copy that is parsed again when the
    file's inode, mtime or size changes, as the JAX client's
    ``_sync_from_disk`` does: the event server looks up an access key on
    every request, and a key another process added is seen on the next
    one."""

    def __init__(self, basedir: str):
        self._path = os.path.join(basedir, "metadata.json")
        self._lock_path = os.path.join(basedir, ".metadata.lock")
        self._lock = threading.RLock()
        #: (the file's (inode, mtime_ns, size) or None, the parsed doc)
        self._cache: Optional[Tuple[Optional[tuple], dict]] = None

    @contextlib.contextmanager
    def _flocked(self):
        with self._lock, open(self._lock_path, "a+") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    @staticmethod
    def _key(st: os.stat_result) -> tuple:
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def _read(self) -> dict:
        """The document as on disk (the caller holds the flock); the
        parsed copy is refreshed with it."""
        try:
            with open(self._path) as f:
                key = self._key(os.fstat(f.fileno()))
                doc = json.load(f)
        except FileNotFoundError:
            key, doc = None, {}
        self._cache = (key, copy.deepcopy(doc))
        return doc

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
            self._cache = (self._key(os.stat(self._path)), doc)

    def rows(self, section: str) -> List[dict]:
        """A section's rows as stored, copied, from the parsed copy
        while the file is unchanged."""
        try:
            key = self._key(os.stat(self._path))
        except FileNotFoundError:
            key = None
        with self._lock:
            if self._cache is None or self._cache[0] != key:
                with self._flocked():
                    self._read()
            return copy.deepcopy(self._cache[1].get(section, []))

    def records(self, section: str, cls) -> list:
        return [dict_to_record(cls, rd) for rd in self.rows(section)]

    def upsert(self, section: str, field: str, record) -> None:
        """Replace the row whose ``field`` equals the record's, or add
        it."""
        rd = record_to_dict(record)
        with self.changing() as doc:
            rows = [r for r in doc.get(section, [])
                    if r[field] != rd[field]]
            doc[section] = rows + [rd]

    def remove(self, section: str, field: str, value) -> None:
        with self.changing() as doc:
            doc[section] = [r for r in doc.get(section, [])
                            if r[field] != value]

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

    def get(self, app_id):
        return next((a for a in self.get_all() if a.id == int(app_id)), None)

    def get_by_name(self, name):
        return next((a for a in self.get_all() if a.name == name), None)

    def get_all(self):
        return sorted(self._doc.records("apps", App), key=lambda a: a.id)

    def update(self, app):
        self._doc.upsert("apps", "id", app)

    def delete(self, app_id):
        self._doc.remove("apps", "id", int(app_id))


class LocalFSAccessKeysRepo(S.AccessKeysRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def insert(self, access_key: AccessKey) -> str:
        if not access_key.key:
            access_key = AccessKey.generate(access_key.appid,
                                            access_key.events)
        self._doc.upsert("access_keys", "key", access_key)
        return access_key.key

    def get(self, key):
        return next((dict_to_record(AccessKey, rd)
                     for rd in self._doc.rows("access_keys")
                     if rd["key"] == key), None)

    def get_all(self):
        return self._doc.records("access_keys", AccessKey)

    def get_by_app_id(self, app_id):
        return [k for k in self.get_all() if k.appid == int(app_id)]

    def update(self, access_key):
        self._doc.upsert("access_keys", "key", access_key)

    def delete(self, key):
        self._doc.remove("access_keys", "key", key)


class LocalFSChannelsRepo(S.ChannelsRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def insert(self, name, app_id) -> Channel:
        if not Channel.is_valid_name(name):
            raise S.StorageError(f"invalid channel name {name!r} (must "
                                 "match [a-zA-Z0-9-]{1,16})")
        with self._doc.changing() as doc:
            if any(rd["name"] == name and rd["appid"] == int(app_id)
                   for rd in doc.get("channels", [])):
                raise S.StorageError(
                    f"channel {name!r} already exists for app {app_id}")
            ch = Channel(id=self._doc.next_id(doc, "channels"), name=name,
                         appid=int(app_id))
            doc.setdefault("channels", []).append(record_to_dict(ch))
        return ch

    def get(self, channel_id):
        return next((c for c in self._doc.records("channels", Channel)
                     if c.id == int(channel_id)), None)

    def get_by_app_id(self, app_id):
        return sorted((c for c in self._doc.records("channels", Channel)
                       if c.appid == int(app_id)), key=lambda c: c.id)

    def delete(self, channel_id):
        self._doc.remove("channels", "id", int(channel_id))


class LocalFSEngineInstancesRepo(S.EngineInstancesRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def insert(self, instance: EngineInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        self._doc.upsert("engine_instances", "id", instance)
        return instance.id

    def get(self, id: str) -> Optional[EngineInstance]:
        return next((r for r in self.get_all() if r.id == id), None)

    def get_all(self) -> List[EngineInstance]:
        return self._doc.records("engine_instances", EngineInstance)


class LocalFSEvaluationInstancesRepo(S.EvaluationInstancesRepo):
    def __init__(self, doc: _MetadataDoc):
        self._doc = doc

    def insert(self, instance: EvaluationInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        self._doc.upsert("evaluation_instances", "id", instance)
        return instance.id

    def get(self, id: str) -> Optional[EvaluationInstance]:
        return next((r for r in self.get_all() if r.id == id), None)

    def get_all(self) -> List[EvaluationInstance]:
        return self._doc.records("evaluation_instances", EvaluationInstance)

    def delete(self, id: str) -> None:
        self._doc.remove("evaluation_instances", "id", id)


class LocalFSStorageClient(S.StorageClient):
    """Directory-rooted storage source; ``PATH`` config key sets the root."""

    def __init__(self, config: Dict[str, str]):
        basedir = os.path.expanduser(config.get("PATH") or "~/.pio_store")
        os.makedirs(basedir, exist_ok=True)
        doc = _MetadataDoc(basedir)
        self._events = LocalFSEventStore(basedir)
        self._apps = LocalFSAppsRepo(doc)
        self._access_keys = LocalFSAccessKeysRepo(doc)
        self._channels = LocalFSChannelsRepo(doc)
        self._engine_instances = LocalFSEngineInstancesRepo(doc)
        self._evaluation_instances = LocalFSEvaluationInstancesRepo(doc)
        self._models = LocalFSModelsRepo(basedir)

    def events(self): return self._events
    def apps(self): return self._apps
    def access_keys(self): return self._access_keys
    def channels(self): return self._channels
    def engine_instances(self): return self._engine_instances
    def evaluation_instances(self): return self._evaluation_instances
    def models(self): return self._models


S.register_backend("localfs", LocalFSStorageClient)
