"""Storage abstraction + env-configured registry.

Copy of ``predictionio_tpu/data/storage.py`` trimmed to what ``pio
train`` and ``pio deploy`` use: the EVENTDATA repository (events, read
by a filtered scan or as dict-encoded columns), the apps and channels
that name an event table, engine instances and model blobs. The env-var
contract is the same (ref: Storage.scala:40,151,183): sources are
declared with ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-type config)
and repositories are mapped onto them with
``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}``; with no storage vars
at all, one localfs source rooted at ``$PIO_FS_BASEDIR`` (default
``~/.pio_store``) serves everything.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt
import os
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import (App, Channel, EngineInstance,
                                              Model)

#: sentinel distinguishing "don't filter" from "filter for None"
#: (ref: PEvents.find targetEntityType: Option[Option[String]])
UNSET = object()


class StorageError(RuntimeError):
    pass


@dataclasses.dataclass
class EventColumns:
    """Dict-encoded columnar view of a filtered event scan — the bulk
    training read. ``entity_codes[i]`` indexes ``entity_vocab``
    (first-seen order); ``target_codes[i]`` likewise, with -1 for events
    without a target id. ``values[i]`` is the numeric property asked for
    via ``value_property`` (NaN when absent or not numeric). ``times_us``
    is the event time in epoch microseconds (UTC)."""

    entity_codes: np.ndarray      # int32 [n]
    target_codes: np.ndarray      # int32 [n], -1 = no target id
    name_codes: np.ndarray        # int32 [n]
    values: np.ndarray            # float64 [n], NaN = absent
    times_us: np.ndarray          # int64 [n]
    entity_vocab: List[str]
    target_vocab: List[str]
    names: List[str]

    def __len__(self) -> int:
        return len(self.entity_codes)


class EventStore(abc.ABC):
    """Event DAO (ref: LEvents.scala:30 + PEvents.scala:30, one store
    for both the write path and the bulk training read)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Create the event table of an app (ref: LEvents.init)."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Append one event, returning its assigned eventId."""

    def insert_batch(self, events: List[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Bulk append (ref: PEvents.write:124)."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def find(self, app_id: int, channel_id: Optional[int] = None,
             start_time: Optional[_dt.datetime] = None,
             until_time: Optional[_dt.datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[List[str]] = None,
             target_entity_type: Any = UNSET,
             target_entity_id: Any = UNSET,
             limit: Optional[int] = None,
             reversed: bool = False) -> List[Event]:
        """Filtered scan ordered by event time (ref: PEvents.find:70);
        ``[start_time, until_time)`` is half-open, ``limit`` None or -1
        means all, ``reversed`` returns newest first."""

    def find_columnar(self, app_id: int, channel_id: Optional[int] = None,
                      value_property: Optional[str] = None,
                      time_ordered: bool = True,
                      **find_kwargs) -> EventColumns:
        """Filtered scan as dict-encoded columns (see EventColumns), by
        converting ``find``'s events as the JAX package's default does.
        ``time_ordered`` is accepted for the same signature: ``find``
        always orders by time."""
        events = self.find(app_id, channel_id=channel_id, **find_kwargs)
        n = len(events)
        ent_codes = np.empty(n, np.int32)
        tgt_codes = np.empty(n, np.int32)
        name_codes = np.empty(n, np.int32)
        values = np.full(n, np.nan, np.float64)
        times_us = np.empty(n, np.int64)
        ent_vocab: Dict[str, int] = {}
        tgt_vocab: Dict[str, int] = {}
        name_vocab: Dict[str, int] = {}
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        for i, e in enumerate(events):
            ent_codes[i] = ent_vocab.setdefault(e.entity_id, len(ent_vocab))
            tgt_codes[i] = (-1 if e.target_entity_id is None else
                            tgt_vocab.setdefault(e.target_entity_id,
                                                 len(tgt_vocab)))
            name_codes[i] = name_vocab.setdefault(e.event, len(name_vocab))
            times_us[i] = (e.event_time - epoch) // _dt.timedelta(
                microseconds=1)
            if value_property is not None:
                v = e.properties.get_opt(value_property)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    values[i] = float(v)
        return EventColumns(
            entity_codes=ent_codes, target_codes=tgt_codes,
            name_codes=name_codes, values=values, times_us=times_us,
            entity_vocab=list(ent_vocab), target_vocab=list(tgt_vocab),
            names=list(name_vocab))


class AppsRepo(abc.ABC):
    """ref: Apps.scala"""

    @abc.abstractmethod
    def insert(self, name: str, description: Optional[str] = None) -> App: ...
    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self.get_all() if a.name == name), None)


class ChannelsRepo(abc.ABC):
    """ref: Channels.scala — read by app-name resolution; channels are
    created with the JAX package's ``pio app channel-new``."""

    @abc.abstractmethod
    def get_all(self) -> List[Channel]: ...

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return sorted((c for c in self.get_all() if c.appid == int(app_id)),
                      key=lambda c: c.id)


class EngineInstancesRepo(abc.ABC):
    """ref: EngineInstances.scala"""

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[EngineInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    def update(self, instance: EngineInstance) -> None:
        """Replace the record under its id (insert is an upsert)."""
        self.insert(instance)

    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        """ref: EngineInstances.getCompleted — newest first."""
        out = [i for i in self.get_all()
               if i.status == "COMPLETED" and i.engine_id == engine_id
               and i.engine_version == engine_version
               and i.engine_variant == engine_variant]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str) -> Optional[EngineInstance]:
        completed = self.get_completed(engine_id, engine_version,
                                       engine_variant)
        return completed[0] if completed else None


class ModelsRepo(abc.ABC):
    """ref: Models.scala — model blobs keyed by engine-instance id."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[Model]: ...


class StorageClient(abc.ABC):
    """One configured storage source (ref: BaseStorageClient,
    Storage.scala:298), made from its ``PIO_STORAGE_SOURCES_<NAME>_*``
    config."""

    @abc.abstractmethod
    def events(self) -> EventStore: ...
    @abc.abstractmethod
    def apps(self) -> AppsRepo: ...
    @abc.abstractmethod
    def channels(self) -> ChannelsRepo: ...
    @abc.abstractmethod
    def engine_instances(self) -> EngineInstancesRepo: ...
    @abc.abstractmethod
    def models(self) -> ModelsRepo: ...


_BACKENDS: Dict[str, type] = {}


def register_backend(type_name: str, client_cls: type) -> None:
    _BACKENDS[type_name] = client_cls


def _load_backends() -> None:
    # import side effect registers the built-in backends
    from predictionio_torch.data.backends import localfs, memory  # noqa: F401


_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_(.+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


class Storage:
    """Repositories mapped to StorageClients (ref: Storage.scala:40-166).
    A source is opened at its first use, so a deployment whose EVENTDATA
    source has a type the port lacks (the native eventlog) still reads
    its metadata and models."""

    def __init__(self, sources: Dict[str, Dict[str, str]],
                 repo_to_source: Dict[str, str]):
        self._sources = sources
        self._repo_to_source = repo_to_source
        self._clients: Dict[str, StorageClient] = {}
        self._lock = threading.Lock()

    def client_for(self, repo: str) -> StorageClient:
        source = self._repo_to_source.get(repo.upper())
        if source is None or source not in self._sources:
            raise StorageError(f"repository {repo} has no configured source")
        with self._lock:
            client = self._clients.get(source)
            if client is None:
                type_name = self._sources[source].get("TYPE")
                if type_name not in _BACKENDS:
                    raise StorageError(
                        f"storage source {source}: TYPE {type_name!r} is "
                        f"not ported (known: {sorted(_BACKENDS)})")
                client = _BACKENDS[type_name](self._sources[source])
                self._clients[source] = client
        return client

    def events(self) -> EventStore:
        return self.client_for("EVENTDATA").events()

    def apps(self) -> AppsRepo:
        return self.client_for("METADATA").apps()

    def channels(self) -> ChannelsRepo:
        return self.client_for("METADATA").channels()

    def engine_instances(self) -> EngineInstancesRepo:
        return self.client_for("METADATA").engine_instances()

    def models(self) -> ModelsRepo:
        return self.client_for("MODELDATA").models()

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "Storage":
        """Parse PIO_STORAGE_* env vars (ref: Storage.scala:45-128)."""
        _load_backends()
        env = dict(env if env is not None else os.environ)
        sources: Dict[str, Dict[str, str]] = {}
        repos: Dict[str, Dict[str, str]] = {}
        for key, value in env.items():
            m = _SOURCE_RE.match(key)
            if m:
                sources.setdefault(m.group(1), {})[m.group(2)] = value
                continue
            m = _REPO_RE.match(key)
            if m:
                repos.setdefault(m.group(1), {})[m.group(2)] = value
        if not sources:
            basedir = env.get("PIO_FS_BASEDIR",
                              os.path.expanduser("~/.pio_store"))
            sources = {"LOCALFS": {"TYPE": "localfs", "PATH": basedir}}
            repos = {r: {"NAME": r.lower(), "SOURCE": "LOCALFS"}
                     for r in REPOSITORIES}

        repo_to_source: Dict[str, str] = {}
        for repo in REPOSITORIES:
            cfg = repos.get(repo)
            if cfg and cfg.get("SOURCE"):
                repo_to_source[repo] = cfg["SOURCE"]
            elif len(sources) == 1:
                repo_to_source[repo] = next(iter(sources))
        return Storage(sources, repo_to_source)


_storage_lock = threading.Lock()
_storage: Optional[Storage] = None


def get_storage() -> Storage:
    global _storage
    with _storage_lock:
        if _storage is None:
            _storage = Storage.from_env()
        return _storage


def set_storage(storage: Optional[Storage]) -> None:
    """Install/replace (or with None, reset) the process-wide storage."""
    global _storage
    with _storage_lock:
        _storage = storage
