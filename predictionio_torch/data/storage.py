"""Storage abstraction + env-configured registry.

Copy of ``predictionio_tpu/data/storage.py`` trimmed to what the event
server, the app and access-key commands, ``pio train`` and ``pio
deploy`` and ``pio eval`` use: the EVENTDATA repository (events:
appended one by one, in batches or as dict-encoded columns; read by id,
by a filtered scan, as dict-encoded columns, or binned straight into the
ALS layout by the native event log), the apps, access keys and channels that
name an event table, engine and evaluation instances and model blobs. The env-var
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
import logging
import math
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import (AccessKey, App, Channel,
                                              EngineInstance,
                                              EvaluationInstance, Model)

log = logging.getLogger(__name__)

#: sentinel distinguishing "don't filter" from "filter for None"
#: (ref: PEvents.find targetEntityType: Option[Option[String]])
UNSET = object()


class StorageError(RuntimeError):
    pass


class RowValidationError(StorageError):
    """A strict batch insert met an invalid row: a client-data error
    (nothing was appended), never a backend fault."""


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


@dataclasses.dataclass
class BinnedSide:
    """One side of the ALS trainer's transfer-compressed segmented
    layout as the native builders produce it (``el_bin_columnar``,
    ``rb_bin_compressed``): the same shapes and bytes as
    ``ops.als.compress_side(ops.ragged.build_segmented_groups(...))``
    over the same COO. The arrays may be zero-copy views over native
    buffers, whose lifetime their buffer objects anchor
    (``native.as_ndarray``)."""

    idx_lo: np.ndarray              # [R, L] uint16
    idx_hi: Optional[np.ndarray]    # [R, L] uint8, None when vocab < 2^16
    val: np.ndarray                 # [R, L] uint8 codes | float32
    mask: Optional[np.ndarray]      # [R, L] uint8, None when val is coded
    seg: np.ndarray                 # [R] int32
    counts: np.ndarray              # [G] int32
    affine: Optional[Tuple[float, float]]
    row_block: int
    group_block: int
    groups_per_shard: int
    n_shards: int
    n_groups: int                   # true group count (before padding)
    kept_entries: int
    kept_value_sum: float


@dataclasses.dataclass
class BinnedInteractions:
    """Both sides of an interaction dataset binned straight off the
    event log by one native call: grouped by entity (users) and by
    target (items), the id vocabularies (first-seen order), and an
    optional held-out COO split. ``scan_sec``/``bin_sec`` are the
    native call's own split of its time: filter, encode and vocabularies
    against plan and fill."""

    user_side: BinnedSide
    item_side: BinnedSide
    entity_vocab: List[str]
    target_vocab: List[str]
    #: (user_idx int32, item_idx int32, values float32) or None
    holdout: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    n_rows: int
    scan_sec: float
    bin_sec: float


def pack_vocab(vocab) -> tuple:
    """Concatenated UTF-8 bytes + exact (len+1) uint64 prefix offsets:
    the separator-free dictionary layout of the native columnar calls
    and of the bin cache, so ids holding any byte round-trip."""
    bs = [s.encode("utf-8") for s in vocab]
    offsets = np.zeros(len(bs) + 1, np.uint64)
    if bs:
        np.cumsum(np.fromiter((len(b) for b in bs), np.uint64,
                              count=len(bs)), out=offsets[1:])
    return b"".join(bs), offsets


def unpack_vocab(data, offsets) -> List[str]:
    """Inverse of :func:`pack_vocab`: concatenated bytes (bytes or a
    uint8 array) + prefix offsets -> the vocabulary list."""
    raw = data.tobytes() if hasattr(data, "tobytes") else bytes(data)
    offs = [int(o) for o in offsets]
    return [raw[offs[i]:offs[i + 1]].decode("utf-8")
            for i in range(len(offs) - 1)]


class EventStore(abc.ABC):
    """Event DAO (ref: LEvents.scala:30 + PEvents.scala:30, one store
    for both the write path and the bulk training read)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Create the event table of an app (ref: LEvents.init)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Drop the event table of an app (ref: LEvents.remove)."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Append one event, returning its assigned eventId."""

    def insert_batch(self, events: List[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Bulk append (ref: PEvents.write:124)."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        """The event with this id, or None (ref: LEvents.get)."""

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        """Delete one event; False when there was none (ref:
        LEvents.delete)."""

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

    def insert_columnar(self, cols: EventColumns, app_id: int,
                        channel_id: Optional[int] = None, *,
                        entity_type: str,
                        target_entity_type: Optional[str] = None,
                        value_property: Optional[str] = None) -> int:
        """Bulk append from dict-encoded columns, the ingest mirror of
        ``find_columnar`` (ref: PEvents.write:124): ``values`` NaN = no
        property, ``target_codes`` -1 = no target; event times come
        from ``times_us`` and fresh ids are assigned. Returns the row
        count. This default builds events in chunks; the native event
        log packs the rows in C++."""
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        n = len(cols)
        chunk = 100_000
        for s in range(0, n, chunk):
            events = []
            for i in range(s, min(s + chunk, n)):
                props: Dict[str, Any] = {}
                v = (float(cols.values[i]) if value_property is not None
                     else math.nan)
                if not math.isnan(v):
                    props[value_property] = v
                tc = int(cols.target_codes[i])
                events.append(Event(
                    event=cols.names[cols.name_codes[i]],
                    entity_type=entity_type,
                    entity_id=cols.entity_vocab[cols.entity_codes[i]],
                    target_entity_type=target_entity_type if tc >= 0 else None,
                    target_entity_id=cols.target_vocab[tc] if tc >= 0 else None,
                    properties=props,
                    event_time=epoch + _dt.timedelta(
                        microseconds=int(cols.times_us[i]))))
            self.insert_batch(events, app_id, channel_id)
        return n

    def compact(self, app_id: int, channel_id: Optional[int] = None):
        """Reclaim the space of deleted or superseded events (the HBase
        major-compaction role). Stores that update in place have none to
        reclaim and return None; the native event log overrides."""
        return None


class AppsRepo(abc.ABC):
    """ref: Apps.scala"""

    @abc.abstractmethod
    def insert(self, name: str, description: Optional[str] = None) -> App: ...
    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...
    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...
    @abc.abstractmethod
    def get_all(self) -> List[App]: ...
    @abc.abstractmethod
    def update(self, app: App) -> None: ...
    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...


class AccessKeysRepo(abc.ABC):
    """ref: AccessKeys.scala"""

    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str: ...
    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...
    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...
    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...
    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> None: ...
    @abc.abstractmethod
    def delete(self, key: str) -> None: ...


class ChannelsRepo(abc.ABC):
    """ref: Channels.scala — created by ``pio app channel-new``; a
    channel names its own event table of the app."""

    @abc.abstractmethod
    def insert(self, name: str, app_id: int) -> Channel: ...
    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...
    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...
    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...


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


class EvaluationInstancesRepo(abc.ABC):
    """ref: EvaluationInstances.scala"""

    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[EvaluationInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...
    @abc.abstractmethod
    def delete(self, id: str) -> None: ...

    def update(self, instance: EvaluationInstance) -> None:
        """Replace the record under its id (insert is an upsert)."""
        self.insert(instance)

    def get_completed(self) -> List[EvaluationInstance]:
        """ref: EvaluationInstances.getCompleted — EVALCOMPLETED runs,
        newest first."""
        out = [i for i in self.get_all() if i.status == "EVALCOMPLETED"]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out


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
    def access_keys(self) -> AccessKeysRepo: ...
    @abc.abstractmethod
    def channels(self) -> ChannelsRepo: ...
    @abc.abstractmethod
    def engine_instances(self) -> EngineInstancesRepo: ...
    @abc.abstractmethod
    def evaluation_instances(self) -> EvaluationInstancesRepo: ...
    @abc.abstractmethod
    def models(self) -> ModelsRepo: ...

    def health_check(self) -> bool:
        """Backend reachability probe (ref: Storage.verifyAllDataObjects
        instantiates each DAO against its live backend). The port's
        backends are local and healthy once constructed."""
        return True


_BACKENDS: Dict[str, type] = {}


def register_backend(type_name: str, client_cls: type) -> None:
    _BACKENDS[type_name] = client_cls


def _load_backends() -> None:
    # import side effect registers the built-in backends; the eventlog
    # backend builds its native library at first use, not on import
    from predictionio_torch.data.backends import (eventlog, localfs,  # noqa: F401
                                                  memory)


_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_(.+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


class Storage:
    """Repositories mapped to StorageClients (ref: Storage.scala:40-166).
    A source is opened at its first use, so a deployment whose EVENTDATA
    source has a type the port lacks still reads its metadata and
    models."""

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

    def access_keys(self) -> AccessKeysRepo:
        return self.client_for("METADATA").access_keys()

    def channels(self) -> ChannelsRepo:
        return self.client_for("METADATA").channels()

    def engine_instances(self) -> EngineInstancesRepo:
        return self.client_for("METADATA").engine_instances()

    def evaluation_instances(self) -> EvaluationInstancesRepo:
        return self.client_for("METADATA").evaluation_instances()

    def models(self) -> ModelsRepo:
        return self.client_for("MODELDATA").models()

    def verify_all_data_objects(self) -> Dict[str, bool]:
        """ref: Storage.verifyAllDataObjects:237 — each repository's
        source opened and probed; a source that cannot be opened (a TYPE
        the port lacks, an unreadable path) reads False."""
        results: Dict[str, bool] = {}
        for repo in REPOSITORIES:
            try:
                results[repo] = self.client_for(repo).health_check()
            except Exception as e:  # noqa: BLE001 — reported, not raised
                log.warning("health check failed for %s: %s: %s",
                            repo, type(e).__name__, e)
                results[repo] = False
        return results

    def serving_status(self) -> Dict[str, Dict[str, Any]]:
        """Per repository, whether its source can answer (``serving``),
        whether it answers with some endpoint down (``degraded``) and
        each endpoint's state: the shape ``pio status`` reads. Every
        port source has one endpoint, so ``degraded`` is always False."""
        return {repo: {"serving": up, "degraded": False,
                       "endpoints": {"": up}}
                for repo, up in self.verify_all_data_objects().items()}

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
