"""Storage abstraction + env-configured registry, for what deploy reads.

Copy of ``predictionio_tpu/data/storage.py`` trimmed to the METADATA
and MODELDATA repositories: engine instances and model blobs. The
env-var contract is the same (ref: Storage.scala:40,151,183): sources
are declared with ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-type
config) and repositories are mapped onto them with
``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}``; with no storage vars
at all, one localfs source rooted at ``$PIO_FS_BASEDIR`` (default
``~/.pio_store``) serves everything. Sources that only the EVENTDATA
repository uses are not opened: the event store comes with the
training slice.
"""

from __future__ import annotations

import abc
import os
import re
import threading
from typing import Dict, List, Optional

from predictionio_torch.data.metadata import EngineInstance, Model


class StorageError(RuntimeError):
    pass


class EngineInstancesRepo(abc.ABC):
    """ref: EngineInstances.scala"""

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[EngineInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

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

REPOSITORIES = ("METADATA", "MODELDATA")


class Storage:
    """Repositories mapped to live StorageClients (ref: Storage.scala:40-166)."""

    def __init__(self, clients: Dict[str, StorageClient],
                 repo_to_source: Dict[str, str]):
        self._clients = clients
        self._repo_to_source = repo_to_source

    def client_for(self, repo: str) -> StorageClient:
        source = self._repo_to_source.get(repo.upper())
        if source is None or source not in self._clients:
            raise StorageError(f"repository {repo} has no configured source")
        return self._clients[source]

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
        clients: Dict[str, StorageClient] = {}
        for name in sorted(set(repo_to_source.values()) & set(sources)):
            type_name = sources[name].get("TYPE")
            if type_name not in _BACKENDS:
                raise StorageError(
                    f"storage source {name}: TYPE {type_name!r} is not "
                    f"ported (known: {sorted(_BACKENDS)})")
            clients[name] = _BACKENDS[type_name](sources[name])
        return Storage(clients, repo_to_source)


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
