"""Local-filesystem storage backend: engine instances and model blobs.

The on-disk format is ``predictionio_tpu/data/backends/localfs.py``'s,
so the port reads what ``pio train`` wrote and the JAX package reads
what the port writes:

  - metadata -> one JSON document ``<root>/metadata.json``; engine
                instances are its ``"engine_instances"`` list (ref:
                elasticsearch indices)
  - models   -> blob files ``<root>/models/pio_<id>``
                (ref: localfs/LocalFSModels.scala:29)

The port owns only the ``"engine_instances"`` section: every other
section of the document (apps, access keys, channels, sequences, ...)
is written back as it was read. Reads and writes hold the same
exclusive ``flock`` on ``<root>/.metadata.lock`` as the JAX backend, so
processes of both packages can share one root; writes are atomic
renames.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import threading
import uuid
from typing import Dict, List, Optional

from predictionio_torch.data import storage as S
from predictionio_torch.data.metadata import (EngineInstance, Model,
                                              dict_to_record, record_to_dict)

_SECTION = "engine_instances"


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


class LocalFSEngineInstancesRepo(S.EngineInstancesRepo):
    def __init__(self, basedir: str):
        self._meta_path = os.path.join(basedir, "metadata.json")
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

    def _read_doc(self) -> dict:
        try:
            with open(self._meta_path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def _records(self, doc: dict) -> Dict[str, EngineInstance]:
        return {rd["id"]: dict_to_record(EngineInstance, rd)
                for rd in doc.get(_SECTION, [])}

    def _write(self, doc: dict, records: Dict[str, EngineInstance]) -> None:
        doc[_SECTION] = [record_to_dict(r) for r in records.values()]
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(doc, indent=1, sort_keys=True))
        os.replace(tmp, self._meta_path)

    def insert(self, instance: EngineInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        with self._flocked():
            doc = self._read_doc()
            records = self._records(doc)
            records[instance.id] = instance
            self._write(doc, records)
        return instance.id

    def get(self, id: str) -> Optional[EngineInstance]:
        with self._flocked():
            return self._records(self._read_doc()).get(id)

    def get_all(self) -> List[EngineInstance]:
        with self._flocked():
            return list(self._records(self._read_doc()).values())


class LocalFSStorageClient(S.StorageClient):
    """Directory-rooted storage source; ``PATH`` config key sets the root."""

    def __init__(self, config: Dict[str, str]):
        basedir = os.path.expanduser(config.get("PATH") or "~/.pio_store")
        os.makedirs(basedir, exist_ok=True)
        self._engine_instances = LocalFSEngineInstancesRepo(basedir)
        self._models = LocalFSModelsRepo(basedir)

    def engine_instances(self): return self._engine_instances
    def models(self): return self._models


S.register_backend("localfs", LocalFSStorageClient)
