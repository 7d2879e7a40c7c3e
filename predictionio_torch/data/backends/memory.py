"""In-memory storage backend (engine instances and model blobs).

Copy of the corresponding parts of
``predictionio_tpu/data/backends/memory.py``: plain dicts under one
lock, records deep-copied at the repo boundary so callers mutating a
record after insert do not change what is stored.
"""

from __future__ import annotations

import copy
import threading
import uuid
from typing import Dict

from predictionio_torch.data import storage as S
from predictionio_torch.data.metadata import EngineInstance, Model


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
            self._models[model.id] = Model(id=model.id, models=bytes(model.models))

    def get(self, id):
        with self._lock:
            m = self._models.get(id)
            return Model(id=m.id, models=m.models) if m is not None else None


class MemoryStorageClient(S.StorageClient):
    def __init__(self, config: Dict[str, str]):
        lock = threading.RLock()
        self._engine_instances = MemoryEngineInstancesRepo(lock)
        self._models = MemoryModelsRepo(lock)

    def engine_instances(self): return self._engine_instances
    def models(self): return self._models


S.register_backend("memory", MemoryStorageClient)
