"""Opt-in custom model persistence.

Counterpart of ``predictionio_tpu/core/persistent_model.py`` (ref:
controller/PersistentModel.scala:47,72, PersistentModelManifest.scala:18):
an algorithm whose model implements ``PersistentModel`` saves itself
under the engine-instance id at ``pio train``, and the Models repo then
stores only a manifest naming its loader class; at deploy the manifest's
class loads the model. ``LocalFileSystemPersistentModel`` (ref:
LocalFileSystemPersistentModel.scala:26) is the ready-made file-based
implementation, in the same directory as the JAX package's
(``$PIO_FS_BASEDIR/persistent_models``), so each package deploys what the
other saved. A manifest or a saved file naming a class under
``predictionio_tpu.`` resolves under ``predictionio_torch.``.
"""

from __future__ import annotations

import abc
import importlib
import os
import pickle
from dataclasses import dataclass
from typing import Any

from predictionio_torch.core.engine import port_module
from predictionio_torch.core.params import Params
from predictionio_torch.parallel.context import DeviceContext


@dataclass(frozen=True)
class PersistentModelManifest:
    """Stored in the Models repo instead of the model bytes
    (ref: PersistentModelManifest.scala:18)."""

    class_name: str
    module_name: str


class PersistentModel(abc.ABC):
    """Models that manage their own persistence (ref: PersistentModel.scala:47)."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Params,
             ctx: DeviceContext) -> bool:
        """Persist under the engine-instance id; return True if saved."""

    @classmethod
    @abc.abstractmethod
    def load(cls, instance_id: str, params: Params,
             ctx: DeviceContext) -> "PersistentModel":
        """ref: PersistentModelLoader.apply."""


def model_base_dir() -> str:
    base = os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store"))
    path = os.path.join(base, "persistent_models")
    os.makedirs(path, exist_ok=True)
    return path


class LocalFileSystemPersistentModel(PersistentModel):
    """File-per-instance pickle persistence
    (ref: LocalFileSystemPersistentModel.scala:26)."""

    def save(self, instance_id: str, params: Params,
             ctx: DeviceContext) -> bool:
        with open(os.path.join(model_base_dir(), instance_id), "wb") as f:
            pickle.dump(self, f)
        return True

    @classmethod
    def load(cls, instance_id: str, params: Params, ctx: DeviceContext):
        # the deploy loader's unpickler: a file the JAX package saved
        # loads into the port's classes
        from predictionio_torch.workflow.deploy import load_blob

        with open(os.path.join(model_base_dir(), instance_id), "rb") as f:
            return load_blob(f.read())


def manifest_for(model: PersistentModel) -> PersistentModelManifest:
    return PersistentModelManifest(class_name=type(model).__qualname__,
                                   module_name=type(model).__module__)


def load_from_manifest(manifest: PersistentModelManifest, instance_id: str,
                       params: Params, ctx: DeviceContext) -> Any:
    """ref: SparkWorkflowUtils.getPersistentModel (WorkflowUtils.scala:356)."""
    cls: Any = importlib.import_module(port_module(manifest.module_name))
    for part in manifest.class_name.split("."):
        cls = getattr(cls, part)
    return cls.load(instance_id, params, ctx)
