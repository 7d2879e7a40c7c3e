"""Model persistence manifests.

Counterpart of ``predictionio_tpu/core/persistent_model.py`` for the
deploy side (ref: controller/PersistentModel.scala:47,72,
PersistentModelManifest.scala:18): an algorithm whose model saves itself
stores only a manifest naming its loader class in the Models repo; at
deploy the manifest's class loads the model. No model of the port saves
itself (``pio train`` pickles them whole), so the saving side is not
ported. A manifest naming a class under ``predictionio_tpu.`` resolves
under ``predictionio_torch.``.
"""

from __future__ import annotations

import importlib
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


def load_from_manifest(manifest: PersistentModelManifest, instance_id: str,
                       params: Params, ctx: DeviceContext) -> Any:
    """ref: SparkWorkflowUtils.getPersistentModel (WorkflowUtils.scala:356)."""
    cls: Any = importlib.import_module(port_module(manifest.module_name))
    for part in manifest.class_name.split("."):
        cls = getattr(cls, part)
    return cls.load(instance_id, params, ctx)
