"""DASE controller framework of the port (counterpart of
``predictionio_tpu.core``; ref: core/src/main/scala/io/prediction/controller/)."""

from predictionio_torch.core.params import Params, EmptyParams, EngineParams
from predictionio_torch.core.controller import (
    Algorithm,
    DataSource,
    FirstServing,
    Preparator,
    SanityCheck,
    Serving,
)
from predictionio_torch.core.engine import Engine, EngineFactory

__all__ = [
    "Params",
    "EmptyParams",
    "EngineParams",
    "DataSource",
    "Preparator",
    "SanityCheck",
    "Algorithm",
    "Serving",
    "FirstServing",
    "Engine",
    "EngineFactory",
]
