"""DASE controller framework of the port (counterpart of
``predictionio_tpu.core``; ref: core/src/main/scala/io/prediction/controller/)."""

from predictionio_torch.core.params import Params, EmptyParams, EngineParams
from predictionio_torch.core.controller import (
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    Preparator,
    SanityCheck,
    Serving,
)
from predictionio_torch.core.engine import (Engine, EngineFactory, SimpleEngine,
                                         TrainResult)

__all__ = [
    "Params",
    "EmptyParams",
    "EngineParams",
    "DataSource",
    "Preparator",
    "IdentityPreparator",
    "SanityCheck",
    "Algorithm",
    "Serving",
    "FirstServing",
    "AverageServing",
    "Engine",
    "EngineFactory",
    "SimpleEngine",
    "TrainResult",
]
