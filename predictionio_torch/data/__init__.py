"""Events, metadata and model storage of the port (counterpart of
``predictionio_tpu.data``; ref: data/src/main/scala/io/prediction/data/):
what ``pio build``, ``pio train`` and ``pio deploy`` read and write, the
native event log and entity properties folded from ``$set`` events
included."""

from predictionio_torch.data.event import Event, EventValidationError, validate_event
from predictionio_torch.data.datamap import DataMap, PropertyMap
from predictionio_torch.data.aggregation import aggregate_properties_from_events
from predictionio_torch.data.bimap import BiMap, EntityIdIxMap, EntityMap

__all__ = [
    "Event",
    "EventValidationError",
    "validate_event",
    "DataMap",
    "PropertyMap",
    "aggregate_properties_from_events",
    "BiMap",
    "EntityIdIxMap",
    "EntityMap",
]
