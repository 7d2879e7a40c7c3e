"""Metadata and model storage of the port (a trimmed copy of
``predictionio_tpu.data``: what ``pio deploy`` reads). The event store
comes with the training slice."""
