"""Events, metadata and model storage of the port (a trimmed copy of
``predictionio_tpu.data``: what ``pio build``, ``pio train`` and ``pio
deploy`` read and write, the native event log and entity properties
folded from ``$set`` events included)."""
