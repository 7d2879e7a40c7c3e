"""Events, metadata and model storage of the port (a trimmed copy of
``predictionio_tpu.data``: what ``pio train`` and ``pio deploy`` read
and write)."""
