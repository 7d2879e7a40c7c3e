"""CLI of the port (counterpart of ``predictionio_tpu.tools``)."""
