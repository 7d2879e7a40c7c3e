"""The benchmark of ``predictionio_torch`` on one NVIDIA H100 (see README.md)."""
