"""Storage backends of the port: ``memory`` (in-process, tests and
embedding), ``localfs`` (the single-host default) and ``eventlog`` (the
native append-only event log with its fused scan+bin; metadata and
models in localfs), each in the same on-disk format as
``predictionio_tpu``'s."""
