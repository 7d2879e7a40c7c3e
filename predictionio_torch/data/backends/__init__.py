"""Storage backends of the port: ``memory`` (in-process, tests and
embedding) and ``localfs`` (the single-host default, in the same
on-disk format as ``predictionio_tpu``'s)."""
