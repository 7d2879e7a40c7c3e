"""Numeric code of the port: plain PyTorch, plus the hand-written Hopper
kernels under ``ops/kernels`` (the counterparts of ``ops/pallas``)."""
