"""Device placement for the port (the counterpart of predictionio_tpu.parallel)."""

from predictionio_torch.parallel.context import DeviceContext, resolve_device

__all__ = ["DeviceContext", "resolve_device"]
