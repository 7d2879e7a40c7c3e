"""PyTorch runtime instrumentation: kernel builds, transfers, train steps,
device memory.

Counterpart of ``predictionio_tpu/obs/jaxmon.py``. The JAX module
bridges ``jax.monitoring``'s compile events into the registry; the
port compiles no programs, and its one compile tax is ``nvcc``
building the hand-written kernels (``ops/kernels/__init__.py``
``build_all``), which reports here:

  pio_kernel_build_total{kernel,result="built"|"cached"|
                         "cache_unavailable"}       library built now or
                                                    found on disk; the
                                                    cache directory could
                                                    not be used
  pio_kernel_build_seconds{kernel}                  nvcc wall time
  pio_kernel_enabled{kernel=}                       kernel vs torch form
                                                    (the JAX package's
                                                    pio_pallas_kernel_enabled)
  pio_transfer_bytes_total{direction="h2d"|"d2h"}   explicit hot-path counts
  pio_train_step_seconds_bucket                     per timed train dispatch
  pio_train_seconds_bucket{engine=...}              whole-train wall time
  pio_device_memory_bytes{device,kind}              owned by obs/memacct.py

Every family but the kernel ones keeps its JAX name, so one dashboard
reads both packages. Nothing here imports torch or raises:
observability must not change whether training runs.

:func:`train_steps` counts the steps JAX's profile capture divides by
(``workflow/train.py``): the session trainer's steps, and the two-tower
trainer's epochs (one dispatch each in the JAX package). It is kept
apart from ``pio_train_step_seconds``, which the session trainer feeds
once an epoch (it times the epoch, its steps run asynchronously).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from predictionio_torch.obs import metrics

log = logging.getLogger(__name__)

#: nvcc builds run seconds..minutes; coarse buckets
_BUILD_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

KERNEL_BUILD_TOTAL = metrics.counter(
    "pio_kernel_build_total",
    "Kernel library requests by outcome: built (nvcc ran now), cached "
    "(the library for this source, these flags and this nvcc was on "
    "disk) or cache_unavailable (PIO_COMPILE_CACHE_DIR could not be "
    "used; the package's _build/ served instead)",
    ("kernel", "result"),
)

KERNEL_BUILD_SECONDS = metrics.histogram(
    "pio_kernel_build_seconds",
    "nvcc wall time of a kernel library build",
    ("kernel",),
    buckets=_BUILD_BUCKETS,
)

TRANSFER_BYTES = metrics.counter(
    "pio_transfer_bytes_total",
    "Host<->device bytes moved on instrumented hot paths",
    ("direction",),
)

TRAIN_STEP_SECONDS = metrics.histogram(
    "pio_train_step_seconds",
    "Per-train-step wall time (dispatch + device compute)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0),
)

TRAIN_SECONDS = metrics.histogram(
    "pio_train_seconds",
    "Whole engine.train wall time per training run",
    ("engine",),
    buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0, 600.0,
             1800.0, 3600.0),
)

KERNEL_ENABLED = metrics.gauge(
    "pio_kernel_enabled",
    "Whether a hand-written kernel (ops/kernels/) computes this part of "
    "the current trainer (1) or its torch form does (0)",
    ("kernel",),
)


def record_kernel_build(kernel: str, seconds: Optional[float]) -> None:
    """One kernel library request: ``seconds`` of nvcc when it was built
    now, None when the library was found on disk."""
    if seconds is None:
        KERNEL_BUILD_TOTAL.labels(kernel, "cached").inc()
        return
    KERNEL_BUILD_TOTAL.labels(kernel, "built").inc()
    KERNEL_BUILD_SECONDS.labels(kernel).observe(seconds)


def record_kernel_plan(plan: dict) -> None:
    """Export a trainer's kernel selection so a capture always says
    which path produced its numbers."""
    for kernel in ("flash_ce", "embed_update"):
        if kernel in plan:
            KERNEL_ENABLED.labels(kernel).set(float(bool(plan[kernel])))


_steps_lock = threading.Lock()
_train_steps = 0


def count_train_steps(n: int) -> None:
    """Add ``n`` train steps, as JAX's profile capture counts them."""
    global _train_steps
    with _steps_lock:
        _train_steps += int(n)


def train_steps() -> int:
    """Train steps counted in this process so far (read before and after
    a train: the difference is the train's)."""
    with _steps_lock:
        return _train_steps


def record_transfer(nbytes: Optional[int], direction: str) -> None:
    """Count one host<->device transfer (direction: 'h2d' | 'd2h')."""
    if nbytes:
        TRANSFER_BYTES.labels(direction).inc(int(nbytes))


def observe_train_step(seconds: float) -> None:
    TRAIN_STEP_SECONDS.observe(seconds)
    # feed the train-step deadman (obs/health.py): each observation
    # both extends its duration history and pushes the stall deadline
    # out; silence beyond factor x trailing median fires the watchdog
    from predictionio_torch.obs import health

    health.TRAIN_WATCHDOG.beat(seconds)


def update_device_memory_gauges() -> int:
    """Refresh pio_device_memory_bytes from each initialised card's
    allocator; returns the number of cards reporting. Delegates to
    obs/memacct.py, the one owner of device-memory accounting."""
    from predictionio_torch.obs import memacct

    return memacct.update_device_memory_gauges()
