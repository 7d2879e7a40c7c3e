"""The kernel-library cache: ``nvcc`` output shared across processes.

Counterpart of ``predictionio_tpu/parallel/compile_cache.py``. The JAX
package caches XLA executables; the port compiles no XLA, and its
compile tax is ``nvcc`` building the hand-written kernels
(``ops/kernels/__init__.py``), which can take minutes for one source.
This module says where the built libraries live:

  PIO_COMPILE_CACHE_DIR  cache directory; the libraries go under
                         ``<dir>/kernels/`` (the subdirectory keeps them
                         apart from the entries JAX's cache writes to
                         the same directory), each beside its build log
  PIO_COMPILE_CACHE=0    disable: the package's ``_build/``

Unlike the JAX module there is no default home: with the variable
unset the libraries go into the package's ``ops/kernels/_build/`` (git
ignores it), so a fresh checkout builds at first use into its own tree
and every process of one run shares that one build. Point the variable
at a directory (``cache_dir_default()`` is the JAX cache's home,
``$PIO_FS_BASEDIR/compile_cache``) to share the libraries across
checkouts. A library's name carries a hash of its source, the ``nvcc``
flags and ``nvcc --version``, so a cache shared across edits or
toolkits never loads a stale one.

Multi-process safe: a build writes a temporary name of its own process
and renames it into place, so processes sharing the directory only
ever load complete libraries; two that miss on one key at once both
build it, and either result is correct.

The directory is resolved from the environment at every build and
load (the only state kept is which directories were logged), so a
test's ``monkeypatch`` takes effect at once. A cache directory that cannot be created logs a
warning, counts ``pio_kernel_build_total{result="cache_unavailable"}``
and falls back to ``_build/``; the kernel is still built and launched.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

log = logging.getLogger(__name__)

#: the package's own build directory (git ignores it)
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "kernels", "_build")

_logged: set = set()
_logged_lock = threading.Lock()


def cache_dir_default() -> str:
    """The JAX cache's home, ``$PIO_FS_BASEDIR/compile_cache``."""
    base = os.environ.get("PIO_FS_BASEDIR", os.path.expanduser("~/.pio_store"))
    return os.path.join(base, "compile_cache")


def configured_dir() -> Optional[str]:
    """``PIO_COMPILE_CACHE_DIR``, or None when it is unset or
    ``PIO_COMPILE_CACHE=0``."""
    if os.environ.get("PIO_COMPILE_CACHE", "1") == "0":
        return None
    return os.environ.get("PIO_COMPILE_CACHE_DIR") or None


def kernel_dir(kernel: Optional[str] = None) -> str:
    """Where kernel libraries are built and loaded now: ``<cache>/kernels``
    when the cache is configured and usable, else the package's
    ``_build/``. An unusable cache is counted against ``kernel``."""
    cache = configured_dir()
    if cache is None:
        return BUILD_DIR
    path = os.path.join(cache, "kernels")
    try:
        os.makedirs(path, exist_ok=True)
        if not os.access(path, os.W_OK | os.X_OK):
            raise PermissionError(f"{path} is not writable")
    except OSError as e:
        log.warning("kernel-library cache unavailable (%s); building into "
                    "%s", e, BUILD_DIR)
        if kernel is not None:
            from predictionio_torch.obs import torchmon

            torchmon.KERNEL_BUILD_TOTAL.labels(
                kernel, "cache_unavailable").inc()
        return BUILD_DIR
    return path


def enable_persistent_cache() -> Optional[str]:
    """Check the configured cache where the JAX package turns its cache
    on (mesh creation, ``run_train``, deploy, ``pio eval``): returns
    the directory the kernel libraries go to, None when no cache is
    configured (``PIO_COMPILE_CACHE_DIR`` unset, or
    ``PIO_COMPILE_CACHE=0``) or it is unusable. Logs the location once
    a directory; never raises."""
    if configured_dir() is None:
        return None
    path = kernel_dir()
    if path == BUILD_DIR:
        return None
    with _logged_lock:
        fresh = path not in _logged
        _logged.add(path)
    if fresh:
        log.info("kernel-library cache at %s", path)
    return path
