"""Where a run keeps the program's build caches, and the check that no
module of the JAX package or of JAX itself was loaded.

Every cache directory is a fixed path: inside the checkout for what the
program builds (so that only a checkout's first run compiles), under
``TMPDIR`` for the program's file-system store. A program that fixes its
cache directory in code takes the one set here, so the variables are
set whatever the environment held before.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Iterable, List, Optional

#: top-level module names a run may not load; compared whole, so the
#: port (``predictionio_torch``) is not caught by ``predictionio_tpu``
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")


def checkout_root() -> str:
    """The directory that holds ``BENCHMARK.json`` and ``benchmark/``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def cache_env(root: str) -> dict:
    """The variables a run sets before the program is imported."""
    cache = os.path.join(root, "benchmark", ".cache")
    tmp = os.path.join(tempfile.gettempdir(), "pio_benchmark")
    return {
        # nvcc output of the port's kernels (ops/kernels, compile_cache)
        "PIO_COMPILE_CACHE_DIR": os.path.join(cache, "compile"),
        "PIO_COMPILE_CACHE": "1",
        # g++ output of the port's native binning (native/)
        "PIO_NATIVE_BUILD_DIR": os.path.join(cache, "native"),
        # unused by the port today; fixed so that a later build hits
        "TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
        # the program's store and layout cache (no cell uses either)
        "PIO_FS_BASEDIR": os.path.join(tmp, "fs"),
        "PIO_BIN_CACHE_DIR": os.path.join(tmp, "bincache"),
        # libraries that would load JAX by themselves do not
        "USE_FLAX": "0",
        "USE_JAX": "0",
    }


def set_cache_env(root: Optional[str] = None) -> dict:
    env = cache_env(root or checkout_root())
    os.environ.update(env)
    return env


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``), each compared whole."""
    names = sys.modules if modules is None else modules
    tops = {str(name).split(".", 1)[0] for name in list(names)}
    return sorted(tops & set(FORBIDDEN))
