"""Hand-written CUDA kernels for Hopper, and how they are built.

Counterpart of ``predictionio_tpu/ops/pallas/__init__.py``. Each kernel
is a CUDA C++ source under ``csrc/`` with a plain C entry point. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first
use, and loaded with ``ctypes``. No PyTorch headers are involved, yet a
build can take minutes (``topk_dot``'s took over two minutes on an
H100 host; PERF.md has the times). So the libraries can live in a cache
shared across checkouts (``parallel/compile_cache.py``): under
``$PIO_COMPILE_CACHE_DIR/kernels/`` when that is set, else (or with
``PIO_COMPILE_CACHE=0``) in the package's ``_build/``, which git
ignores. :func:`library_dir` resolves the directory at every build and
load. A library's name hashes its source, ``NVCC_FLAGS`` and ``nvcc
--version``; its build log (``ptxas -v``) sits beside it.

The selection contract differs from the Pallas one on purpose. There is
no probe and no degrade: a wrapper given CUDA tensors launches its
kernel or raises (a failed build, a refused launch and a non-zero
``cudaGetLastError`` all raise). The plain PyTorch version of each
kernel, kept beside it, runs only for tensors that lie on the CPU.

Each library request reports to ``obs/torchmon.py``
(``pio_kernel_build_total{kernel,result="built"|"cached"|
"cache_unavailable"}`` and ``pio_kernel_build_seconds{kernel}``); the
built/cached counts feed the ``/readyz`` ``compile_cache`` probe, and
:func:`requested_kernels` / :func:`loaded_kernels` its ``kernels``
probe (``obs/health.py``). :func:`load_seconds` keeps the ``ctypes``
load time of each library this process loaded.

``resolve_flag`` keeps the on/off/auto flag and its environment
override (``PIO_INDEX_KERNEL``). It chooses only on the CPU (between a
kernel's plain version and the scorer); on a CUDA device the kernel
always serves.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

#: sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target;
#: ``-Xptxas -v`` reports each kernel's registers and spills
#: (:func:`ptxas_report`)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def resolve_flag(config_value: str, env_name: str) -> str:
    """Normalize a kernel flag to ``on`` / ``off`` / ``auto``; the env
    variable overrides the config value. An unrecognized value falls
    back to ``auto`` with a warning."""
    value = str(os.environ.get(env_name, config_value)).strip().lower()
    if value in _TRUTHY:
        return "on"
    if value in _FALSY:
        return "off"
    if value != "auto":
        log.warning("unrecognized kernel flag %r (config %r / env %s); "
                    "treating as 'auto' — valid values: on/off/auto",
                    value, config_value, env_name)
    return "auto"


class LaunchCounter:
    """Kernel launches since the last ``reset`` — one ``add`` where a
    wrapper launches its kernel and nowhere else, so a run can show that
    its path went through the kernel. Thread-safe: the engine server
    launches from handler threads and the micro-batch worker."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, else ``PATH``, else
    the toolkit's conventional install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


_nvcc_versions: Dict[str, str] = {}


def nvcc_version() -> str:
    """``nvcc --version``'s output (once per process and ``nvcc``); part
    of every library's key, so a cache shared across toolkits never
    loads another toolkit's library."""
    nvcc = nvcc_path()
    version = _nvcc_versions.get(nvcc)
    if version is None:
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, check=True,
                                 timeout=60).stdout
        _nvcc_versions[nvcc] = version
    return version


def library_dir(name: Optional[str] = None) -> str:
    """Where the libraries are built and loaded now (resolved from the
    environment at each call): ``$PIO_COMPILE_CACHE_DIR/kernels`` or the
    package's ``_build/`` (``parallel/compile_cache.py``)."""
    from predictionio_torch.parallel import compile_cache

    return compile_cache.kernel_dir(name)


def _library_path(name: str, directory: Optional[str] = None) -> str:
    """Build output named by a hash of the source, the flags and the
    ``nvcc`` version, so an edited source or another toolkit never
    loads a stale library."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                + nvcc_version().encode())
    return os.path.join(directory or library_dir(),
                        f"lib{name}-{digest.hexdigest()[:16]}.so")


_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
#: every kernel whose library this process asked for (load_library)
_requested: set = set()
#: ctypes load seconds of each library this process loaded
_load_seconds: Dict[str, float] = {}


def requested_kernels() -> List[str]:
    """Kernels whose library this process asked for (a warm-up that
    launched a kernel asked first)."""
    with _libs_lock:
        return sorted(_requested)


def loaded_kernels() -> List[str]:
    """Kernels whose library is loaded in this process."""
    with _libs_lock:
        return sorted(_libs)


def load_seconds() -> Dict[str, float]:
    """``ctypes`` load seconds of each library this process loaded."""
    with _libs_lock:
        return dict(_load_seconds)


def build_all(names: Optional[List[str]] = None) -> List[str]:
    """Build every kernel under ``csrc/`` (or ``names``) whose library
    is missing from :func:`library_dir`, with one ``nvcc`` per source,
    all started together; each output goes to a temporary name of this
    process renamed into place on success. Returns the names."""
    from predictionio_torch.obs import torchmon

    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                       if f.endswith(".cu"))
    with _libs_lock:
        builds = []
        t0 = time.perf_counter()
        for name in names:
            out = _library_path(name, library_dir(name))
            if os.path.exists(out):
                torchmon.record_kernel_build(name, None)
                continue
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            # the build log goes to a file (a pipe could fill while
            # another nvcc is waited for), renamed beside the library
            with open(f"{tmp}.log", "w") as log_file:  # graftlint: disable=JT21 — the build log is opened beside the library under the same lock as the build; once per build
                builds.append((name, tmp, out, subprocess.Popen(
                    cmd, stdout=log_file, stderr=subprocess.STDOUT)))
        # wait for every nvcc before reporting a failure: none outlives
        # us; each build's seconds end when its own nvcc exits
        seconds: Dict[str, float] = {}
        while len(seconds) < len(builds):
            for name, *_, proc in builds:
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            if len(seconds) < len(builds):
                time.sleep(0.05)  # graftlint: disable=JT21 — _libs_lock exists to keep a second caller from starting the same nvcc builds; it waits for them, once per process per source
        for name, tmp, out, proc in builds:
            if proc.returncode != 0:
                with open(f"{tmp}.log") as f:  # graftlint: disable=JT21 — the failed build's log is read for its error, once
                    output = f.read()
                raise RuntimeError(
                    f"nvcc failed to build kernel {name!r} "
                    f"(exit {proc.returncode}):\n{output}")
            os.replace(f"{tmp}.log", f"{out}.log")
            os.replace(tmp, out)
            torchmon.record_kernel_build(name, seconds[name])
    return names


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers, spill stores and spill loads of each kernel in source
    ``name``, read from the ``ptxas -v`` output kept beside its library
    (empty before the first build). Kernel names are shortened to
    ``function<template args>``."""
    report: Dict[str, Dict[str, int]] = {}
    kernel = None
    log_path = f"{_library_path(name)}.log"
    text = open(log_path).read() if os.path.exists(log_path) else ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = _short_name(m.group(1))
            report[kernel] = {}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[kernel]["spill_stores"] = int(m.group(1))
            report[kernel]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[kernel]["registers"] = int(m.group(1))
    return report


def _short_name(mangled: str) -> str:
    """``_ZN12_GLOBAL__N_115flash_ce_kernelILi128ELb1EEEv..`` ->
    ``flash_ce_kernel<128,1>``: the last name of the nested name and
    its integer template arguments."""
    if not mangled.startswith("_ZN"):
        return mangled
    rest, name = mangled[3:], mangled
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group(0)
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
    if not args:
        return name
    return f"{name}<{','.join(re.findall(r'(\d+)E', args.group(1)))}>"


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _libs_lock:
        _requested.add(name)
    build_all([name])
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            # build_all counted an unusable cache; resolve it quietly
            lib = ctypes.CDLL(_library_path(name, library_dir()))
            _load_seconds[name] = time.perf_counter() - t0
            _libs[name] = lib
    return lib
