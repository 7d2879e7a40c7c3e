"""Native (C++) host code: the event log and the ragged binning.

The port's own copy of ``predictionio_tpu/native/``, trimmed to what
the main path's data lane uses:

- ``eventlog.cpp``: the append-only event log (the EVENTDATA tier of the
  ``eventlog`` storage backend) and its fused scan+bin
  (``el_bin_columnar``);
- ``raggedbin.cpp``: the one-pass fills of the ALS segmented layout from
  host COO (``rb_fill_segmented``, ``rb_bin_compressed``);
- ``binlayout.h``: the layout math both share.

They are host code, no CUDA. The on-disk log format and the ``CSide``
layout are the JAX package's byte for byte, so either package reads a
log the other wrote and the binned layouts are equal.

Libraries are compiled with ``g++`` (``PIO_CXX``) at first use, never
at import, into ``_build/`` beside the sources (``PIO_NATIVE_BUILD_DIR``
moves it), and loaded with ``ctypes``. A build holds an exclusive
``flock`` on the build directory and writes to a file name of its own
(pid and a random suffix) that it renames into place, so processes that
build at once never load a half-written library. A failed build raises
``NativeBuildError``: nothing falls back to another route.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
import uuid
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))

_lock = threading.Lock()
_cache: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


def build_dir() -> str:
    return os.environ.get("PIO_NATIVE_BUILD_DIR",
                          os.path.join(_HERE, "_build"))


@contextlib.contextmanager
def _build_lock(directory: str):
    """Exclusive lock across processes for one build directory."""
    with open(os.path.join(directory, ".lock"), "a") as f:  # graftlint: disable=JT21 — this open IS the cross-process build lock (its flock); the module lock serializes in-process builds of one library, once per process
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_library(name: str) -> str:
    """Compile ``<name>.cpp`` to ``<build dir>/_<name>.so`` unless a
    library newer than the source and every shared header is there.
    Returns its path; raises NativeBuildError."""
    src = os.path.join(_HERE, f"{name}.cpp")
    directory = build_dir()
    out = os.path.join(directory, f"_{name}.so")
    # the headers (binlayout.h) are inlined into every library, so a
    # changed header rebuilds them too
    dep_mtime = max([os.path.getmtime(src)] + [
        os.path.getmtime(os.path.join(_HERE, f))
        for f in os.listdir(_HERE) if f.endswith(".h")])

    def fresh() -> bool:
        return os.path.exists(out) and os.path.getmtime(out) >= dep_mtime

    if fresh():
        return out
    os.makedirs(directory, exist_ok=True)
    with _build_lock(directory):
        if fresh():   # another process built it while this one waited
            return out
        cxx = os.environ.get("PIO_CXX", "g++")
        tmp = f"{out}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               src, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except FileNotFoundError:
            raise NativeBuildError(
                f"C++ compiler {cxx!r} not found (set PIO_CXX)") from None
        except subprocess.TimeoutExpired:
            raise NativeBuildError(f"compiling {name} timed out") from None
        if proc.returncode != 0:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
            raise NativeBuildError(
                f"compiling {name} failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load a native library, once per process."""
    with _lock:
        lib = _cache.get(name)
        if lib is None:
            path = build_library(name)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"loading {path} failed: {e}") from None
            _cache[name] = lib
        return lib


class CSide(ctypes.Structure):
    """Mirror of ``binlayout::CSide`` (``binlayout.h``): one side of a
    transfer-compressed binned layout. Every field is 8 bytes, so the
    Python and C layouts have no padding and agree. Filled by
    ``el_bin_columnar`` and ``rb_bin_compressed``."""

    _fields_ = [
        ("idx_lo", ctypes.c_void_p),
        ("idx_hi", ctypes.c_void_p),
        ("val_u8", ctypes.c_void_p),
        ("val_f32", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
        ("seg", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("rows", ctypes.c_int64),
        ("L", ctypes.c_int64),
        ("g_per_shard", ctypes.c_int64),
        ("n_shards", ctypes.c_int64),
        ("row_block", ctypes.c_int64),
        ("group_block", ctypes.c_int64),
        ("n_groups", ctypes.c_int64),
        ("affine", ctypes.c_int64),
        ("affine_a", ctypes.c_double),
        ("affine_b", ctypes.c_double),
        ("kept_entries", ctypes.c_int64),
        ("kept_value_sum", ctypes.c_double),
    ]


class NativeOwner:
    """Frees a set of native buffers when garbage-collected: the
    lifetime anchor of every zero-copy numpy view over native memory
    (``as_ndarray`` ties each view's buffer to its owner, so a view that
    is alive keeps the allocation alive)."""

    def __init__(self, free_fn, ptrs=()):
        self._free = free_fn
        self._ptrs = [int(p) for p in ptrs if p]

    def add(self, ptr) -> None:
        if ptr:
            self._ptrs.append(int(ptr))

    def __del__(self):
        free = getattr(self, "_free", None)
        for p in getattr(self, "_ptrs", ()):
            try:
                free(p)
            except Exception:   # noqa: BLE001 — interpreter teardown
                pass
        self._ptrs = []


def as_ndarray(ptr, nbytes: int, dtype, shape, owner: NativeOwner):
    """Zero-copy numpy view over a native allocation, or None for a
    null pointer. The view's buffer holds a reference to ``owner``, so
    the memory outlives every view derived from it (slices, reshapes,
    ``torch.from_numpy``)."""
    import numpy as np

    if not ptr:
        return None
    buf = (ctypes.c_char * nbytes).from_address(int(ptr))
    buf._owner = owner   # lifetime anchor (ctypes instances take attrs)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def unpack_cside(c: CSide, owner: NativeOwner) -> dict:
    """``CSide`` -> the fields of ``data.storage.BinnedSide``: zero-copy
    views over the native buffers, whose pointers are registered on
    ``owner`` here."""
    slots = c.rows * c.L
    for p in (c.idx_lo, c.idx_hi, c.val_u8, c.val_f32, c.mask, c.seg,
              c.counts):
        owner.add(p)
    coded = bool(c.affine)
    G = c.g_per_shard * c.n_shards
    shape = (c.rows, c.L)
    return dict(
        idx_lo=as_ndarray(c.idx_lo, slots * 2, "uint16", shape, owner),
        idx_hi=as_ndarray(c.idx_hi, slots, "uint8", shape, owner),
        val=(as_ndarray(c.val_u8, slots, "uint8", shape, owner) if coded
             else as_ndarray(c.val_f32, slots * 4, "float32", shape, owner)),
        mask=(None if coded
              else as_ndarray(c.mask, slots, "uint8", shape, owner)),
        seg=as_ndarray(c.seg, c.rows * 4, "int32", (c.rows,), owner),
        counts=as_ndarray(c.counts, G * 4, "int32", (G,), owner),
        affine=(c.affine_a, c.affine_b) if coded else None,
        row_block=int(c.row_block),
        group_block=int(c.group_block),
        groups_per_shard=int(c.g_per_shard),
        n_shards=int(c.n_shards),
        n_groups=int(c.n_groups),
        kept_entries=int(c.kept_entries),
        kept_value_sum=float(c.kept_value_sum),
    )
