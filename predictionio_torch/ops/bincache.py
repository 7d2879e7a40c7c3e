"""Persistent cache of binned device layouts.

The port's copy of ``predictionio_tpu/ops/bincache.py``. A retrain on
unchanged events need not pay the read and the binning again: the
segmented layouts the ALS trainer puts on the card are a pure function
of (event-log content, layout knobs), so they are kept here under a key
made of the event store's O(1) ``data_fingerprint`` and every knob that
shapes the layout (``ops.als.layout_cache_key``). The cache stores the
transfer-compressed form (``ops.als.SideLayout``).

Format (``PIOBIN4``, the JAX package's): one file per entry,
``<key>.bin`` = magic + 8-byte header length + JSON header (meta and an
array manifest) + the raw arrays, each 64-byte aligned. ``load`` maps
the file and returns numpy views over the mapping. ``save`` writes a
temporary file in the same directory and commits it with
``os.replace``, so a crash mid-save leaves an orphaned ``.tmp`` (swept
by ``_prune`` once an hour old), never a torn entry. Entries are
machine-local (native byte order). Keys, format and directory rules are
the JAX package's, so an entry written by either package serves the
other.

Directory: ``PIO_BIN_CACHE_DIR``, else ``$PIO_FS_BASEDIR/bin_cache``
(default ``~/.pio_store/bin_cache``); ``PIO_BIN_CACHE_KEEP`` entries
(default 4) are kept, the least recently used go.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import mmap
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_FORMAT_VERSION = 4   # part of every key: bump when the stored layout changes
_MAGIC = b"PIOBIN4\n"
_ALIGN = 64
#: an orphaned .tmp older than this is a dead save; a younger one may be
#: another process's save in flight
_TMP_TTL_SEC = 3600.0


def cache_dir() -> str:
    d = os.environ.get("PIO_BIN_CACHE_DIR")
    if not d:
        base = os.environ.get("PIO_FS_BASEDIR",
                              os.path.expanduser("~/.pio_store"))
        d = os.path.join(base, "bin_cache")
    return d


def layout_key(fingerprint: str, derivation: str,
               params: Dict[str, Any]) -> str:
    """Stable key: the data fingerprint, how the COO was derived from
    it, and every layout-affecting knob."""
    blob = json.dumps(
        {"v": _FORMAT_VERSION, "fp": fingerprint, "d": derivation,
         "p": {k: params[k] for k in sorted(params)}},
        sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


def _path(key: str) -> str:
    return os.path.join(cache_dir(), f"{key}.bin")


def _prune(keep: int) -> None:
    """Keep the ``keep`` most recently used entries (by file mtime,
    which ``load`` touches) and sweep dead ``.tmp`` files, skipping
    young ones: a fresh temp may be a save in flight."""
    d = cache_dir()
    try:
        names = os.listdir(d)
    except OSError:
        return
    entries = []
    now = time.time()
    for f in names:
        path = os.path.join(d, f)
        try:
            if f.endswith(".tmp"):
                if now - os.path.getmtime(path) > _TMP_TTL_SEC:
                    os.remove(path)
            elif f.endswith(".bin"):
                entries.append((os.path.getmtime(path), path))
        except OSError:
            pass   # removed by another process meanwhile
    entries.sort(reverse=True)
    for _, stale in entries[keep:]:
        with contextlib.suppress(OSError):
            os.remove(stale)


def _data_start(header_len: int) -> int:
    return ((len(_MAGIC) + 8 + header_len + _ALIGN - 1)
            // _ALIGN) * _ALIGN


def save(key: str, arrays: Dict[str, np.ndarray],
         meta: Dict[str, Any]) -> None:
    """Atomic single-file write (temp file + ``os.replace``), then a
    prune to ``PIO_BIN_CACHE_KEEP`` entries. A failed write (a full
    disk) is logged and leaves the cache without the entry: training
    goes on uncached."""
    os.makedirs(cache_dir(), exist_ok=True)
    manifest = []
    offset = 0
    contiguous = {}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        contiguous[name] = a
        offset = ((offset + _ALIGN - 1) // _ALIGN) * _ALIGN
        manifest.append({"name": name, "dtype": a.dtype.str,
                         "shape": list(a.shape), "offset": offset,
                         "nbytes": int(a.nbytes)})
        offset += a.nbytes
    header = json.dumps({"meta": meta, "arrays": manifest}).encode()
    start = _data_start(len(header))
    fd, tmp = tempfile.mkstemp(dir=cache_dir(), suffix=".bin.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_MAGIC)
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            f.write(b"\0" * (start - len(_MAGIC) - 8 - len(header)))
            pos = 0
            for m in manifest:
                f.write(b"\0" * (m["offset"] - pos))
                f.write(contiguous[m["name"]])
                pos = m["offset"] + m["nbytes"]
        os.replace(tmp, _path(key))
    except OSError as e:
        log.warning("bin-cache save failed (%s); continuing uncached", e)
        with contextlib.suppress(OSError):
            os.remove(tmp)
    _prune(max(1, int(os.environ.get("PIO_BIN_CACHE_KEEP", "4"))))


def _load_v4(path: str):
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC) + 8)
        if len(head) != len(_MAGIC) + 8 or head[:len(_MAGIC)] != _MAGIC:
            return None
        header_len = int.from_bytes(head[len(_MAGIC):], "little")
        size = os.fstat(f.fileno()).st_size
        if header_len <= 0 or len(_MAGIC) + 8 + header_len > size:
            return None   # torn header
        doc = json.loads(f.read(header_len).decode("utf-8"))
        start = _data_start(header_len)
        manifest = doc["arrays"]
        end = max((start + m["offset"] + m["nbytes"] for m in manifest),
                  default=start)
        if size < end:
            return None   # torn tail
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    arrays = {}
    for m in manifest:
        dtype = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] else 1
        arrays[m["name"]] = np.frombuffer(
            mm, dtype=dtype, count=count,
            offset=start + m["offset"]).reshape(m["shape"])
    # the views keep the map alive through their base; the mapping stays
    # valid if the file is unlinked (a prune) while they are in use
    return arrays, doc["meta"]


def load(key: str) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
    """The entry's arrays (read-only views over the file's mapping) and
    meta, or None on a miss or a torn or foreign file."""
    path = _path(key)
    try:
        out = _load_v4(path)
    except (OSError, ValueError, KeyError):
        return None
    if out is not None:
        with contextlib.suppress(OSError):
            os.utime(path)   # LRU touch for _prune
    return out
