"""``eventlog`` storage backend: the native append-only event log.

The port's copy of ``predictionio_tpu/data/backends/eventlog.py``, the
EVENTDATA tier that plays HBase's role in the reference
(conf/pio-env.sh.template:43; scans by partial rowkey and column
filters, hbase/HBEventsUtil.scala:286). Events live in a native
append-only log with an in-memory index (``native/eventlog.cpp``), one
log directory per (app, channel); metadata and models go to the localfs
backend under ``<PATH>/meta``, as the reference pairs HBase (events)
with Elasticsearch (metadata). The log format is the JAX package's
byte for byte, so either package reads a log the other wrote and
closed: each log is single-writer, held by an ``flock`` while open.

Config (``PIO_STORAGE_SOURCES_<NAME>_*``):
  TYPE=eventlog
  PATH=<base dir>         (default ~/.pio_store/eventlog)
  FSYNC=1                 (optional: fdatasync per append batch)

Beyond the generic store it offers the JSON row lane of the event
server (``insert_json_batch``), the native columnar ingest and read
(``insert_columnar``, ``find_columnar``), the fused scan+bin into the
ALS trainer's layout (``bin_columnar``), an O(1) ``data_fingerprint``
that keys the layout cache, and ``compact``. Constructing the store
builds the native library (``NativeBuildError`` when that fails).
"""

from __future__ import annotations

import ctypes
import datetime as _dt
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from predictionio_torch import native
from predictionio_torch.data import storage as S
from predictionio_torch.data.backends.localfs import LocalFSStorageClient
from predictionio_torch.data.datamap import DataMap
from predictionio_torch.data.event import (Event, EventValidationError,
                                           validate_event)
from predictionio_torch.obs import dataobs, perfacct

UTC = _dt.timezone.utc
_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=UTC)
_US = _dt.timedelta(microseconds=1)
_I64_MIN = -(2**63)
_I64_MAX = 2**63 - 1
_ABSENT = 0xFFFF
_INF = float("inf")
_NINF = float("-inf")


class _BinColumnarOut(ctypes.Structure):
    """Mirror of BinColumnarOut (eventlog.cpp el_bin_columnar)."""

    _fields_ = [
        ("user_side", native.CSide),
        ("item_side", native.CSide),
        ("ent_dict", ctypes.c_void_p),
        ("ent_offsets", ctypes.c_void_p),
        ("tgt_dict", ctypes.c_void_p),
        ("tgt_offsets", ctypes.c_void_p),
        ("hold_u", ctypes.c_void_p),
        ("hold_i", ctypes.c_void_p),
        ("hold_v", ctypes.c_void_p),
        ("ent_dict_bytes", ctypes.c_uint64),
        ("tgt_dict_bytes", ctypes.c_uint64),
        ("n_ent", ctypes.c_int64),
        ("n_tgt", ctypes.c_int64),
        ("n_hold", ctypes.c_int64),
        ("n_rows", ctypes.c_int64),
        ("scan_sec", ctypes.c_double),
        ("bin_sec", ctypes.c_double),
    ]


class _FindReq(ctypes.Structure):
    """Mirror of FindReq (eventlog.cpp)."""

    _fields_ = [
        ("start_us", ctypes.c_int64),
        ("until_us", ctypes.c_int64),
        ("entity_type", ctypes.c_char_p),
        ("entity_id", ctypes.c_char_p),
        ("target_type_mode", ctypes.c_int32),
        ("target_id_mode", ctypes.c_int32),
        ("target_entity_type", ctypes.c_char_p),
        ("target_entity_id", ctypes.c_char_p),
        ("event_names", ctypes.c_char_p),
        ("n_event_names", ctypes.c_int32),
        ("reversed", ctypes.c_int32),
        ("limit", ctypes.c_int64),
    ]


def _load() -> ctypes.CDLL:
    lib = native.load_library("eventlog")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u8pp = ctypes.POINTER(u8p)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
    lib.el_open.restype = ctypes.c_void_p
    lib.el_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.el_close.restype = None
    lib.el_close.argtypes = [ctypes.c_void_p]
    lib.el_delete.restype = ctypes.c_int
    lib.el_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.el_compact.restype = ctypes.c_int64
    lib.el_compact.argtypes = [ctypes.c_void_p, u64p, u64p]
    lib.el_get.restype = ctypes.c_int64
    lib.el_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8pp]
    lib.el_find.restype = ctypes.c_int64
    lib.el_find.argtypes = [ctypes.c_void_p, ctypes.POINTER(_FindReq), u8pp,
                            u64p]
    lib.el_find_columnar.restype = ctypes.c_int64
    lib.el_find_columnar.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_FindReq), ctypes.c_char_p,
        ctypes.c_int32,                                   # time_ordered
        i32pp, i32pp, i32pp,                              # ent/tgt/name codes
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),  # values
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),   # times_us
        u8pp, u64p, ctypes.POINTER(ctypes.c_int64),       # ent dict
        u8pp, u64p, ctypes.POINTER(ctypes.c_int64),       # tgt dict
        u8pp, u64p, ctypes.POINTER(ctypes.c_int64),       # name dict
        ctypes.POINTER(u64p), ctypes.POINTER(u64p),       # dict offsets
        ctypes.POINTER(u64p),
    ]
    lib.el_find_columnar_since.restype = ctypes.c_int64
    lib.el_find_columnar_since.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_FindReq), ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_uint64,                 # since gen/rec
        u64p, u64p,                                       # out gen/rec
        ctypes.POINTER(ctypes.c_int32),                   # out rebased
        i32pp, i32pp, i32pp,                              # ent/tgt/name codes
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),  # values
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),   # times_us
        u8pp, u64p, ctypes.POINTER(ctypes.c_int64),       # ent dict
        u8pp, u64p, ctypes.POINTER(ctypes.c_int64),       # tgt dict
        u8pp, u64p, ctypes.POINTER(ctypes.c_int64),       # name dict
        ctypes.POINTER(u64p), ctypes.POINTER(u64p),       # dict offsets
        ctypes.POINTER(u64p),
    ]
    lib.el_append_json.restype = ctypes.c_int64
    lib.el_append_json.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int64, ctypes.c_int32,
        u8pp, u8pp, u8pp, u64p, u8pp, u64p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.el_append_columnar.restype = ctypes.c_int64
    lib.el_append_columnar.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, u64p, ctypes.c_int64,
        ctypes.c_char_p, u64p, ctypes.c_int64,
        ctypes.c_char_p, u64p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_char_p,
    ]
    lib.el_append_rows.restype = ctypes.c_int64
    lib.el_append_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p,                                  # ids n*16
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,                                  # flags
        ctypes.c_char_p, u64p, ctypes.c_char_p, u64p,     # ev, et
        ctypes.c_char_p, u64p, ctypes.c_char_p, u64p,     # ei, tt
        ctypes.c_char_p, u64p, ctypes.c_char_p, u64p,     # ti, extra
        ctypes.c_int32,                                   # fresh_ids
    ]
    lib.el_fingerprint.restype = None
    lib.el_fingerprint.argtypes = [ctypes.c_void_p, u64p]
    lib.el_bin_columnar.restype = ctypes.c_int64
    lib.el_bin_columnar.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_FindReq), ctypes.c_char_p,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,                   # skip mod/rem
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,   # seg_len, max u/i
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double,  # shards, block, cost
        ctypes.POINTER(_BinColumnarOut),
    ]
    lib.el_free.restype = None
    lib.el_free.argtypes = [ctypes.c_void_p]
    return lib


# ---------------------------------------------------------------------------
# record (de)serialization: the wire format documented in eventlog.cpp
# ---------------------------------------------------------------------------

def _id16(event_id: str) -> bytes:
    """32-hex ids (the framework's uuid4().hex) map to their raw bytes;
    anything else maps through MD5, as the reference's rowkey
    MD5(entityType-entityId) does (HBEventsUtil.scala:96)."""
    try:
        raw = bytes.fromhex(event_id)
        if len(raw) == 16:
            return raw
    except ValueError:
        pass
    return hashlib.md5(event_id.encode("utf-8")).digest()


def _us(t: _dt.datetime) -> int:
    """Epoch microseconds; a naive time counts as UTC."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return (t - _EPOCH) // _US


def _plain_key(k: str) -> bool:
    """The key needs no JSON escaping (ascii, printable, no quote or
    backslash): the guard of the formatter fast path below."""
    return (type(k) is str and k.isascii() and k.isprintable()
            and '"' not in k and "\\" not in k)


def _extra_bytes(e: Event, orig_id: Optional[str]) -> bytes:
    """The record's JSON ``extra`` blob: everything the filterable
    header does not carry: properties, tags, prId, the exact ISO times
    when they are not UTC (a UTC time is rebuilt exactly from the
    micros header), and the original id when it is not canonical
    16-byte hex."""
    extra: Dict[str, Any] = {}
    if e.event_time.utcoffset():
        extra["et"] = e.event_time.isoformat()
    if e.creation_time.utcoffset():
        extra["ct"] = e.creation_time.isoformat()
    if len(e.properties):
        extra["p"] = e.properties.to_dict()
    if e.tags:
        extra["t"] = list(e.tags)
    if e.pr_id is not None:
        extra["pr"] = e.pr_id
    if orig_id is not None:
        extra["id"] = orig_id
    if not extra:
        return b""
    if len(extra) == 1 and "p" in extra:
        # the common shape, properties only; a single numeric property
        # ({"rating": 4.5}) skips json.dumps
        p = extra["p"]
        if len(p) == 1:
            k, v = next(iter(p.items()))
            tv = type(v)
            if ((tv is float and v == v and v not in (_INF, _NINF))
                    or tv is int) and _plain_key(k):
                return f'{{"p":{{"{k}":{v!r}}}}}'.encode("utf-8")
        return b'{"p":' + json.dumps(
            p, separators=(",", ":")).encode("utf-8") + b"}"
    return json.dumps(extra, separators=(",", ":")).encode("utf-8")


def _unpack_records(buf: bytes) -> List[Event]:
    import struct

    events = []
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (rlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        id16, t_us, c_us, l_ev, l_et, l_ei, l_tt, l_ti, l_ex = (
            struct.unpack_from("<16sqqHHHHHI", buf, off))
        p = off + 46
        ev = buf[p:p + l_ev].decode("utf-8"); p += l_ev
        et = buf[p:p + l_et].decode("utf-8"); p += l_et
        ei = buf[p:p + l_ei].decode("utf-8"); p += l_ei
        tt = ti = None
        if l_tt != _ABSENT:
            tt = buf[p:p + l_tt].decode("utf-8"); p += l_tt
        if l_ti != _ABSENT:
            ti = buf[p:p + l_ti].decode("utf-8"); p += l_ti
        extra = json.loads(buf[p:p + l_ex].decode("utf-8")) if l_ex else {}
        off += rlen
        events.append(Event(
            event=ev, entity_type=et, entity_id=ei,
            target_entity_type=tt, target_entity_id=ti,
            properties=DataMap(extra.get("p") or {}),
            event_time=(_dt.datetime.fromisoformat(extra["et"])
                        if "et" in extra else _EPOCH + t_us * _US),
            tags=tuple(extra.get("t") or ()),
            pr_id=extra.get("pr"),
            event_id=extra.get("id") or id16.hex(),
            creation_time=(_dt.datetime.fromisoformat(extra["ct"])
                           if "ct" in extra else _EPOCH + c_us * _US)))
    return events


def _decode_vocab(ptr, nbytes: int, offs_ptr, count: int) -> List[str]:
    """Native dictionary -> vocabulary list: concatenated bytes + exact
    prefix offsets (ids may hold any byte)."""
    if not count:
        return []
    raw = ctypes.string_at(ptr, nbytes)
    offs = ctypes.cast(offs_ptr, ctypes.POINTER(ctypes.c_uint64))
    return [raw[offs[i]:offs[i + 1]].decode("utf-8") for i in range(count)]


class JsonRowsUnsupported(Exception):
    """The JSON payload uses a construct the native lane does not take
    (caller-stamped ids, other time formats, escaped property keys,
    properties that are not an object, ...): the caller takes the
    per-row path (``Event.from_dict``, ``validate_event``,
    ``insert_batch``), which accepts everything."""


#: native RowErr codes -> the validate_event / from_dict messages
#: (data/event.py), in lockstep with enum RowErr in eventlog.cpp
_ROW_ERRORS = {
    1: "field event is required",
    2: "field entityType is required",
    3: "field entityId is required",
    4: "event must not be empty.",
    5: "entityType must not be empty string.",
    6: "entityId must not be empty string.",
    7: "targetEntityType and targetEntityId must be specified together.",
    8: "targetEntityType must not be empty string.",
    9: "targetEntityId must not be empty string.",
    10: "properties cannot be empty for $unset event",
    11: "reserved event names must be one of $set/$unset/$delete.",
    12: "Reserved events cannot have targetEntity.",
    13: "The entityType is not allowed. 'pio_' is a reserved name prefix.",
    14: "The targetEntityType is not allowed. 'pio_' is a reserved name "
        "prefix.",
    15: "The property is not allowed. 'pio_' is a reserved name prefix.",
    16: "Invalid time string.",
    17: "event must be a JSON object",
    18: "a string field exceeds the 65534-byte wire-format limit",
}


def _validate_columns(cols: S.EventColumns, entity_type: str,
                      target_entity_type: Optional[str],
                      value_property: Optional[str]) -> None:
    """``validate_event``'s rules over dict-encoded rows: each distinct
    (event name, has a target, has a value) kind of row is checked once
    through one representative event, and the vocabularies for empty
    ids. Raises EventValidationError."""
    if "" in cols.entity_vocab:
        raise EventValidationError("entityId must not be empty string.")
    if "" in cols.target_vocab:
        raise EventValidationError("targetEntityId must not be empty string.")
    n_names = max(len(cols.names), 1)
    has_tgt = (cols.target_codes >= 0).astype(np.int64)
    has_val = (np.zeros(len(cols), np.int64) if value_property is None
               else (~np.isnan(cols.values)).astype(np.int64))
    kinds = np.bincount(
        (cols.name_codes.astype(np.int64) * 2 + has_tgt) * 2 + has_val,
        minlength=n_names * 4)
    for kind in np.flatnonzero(kinds):
        name, tgt, val = int(kind) // 4, int(kind) // 2 % 2, int(kind) % 2
        validate_event(Event(
            event=cols.names[name], entity_type=entity_type, entity_id="e",
            target_entity_type=target_entity_type if tgt else None,
            target_entity_id="t" if tgt else None,
            properties={value_property: 1.0} if val else {}))


class _ColumnarOut:
    """The columnar out-params of ``el_find_columnar``: 5 row arrays and
    3 dictionaries with exact prefix offsets and their counts."""

    def __init__(self, lib):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib = lib
        self.ent = ctypes.POINTER(ctypes.c_int32)()
        self.tgt = ctypes.POINTER(ctypes.c_int32)()
        self.nam = ctypes.POINTER(ctypes.c_int32)()
        self.val = ctypes.POINTER(ctypes.c_double)()
        self.tim = ctypes.POINTER(ctypes.c_int64)()
        self.ent_d, self.tgt_d, self.nam_d = u8p(), u8p(), u8p()
        self.ent_db = ctypes.c_uint64()
        self.tgt_db = ctypes.c_uint64()
        self.nam_db = ctypes.c_uint64()
        self.n_ent, self.n_tgt, self.n_nam = (
            ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64())
        self.ent_o, self.tgt_o, self.nam_o = u64p(), u64p(), u64p()

    def argrefs(self):
        return tuple(ctypes.byref(p) for p in (
            self.ent, self.tgt, self.nam, self.val, self.tim,
            self.ent_d, self.ent_db, self.n_ent,
            self.tgt_d, self.tgt_db, self.n_tgt,
            self.nam_d, self.nam_db, self.n_nam,
            self.ent_o, self.tgt_o, self.nam_o))

    def take(self, n: int) -> S.EventColumns:
        """Copy the native buffers into a Python-owned EventColumns and
        free them (always, even when the copy raises)."""
        def arr(ptr, ctype, np_dtype):
            if not n:
                return np.empty(0, np_dtype)
            return np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(n,)
            ).astype(np_dtype, copy=True)

        try:
            return S.EventColumns(
                entity_codes=arr(self.ent, ctypes.c_int32, np.int32),
                target_codes=arr(self.tgt, ctypes.c_int32, np.int32),
                name_codes=arr(self.nam, ctypes.c_int32, np.int32),
                values=arr(self.val, ctypes.c_double, np.float64),
                times_us=arr(self.tim, ctypes.c_int64, np.int64),
                entity_vocab=_decode_vocab(self.ent_d, self.ent_db.value,
                                           self.ent_o, self.n_ent.value),
                target_vocab=_decode_vocab(self.tgt_d, self.tgt_db.value,
                                           self.tgt_o, self.n_tgt.value),
                names=_decode_vocab(self.nam_d, self.nam_db.value,
                                    self.nam_o, self.n_nam.value))
        finally:
            for p in (self.ent, self.tgt, self.nam, self.val, self.tim,
                      self.ent_d, self.tgt_d, self.nam_d,
                      self.ent_o, self.tgt_o, self.nam_o):
                if p:
                    self._lib.el_free(p)


_FIND_FILTERS = frozenset({
    "start_time", "until_time", "entity_type", "entity_id", "event_names",
    "target_entity_type", "target_entity_id"})


class EventLogEventStore(S.EventStore):
    """Events in native logs under ``base_path/events_<app>[_<channel>]``."""

    def __init__(self, base_path: str, fsync: bool = False):
        self._lib = _load()
        self._base = base_path
        self._fsync = fsync
        self._handles: Dict[Tuple[int, Optional[int]], int] = {}
        self._lock = threading.Lock()
        #: fused scan+bin calls made by this store (the layout cache's
        #: hits make none)
        self.bin_columnar_calls = 0
        os.makedirs(base_path, exist_ok=True)

    def _dir(self, app_id: int, channel_id: Optional[int]) -> str:
        name = (f"events_{app_id}" if channel_id is None
                else f"events_{app_id}_{channel_id}")
        return os.path.join(self._base, name)

    def _handle(self, app_id: int, channel_id: Optional[int],
                create: bool = False) -> int:
        key = (app_id, channel_id)
        with self._lock:
            h = self._handles.get(key)
            if h:
                return h
            path = self._dir(app_id, channel_id)
            if not create and not os.path.isdir(path):
                raise S.StorageError(f"event log for app {app_id} channel "
                                     f"{channel_id} not initialized")
            h = self._lib.el_open(path.encode(), 1 if self._fsync else 0)
            if not h:
                raise S.StorageError(
                    f"cannot open event log at {path} (is another process "
                    "holding its LOCK? the log has one writer at a time)")
            self._handles[key] = h
            return h

    def init(self, app_id, channel_id=None):
        self._handle(app_id, channel_id, create=True)

    def remove(self, app_id, channel_id=None):
        with self._lock:
            h = self._handles.pop((app_id, channel_id), None)
            if h:
                self._lib.el_close(h)
            shutil.rmtree(self._dir(app_id, channel_id), ignore_errors=True)

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        # observation stays off: the event server's 201 lane observed
        # this event already, and single writes below the server are not
        # observed
        return self.insert_batch([event], app_id, channel_id,
                                 _observe=False)[0]

    def insert_batch(self, events, app_id, channel_id=None, *,
                     _observe: bool = True) -> List[str]:
        """Row-lane bulk append: one Python pass collects per-field byte
        streams, numpy assembles the offset tables, and one native call
        (el_append_rows) packs every wire record and appends under one
        lock with the GIL released. Ids minted here keep the log's lazy
        id index; caller-stamped ids pay the duplicate check. The
        accepted batch moves the ingest clock once, and the data plane
        gets the byte streams already built (enqueue only)."""
        h = self._handle(app_id, channel_id)
        events = list(events)
        n = len(events)
        if n == 0:
            return []
        rand = os.urandom(16 * n)
        ids = bytearray(rand)
        out_ids: List[str] = []
        fresh = True   # every id generated right here
        times = np.empty(n, np.int64)
        ctimes = np.empty(n, np.int64)
        flags = bytearray(n)
        ev_p: List[bytes] = []
        et_p: List[bytes] = []
        ei_p: List[bytes] = []
        tt_p: List[bytes] = []
        ti_p: List[bytes] = []
        ex_p: List[bytes] = []
        for i, e in enumerate(events):
            orig_id = None
            if e.event_id:
                fresh = False
                id16 = _id16(e.event_id)
                if id16.hex() != e.event_id:
                    orig_id = e.event_id
                ids[16 * i:16 * i + 16] = id16
                out_ids.append(e.event_id)
            else:
                out_ids.append(rand[16 * i:16 * i + 16].hex())
            times[i] = _us(e.event_time)
            ctimes[i] = _us(e.creation_time)
            ev_p.append(e.event.encode("utf-8"))
            et_p.append(e.entity_type.encode("utf-8"))
            ei_p.append(e.entity_id.encode("utf-8"))
            f = 0
            if e.target_entity_type is not None:
                tt_p.append(e.target_entity_type.encode("utf-8"))
                f |= 1
            else:
                tt_p.append(b"")
            if e.target_entity_id is not None:
                ti_p.append(e.target_entity_id.encode("utf-8"))
                f |= 2
            else:
                ti_p.append(b"")
            flags[i] = f
            ex_p.append(_extra_bytes(e, orig_id))

        def stream(parts):
            offs = np.zeros(n + 1, np.uint64)
            np.cumsum(np.fromiter(map(len, parts), np.uint64, count=n),
                      out=offs[1:])
            return b"".join(parts), offs

        def optr(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

        ev_b, ev_o = stream(ev_p)
        et_b, et_o = stream(et_p)
        ei_b, ei_o = stream(ei_p)
        tt_b, tt_o = stream(tt_p)
        ti_b, ti_o = stream(ti_p)
        ex_b, ex_o = stream(ex_p)
        rc = self._lib.el_append_rows(
            h, n, bytes(ids),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctimes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bytes(flags),
            ev_b, optr(ev_o), et_b, optr(et_o), ei_b, optr(ei_o),
            tt_b, optr(tt_o), ti_b, optr(ti_o), ex_b, optr(ex_o),
            1 if fresh else 0)
        if rc == -2:
            raise S.StorageError(
                "a string field exceeds the 65534-byte wire-format limit")
        if rc != n:
            raise S.StorageError(f"append failed ({rc} of {n} written)")
        # freshness clock: these rows now wait for a model publish
        perfacct.note_ingest()
        if _observe and dataobs.DATAOBS.enabled():
            # the extra-record lengths stand in for the payload sizes
            dataobs.DATAOBS.observe_batch(
                app_id, ev_p, entity_ids=ei_p, target_ids=ti_p,
                payload_lens=np.diff(ex_o.astype(np.int64)),
                events=events)
        return out_ids

    def insert_json_batch(self, raw: bytes, app_id, channel_id=None, *,
                          strict: bool = True):
        """The event server's row lane: the API-format JSON array goes
        straight to C++, where parsing, the reference's validation
        rules (``validate_event``), wire-record packing and the append
        happen in one call with the GIL released (ref: EventAPI.scala:209).

        Returns ``(ids, codes, names, entity_types)``, per row: the event
        id hex (None for a rejected row), the validation code (0 =
        appended; ``_ROW_ERRORS`` maps the rest), the event name and the
        entity type. ``strict=True`` raises RowValidationError on the
        first invalid row with nothing appended; ``strict=False``
        appends the valid rows and reports the rest. Raises
        JsonRowsUnsupported when the payload needs the per-row path, and
        ValueError when it is not a JSON array of events."""
        h = self._handle(app_id, channel_id)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        out_ids, out_codes, out_names, out_et = u8p(), u8p(), u8p(), u8p()
        names_b, et_b = ctypes.c_uint64(), ctypes.c_uint64()
        out_n = ctypes.c_int64()
        rc = self._lib.el_append_json(
            h, raw, len(raw), _us(_dt.datetime.now(tz=UTC)),
            1 if strict else 0,
            ctypes.byref(out_ids), ctypes.byref(out_codes),
            ctypes.byref(out_names), ctypes.byref(names_b),
            ctypes.byref(out_et), ctypes.byref(et_b), ctypes.byref(out_n))
        try:
            if rc == -2:
                raise JsonRowsUnsupported()
            if rc == -3:
                raise ValueError("malformed JSON event array")
            if rc == -4:
                n = out_n.value
                code = ctypes.string_at(out_codes, n)[-1] if out_codes else 0
                raise S.RowValidationError(
                    f"event {n - 1}: "
                    f"{_ROW_ERRORS.get(code, f'validation error {code}')}")
            if rc < 0:
                raise S.StorageError("append failed in native event log")
            n = out_n.value
            ids_raw = ctypes.string_at(out_ids, 16 * n) if n else b""
            codes = list(ctypes.string_at(out_codes, n)) if n else []
            names = (ctypes.string_at(out_names, names_b.value)
                     .decode("utf-8").split("\0")[:-1] if n else [])
            etypes = (ctypes.string_at(out_et, et_b.value)
                      .decode("utf-8").split("\0")[:-1] if n else [])
        finally:
            for p in (out_ids, out_codes, out_names, out_et):
                if p:
                    self._lib.el_free(p)
        hex_all = ids_raw.hex()
        ids = [hex_all[32 * i:32 * i + 32] if codes[i] == 0 else None
               for i in range(n)]
        if any(c == 0 for c in codes):
            perfacct.note_ingest()
            if dataobs.DATAOBS.enabled():
                # the native lane surfaces names only (ids never become
                # Python objects): count the accepted rows
                dataobs.DATAOBS.observe_batch(
                    app_id, [nm for nm, c in zip(names, codes) if c == 0])
        return ids, codes, names, etypes

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        h = self._handle(app_id, channel_id)
        out = ctypes.POINTER(ctypes.c_uint8)()
        nbytes = self._lib.el_get(h, _id16(event_id), ctypes.byref(out))
        if nbytes <= 0:
            return None
        try:
            buf = ctypes.string_at(out, nbytes)
        finally:
            self._lib.el_free(out)
        events = _unpack_records(buf)
        return events[0] if events else None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        h = self._handle(app_id, channel_id)
        return self._lib.el_delete(h, _id16(event_id)) == 1

    @staticmethod
    def _build_req(start_time=None, until_time=None, entity_type=None,
                   entity_id=None, event_names=None,
                   target_entity_type=S.UNSET, target_entity_id=S.UNSET,
                   limit=None, reversed=False) -> _FindReq:
        def target_mode(v) -> Tuple[int, Optional[bytes]]:
            if v is S.UNSET:
                return 0, None
            if v is None:
                return 1, None
            return 2, str(v).encode("utf-8")

        tt_mode, tt_val = target_mode(target_entity_type)
        ti_mode, ti_val = target_mode(target_entity_id)
        names = list(event_names) if event_names is not None else []
        return _FindReq(
            start_us=_us(start_time) if start_time is not None else _I64_MIN,
            until_us=_us(until_time) if until_time is not None else _I64_MAX,
            entity_type=(entity_type.encode() if entity_type is not None
                         else None),
            entity_id=entity_id.encode() if entity_id is not None else None,
            target_type_mode=tt_mode, target_id_mode=ti_mode,
            target_entity_type=tt_val, target_entity_id=ti_val,
            event_names=(b"\0".join(n.encode() for n in names) + b"\0"
                         if names else None),
            n_event_names=len(names),
            reversed=1 if reversed else 0,
            limit=limit if limit is not None and limit >= 0 else -1)

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=S.UNSET, target_entity_id=S.UNSET,
             limit=None, reversed=False) -> List[Event]:
        h = self._handle(app_id, channel_id)
        req = self._build_req(start_time, until_time, entity_type, entity_id,
                              event_names, target_entity_type,
                              target_entity_id, limit, reversed)
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_bytes = ctypes.c_uint64()
        n = self._lib.el_find(h, ctypes.byref(req), ctypes.byref(out),
                              ctypes.byref(out_bytes))
        if n < 0:
            raise S.StorageError("find failed in native event log")
        if n == 0:
            return []
        try:
            buf = ctypes.string_at(out, out_bytes.value)
        finally:
            self._lib.el_free(out)
        return _unpack_records(buf)

    def find_columnar(self, app_id, channel_id=None, value_property=None,
                      time_ordered=True, shard_index=None, shard_count=None,
                      **find_kwargs) -> S.EventColumns:
        """One native pass: filter, dict-encode and extract the property;
        no Event objects. ``time_ordered=False`` (bulk training reads)
        fuses filter and encode into one parse per record and skips the
        sort. An entity-hash read shard (``shard_index``/``shard_count``)
        is applied after the read, on the encoded columns: the scan
        still reads the whole log (local disk), and only the shard's
        rows stay. A row limit then applies to the shard."""
        S.EventStore.check_shard_params(shard_index, shard_count)
        sharding = shard_count is not None and shard_count > 1
        # the shard filter precedes a row limit: scan unlimited, filter,
        # then limit_columns
        shard_limit = find_kwargs.pop("limit", None) if sharding else None
        unknown = set(find_kwargs) - _FIND_FILTERS - {"limit", "reversed"}
        if unknown:
            # a mistyped filter must fail, never scan unfiltered
            raise TypeError(
                f"find_columnar() got unexpected filters {sorted(unknown)}")
        h = self._handle(app_id, channel_id)
        req = self._build_req(**find_kwargs)
        out = _ColumnarOut(self._lib)
        n = self._lib.el_find_columnar(
            h, ctypes.byref(req),
            value_property.encode() if value_property is not None else None,
            1 if time_ordered else 0, *out.argrefs())
        if n < 0:
            raise S.StorageError("columnar find failed in native event log")
        cols = out.take(n)
        if sharding:
            cols = S.shard_columns(cols, shard_index, shard_count)
            cols = S.limit_columns(
                cols, shard_limit,
                newest_first=bool(find_kwargs.get("reversed", False)))
        return cols

    # -- streaming delta reads ---------------------------------------------
    @staticmethod
    def _parse_cursor(cursor: str) -> Tuple[int, int]:
        try:
            gen_s, rec_s = cursor.split(":", 1)
            if gen_s[0] != "g" or rec_s[0] != "r":
                raise ValueError
            return int(gen_s[1:]), int(rec_s[1:])
        except (ValueError, IndexError):
            raise ValueError(
                f"malformed delta cursor {cursor!r} (expected 'g<gen>:r<rec>')"
            ) from None

    def delta_cursor(self, app_id, channel_id=None) -> str:
        """The current tail position as an opaque cursor string:
        ``find_columnar_since`` from here returns only rows appended
        AFTER this call. Built on el_fingerprint's generation and record
        counters, so it stays valid across process restarts and between
        the two packages (the log format is shared)."""
        h = self._handle(app_id, channel_id)
        out = (ctypes.c_uint64 * 4)()
        self._lib.el_fingerprint(h, out)
        return f"g{out[0]}:r{out[2]}"

    def find_columnar_since(
        self,
        app_id,
        channel_id=None,
        *,
        cursor: str,
        value_property: Optional[str] = None,
        **find_kwargs,
    ) -> Tuple[S.EventColumns, str, bool]:
        """Delta read: the live rows appended since ``cursor`` that
        match the filters, dict-encoded, in ARRIVAL order (one native
        pass over only the new records: the streaming tailer's lane).

        Returns ``(columns, new_cursor, rebased)``. ``rebased=True``
        means the cursor could not be mapped onto this log (a
        compaction renumbered records, or a crash truncated appends the
        cursor had seen): the returned columns are then a RESYNC of the
        entire live row set, not a delta, and callers should treat it
        as "full retrain needed", not fold it in."""
        unknown = set(find_kwargs) - _FIND_FILTERS
        if unknown:
            # as find_columnar: a mistyped filter must never widen the
            # delta; limit / reversed are not accepted, since a delta
            # is exactly the new rows
            raise TypeError(
                f"find_columnar_since() got unexpected filters "
                f"{sorted(unknown)}")
        gen, rec = self._parse_cursor(cursor)
        h = self._handle(app_id, channel_id)
        req = self._build_req(**find_kwargs)
        out_gen = ctypes.c_uint64()
        out_rec = ctypes.c_uint64()
        out_rebased = ctypes.c_int32()
        out = _ColumnarOut(self._lib)
        n = self._lib.el_find_columnar_since(
            h, ctypes.byref(req),
            value_property.encode() if value_property is not None else None,
            gen, rec, ctypes.byref(out_gen), ctypes.byref(out_rec),
            ctypes.byref(out_rebased), *out.argrefs())
        if n < 0:
            raise S.StorageError("delta columnar read failed in native "
                                 "event log")
        return (out.take(n), f"g{out_gen.value}:r{out_rec.value}",
                bool(out_rebased.value))

    def bin_columnar(self, app_id, channel_id=None, *,
                     value_property: Optional[str] = None,
                     overrides: Optional[Dict[str, float]] = None,
                     skip_mod: int = 0, skip_rem: int = 0,
                     seg_len="auto",
                     max_len_user: Optional[int] = None,
                     max_len_item: Optional[int] = None,
                     n_shards: int = 1, block_size: int = 4096,
                     row_cost_slots: float = 16.0,
                     **find_kwargs) -> S.BinnedInteractions:
        """The fused ingest->bin lane: one native call takes the mmapped
        log to both sides' compressed layouts (grouped by entity and by
        target) with the GIL released for the whole scan and bin; no
        Event objects and no intermediate COO. The returned arrays are
        zero-copy views over aligned native buffers, which their buffer
        objects keep alive.

        ``overrides`` maps event names to constant ratings (the "buy
        means 4.0" rule); other rows take ``value_property`` with NaN ->
        0.0. ``skip_mod``/``skip_rem`` hold out every row whose kept-row
        ordinal % mod == rem as an evaluation COO. Rows without a target
        id are dropped. The layout is bit-identical to
        ``compress_side(build_segmented_groups(...))`` over the same
        COO."""
        unknown = set(find_kwargs) - _FIND_FILTERS
        if unknown:
            raise TypeError(
                f"bin_columnar() got unexpected filters {sorted(unknown)}")
        if isinstance(seg_len, str):
            if seg_len != "auto":
                raise ValueError(
                    f"seg_len must be an int or 'auto', got {seg_len!r}")
            seg_len_i = -1
        else:
            seg_len_i = int(seg_len)
        h = self._handle(app_id, channel_id)
        req = self._build_req(**find_kwargs)
        ov = dict(overrides or {})
        ov_names = b"".join(k.encode("utf-8") + b"\0" for k in ov) or None
        ov_vals = ((ctypes.c_double * len(ov))(*[float(v) for v in
                                                 ov.values()])
                   if ov else None)
        out = _BinColumnarOut()
        with self._lock:
            self.bin_columnar_calls += 1
        n = self._lib.el_bin_columnar(
            h, ctypes.byref(req),
            value_property.encode() if value_property is not None else None,
            ov_names, ov_vals, len(ov), int(skip_mod), int(skip_rem),
            seg_len_i,
            -1 if max_len_user is None else int(max_len_user),
            -1 if max_len_item is None else int(max_len_item),
            int(n_shards), int(block_size), float(row_cost_slots),
            ctypes.byref(out))
        if n == -3:
            raise ValueError("vocab exceeds the 24-bit index wire format "
                             "(widen idx_hi before raising this cap)")
        if n < 0:
            raise S.StorageError(f"native columnar binning failed (rc {n})")
        # one owner per group of buffers released together: the trainer
        # drops the sides once the card holds them, while a holdout COO
        # lives on through an evaluation and must not pin the sides
        owner = native.NativeOwner(self._lib.el_free)
        hold_owner = native.NativeOwner(self._lib.el_free)
        try:
            user_side = S.BinnedSide(**native.unpack_cside(out.user_side,
                                                           owner))
            item_side = S.BinnedSide(**native.unpack_cside(out.item_side,
                                                           owner))
            ent_vocab = _decode_vocab(out.ent_dict, out.ent_dict_bytes,
                                      out.ent_offsets, out.n_ent)
            tgt_vocab = _decode_vocab(out.tgt_dict, out.tgt_dict_bytes,
                                      out.tgt_offsets, out.n_tgt)
            holdout = None
            if out.n_hold:
                nh = out.n_hold
                for p in (out.hold_u, out.hold_i, out.hold_v):
                    hold_owner.add(p)
                holdout = (
                    native.as_ndarray(out.hold_u, nh * 4, np.int32, (nh,),
                                      hold_owner),
                    native.as_ndarray(out.hold_i, nh * 4, np.int32, (nh,),
                                      hold_owner),
                    native.as_ndarray(out.hold_v, nh * 4, np.float32, (nh,),
                                      hold_owner))
        finally:
            # the vocabularies are Python strings now
            for p in (out.ent_dict, out.ent_offsets, out.tgt_dict,
                      out.tgt_offsets):
                if p:
                    self._lib.el_free(p)
        return S.BinnedInteractions(
            user_side=user_side, item_side=item_side,
            entity_vocab=ent_vocab, target_vocab=tgt_vocab,
            holdout=holdout, n_rows=int(n),
            scan_sec=float(out.scan_sec), bin_sec=float(out.bin_sec))

    def insert_columnar(self, cols: S.EventColumns, app_id, channel_id=None,
                        *, entity_type: str,
                        target_entity_type: Optional[str] = None,
                        value_property: Optional[str] = None) -> int:
        """Native bulk ingest: the rows are checked against
        ``validate_event``'s rules by kind (``_validate_columns``), then
        packed into wire records in C++ straight from the dict-encoded
        columns, 4M rows a call (ref: PEvents.write:124)."""
        h = self._handle(app_id, channel_id)
        _validate_columns(cols, entity_type, target_entity_type,
                          value_property)

        def dict_concat(vocab):
            joined, offsets = S.pack_vocab(vocab)
            # the u16 wire header: >= 0xFFFF would alias the absent
            # sentinel
            widths = np.diff(offsets.astype(np.int64))
            if widths.size and int(widths.max()) >= 0xFFFF:
                raise S.StorageError(
                    f"id/name of {int(widths.max())} bytes exceeds the "
                    "65534-byte wire-format limit")
            return joined, offsets

        def ptr(arr, ctype):
            return arr.ctypes.data_as(ctypes.POINTER(ctype))

        ent_b, ent_off = dict_concat(cols.entity_vocab)
        tgt_b, tgt_off = dict_concat(cols.target_vocab)
        nam_b, nam_off = dict_concat(cols.names)
        ent_codes = np.ascontiguousarray(cols.entity_codes, np.int32)
        tgt_codes = np.ascontiguousarray(cols.target_codes, np.int32)
        nam_codes = np.ascontiguousarray(cols.name_codes, np.int32)
        times = np.ascontiguousarray(cols.times_us, np.int64)
        values = np.ascontiguousarray(cols.values, np.float64)
        n = len(cols)
        chunk = 4_000_000
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            wrote = self._lib.el_append_columnar(
                h, m, entity_type.encode("utf-8"),
                (target_entity_type.encode("utf-8")
                 if target_entity_type is not None else None),
                (value_property.encode("utf-8")
                 if value_property is not None else None),
                ent_b, ptr(ent_off, ctypes.c_uint64), len(cols.entity_vocab),
                tgt_b, ptr(tgt_off, ctypes.c_uint64), len(cols.target_vocab),
                nam_b, ptr(nam_off, ctypes.c_uint64), len(cols.names),
                ptr(ent_codes[s:s + m], ctypes.c_int32),
                ptr(tgt_codes[s:s + m], ctypes.c_int32),
                ptr(nam_codes[s:s + m], ctypes.c_int32),
                ptr(times[s:s + m], ctypes.c_int64),
                ptr(values[s:s + m], ctypes.c_double),
                None)
            if wrote != m:
                raise S.StorageError(
                    f"columnar append failed ({wrote} of {m} written)")
        if n:
            perfacct.note_ingest()
            if dataobs.DATAOBS.enabled():
                dataobs.DATAOBS.observe_columnar(app_id, cols)
        return n

    def data_fingerprint(self, app_id, channel_id=None) -> str:
        """O(1) content fingerprint that changes whenever the log does:
        a hash of the resolved log directory (the log's identity, so two
        apps with equal content differ) and the content quadruple
        (generation, bytes, records, tombstones). The layout cache keys
        on it."""
        h = self._handle(app_id, channel_id)
        out = (ctypes.c_uint64 * 4)()
        self._lib.el_fingerprint(h, out)
        log_id = hashlib.sha256(os.path.realpath(
            self._dir(app_id, channel_id)).encode()).hexdigest()[:12]
        return f"L{log_id}-g{out[0]}-b{out[1]}-n{out[2]}-t{out[3]}"

    def compact(self, app_id, channel_id=None) -> Dict[str, int]:
        """Rewrite the log keeping only live records (the role of an
        HBase major compaction) and persist a fresh index snapshot.
        Returns {"dropped", "before_bytes", "after_bytes"}."""
        h = self._handle(app_id, channel_id)
        before = ctypes.c_uint64()
        after = ctypes.c_uint64()
        dropped = self._lib.el_compact(h, ctypes.byref(before),
                                       ctypes.byref(after))
        if dropped < 0:
            raise S.StorageError("compaction failed in native event log")
        return {"dropped": int(dropped), "before_bytes": int(before.value),
                "after_bytes": int(after.value)}

    def close(self) -> None:
        """Close every open log (releasing its writer lock)."""
        with self._lock:
            for h in self._handles.values():
                self._lib.el_close(h)
            self._handles.clear()


class EventLogStorageClient(S.StorageClient):
    """Events in the native log; metadata and models in localfs at
    ``<PATH>/meta`` (the HBase-for-events, ES-for-metadata pairing)."""

    def __init__(self, config: Dict[str, str]):
        super().__init__(config)
        base = os.path.expanduser(
            config.get("PATH", os.path.join("~", ".pio_store", "eventlog")))
        self._events = EventLogEventStore(
            os.path.join(base, "events"),
            fsync=config.get("FSYNC", "0") == "1")
        self._meta = LocalFSStorageClient({"PATH": os.path.join(base, "meta")})

    def events(self):
        return self._events

    def apps(self):
        return self._meta.apps()

    def access_keys(self):
        return self._meta.access_keys()

    def channels(self):
        return self._meta.channels()

    def engine_manifests(self):
        return self._meta.engine_manifests()

    def engine_instances(self):
        return self._meta.engine_instances()

    def evaluation_instances(self):
        return self._meta.evaluation_instances()

    def models(self):
        return self._meta.models()

    def health_check(self) -> bool:
        return self._meta.health_check()


S.register_backend("eventlog", EventLogStorageClient)
