"""Storage abstraction + env-configured registry.

Copy of ``predictionio_tpu/data/storage.py``: the EVENTDATA repository
(events: appended one by one, in batches or as dict-encoded columns;
read by id, by a filtered scan, as dict-encoded columns, or binned
straight into the ALS layout by the native event log; entity
properties folded from ``$set``/``$unset``/``$delete`` events), the
apps, access keys and channels that name an event table, engine
manifests, engine and evaluation instances and model blobs, each with
the upsert (``put``) that replication and repair write through. The
env-var contract is the same (ref: Storage.scala:40,151,183): sources
are declared with ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-type
config; the types are ``memory``, ``localfs``, ``eventlog``, ``sqlite``
and ``rest``) and repositories are mapped onto them with
``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}``; with no storage vars
at all, one localfs source rooted at ``$PIO_FS_BASEDIR`` (default
``~/.pio_store``) serves everything. A source is opened at its first
use.
"""

from __future__ import annotations

import abc
import dataclasses
import datetime as _dt
import hashlib
import io
import logging
import math
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_torch.data.datamap import PropertyMap
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import (AccessKey, App, Channel,
                                              EngineInstance, EngineManifest,
                                              EvaluationInstance, Model)
from predictionio_torch.obs import dataobs, perfacct
from predictionio_torch.resilience import chaos

log = logging.getLogger(__name__)

#: sentinel distinguishing "don't filter" from "filter for None"
#: (ref: PEvents.find targetEntityType: Option[Option[String]])
UNSET = object()


class StorageError(RuntimeError):
    pass


class StorageUnavailableError(StorageError):
    """Connection-level failure (refused, reset, timed out): the backend
    could not be reached, as opposed to an application error it
    answered with. Idempotent network operations retry on it, and
    replica failover moves past it."""


class RowValidationError(StorageError):
    """A strict batch insert met an invalid row: a client-data error
    (nothing was appended), never a backend fault."""


@dataclasses.dataclass
class EventColumns:
    """Dict-encoded columnar view of a filtered event scan — the bulk
    training read. ``entity_codes[i]`` indexes ``entity_vocab``
    (first-seen order); ``target_codes[i]`` likewise, with -1 for events
    without a target id. ``values[i]`` is the numeric property asked for
    via ``value_property`` (NaN when absent or not numeric). ``times_us``
    is the event time in epoch microseconds (UTC)."""

    entity_codes: np.ndarray      # int32 [n]
    target_codes: np.ndarray      # int32 [n], -1 = no target id
    name_codes: np.ndarray        # int32 [n]
    values: np.ndarray            # float64 [n], NaN = absent
    times_us: np.ndarray          # int64 [n]
    entity_vocab: List[str]
    target_vocab: List[str]
    names: List[str]

    def __len__(self) -> int:
        return len(self.entity_codes)


@dataclasses.dataclass
class BinnedSide:
    """One side of the ALS trainer's transfer-compressed segmented
    layout as the native builders produce it (``el_bin_columnar``,
    ``rb_bin_compressed``): the same shapes and bytes as
    ``ops.als.compress_side(ops.ragged.build_segmented_groups(...))``
    over the same COO. The arrays may be zero-copy views over native
    buffers, whose lifetime their buffer objects anchor
    (``native.as_ndarray``)."""

    idx_lo: np.ndarray              # [R, L] uint16
    idx_hi: Optional[np.ndarray]    # [R, L] uint8, None when vocab < 2^16
    val: np.ndarray                 # [R, L] uint8 codes | float32
    mask: Optional[np.ndarray]      # [R, L] uint8, None when val is coded
    seg: np.ndarray                 # [R] int32
    counts: np.ndarray              # [G] int32
    affine: Optional[Tuple[float, float]]
    row_block: int
    group_block: int
    groups_per_shard: int
    n_shards: int
    n_groups: int                   # true group count (before padding)
    kept_entries: int
    kept_value_sum: float


@dataclasses.dataclass
class BinnedInteractions:
    """Both sides of an interaction dataset binned straight off the
    event log by one native call: grouped by entity (users) and by
    target (items), the id vocabularies (first-seen order), and an
    optional held-out COO split. ``scan_sec``/``bin_sec`` are the
    native call's own split of its time: filter, encode and vocabularies
    against plan and fill."""

    user_side: BinnedSide
    item_side: BinnedSide
    entity_vocab: List[str]
    target_vocab: List[str]
    #: (user_idx int32, item_idx int32, values float32) or None
    holdout: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    n_rows: int
    scan_sec: float
    bin_sec: float


def pack_vocab(vocab) -> tuple:
    """Concatenated UTF-8 bytes + exact (len+1) uint64 prefix offsets:
    the separator-free dictionary layout of the native columnar calls
    and of the bin cache, so ids holding any byte round-trip."""
    bs = [s.encode("utf-8") for s in vocab]
    offsets = np.zeros(len(bs) + 1, np.uint64)
    if bs:
        np.cumsum(np.fromiter((len(b) for b in bs), np.uint64,
                              count=len(bs)), out=offsets[1:])
    return b"".join(bs), offsets


def unpack_vocab(data, offsets) -> List[str]:
    """Inverse of :func:`pack_vocab`: concatenated bytes (bytes or a
    uint8 array) + prefix offsets -> the vocabulary list."""
    raw = data.tobytes() if hasattr(data, "tobytes") else bytes(data)
    offs = [int(o) for o in offsets]
    return [raw[offs[i]:offs[i + 1]].decode("utf-8")
            for i in range(len(offs) - 1)]


def stable_hash(s: str) -> int:
    """Process-independent 64-bit hash of a string id: the partition
    function of every entity-routed split (host-sharded training reads,
    ``parallel.multihost``, and shard-filtered columnar scans,
    ``find_columnar(shard_index=, shard_count=)``), as every HBase reader
    and writer agrees on the MD5 rowkey prefix
    (hbase/HBEventsUtil.scala:96-108). The same md5 as the JAX package's,
    so both packages shard alike; builtin ``hash`` is salted per
    process."""
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "little")


def _compact_columns(cols: EventColumns, keep: np.ndarray) -> EventColumns:
    """Rows where ``keep`` is True, with every vocabulary compacted to
    the ids those rows reference (first-seen order preserved)."""

    def remap(codes, vocab, sentinel: bool):
        kept = codes[keep]
        used = np.unique(kept)
        if sentinel:
            used = used[used >= 0]
        table = np.full(len(vocab), -1, np.int32)
        table[used] = np.arange(len(used), dtype=np.int32)
        new_vocab = [vocab[int(c)] for c in used]
        if sentinel:
            new_codes = np.where(
                kept >= 0,
                table[np.maximum(kept, 0)] if table.size else np.int32(-1),
                np.int32(-1)).astype(np.int32)
        else:
            new_codes = table[kept].astype(np.int32, copy=False)
        return new_codes, new_vocab

    ent, ent_v = remap(cols.entity_codes, cols.entity_vocab, False)
    tgt, tgt_v = remap(cols.target_codes, cols.target_vocab, True)
    nam, nam_v = remap(cols.name_codes, cols.names, False)
    return EventColumns(
        entity_codes=ent, target_codes=tgt, name_codes=nam,
        values=cols.values[keep], times_us=cols.times_us[keep],
        entity_vocab=ent_v, target_vocab=tgt_v, names=nam_v)


def shard_columns(cols: EventColumns, shard_index: int,
                  shard_count: int) -> EventColumns:
    """The rows of ``cols`` whose entity id hash-routes to shard
    ``shard_index`` of ``shard_count`` (``stable_hash % count``): all of
    one entity's events land on one shard (the reference's rowkey-prefix
    region split, HBEventsUtil RowKey:81). Vocabularies are compacted to
    the surviving rows."""
    if shard_count <= 1:
        return cols
    vmask = np.fromiter(
        (stable_hash(v) % shard_count == shard_index
         for v in cols.entity_vocab),
        np.bool_, count=len(cols.entity_vocab))
    keep = (vmask[cols.entity_codes] if len(cols)
            else np.zeros(0, np.bool_))
    return _compact_columns(cols, keep)


def limit_columns(cols: EventColumns, limit: Optional[int],
                  newest_first: bool = False) -> EventColumns:
    """The ``limit`` rows of ``cols`` by event time (newest when
    ``newest_first``), vocabularies compacted: how a shard-filtered read
    applies a row limit after its shard filter, as ``find`` orders and
    then truncates."""
    if limit is None or limit < 0 or len(cols) <= limit:
        return cols
    order = np.argsort(cols.times_us, kind="stable")
    if newest_first:
        order = order[::-1]
    take = order[:limit]
    sub = EventColumns(
        entity_codes=cols.entity_codes[take],
        target_codes=cols.target_codes[take],
        name_codes=cols.name_codes[take],
        values=cols.values[take], times_us=cols.times_us[take],
        entity_vocab=cols.entity_vocab, target_vocab=cols.target_vocab,
        names=cols.names)
    return _compact_columns(sub, np.ones(limit, np.bool_))


def merge_columns(parts: Sequence[EventColumns],
                  time_ordered: bool = False) -> EventColumns:
    """Concatenate columnar scan results (one per shard) into one
    ``EventColumns`` with union vocabularies; codes are remapped per
    part. ``time_ordered=True`` stably sorts the merged rows by event
    time (shard scans interleave times)."""
    if not parts:
        return EventColumns(
            entity_codes=np.empty(0, np.int32),
            target_codes=np.empty(0, np.int32),
            name_codes=np.empty(0, np.int32),
            values=np.empty(0, np.float64), times_us=np.empty(0, np.int64),
            entity_vocab=[], target_vocab=[], names=[])
    if len(parts) == 1 and not time_ordered:
        return parts[0]
    ent_vocab: Dict[str, int] = {}
    tgt_vocab: Dict[str, int] = {}
    nam_vocab: Dict[str, int] = {}
    ents, tgts, nams, vals, tims = [], [], [], [], []

    def vocab_map(vocab, union):
        return np.fromiter((union.setdefault(v, len(union)) for v in vocab),
                           np.int32, count=len(vocab))

    for cols in parts:
        ent_map = vocab_map(cols.entity_vocab, ent_vocab)
        tgt_map = vocab_map(cols.target_vocab, tgt_vocab)
        nam_map = vocab_map(cols.names, nam_vocab)
        ents.append(ent_map[cols.entity_codes] if len(cols)
                    else cols.entity_codes)
        if len(cols):
            tgts.append(np.where(
                cols.target_codes >= 0,
                tgt_map[np.maximum(cols.target_codes, 0)]
                if tgt_map.size else np.int32(-1),
                np.int32(-1)).astype(np.int32))
            nams.append(nam_map[cols.name_codes])
        else:
            tgts.append(cols.target_codes)
            nams.append(cols.name_codes)
        vals.append(cols.values)
        tims.append(cols.times_us)
    merged = EventColumns(
        entity_codes=np.concatenate(ents).astype(np.int32, copy=False),
        target_codes=np.concatenate(tgts).astype(np.int32, copy=False),
        name_codes=np.concatenate(nams).astype(np.int32, copy=False),
        values=np.concatenate(vals), times_us=np.concatenate(tims),
        entity_vocab=list(ent_vocab), target_vocab=list(tgt_vocab),
        names=list(nam_vocab))
    if time_ordered and len(merged):
        order = np.argsort(merged.times_us, kind="stable")
        merged = EventColumns(
            entity_codes=merged.entity_codes[order],
            target_codes=merged.target_codes[order],
            name_codes=merged.name_codes[order],
            values=merged.values[order], times_us=merged.times_us[order],
            entity_vocab=merged.entity_vocab,
            target_vocab=merged.target_vocab, names=merged.names)
    return merged


def columns_to_npz(cols: EventColumns) -> bytes:
    """``EventColumns`` -> one .npz blob: the wire format in which
    ``parallel.multihost.exchange_columns`` moves a read shard (the JAX
    package's storage server speaks it too)."""
    buf = io.BytesIO()
    columns_to_npz_file(cols, buf)
    return buf.getvalue()


def columns_to_npz_file(cols: EventColumns, f) -> None:
    """Write the npz wire format to an open binary file; vocabularies
    travel as ``pack_vocab`` bytes and offsets."""

    def vocab_arrays(vocab):
        joined, offsets = pack_vocab(vocab)
        return np.frombuffer(joined, dtype=np.uint8), offsets

    ent_b, ent_off = vocab_arrays(cols.entity_vocab)
    tgt_b, tgt_off = vocab_arrays(cols.target_vocab)
    nam_b, nam_off = vocab_arrays(cols.names)
    np.savez(
        f, entity_codes=cols.entity_codes, target_codes=cols.target_codes,
        name_codes=cols.name_codes, values=cols.values,
        times_us=cols.times_us,
        entity_vocab=ent_b, entity_vocab_offsets=ent_off,
        target_vocab=tgt_b, target_vocab_offsets=tgt_off,
        names=nam_b, names_offsets=nam_off)


def npz_to_columns(blob) -> EventColumns:
    """Inverse of :func:`columns_to_npz`; takes bytes, a binary file
    object or a path (``np.load``'s own contract)."""
    z = np.load(io.BytesIO(blob) if isinstance(blob, bytes) else blob)

    def vocab(key):
        return unpack_vocab(z[key], z[key + "_offsets"])

    return EventColumns(
        entity_codes=z["entity_codes"], target_codes=z["target_codes"],
        name_codes=z["name_codes"], values=z["values"],
        times_us=z["times_us"], entity_vocab=vocab("entity_vocab"),
        target_vocab=vocab("target_vocab"), names=vocab("names"))


class EventStore(abc.ABC):
    """Event DAO (ref: LEvents.scala:30 + PEvents.scala:30, one store
    for both the write path and the bulk training read)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Create the event table of an app (ref: LEvents.init)."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Drop the event table of an app (ref: LEvents.remove)."""

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Append one event, returning its assigned eventId."""

    def insert_batch(self, events: List[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """Bulk append (ref: PEvents.write:124). An accepted batch moves
        the ingest clock (``pio_model_staleness_seconds`` counts how long
        its rows wait for a servable model) and is observed by the data
        plane."""
        ids = self._insert_many(events, app_id, channel_id)
        if ids:
            perfacct.note_ingest()
            dataobs.DATAOBS.observe_events(app_id, events)
        return ids

    def _insert_many(self, events: List[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """The append step of ``insert_batch``: one ``insert`` per event
        here; a store that writes a batch at once overrides it."""
        return [self.insert(e, app_id, channel_id) for e in events]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        """The event with this id, or None (ref: LEvents.get)."""

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        """Delete one event; False when there was none (ref:
        LEvents.delete)."""

    @abc.abstractmethod
    def find(self, app_id: int, channel_id: Optional[int] = None,
             start_time: Optional[_dt.datetime] = None,
             until_time: Optional[_dt.datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[List[str]] = None,
             target_entity_type: Any = UNSET,
             target_entity_id: Any = UNSET,
             limit: Optional[int] = None,
             reversed: bool = False) -> List[Event]:
        """Filtered scan ordered by event time (ref: PEvents.find:70);
        ``[start_time, until_time)`` is half-open, ``limit`` None or -1
        means all, ``reversed`` returns newest first."""

    @staticmethod
    def check_shard_params(shard_index: Optional[int],
                           shard_count: Optional[int]) -> None:
        """Validate the optional entity-hash read-shard pair (both set
        or neither; the index in range). Every find_columnar calls it."""
        if (shard_index is None) != (shard_count is None):
            raise ValueError(
                "shard_index and shard_count must be given together")
        if shard_count is not None and not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"shard_count {shard_count}")

    def find_columnar(self, app_id: int, channel_id: Optional[int] = None,
                      value_property: Optional[str] = None,
                      time_ordered: bool = True,
                      shard_index: Optional[int] = None,
                      shard_count: Optional[int] = None,
                      **find_kwargs) -> EventColumns:
        """Filtered scan as dict-encoded columns (see EventColumns), by
        converting ``find``'s events as the JAX package's default does.
        ``time_ordered`` is accepted for the same signature: ``find``
        always orders by time.

        ``shard_index``/``shard_count`` select the entity-hash read shard
        (``stable_hash(entity_id) % count == index``): each of N training
        processes reads its ~1/N of the rows (the reference's
        per-executor HBase region scans, hbase/HBPEvents.scala:48). A row
        ``limit`` applies after the shard filter."""
        self.check_shard_params(shard_index, shard_count)
        sharding = shard_count is not None and shard_count > 1
        limit = find_kwargs.pop("limit", None) if sharding else None
        events = self.find(app_id, channel_id=channel_id, **find_kwargs)
        if sharding:
            events = [e for e in events
                      if stable_hash(e.entity_id) % shard_count == shard_index]
            if limit is not None and limit >= 0:
                events = events[:limit]
        n = len(events)
        ent_codes = np.empty(n, np.int32)
        tgt_codes = np.empty(n, np.int32)
        name_codes = np.empty(n, np.int32)
        values = np.full(n, np.nan, np.float64)
        times_us = np.empty(n, np.int64)
        ent_vocab: Dict[str, int] = {}
        tgt_vocab: Dict[str, int] = {}
        name_vocab: Dict[str, int] = {}
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        for i, e in enumerate(events):
            ent_codes[i] = ent_vocab.setdefault(e.entity_id, len(ent_vocab))
            tgt_codes[i] = (-1 if e.target_entity_id is None else
                            tgt_vocab.setdefault(e.target_entity_id,
                                                 len(tgt_vocab)))
            name_codes[i] = name_vocab.setdefault(e.event, len(name_vocab))
            times_us[i] = (e.event_time - epoch) // _dt.timedelta(
                microseconds=1)
            if value_property is not None:
                v = e.properties.get_opt(value_property)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    values[i] = float(v)
        return EventColumns(
            entity_codes=ent_codes, target_codes=tgt_codes,
            name_codes=name_codes, values=values, times_us=times_us,
            entity_vocab=list(ent_vocab), target_vocab=list(tgt_vocab),
            names=list(name_vocab))

    def insert_columnar(self, cols: EventColumns, app_id: int,
                        channel_id: Optional[int] = None, *,
                        entity_type: str,
                        target_entity_type: Optional[str] = None,
                        value_property: Optional[str] = None) -> int:
        """Bulk append from dict-encoded columns, the ingest mirror of
        ``find_columnar`` (ref: PEvents.write:124): ``values`` NaN = no
        property, ``target_codes`` -1 = no target; event times come
        from ``times_us`` and fresh ids are assigned. Returns the row
        count. This default builds events in chunks; the native event
        log packs the rows in C++."""
        epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
        n = len(cols)
        chunk = 100_000
        for s in range(0, n, chunk):
            events = []
            for i in range(s, min(s + chunk, n)):
                props: Dict[str, Any] = {}
                v = (float(cols.values[i]) if value_property is not None
                     else math.nan)
                if not math.isnan(v):
                    props[value_property] = v
                tc = int(cols.target_codes[i])
                events.append(Event(
                    event=cols.names[cols.name_codes[i]],
                    entity_type=entity_type,
                    entity_id=cols.entity_vocab[cols.entity_codes[i]],
                    target_entity_type=target_entity_type if tc >= 0 else None,
                    target_entity_id=cols.target_vocab[tc] if tc >= 0 else None,
                    properties=props,
                    event_time=epoch + _dt.timedelta(
                        microseconds=int(cols.times_us[i]))))
            self.insert_batch(events, app_id, channel_id)
        return n

    def compact(self, app_id: int, channel_id: Optional[int] = None):
        """Reclaim the space of deleted or superseded events (the HBase
        major-compaction role). Stores that update in place have none to
        reclaim and return None; the native event log overrides."""
        return None

    def aggregate_properties(
        self, app_id: int, entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        required: Optional[List[str]] = None,
    ) -> Dict[str, PropertyMap]:
        """Materialize entity properties from their ``$set`` /
        ``$unset`` / ``$delete`` events (ref:
        PEvents.aggregateProperties:95)."""
        from predictionio_torch.data.aggregation import (
            aggregate_properties_from_events)

        events = self.find(app_id, channel_id=channel_id,
                           start_time=start_time, until_time=until_time,
                           entity_type=entity_type,
                           event_names=["$set", "$unset", "$delete"])
        return aggregate_properties_from_events(events, required=required)


class AppsRepo(abc.ABC):
    """ref: Apps.scala"""

    @abc.abstractmethod
    def insert(self, name: str, description: Optional[str] = None) -> App: ...
    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...
    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...
    @abc.abstractmethod
    def get_all(self) -> List[App]: ...
    @abc.abstractmethod
    def update(self, app: App) -> None: ...
    @abc.abstractmethod
    def delete(self, app_id: int) -> None: ...

    def put(self, app: App) -> None:
        """Upsert the full record under its existing id: the replication
        and repair write (the metadata-tier role of ES's replica shards,
        elasticsearch/StorageClient.scala:42). It assigns no id and does
        not check uniqueness again: the owner's ``insert`` did both.
        Backends whose ``update`` is not an upsert override it."""
        self.update(app)


class AccessKeysRepo(abc.ABC):
    """ref: AccessKeys.scala"""

    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> str: ...
    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...
    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...
    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...
    @abc.abstractmethod
    def update(self, access_key: AccessKey) -> None: ...
    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    def put(self, access_key: AccessKey) -> None:
        """Replication and repair upsert (see ``AppsRepo.put``)."""
        self.update(access_key)


class ChannelsRepo(abc.ABC):
    """ref: Channels.scala — created by ``pio app channel-new``; a
    channel names its own event table of the app."""

    @abc.abstractmethod
    def insert(self, name: str, app_id: int) -> Channel: ...
    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...
    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...
    @abc.abstractmethod
    def delete(self, channel_id: int) -> None: ...
    @abc.abstractmethod
    def put(self, channel: Channel) -> None:
        """Replication and repair upsert under the record's existing id
        (see ``AppsRepo.put``); abstract because channels have no
        ``update`` to fall back on."""


class EngineManifestsRepo(abc.ABC):
    """ref: EngineManifests.scala"""

    @abc.abstractmethod
    def insert(self, manifest: EngineManifest) -> None: ...
    @abc.abstractmethod
    def get(self, id: str, version: str) -> Optional[EngineManifest]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EngineManifest]: ...
    @abc.abstractmethod
    def update(self, manifest: EngineManifest) -> None: ...
    @abc.abstractmethod
    def delete(self, id: str, version: str) -> None: ...

    def put(self, manifest: EngineManifest) -> None:
        """Replication and repair upsert (see ``AppsRepo.put``)."""
        self.update(manifest)


class EngineInstancesRepo(abc.ABC):
    """ref: EngineInstances.scala"""

    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[EngineInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...
    @abc.abstractmethod
    def delete(self, id: str) -> None: ...

    def update(self, instance: EngineInstance) -> None:
        """Replace the record under its id (insert is an upsert)."""
        self.insert(instance)

    def put(self, instance: EngineInstance) -> None:
        """Replication and repair upsert (see ``AppsRepo.put``)."""
        self.update(instance)

    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]:
        """ref: EngineInstances.getCompleted — newest first."""
        out = [i for i in self.get_all()
               if i.status == "COMPLETED" and i.engine_id == engine_id
               and i.engine_version == engine_version
               and i.engine_variant == engine_variant]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out

    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str) -> Optional[EngineInstance]:
        completed = self.get_completed(engine_id, engine_version,
                                       engine_variant)
        return completed[0] if completed else None


class EvaluationInstancesRepo(abc.ABC):
    """ref: EvaluationInstances.scala"""

    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[EvaluationInstance]: ...
    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...
    @abc.abstractmethod
    def delete(self, id: str) -> None: ...

    def update(self, instance: EvaluationInstance) -> None:
        """Replace the record under its id (insert is an upsert)."""
        self.insert(instance)

    def put(self, instance: EvaluationInstance) -> None:
        """Replication and repair upsert (see ``AppsRepo.put``)."""
        self.update(instance)

    def get_completed(self) -> List[EvaluationInstance]:
        """ref: EvaluationInstances.getCompleted — EVALCOMPLETED runs,
        newest first."""
        out = [i for i in self.get_all() if i.status == "EVALCOMPLETED"]
        out.sort(key=lambda i: i.start_time, reverse=True)
        return out


class ModelsRepo(abc.ABC):
    """ref: Models.scala — model blobs keyed by engine-instance id."""

    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...
    @abc.abstractmethod
    def get(self, id: str) -> Optional[Model]: ...
    @abc.abstractmethod
    def delete(self, id: str) -> None: ...

    def size(self, id: str) -> Optional[int]:
        """Blob length in bytes, or None when absent. Backends answer
        from metadata (a stat, a SQL ``length``); this fallback fetches
        the blob and measures it."""
        model = self.get(id)
        return None if model is None else len(model.models)

    @abc.abstractmethod
    def list(self) -> List[Dict[str, Any]]:
        """Inventory for replica repair: one ``{"id", "bytes",
        "sha256"}`` per stored blob (the role of HDFS's block reports
        under 3x replication, hdfs/HDFSModels.scala:28)."""


def blob_inventory(blobs) -> List[Dict[str, Any]]:
    """``ModelsRepo.list`` rows of ``(id, bytes)`` pairs."""
    return [{"id": mid, "bytes": len(blob),
             "sha256": hashlib.sha256(blob).hexdigest()}
            for mid, blob in blobs]


class StorageClient(abc.ABC):
    """One configured storage source (ref: BaseStorageClient,
    Storage.scala:298), made from its ``PIO_STORAGE_SOURCES_<NAME>_*``
    config."""

    def __init__(self, config: Dict[str, str]):
        self.config = config

    @abc.abstractmethod
    def events(self) -> EventStore: ...
    @abc.abstractmethod
    def apps(self) -> AppsRepo: ...
    @abc.abstractmethod
    def access_keys(self) -> AccessKeysRepo: ...
    @abc.abstractmethod
    def channels(self) -> ChannelsRepo: ...
    @abc.abstractmethod
    def engine_manifests(self) -> EngineManifestsRepo: ...
    @abc.abstractmethod
    def engine_instances(self) -> EngineInstancesRepo: ...
    @abc.abstractmethod
    def evaluation_instances(self) -> EvaluationInstancesRepo: ...
    @abc.abstractmethod
    def models(self) -> ModelsRepo: ...

    def health_check(self) -> bool:
        """Backend reachability probe (ref: Storage.verifyAllDataObjects
        instantiates each DAO against its live backend). Local backends
        are healthy once constructed; network backends override."""
        return True


_BACKENDS: Dict[str, type] = {}


def register_backend(type_name: str, client_cls: type) -> None:
    _BACKENDS[type_name] = client_cls


def _load_backends() -> None:
    # import side effect registers the built-in backends; the eventlog
    # backend builds its native library at first use, not on import
    from predictionio_torch.data.backends import (eventlog, localfs,  # noqa: F401
                                                  memory, rest, sqlite)


_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_(.+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


class Storage:
    """Repositories mapped to StorageClients (ref: Storage.scala:40-166).
    A source is opened at its first use, so a deployment whose EVENTDATA
    source cannot be opened (a type no backend registers, a server that
    is down) still reads its metadata and models."""

    def __init__(self, sources: Dict[str, Dict[str, str]],
                 repo_to_source: Dict[str, str]):
        self._sources = sources
        self._repo_to_source = repo_to_source
        self._clients: Dict[str, StorageClient] = {}
        self._lock = threading.Lock()

    def client_for(self, repo: str) -> StorageClient:
        # the chaos harness's storage seam: every repository access
        # (DAO lookups, health probes, model loads) funnels through here
        # (resilience/chaos.py; ChaosError is a ConnectionError)
        chaos.inject("storage")
        source = self._repo_to_source.get(repo.upper())
        if source is None or source not in self._sources:
            raise StorageError(f"repository {repo} has no configured source")
        with self._lock:
            client = self._clients.get(source)
            if client is None:
                type_name = self._sources[source].get("TYPE")
                if type_name not in _BACKENDS:
                    raise StorageError(
                        f"storage source {source}: unknown TYPE "
                        f"{type_name!r} (known: {sorted(_BACKENDS)})")
                client = _BACKENDS[type_name](self._sources[source])
                self._clients[source] = client
        return client

    def events(self) -> EventStore:
        return self.client_for("EVENTDATA").events()

    def apps(self) -> AppsRepo:
        return self.client_for("METADATA").apps()

    def access_keys(self) -> AccessKeysRepo:
        return self.client_for("METADATA").access_keys()

    def channels(self) -> ChannelsRepo:
        return self.client_for("METADATA").channels()

    def engine_manifests(self) -> EngineManifestsRepo:
        return self.client_for("METADATA").engine_manifests()

    def engine_instances(self) -> EngineInstancesRepo:
        return self.client_for("METADATA").engine_instances()

    def evaluation_instances(self) -> EvaluationInstancesRepo:
        return self.client_for("METADATA").evaluation_instances()

    def models(self) -> ModelsRepo:
        return self.client_for("MODELDATA").models()

    def verify_all_data_objects(self) -> Dict[str, bool]:
        """ref: Storage.verifyAllDataObjects:237 — each repository's
        source opened and probed; a source that cannot be opened (a TYPE
        the port lacks, an unreadable path) reads False."""
        results: Dict[str, bool] = {}
        for repo in REPOSITORIES:
            try:
                results[repo] = self.client_for(repo).health_check()
            except Exception as e:  # noqa: BLE001 — reported, not raised
                log.warning("health check failed for %s: %s: %s",
                            repo, type(e).__name__, e)
                results[repo] = False
        return results

    def health_details(self) -> Dict[str, Dict[str, bool]]:
        """Per repository, each endpoint's liveness for sources that
        expose it (the sharded ``rest`` source), so ``pio status`` names
        a down shard; a one-endpoint source reports one empty-named
        entry. Each client is probed once, however many repositories it
        serves."""
        out: Dict[str, Dict[str, bool]] = {}
        probed: Dict[int, Dict[str, bool]] = {}
        for repo in REPOSITORIES:
            try:
                client = self.client_for(repo)
                cached = probed.get(id(client))
                if cached is None:
                    detail = getattr(client, "health_detail", None)
                    cached = (dict(detail()) if detail is not None
                              else {"": client.health_check()})
                    probed[id(client)] = cached
                out[repo] = dict(cached)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                log.warning("health detail probe failed for %s: %s: %s",
                            repo, type(e).__name__, e)
                out[repo] = {"": False}
        return out

    def serving_status(self) -> Dict[str, Dict[str, Any]]:
        """Per repository, whether its tier can still answer
        (``serving``: a replicated source serves through surviving
        replicas), whether it answers with some endpoint down
        (``degraded``) and each endpoint's state: what ``pio status``
        turns into exit codes. A client with ``health_tiers`` (the
        ``rest`` source) resolves its tiers itself; any other serves
        while its one endpoint answers. A source that cannot be opened
        reads not serving."""
        out: Dict[str, Dict[str, Any]] = {}
        probed: Dict[int, Dict[str, Any]] = {}
        for repo in REPOSITORIES:
            try:
                client = self.client_for(repo)
                tiers = probed.get(id(client))
                if tiers is None:
                    fn = getattr(client, "health_tiers", None)
                    if fn is not None:
                        tiers = dict(fn())
                    else:
                        up = bool(client.health_check())
                        tiers = {"endpoints": {"": up},
                                 "metadata_serving": up,
                                 "events_serving": up, "all_up": up}
                    probed[id(client)] = tiers
                serving = (tiers["events_serving"] if repo == "EVENTDATA"
                           else tiers["metadata_serving"])
                out[repo] = {
                    "serving": bool(serving),
                    "degraded": bool(serving) and not tiers["all_up"],
                    "endpoints": dict(tiers["endpoints"]),
                }
            except Exception as e:  # noqa: BLE001 — reported, not raised
                log.warning("serving-status probe failed for %s: %s: %s",
                            repo, type(e).__name__, e)
                out[repo] = {"serving": False, "degraded": False,
                             "endpoints": {"": False}}
        return out

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "Storage":
        """Parse PIO_STORAGE_* env vars (ref: Storage.scala:45-128)."""
        _load_backends()
        env = dict(env if env is not None else os.environ)
        sources: Dict[str, Dict[str, str]] = {}
        repos: Dict[str, Dict[str, str]] = {}
        for key, value in env.items():
            m = _SOURCE_RE.match(key)
            if m:
                sources.setdefault(m.group(1), {})[m.group(2)] = value
                continue
            m = _REPO_RE.match(key)
            if m:
                repos.setdefault(m.group(1), {})[m.group(2)] = value
        if not sources:
            basedir = env.get("PIO_FS_BASEDIR",
                              os.path.expanduser("~/.pio_store"))
            sources = {"LOCALFS": {"TYPE": "localfs", "PATH": basedir}}
            repos = {r: {"NAME": r.lower(), "SOURCE": "LOCALFS"}
                     for r in REPOSITORIES}

        repo_to_source: Dict[str, str] = {}
        for repo in REPOSITORIES:
            cfg = repos.get(repo)
            if cfg and cfg.get("SOURCE"):
                repo_to_source[repo] = cfg["SOURCE"]
            elif len(sources) == 1:
                repo_to_source[repo] = next(iter(sources))
        return Storage(sources, repo_to_source)


_storage_lock = threading.Lock()
_storage: Optional[Storage] = None


def get_storage() -> Storage:
    global _storage
    with _storage_lock:
        if _storage is None:
            _storage = Storage.from_env()
        return _storage


def set_storage(storage: Optional[Storage]) -> None:
    """Install/replace (or with None, reset) the process-wide storage."""
    global _storage
    with _storage_lock:
        _storage = storage
