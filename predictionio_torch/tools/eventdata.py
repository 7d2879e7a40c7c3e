"""Event import/export as JSON-lines or parquet files.

Counterpart of ``predictionio_tpu/tools/eventdata.py``, with the same
record format, so a file one package exports the other imports.
Parquet needs pyarrow, which the port does not depend on: without it a
parquet path raises ``RuntimeError``. Behavior contracts:

  - export (ref: tools/.../export/EventsToFile.scala:39,92-98): read all
    events of an app (+ optional channel), write one record per event in
    the Event API format — JSONL, or parquet like the reference's
    SparkSQL path (via pyarrow here).
  - import (ref: tools/.../imprt/FileToEvents.scala:38,80-90): read a
    JSONL/parquet file, validate each record as an Event, batch-write
    into the app's event store.

Format selection: explicit ``format=`` or the ``.parquet`` extension;
default JSONL. Parquet schema is flat API-format columns with
``properties`` as a JSON-encoded string column (the stable encoding —
arbitrary property bags have no fixed arrow struct type).
"""

from __future__ import annotations

import json
import re
from typing import Iterable, List, Optional

from predictionio_torch.data.event import Event, validate_event
from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.data.store import resolve_app

_PARQUET_COLS = (
    "eventId", "event", "entityType", "entityId", "targetEntityType",
    "targetEntityId", "properties", "eventTime", "tags", "prId",
)


def _fmt(path: str, format: Optional[str]) -> str:
    if format:
        return format
    return "parquet" if path.endswith(".parquet") else "json"


def _require_pyarrow():
    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "pyarrow is required for parquet import/export"
        ) from e


def _write_parquet(path: str, dicts: Iterable[dict]) -> None:
    _require_pyarrow()
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = list(dicts)
    cols: dict = {c: [] for c in _PARQUET_COLS}
    for d in rows:
        for c in _PARQUET_COLS:
            v = d.get(c)
            if c == "properties":
                v = json.dumps(v) if v is not None else None
            elif c == "tags":
                v = list(v) if v else None
            cols[c].append(v)
    schema = pa.schema(
        [
            pa.field(c, pa.list_(pa.string()) if c == "tags" else pa.string())
            for c in _PARQUET_COLS
        ]
    )
    pq.write_table(pa.table(cols, schema=schema), path)


def _table_to_dicts(table) -> List[dict]:
    out = []
    for row in table.to_pylist():
        d = {k: v for k, v in row.items() if v is not None}
        if "properties" in d:
            d["properties"] = json.loads(d["properties"])
        out.append(d)
    return out


def _read_parquet(path: str) -> List[dict]:
    _require_pyarrow()
    import pyarrow.parquet as pq

    return _table_to_dicts(pq.read_table(path))


def export_events(
    app_name: str,
    path: str,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
    format: Optional[str] = None,
) -> int:
    """Write all events to ``path``; returns the event count."""
    st = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, st)
    events = st.events().find(app_id, channel_id=channel_id)
    dicts = (e.to_dict(api_format=True) for e in events)
    if _fmt(path, format) == "parquet":
        _write_parquet(path, dicts)
    else:
        with open(path, "w") as f:
            for d in dicts:
                f.write(json.dumps(d) + "\n")
    return len(events)


def _import_parquet_columnar(table, st, app_id, channel_id) -> Optional[int]:
    """Columnar fast path for interaction-shaped parquet files.

    A 20M-row ratings file (one entity type, one/no target type, no
    eventId/tags/prId, properties either empty or one shared numeric
    key) bulk-loads through EventStore.insert_columnar — Arrow does the
    dictionary encoding and value extraction vectorized, the native
    eventlog packs records in C++ (ref: FileToEvents.scala:38 feeding
    PEvents.write, which is Spark-parallel in the reference). Returns
    None when the file doesn't fit the shape or any record would fail
    validation — the generic row path then reports per-record errors.
    """
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from predictionio_torch.data.event import (SPECIAL_EVENTS,
                                               EventValidationError,
                                               is_reserved_prefix)
    from predictionio_torch.data.storage import EventColumns

    names = set(table.column_names)

    def all_null(col: str) -> bool:
        return col not in names or table[col].null_count == len(table)

    def single_value(col: str) -> Optional[str]:
        vals = [v for v in pc.unique(table[col]).to_pylist() if v is not None]
        return vals[0] if len(vals) == 1 else None

    n = len(table)
    if n == 0:
        return None
    # required columns present and fully populated (a null cell would
    # otherwise dict-encode to a garbage index)
    if not {"event", "entityType", "entityId", "eventTime"} <= names:
        return None
    if any(table[c].null_count for c in
           ("event", "entityType", "entityId", "eventTime")):
        return None
    if not (all_null("eventId") and all_null("tags") and all_null("prId")):
        return None
    entity_type = single_value("entityType")
    if entity_type is None:
        return None
    target_entity_type = None
    if not all_null("targetEntityType"):
        target_entity_type = single_value("targetEntityType")
        if target_entity_type is None or "targetEntityId" not in names:
            return None
        # type and id must be present/absent on exactly the same rows
        mismatch = pc.xor(
            pc.is_null(table["targetEntityType"].combine_chunks()),
            pc.is_null(table["targetEntityId"].combine_chunks()),
        )
        if pc.any(mismatch).as_py():
            return None
    elif not all_null("targetEntityId"):
        return None

    # properties: per row either absent, or exactly {"<key>": <number>}
    # with one shared key across the file
    value_property = None
    values = np.full(n, np.nan, np.float64)
    if not all_null("properties"):
        props = table["properties"].combine_chunks()
        first = json.loads(pc.drop_null(props)[0].as_py())
        if len(first) != 1:
            return None
        value_property = next(iter(first))
        if not isinstance(first[value_property], (int, float)) or isinstance(
            first[value_property], bool
        ):
            return None
        key_re = re.escape(json.dumps(value_property))
        pattern = r"^\{" + key_re + r":\s*(?P<v>-?[0-9][0-9.eE+\-]*)\s*\}$"
        extracted = pc.extract_regex(props, pattern)
        # null extraction is fine where properties were null (-> NaN);
        # a NON-null property that doesn't match is a rich bag -> row path
        bad = pc.and_(pc.is_valid(props), pc.is_null(extracted))
        if pc.any(bad).as_py():
            return None
        try:
            casted = pc.cast(pc.struct_field(extracted, "v"), pa.float64())
        except pa.ArrowInvalid:
            return None  # regex-matched but non-numeric (e.g. "3-")
        values = np.asarray(pc.fill_null(casted, float("nan")))

    # ISO event times -> epoch micros (Arrow parses ISO8601 w/ offsets)
    try:
        ts = pc.cast(table["eventTime"], pa.timestamp("us", tz="UTC"))
    except pa.ArrowInvalid:
        return None
    times_us = np.asarray(ts.cast(pa.int64()))

    def encode(col: str):
        d = table[col].combine_chunks().dictionary_encode()
        # null cells (no-target rows) -> -1, never a garbage cast
        return (
            np.asarray(pc.fill_null(d.indices, -1), dtype=np.int32),
            [s.as_py() for s in d.dictionary],
        )

    ent_codes, ent_vocab = encode("entityId")
    name_codes, name_vocab = encode("event")
    if target_entity_type is not None:
        tgt_codes, tgt_vocab = encode("targetEntityId")
    else:
        tgt_codes, tgt_vocab = np.full(n, -1, np.int32), []

    # the validation contract (validate_event) vectorized: string rules
    # once per UNIQUE vocab entry, cross-field rules as array ops —
    # any violation falls back to the row path for a positioned error
    try:
        for name in name_vocab:
            has_special = name in SPECIAL_EVENTS
            validate_event(Event(
                event=name, entity_type=entity_type, entity_id="probe",
                target_entity_type=None if has_special else target_entity_type,
                target_entity_id=None if has_special else (
                    "probe" if target_entity_type else None),
                properties={value_property: 1.0} if value_property else {},
            ))
        if any(not s for s in ent_vocab) or any(not s for s in tgt_vocab):
            return None  # empty ids
    except EventValidationError:
        return None
    special_codes = [i for i, s in enumerate(name_vocab) if is_reserved_prefix(s)]
    if special_codes:
        is_special = np.isin(name_codes, special_codes)
        # reserved events cannot carry a target (validate_event)
        if np.any(is_special & (tgt_codes >= 0)):
            return None
        # $unset requires non-empty properties
        if "$unset" in name_vocab:
            unset_rows = name_codes == name_vocab.index("$unset")
            if np.any(unset_rows & np.isnan(values)):
                return None

    cols = EventColumns(
        entity_codes=ent_codes,
        target_codes=tgt_codes,
        name_codes=name_codes,
        values=values,
        times_us=times_us,
        entity_vocab=ent_vocab,
        target_vocab=tgt_vocab,
        names=name_vocab,
    )
    return st.events().insert_columnar(
        cols, app_id, channel_id,
        entity_type=entity_type,
        target_entity_type=target_entity_type,
        value_property=value_property,
    )


def import_events(
    app_name: str,
    path: str,
    channel_name: Optional[str] = None,
    storage: Optional[Storage] = None,
    format: Optional[str] = None,
) -> int:
    """Read events from ``path`` into the store; returns the count.

    Invalid records raise ValueError with the record's position (the
    reference fails the whole Spark job on a malformed line). Parquet
    files with a pure interaction shape take the columnar bulk path.
    """
    st = storage or get_storage()
    app_id, channel_id = resolve_app(app_name, channel_name, st)
    if _fmt(path, format) == "parquet":
        _require_pyarrow()
        import pyarrow.parquet as pq

        table = pq.read_table(path)  # read ONCE; shared by both paths
        imported = _import_parquet_columnar(table, st, app_id, channel_id)
        if imported is not None:
            return imported
        raw = enumerate(_table_to_dicts(table), 1)
    else:
        def _jsonl():
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if line:
                        yield lineno, line  # parsed inside the try below
        raw = _jsonl()
    events = []
    for pos, d in raw:
        try:
            event = Event.from_dict(d if isinstance(d, dict) else json.loads(d))
            validate_event(event)
        except Exception as e:
            raise ValueError(f"{path}:{pos}: invalid event: {e}") from e
        events.append(event)
    # validate-all-then-write: a malformed record aborts before any
    # insert, and transactional backends commit the batch once
    st.events().insert_batch(events, app_id, channel_id)
    return len(events)
