"""SQLite storage backend — the durable single-node tier.

Copy of ``predictionio_tpu/data/backends/sqlite.py``: the same schema
and the same microsecond time encoding (``_us``), so a database file
written by one package is read by the other. What follows is the JAX
module's account.

Fills the role of the reference's HBase (EVENTDATA) + Elasticsearch
(METADATA) pair for deployments that want real transactional
persistence and multi-process safety without external services:

  - events   -> one indexed ``events`` table; (app_id, channel_id)
                "tables" are rows gated by an ``event_tables`` registry
                so init/remove keep the reference's create/drop-table
                semantics (ref: hbase/HBEventsUtil.scala:51, the
                ``events_<appId>[_<channelId>]`` table naming)
  - metadata -> JSON documents with key columns
                (ref: elasticsearch/ES* DAOs — JSON docs per index)
  - models   -> blobs (ref: localfs/LocalFSModels.scala:29)

Concurrency: WAL journal mode; every connection is per-process, every
mutation is one transaction — unlike the localfs backend's
flock-and-snapshot dance, concurrent CLI + server processes get real
ACID behavior.

Config (ref: env-var contract, conf/pio-env.sh.template:36-56):
  PIO_STORAGE_SOURCES_<N>_TYPE=sqlite
  PIO_STORAGE_SOURCES_<N>_PATH=/path/to/dir-or-file.db
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import sqlite3
import threading
from typing import Any, Dict, List, Optional

from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Model,
    dict_to_record,
    record_to_dict,
)
from predictionio_torch.data import storage as S

UTC = _dt.timezone.utc

_SCHEMA = """
CREATE TABLE IF NOT EXISTS event_tables (
    app_id INTEGER NOT NULL,
    channel_id INTEGER NOT NULL,
    PRIMARY KEY (app_id, channel_id)
);
CREATE TABLE IF NOT EXISTS events (
    event_id TEXT NOT NULL,
    app_id INTEGER NOT NULL,
    channel_id INTEGER NOT NULL,
    event TEXT NOT NULL,
    entity_type TEXT NOT NULL,
    entity_id TEXT NOT NULL,
    target_entity_type TEXT,
    target_entity_id TEXT,
    event_time_us INTEGER NOT NULL,
    creation_time_us INTEGER NOT NULL,
    payload TEXT NOT NULL,
    PRIMARY KEY (app_id, channel_id, event_id)
);
CREATE INDEX IF NOT EXISTS idx_events_scan
    ON events (app_id, channel_id, event_time_us);
CREATE INDEX IF NOT EXISTS idx_events_entity
    ON events (app_id, channel_id, entity_type, entity_id, event_time_us);
CREATE TABLE IF NOT EXISTS apps (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE,
    payload TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS access_keys (
    key TEXT PRIMARY KEY,
    appid INTEGER NOT NULL,
    payload TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS channels (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    appid INTEGER NOT NULL,
    name TEXT NOT NULL,
    payload TEXT NOT NULL,
    UNIQUE (appid, name)
);
CREATE TABLE IF NOT EXISTS engine_manifests (
    id TEXT NOT NULL,
    version TEXT NOT NULL,
    payload TEXT NOT NULL,
    PRIMARY KEY (id, version)
);
CREATE TABLE IF NOT EXISTS engine_instances (
    id TEXT PRIMARY KEY,
    status TEXT NOT NULL,
    engine_id TEXT NOT NULL,
    engine_version TEXT NOT NULL,
    engine_variant TEXT NOT NULL,
    start_time TEXT NOT NULL,
    payload TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS evaluation_instances (
    id TEXT PRIMARY KEY,
    status TEXT NOT NULL,
    start_time TEXT NOT NULL,
    payload TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS models (
    id TEXT PRIMARY KEY,
    blob BLOB NOT NULL
);
"""

_NO_CHANNEL = -1  # SQL PKs cannot contain NULL; -1 encodes "default channel"


def _us(t: _dt.datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return int(t.timestamp() * 1_000_000)


def _chan(channel_id: Optional[int]) -> int:
    return _NO_CHANNEL if channel_id is None else int(channel_id)


class _Db:
    """One connection per process, serialized by a lock (sqlite handles
    cross-process locking itself)."""

    def __init__(self, path: str):
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        with self._lock, self._conn:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.executescript(_SCHEMA)

    def execute(self, sql: str, params=()) -> sqlite3.Cursor:
        with self._lock, self._conn:
            return self._conn.execute(sql, params)

    def transaction(self):
        """Context manager: lock + one BEGIN..COMMIT for multi-statement
        atomicity; yields the connection."""
        import contextlib

        @contextlib.contextmanager
        def _tx():
            with self._lock, self._conn:
                yield self._conn

        return _tx()

    def query(self, sql: str, params=()) -> List[sqlite3.Row]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


class SqliteEventStore(S.EventStore):
    def __init__(self, db: _Db):
        self._db = db

    def _check_table(self, app_id: int, channel_id: Optional[int]) -> None:
        rows = self._db.query(
            "SELECT 1 FROM event_tables WHERE app_id=? AND channel_id=?",
            (int(app_id), _chan(channel_id)),
        )
        if not rows:
            raise S.StorageError(
                f"event table for app {app_id} channel {channel_id} not initialized"
            )

    def init(self, app_id, channel_id=None):
        self._db.execute(
            "INSERT OR IGNORE INTO event_tables (app_id, channel_id) VALUES (?, ?)",
            (int(app_id), _chan(channel_id)),
        )

    def remove(self, app_id, channel_id=None):
        self._db.execute(
            "DELETE FROM events WHERE app_id=? AND channel_id=?",
            (int(app_id), _chan(channel_id)),
        )
        self._db.execute(
            "DELETE FROM event_tables WHERE app_id=? AND channel_id=?",
            (int(app_id), _chan(channel_id)),
        )

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        self._check_table(app_id, channel_id)
        e = event if event.event_id else event.with_id()
        self._db.execute(
            "INSERT OR REPLACE INTO events (event_id, app_id, channel_id, event,"
            " entity_type, entity_id, target_entity_type, target_entity_id,"
            " event_time_us, creation_time_us, payload)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (
                e.event_id,
                int(app_id),
                _chan(channel_id),
                e.event,
                e.entity_type,
                e.entity_id,
                e.target_entity_type,
                e.target_entity_id,
                _us(e.event_time),
                _us(e.creation_time),
                json.dumps(e.to_dict(api_format=True)),
            ),
        )
        return e.event_id

    def _insert_many(self, events, app_id, channel_id=None):
        """One transaction for the whole batch (ref: PEvents.write:124);
        ``insert_batch`` moves the ingest clock once it commits."""
        self._check_table(app_id, channel_id)
        stamped = [e if e.event_id else e.with_id() for e in events]
        with self._db.transaction() as conn:
            conn.executemany(
                "INSERT OR REPLACE INTO events (event_id, app_id, channel_id, event,"
                " entity_type, entity_id, target_entity_type, target_entity_id,"
                " event_time_us, creation_time_us, payload)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                [
                    (
                        e.event_id, int(app_id), _chan(channel_id), e.event,
                        e.entity_type, e.entity_id, e.target_entity_type,
                        e.target_entity_id, _us(e.event_time),
                        _us(e.creation_time),
                        json.dumps(e.to_dict(api_format=True)),
                    )
                    for e in stamped
                ],
            )
        return [e.event_id for e in stamped]

    def _row_to_event(self, row: sqlite3.Row) -> Event:
        return Event.from_dict(json.loads(row["payload"]))

    def get(self, event_id, app_id, channel_id=None):
        self._check_table(app_id, channel_id)
        rows = self._db.query(
            "SELECT payload FROM events WHERE app_id=? AND channel_id=? AND event_id=?",
            (int(app_id), _chan(channel_id), event_id),
        )
        return self._row_to_event(rows[0]) if rows else None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        self._check_table(app_id, channel_id)
        cur = self._db.execute(
            "DELETE FROM events WHERE app_id=? AND channel_id=? AND event_id=?",
            (int(app_id), _chan(channel_id), event_id),
        )
        return cur.rowcount > 0

    def find(
        self,
        app_id,
        channel_id=None,
        start_time=None,
        until_time=None,
        entity_type=None,
        entity_id=None,
        event_names=None,
        target_entity_type=S.UNSET,
        target_entity_id=S.UNSET,
        limit=None,
        reversed=False,
    ) -> List[Event]:
        self._check_table(app_id, channel_id)
        sql = "SELECT payload FROM events WHERE app_id=? AND channel_id=?"
        params: List[Any] = [int(app_id), _chan(channel_id)]
        if start_time is not None:  # half-open [start, until)
            sql += " AND event_time_us >= ?"
            params.append(_us(start_time))
        if until_time is not None:
            sql += " AND event_time_us < ?"
            params.append(_us(until_time))
        if entity_type is not None:
            sql += " AND entity_type = ?"
            params.append(entity_type)
        if entity_id is not None:
            sql += " AND entity_id = ?"
            params.append(entity_id)
        if event_names is not None:
            sql += f" AND event IN ({','.join('?' * len(event_names))})"
            params.extend(event_names)
        if target_entity_type is not S.UNSET:
            if target_entity_type is None:
                sql += " AND target_entity_type IS NULL"
            else:
                sql += " AND target_entity_type = ?"
                params.append(target_entity_type)
        if target_entity_id is not S.UNSET:
            if target_entity_id is None:
                sql += " AND target_entity_id IS NULL"
            else:
                sql += " AND target_entity_id = ?"
                params.append(target_entity_id)
        direction = "DESC" if reversed else "ASC"
        sql += f" ORDER BY event_time_us {direction}, creation_time_us {direction}"
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        return [self._row_to_event(r) for r in self._db.query(sql, params)]


class SqliteAppsRepo(S.AppsRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, name, description=None) -> App:
        try:
            with self._db.transaction() as conn:
                cur = conn.execute(
                    "INSERT INTO apps (name, payload) VALUES (?, ?)", (name, "{}")
                )
                app = App(id=cur.lastrowid, name=name, description=description)
                conn.execute(
                    "UPDATE apps SET payload=? WHERE id=?",
                    (json.dumps(record_to_dict(app)), app.id),
                )
        except sqlite3.IntegrityError:
            raise S.StorageError(f"app name {name!r} already exists")
        return app

    def _row(self, row) -> App:
        return dict_to_record(App, json.loads(row["payload"]))

    def get(self, app_id):
        rows = self._db.query("SELECT payload FROM apps WHERE id=?", (int(app_id),))
        return self._row(rows[0]) if rows else None

    def get_by_name(self, name):
        rows = self._db.query("SELECT payload FROM apps WHERE name=?", (name,))
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [self._row(r) for r in self._db.query("SELECT payload FROM apps ORDER BY id")]

    def update(self, app):
        self._db.execute(
            "UPDATE apps SET name=?, payload=? WHERE id=?",
            (app.name, json.dumps(record_to_dict(app)), app.id),
        )

    def put(self, app):
        # replication upsert with the owner-assigned id (update above is
        # UPDATE-only and would silently no-op on a replica missing the
        # row — S.AppsRepo.put contract)
        self._db.execute(
            "INSERT OR REPLACE INTO apps (id, name, payload) VALUES (?, ?, ?)",
            (int(app.id), app.name, json.dumps(record_to_dict(app))),
        )

    def delete(self, app_id):
        self._db.execute("DELETE FROM apps WHERE id=?", (int(app_id),))


class SqliteAccessKeysRepo(S.AccessKeysRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, access_key: AccessKey) -> str:
        self._db.execute(
            "INSERT OR REPLACE INTO access_keys (key, appid, payload) VALUES (?, ?, ?)",
            (access_key.key, access_key.appid,
             json.dumps(record_to_dict(access_key))),
        )
        return access_key.key

    def _row(self, row) -> AccessKey:
        return dict_to_record(AccessKey, json.loads(row["payload"]))

    def get(self, key):
        rows = self._db.query("SELECT payload FROM access_keys WHERE key=?", (key,))
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [self._row(r) for r in self._db.query("SELECT payload FROM access_keys")]

    def get_by_app_id(self, app_id):
        return [
            self._row(r)
            for r in self._db.query(
                "SELECT payload FROM access_keys WHERE appid=?", (int(app_id),)
            )
        ]

    def update(self, access_key):
        self.insert(access_key)

    def delete(self, key):
        self._db.execute("DELETE FROM access_keys WHERE key=?", (key,))


class SqliteChannelsRepo(S.ChannelsRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, name, app_id) -> Channel:
        if not Channel.is_valid_name(name):
            raise S.StorageError(
                f"invalid channel name {name!r} (must match [a-zA-Z0-9-]{{1,16}})"
            )
        try:
            with self._db.transaction() as conn:
                cur = conn.execute(
                    "INSERT INTO channels (appid, name, payload) VALUES (?, ?, ?)",
                    (int(app_id), name, "{}"),
                )
                ch = Channel(id=cur.lastrowid, name=name, appid=int(app_id))
                conn.execute(
                    "UPDATE channels SET payload=? WHERE id=?",
                    (json.dumps(record_to_dict(ch)), ch.id),
                )
        except sqlite3.IntegrityError:
            raise S.StorageError(f"channel {name!r} already exists for app {app_id}")
        return ch

    def _row(self, row) -> Channel:
        return dict_to_record(Channel, json.loads(row["payload"]))

    def get(self, channel_id):
        rows = self._db.query("SELECT payload FROM channels WHERE id=?", (int(channel_id),))
        return self._row(rows[0]) if rows else None

    def get_by_app_id(self, app_id):
        return [
            self._row(r)
            for r in self._db.query(
                "SELECT payload FROM channels WHERE appid=? ORDER BY id", (int(app_id),)
            )
        ]

    def delete(self, channel_id):
        self._db.execute("DELETE FROM channels WHERE id=?", (int(channel_id),))

    def put(self, channel):
        # replication upsert with the owner-assigned id (S.ChannelsRepo.put)
        self._db.execute(
            "INSERT OR REPLACE INTO channels (id, appid, name, payload)"
            " VALUES (?, ?, ?, ?)",
            (int(channel.id), int(channel.appid), channel.name,
             json.dumps(record_to_dict(channel))),
        )


class SqliteEngineManifestsRepo(S.EngineManifestsRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, manifest: EngineManifest) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO engine_manifests (id, version, payload) VALUES (?, ?, ?)",
            (manifest.id, manifest.version, json.dumps(record_to_dict(manifest))),
        )

    def _row(self, row) -> EngineManifest:
        return dict_to_record(EngineManifest, json.loads(row["payload"]))

    def get(self, id, version):
        rows = self._db.query(
            "SELECT payload FROM engine_manifests WHERE id=? AND version=?",
            (id, version),
        )
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [self._row(r) for r in self._db.query("SELECT payload FROM engine_manifests")]

    def update(self, manifest):
        self.insert(manifest)

    def delete(self, id, version):
        self._db.execute(
            "DELETE FROM engine_manifests WHERE id=? AND version=?", (id, version)
        )


class SqliteEngineInstancesRepo(S.EngineInstancesRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, instance: EngineInstance) -> str:
        self._db.execute(
            "INSERT OR REPLACE INTO engine_instances"
            " (id, status, engine_id, engine_version, engine_variant, start_time, payload)"
            " VALUES (?, ?, ?, ?, ?, ?, ?)",
            (
                instance.id, instance.status, instance.engine_id,
                instance.engine_version, instance.engine_variant,
                instance.start_time.astimezone(UTC).isoformat(),
                json.dumps(record_to_dict(instance)),
            ),
        )
        return instance.id

    def _row(self, row) -> EngineInstance:
        return dict_to_record(EngineInstance, json.loads(row["payload"]))

    def get(self, id):
        rows = self._db.query("SELECT payload FROM engine_instances WHERE id=?", (id,))
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [self._row(r) for r in self._db.query("SELECT payload FROM engine_instances")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self._db.query(
            "SELECT payload FROM engine_instances WHERE status='COMPLETED'"
            " AND engine_id=? AND engine_version=? AND engine_variant=?"
            " ORDER BY start_time DESC",
            (engine_id, engine_version, engine_variant),
        )
        return [self._row(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance):
        self.insert(instance)

    def delete(self, id):
        self._db.execute("DELETE FROM engine_instances WHERE id=?", (id,))


class SqliteEvaluationInstancesRepo(S.EvaluationInstancesRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, instance: EvaluationInstance) -> str:
        self._db.execute(
            "INSERT OR REPLACE INTO evaluation_instances (id, status, start_time, payload)"
            " VALUES (?, ?, ?, ?)",
            (
                instance.id, instance.status,
                instance.start_time.astimezone(UTC).isoformat(),
                json.dumps(record_to_dict(instance)),
            ),
        )
        return instance.id

    def _row(self, row) -> EvaluationInstance:
        return dict_to_record(EvaluationInstance, json.loads(row["payload"]))

    def get(self, id):
        rows = self._db.query("SELECT payload FROM evaluation_instances WHERE id=?", (id,))
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [
            self._row(r) for r in self._db.query("SELECT payload FROM evaluation_instances")
        ]

    def get_completed(self):
        rows = self._db.query(
            "SELECT payload FROM evaluation_instances WHERE status='EVALCOMPLETED'"
            " ORDER BY start_time DESC"
        )
        return [self._row(r) for r in rows]

    def update(self, instance):
        self.insert(instance)

    def delete(self, id):
        self._db.execute("DELETE FROM evaluation_instances WHERE id=?", (id,))


class SqliteModelsRepo(S.ModelsRepo):
    def __init__(self, db: _Db):
        self._db = db

    def insert(self, model: Model) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO models (id, blob) VALUES (?, ?)",
            (model.id, model.models),
        )

    def get(self, id) -> Optional[Model]:
        rows = self._db.query("SELECT id, blob FROM models WHERE id=?", (id,))
        if not rows:
            return None
        return Model(id=rows[0]["id"], models=rows[0]["blob"])

    def size(self, id) -> Optional[int]:
        # length() in SQL — the blob never crosses into Python (the
        # OOM preflight's cheap question)
        rows = self._db.query(
            "SELECT length(blob) AS n FROM models WHERE id=?", (id,))
        return None if not rows else int(rows[0]["n"])

    def delete(self, id):
        self._db.execute("DELETE FROM models WHERE id=?", (id,))

    def list(self):
        return S.blob_inventory(
            (r["id"], r["blob"])
            for r in self._db.query("SELECT id, blob FROM models ORDER BY id"))


class SqliteStorageClient(S.StorageClient):
    """ref: the per-backend StorageClient contract (Storage.scala:151-166)."""

    def __init__(self, config: Dict[str, str]):
        super().__init__(config)
        path = config.get("PATH", "pio.db")
        if not path.endswith(".db") and (os.path.isdir(path) or "." not in os.path.basename(path)):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "pio.db")
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
        self._db = _Db(path)
        self._events = SqliteEventStore(self._db)
        self._apps = SqliteAppsRepo(self._db)
        self._access_keys = SqliteAccessKeysRepo(self._db)
        self._channels = SqliteChannelsRepo(self._db)
        self._manifests = SqliteEngineManifestsRepo(self._db)
        self._engine_instances = SqliteEngineInstancesRepo(self._db)
        self._evaluation_instances = SqliteEvaluationInstancesRepo(self._db)
        self._models = SqliteModelsRepo(self._db)

    def events(self) -> S.EventStore:
        return self._events

    def apps(self) -> S.AppsRepo:
        return self._apps

    def access_keys(self) -> S.AccessKeysRepo:
        return self._access_keys

    def channels(self) -> S.ChannelsRepo:
        return self._channels

    def engine_manifests(self) -> S.EngineManifestsRepo:
        return self._manifests

    def engine_instances(self) -> S.EngineInstancesRepo:
        return self._engine_instances

    def evaluation_instances(self) -> S.EvaluationInstancesRepo:
        return self._evaluation_instances

    def models(self) -> S.ModelsRepo:
        return self._models

    def health_check(self) -> bool:
        """A real round-trip, not the base class's constant True: a
        closed/corrupted database file must turn /readyz and `pio
        status` red, and only a live query notices."""
        self._db.query("SELECT 1")
        return True

    def close(self) -> None:
        self._db.close()


S.register_backend("sqlite", SqliteStorageClient)
