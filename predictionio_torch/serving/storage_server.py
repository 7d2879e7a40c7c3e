"""The Storage Server: DAO-level REST storage service, default port 7077.

Copy of ``predictionio_tpu/serving/storage_server.py`` on the port's
``serving/http.py``: the same routes, whitelist and bodies, so either
package's ``rest`` client talks to it. What follows is the JAX
module's account.

The reference delegates scale-out storage to external network services —
HBase for events (client RPC, data/.../storage/hbase/StorageClient.scala),
Elasticsearch for metadata (transport port 9300,
elasticsearch/StorageClient.scala:42), HDFS for model blobs
(hdfs/HDFSModels.scala:28). This server is the framework's equivalent
network tier: it exposes the *storage DAO contracts* (EventStore, the
metadata repos, ModelsRepo) over HTTP, backed by whatever local backend
the server process is configured with (eventlog/sqlite/localfs/memory).
N serving hosts + M trainer hosts point a ``rest``-type storage source
(data/backends/rest.py) at one storage server and share one logical
METADATA / EVENTDATA / MODELDATA — train on host A, deploy on host B.

Routes:
  - ``GET  /``                            {"status": "alive"}
  - ``POST /storage/events/<method>``     init/remove/insert/insert_batch/
                                          get/delete/compact — JSON body,
                                          DB-format event dicts
  - ``POST /storage/events/find``         filter body -> NDJSON stream
                                          (one DB-format event per line)
  - ``POST /storage/events/find_columnar``filter body -> {"scan_id", "bytes"}:
                                          the result npz is spooled to DISK
                                          (never a second in-memory copy) and
                                          fetched separately — see next route
  - ``GET  /storage/events/scan/<id>?offset=N`` stream the spooled npz from
                                          byte N (clients resume after a
                                          dropped connection); DELETE frees
                                          it (a TTL reaps abandoned scans)
  - ``POST /storage/meta/<repo>/<method>``whitelisted repo RPC (args array,
                                          records as dicts)
  - ``PUT/GET/DELETE /storage/models/<id>`` raw model blobs

Optional shared-secret auth: configure ``AUTH_KEY`` on the server and the
client; every request must carry it in ``X-PIO-Storage-Key`` (the
reference's storage tiers sit on a trusted network; the key guards
against accidental cross-environment writes, not adversaries).
"""

from __future__ import annotations

import collections
import datetime as _dt
import json
import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from predictionio_torch.data.event import Event
from predictionio_torch.data import metadata as MD
from predictionio_torch.data.metadata import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Model,
)
from predictionio_torch.data.storage import (
    RowValidationError,
    Storage,
    StorageError,
    columns_to_npz_file,
    get_storage,
    npz_to_columns,
)
from predictionio_torch.serving.http import (HTTPServerBase,
                                           JSONRequestHandler,
                                           install_drain_handler)

log = logging.getLogger(__name__)

DEFAULT_PORT = 7077


class _ScanRegistry:
    """Disk-spooled bulk-scan results, fetched (and resumed) by id.

    A 20M-row columnar result is written ONCE to a spool file; N fetch
    requests stream byte ranges of it, so concurrent bulk readers cost
    disk, not resident memory, and a client whose connection dropped
    mid-transfer resumes from its last received byte instead of
    re-scanning. Abandoned scans (client crashed) are reaped after
    ``ttl`` seconds, checked on every registry access."""

    def __init__(self, ttl: float = 600.0):
        self._dir = tempfile.mkdtemp(prefix="pio_scans_")
        self._scans: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._ttl = ttl

    def create(self, write_fn) -> Dict[str, Any]:
        scan_id = uuid.uuid4().hex
        path = os.path.join(self._dir, scan_id + ".npz")
        with open(path, "wb") as f:
            write_fn(f)
        size = os.path.getsize(path)
        with self._lock:
            self._reap_locked()
            self._scans[scan_id] = {"path": path, "bytes": size,
                                    "created": time.monotonic()}
        return {"scan_id": scan_id, "bytes": size}

    def path_for(self, scan_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            self._reap_locked()
            scan = self._scans.get(scan_id)
            if scan is not None:
                # sliding TTL: a transfer making progress (resumed
                # range fetches) must never expire mid-download just
                # because the WHOLE transfer outlives the ttl
                scan["created"] = time.monotonic()
            return scan

    def release(self, scan_id: str) -> bool:
        with self._lock:
            scan = self._scans.pop(scan_id, None)
        if scan:
            try:
                os.remove(scan["path"])
            except FileNotFoundError:
                pass
        return scan is not None

    def live_count(self) -> int:
        """Spools currently held on disk (reaps expired ones first) —
        the observability hook a soak test needs to PROVE the TTL
        reaper fires instead of spool files accumulating forever."""
        with self._lock:
            self._reap_locked()
            return len(self._scans)

    def _reap_locked(self) -> None:
        now = time.monotonic()
        for sid in [s for s, v in self._scans.items()
                    if now - v["created"] > self._ttl]:
            scan = self._scans.pop(sid)
            try:
                os.remove(scan["path"])
            except FileNotFoundError:
                pass

    def close(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)

#: per-repo RPC whitelist: method -> (record-arg positions, result kind)
#: result kinds: "record" | "records" | "scalar"
_REPO_SPECS: Dict[str, Dict[str, Any]] = {
    "apps": {
        "record_cls": App,
        "methods": {
            "insert": ((), "record"),
            "put": ((0,), "scalar"),
            "get": ((), "record"),
            "get_by_name": ((), "record"),
            "get_all": ((), "records"),
            "update": ((0,), "scalar"),
            "delete": ((), "scalar"),
        },
    },
    "access_keys": {
        "record_cls": AccessKey,
        "methods": {
            "insert": ((0,), "scalar"),
            "put": ((0,), "scalar"),
            "get": ((), "record"),
            "get_all": ((), "records"),
            "get_by_app_id": ((), "records"),
            "update": ((0,), "scalar"),
            "delete": ((), "scalar"),
        },
    },
    "channels": {
        "record_cls": Channel,
        "methods": {
            "insert": ((), "record"),
            "put": ((0,), "scalar"),
            "get": ((), "record"),
            "get_by_app_id": ((), "records"),
            "delete": ((), "scalar"),
        },
    },
    "engine_manifests": {
        "record_cls": EngineManifest,
        "methods": {
            "insert": ((0,), "scalar"),
            "put": ((0,), "scalar"),
            "get": ((), "record"),
            "get_all": ((), "records"),
            "update": ((0,), "scalar"),
            "delete": ((), "scalar"),
        },
    },
    "engine_instances": {
        "record_cls": EngineInstance,
        "methods": {
            "insert": ((0,), "scalar"),
            "put": ((0,), "scalar"),
            "get": ((), "record"),
            "get_all": ((), "records"),
            "get_latest_completed": ((), "record"),
            "get_completed": ((), "records"),
            "update": ((0,), "scalar"),
            "delete": ((), "scalar"),
        },
    },
    "evaluation_instances": {
        "record_cls": EvaluationInstance,
        "methods": {
            "insert": ((0,), "scalar"),
            "put": ((0,), "scalar"),
            "get": ((), "record"),
            "get_all": ((), "records"),
            "get_completed": ((), "records"),
            "update": ((0,), "scalar"),
            "delete": ((), "scalar"),
        },
    },
}

_EVENT_METHODS = frozenset(
    {"init", "remove", "insert", "insert_batch", "get", "delete", "find",
     "find_columnar", "insert_columnar", "insert_json", "compact"}
)


def _encode_result(value: Any, kind: str) -> Any:
    if kind == "record":
        return None if value is None else MD.record_to_dict(value)
    if kind == "records":
        return [MD.record_to_dict(r) for r in value]
    return value


class StorageRequestHandler(JSONRequestHandler):
    """Dispatch /storage/* to the wrapped Storage's DAOs."""

    server_version = "PIOStorageServer/0.1"

    # -- auth ---------------------------------------------------------------
    def _authorized(self) -> bool:
        required = self.server_ref.auth_key
        if not required:
            return True
        return self.headers.get("X-PIO-Storage-Key") == required

    def _deny(self) -> None:
        self._send(401, {"message": "Invalid storage key."})

    # -- HTTP verbs ---------------------------------------------------------
    def _guarded(self, fn, *args):
        """Run a route handler, mapping storage/user errors to HTTP
        bodies (a backend failure must answer, not abort the socket —
        an aborted connection reads as a network outage client-side)."""
        try:
            return fn(*args)
        except StorageError as e:
            return self._send(400, {"message": str(e), "type": "StorageError"})
        except (KeyError, TypeError, ValueError) as e:
            return self._send(400, {"message": str(e), "type": type(e).__name__})
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            log.exception("storage server error on %s", self.path)
            return self._send(500, {"message": str(e), "type": type(e).__name__})

    def do_GET(self):
        if not self._authorized():
            return self._deny()
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(self.path)
        if parsed.path == "/":
            return self._send(200, {"status": "alive"})
        if parsed.path == "/storage/stats":
            # operator/test observability: per-request log of columnar
            # scans (rows served, shard asked for) — how a 2-host
            # sharded training read is PROVEN to fetch half the rows
            # each (the Spark-UI per-executor input-size role)
            return self._send(200, self.server_ref.scan_stats())
        if parsed.path in ("/storage/models", "/storage/models/"):
            # replica-reconciliation inventory (id/bytes/sha256 per
            # blob) — the HDFS block-report role for `pio storagerepair`
            return self._guarded(
                lambda: self._send(
                    200, {"models": self.server_ref.storage.models().list()}))
        if parsed.path.startswith("/storage/models/"):
            return self._guarded(self._get_model,
                                 parsed.path[len("/storage/models/"):])
        if parsed.path.startswith("/storage/events/scan/"):
            scan_id = parsed.path[len("/storage/events/scan/"):]
            q = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            return self._guarded(self._fetch_scan, scan_id,
                                 q.get("offset", "0"))
        return self._send(404, {"message": "not found"})

    def _fetch_scan(self, scan_id: str, offset_raw: str):
        offset = int(offset_raw)  # inside _guarded: bad input answers 400
        scan = self.server_ref.scans.path_for(scan_id)
        if scan is None:
            # expired/unknown (e.g. the server restarted mid-transfer):
            # the client re-prepares — a data-miss 404, not a bad route
            return self._send(404, {"message": "unknown scan",
                                    "missing": True})
        size = scan["bytes"]
        if not 0 <= offset <= size:
            return self._send(400, {"message": f"bad offset {offset}"})
        # open BEFORE the status line goes out: a concurrent release or
        # TTL reap unlinking the spool must answer a clean retryable
        # 404, never a second response corrupting the declared body
        try:
            f = open(scan["path"], "rb")
        except FileNotFoundError:
            return self._send(404, {"message": "unknown scan",
                                    "missing": True})
        # stream the spool file in bounded chunks: no full-blob buffer
        self._body_consumed = True  # GET: nothing to drain
        with f:
            f.seek(offset)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(size - offset))
            self.end_headers()
            try:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
            except Exception:  # noqa: BLE001 — status line already sent
                # a mid-stream failure (disk error, dead socket) must
                # NOT bubble to _guarded: its 500 would land inside the
                # declared body as corrupted scan bytes. Drop the
                # connection — the client sees a short read and resumes
                # from its received offset.
                log.exception("scan stream aborted mid-transfer")
                self.close_connection = True

    def _get_model(self, model_id: str):
        model = self.server_ref.storage.models().get(model_id)
        if model is None:
            # "missing": a data miss on a live route, NOT an unknown
            # route — the rest client maps only this 404 form to None
            return self._send(404, {"message": "model not found",
                                    "missing": True})
        return self._send(200, model.models,
                          content_type="application/octet-stream")

    def do_PUT(self):
        if not self._authorized():
            return self._deny()
        if self.path.startswith("/storage/models/"):
            return self._guarded(self._put_model,
                                 self.path[len("/storage/models/"):])
        return self._send(404, {"message": "not found"})

    def _put_model(self, model_id: str):
        if not model_id:
            return self._send(400, {"message": "missing model id"})
        blob = self._read_body()
        self.server_ref.storage.models().insert(Model(id=model_id, models=blob))
        return self._send(200, {"id": model_id, "bytes": len(blob)})

    def do_DELETE(self):
        if not self._authorized():
            return self._deny()
        if self.path.startswith("/storage/models/"):
            return self._guarded(self._delete_model,
                                 self.path[len("/storage/models/"):])
        if self.path.startswith("/storage/events/scan/"):
            scan_id = self.path[len("/storage/events/scan/"):]
            self.server_ref.scans.release(scan_id)
            return self._send(200, {"ok": True})
        return self._send(404, {"message": "not found"})

    def _delete_model(self, model_id: str):
        self.server_ref.storage.models().delete(model_id)
        return self._send(200, {"id": model_id})

    def do_POST(self):
        if not self._authorized():
            return self._deny()
        from urllib.parse import urlparse

        parts = urlparse(self.path).path.strip("/").split("/")
        if len(parts) == 3 and parts[0] == "storage" and parts[1] == "events":
            return self._guarded(self._handle_events, parts[2])
        if len(parts) == 4 and parts[0] == "storage" and parts[1] == "meta":
            return self._guarded(self._handle_meta, parts[2], parts[3])
        return self._send(404, {"message": "not found"})

    # -- events -------------------------------------------------------------
    @staticmethod
    def _find_kwargs(body: Dict[str, Any]) -> Dict[str, Any]:
        """find/find_columnar filter params from the JSON body."""
        kwargs: Dict[str, Any] = {}
        for key in ("start_time", "until_time"):
            if body.get(key) is not None:
                kwargs[key] = _dt.datetime.fromisoformat(body[key])
        for key in ("entity_type", "entity_id"):
            if body.get(key) is not None:
                kwargs[key] = body[key]
        if body.get("event_names") is not None:
            kwargs["event_names"] = list(body["event_names"])
        # target filters: tri-state (absent | null | value) via *_set flags
        if body.get("target_entity_type_set"):
            kwargs["target_entity_type"] = body.get("target_entity_type")
        if body.get("target_entity_id_set"):
            kwargs["target_entity_id"] = body.get("target_entity_id")
        if body.get("limit") is not None:
            kwargs["limit"] = int(body["limit"])
        kwargs["reversed"] = bool(body.get("reversed", False))
        return kwargs

    def _handle_events(self, method: str):
        if method not in _EVENT_METHODS:
            return self._send(404, {"message": f"unknown events method {method!r}"})
        store = self.server_ref.storage.events()
        if method == "insert_json":
            # the native live lane over the wire: the RAW API-format
            # JSON array travels untouched from the event server's
            # socket to this server's local eventlog encoder — no
            # per-row Python objects on EITHER host. Answers
            # {"unsupported": true} when the local backend has no
            # native lane (or declines the payload shape) so the
            # client falls back to the per-row wire path.
            from urllib.parse import parse_qs, urlparse

            from predictionio_torch.data.backends.eventlog import (
                JsonRowsUnsupported,
            )

            q = {k: v[0] for k, v in
                 parse_qs(urlparse(self.path).query).items()}
            fast = getattr(store, "insert_json_batch", None)
            raw = self._read_body()
            if fast is None:
                return self._send(200, {"unsupported": True})
            try:
                ids, codes, names, etypes = fast(
                    raw, int(q["app_id"]),
                    int(q["channel_id"]) if q.get("channel_id") else None,
                    strict=q.get("strict", "1") == "1",
                )
            except JsonRowsUnsupported:
                return self._send(200, {"unsupported": True})
            except ValueError as e:
                return self._send(400, {"message": str(e),
                                        "type": "ValueError"})
            except RowValidationError as e:
                # strict=True row-validation failure: a PERMANENT
                # client-data error, not a retryable backend fault —
                # answer 400 with the row_error discriminator so the
                # rest client re-raises it under the same type; other
                # StorageErrors (lock contention, I/O) fall through to
                # _guarded WITHOUT the flag
                return self._send(400, {"message": str(e),
                                        "type": "StorageError",
                                        "row_error": True})
            return self._send(201, {"ids": ids, "codes": codes,
                                    "names": names, "etypes": etypes})
        if method == "insert_columnar":
            # binary npz body; scalar params ride in the query string
            # (percent-encoded UTF-8 — headers are latin-1-only). The
            # body is spooled to disk in chunks — a multi-GB bulk
            # ingest never holds the raw blob AND the decoded arrays
            # in memory at once.
            from urllib.parse import parse_qs, urlparse

            q = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
            length = int(self.headers.get("Content-Length", 0))
            self._body_consumed = True
            with tempfile.TemporaryFile() as spool:
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        raise StorageError("truncated insert_columnar body")
                    spool.write(chunk)
                    remaining -= len(chunk)
                spool.seek(0)
                cols = npz_to_columns(spool)
            n = store.insert_columnar(
                cols,
                int(q["app_id"]),
                int(q["channel_id"]) if q.get("channel_id") else None,
                entity_type=q["entity_type"],
                target_entity_type=q.get("target_entity_type"),
                value_property=q.get("value_property"),
            )
            return self._send(201, {"count": int(n)})
        body = self._read_json()
        app_id = int(body["app_id"])
        channel_id = body.get("channel_id")
        if channel_id is not None:
            channel_id = int(channel_id)

        if method == "init":
            store.init(app_id, channel_id)
            return self._send(200, {"ok": True})
        if method == "compact":
            return self._send(200, {"stats": store.compact(app_id, channel_id)})
        if method == "remove":
            store.remove(app_id, channel_id)
            return self._send(200, {"ok": True})
        if method == "insert":
            event = Event.from_dict(body["event"])
            event_id = store.insert(event, app_id, channel_id)
            return self._send(201, {"eventId": event_id})
        if method == "insert_batch":
            events = [Event.from_dict(d) for d in body["events"]]
            ids = store.insert_batch(events, app_id, channel_id)
            return self._send(201, {"eventIds": ids})
        if method == "get":
            event = store.get(body["event_id"], app_id, channel_id)
            if event is None:
                return self._send(404, {"message": "event not found",
                                        "missing": True})
            return self._send(200, {"event": event.to_dict(api_format=False)})
        if method == "delete":
            found = store.delete(body["event_id"], app_id, channel_id)
            return self._send(200, {"found": bool(found)})
        if method == "find_columnar":
            # bulk training read: dict-encoded columns spooled to disk
            # as one npz; the response hands back a scan id the client
            # streams (and resumes) via GET /storage/events/scan/<id>.
            # shard_index/shard_count (entity-hash read shards) filter
            # SERVER-side, so a sharded reader receives ~1/N the bytes.
            shard_index = body.get("shard_index")
            shard_count = body.get("shard_count")
            cols = store.find_columnar(
                app_id, channel_id=channel_id,
                value_property=body.get("value_property"),
                time_ordered=bool(body.get("time_ordered", True)),
                shard_index=int(shard_index) if shard_index is not None else None,
                shard_count=int(shard_count) if shard_count is not None else None,
                **self._find_kwargs(body),
            )
            self.server_ref.record_scan(
                app_id=app_id, rows=len(cols),
                shard_index=shard_index, shard_count=shard_count,
            )
            scan = self.server_ref.scans.create(
                lambda f: columns_to_npz_file(cols, f))
            del cols
            return self._send(200, scan)

        # find: NDJSON stream so 20M-event training reads never build one
        # giant JSON document on either side. Optional placement filter
        # (replicated sharded clients): only rows whose entity
        # hash-routes to the requested shards travel, with any row
        # limit applied AFTER the filter
        kwargs = self._find_kwargs(body)
        pshards = body.get("placement_shards")
        pcount = body.get("placement_count")
        if pshards is not None and pcount:
            from predictionio_torch.data.storage import stable_hash

            limit = kwargs.pop("limit", None)
            keep = {int(x) for x in pshards}
            events = [
                e for e in store.find(app_id, channel_id=channel_id, **kwargs)
                if stable_hash(e.entity_id) % int(pcount) in keep
            ]
            if limit is not None and limit >= 0:
                events = events[:limit]
        else:
            events = store.find(app_id, channel_id=channel_id, **kwargs)
        # genuinely chunked NDJSON: a 20M-event training read never
        # joins into one multi-GB buffer on the server side
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        buf: List[bytes] = []
        size = 0
        for e in events:
            line = json.dumps(
                e.to_dict(api_format=False), sort_keys=True
            ).encode() + b"\n"
            buf.append(line)
            size += len(line)
            if size >= 256 * 1024:
                self._write_chunk(b"".join(buf))
                buf, size = [], 0
        if buf:
            self._write_chunk(b"".join(buf))
        self.wfile.write(b"0\r\n\r\n")

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    # -- metadata RPC -------------------------------------------------------
    def _handle_meta(self, repo: str, method: str):
        spec = _REPO_SPECS.get(repo)
        if spec is None or method not in spec["methods"]:
            return self._send(404, {"message": f"unknown meta RPC {repo}/{method}"})
        record_args, result_kind = spec["methods"][method]
        body = self._read_json()
        args = list(body.get("args", []))
        for pos in record_args:
            if pos < len(args) and isinstance(args[pos], dict):
                args[pos] = MD.dict_to_record(spec["record_cls"], args[pos])
        target = getattr(self.server_ref.storage, repo)()
        result = getattr(target, method)(*args)
        return self._send(200, {"result": _encode_result(result, result_kind)})


class StorageServer(HTTPServerBase):
    """DAO-level storage service over a locally-configured Storage."""

    def __init__(
        self,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = DEFAULT_PORT,
        auth_key: Optional[str] = None,
        bind_retries: int = 3,
        scan_ttl: float = 600.0,
    ):
        self.storage = storage if storage is not None else get_storage()
        self.auth_key = auth_key
        self.scans = _ScanRegistry(ttl=scan_ttl)
        # bounded scan log (most recent entries) + lifetime totals: the
        # log is observability, not an audit trail — it must not grow
        # with request count on a long-running server
        self._scan_log: collections.deque = collections.deque(maxlen=1000)
        self._scan_totals = {"scans": 0, "rows": 0}
        self._scan_log_lock = threading.Lock()
        super().__init__(host, port, StorageRequestHandler, bind_retries=bind_retries)

    def record_scan(self, **entry: Any) -> None:
        with self._scan_log_lock:
            self._scan_log.append(entry)
            self._scan_totals["scans"] += 1
            self._scan_totals["rows"] += int(entry.get("rows", 0))

    def scan_stats(self) -> Dict[str, Any]:
        with self._scan_log_lock:
            scans = list(self._scan_log)
            totals = dict(self._scan_totals)
        return {
            "columnar_scans": scans,
            "columnar_scan_count": totals["scans"],
            "columnar_rows_served": totals["rows"],
            "live_scan_spools": self.scans.live_count(),
        }

    def stop(self) -> None:
        super().stop()
        self.scans.close()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="PredictionIO storage server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--auth-key", default=None,
                        help="require X-PIO-Storage-Key on every request")
    args = parser.parse_args(argv)
    server = StorageServer(host=args.host, port=args.port, auth_key=args.auth_key)
    # SIGTERM closes the listening socket and drains in-flight scans
    # before exit — a kill mid-request must not drop the connection
    install_drain_handler(server)
    print(f"Storage server listening on {args.host}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
