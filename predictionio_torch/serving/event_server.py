"""The Event Server: REST event collection API, default port 7070.

Counterpart of ``predictionio_tpu/serving/event_server.py``, with the
same routes, status codes and bodies (ref:
data/.../api/EventAPI.scala):

  - access-key auth on every data route: ``accessKey`` query param (or
    ``Authorization`` basic credentials), resolving to (appId,
    channelId); optional ``channel`` query param; failures are
    401 {"message": "Invalid accessKey."} / channel errors likewise
    (withAccessKey, EventAPI.scala:91-117)
  - ``POST /events.json`` — single event create -> 201 {"eventId": id};
    access keys may carry an allowed-event whitelist -> 403 on others
  - ``POST /batch/events.json`` — an array in, per-event statuses out
    (EventAPI.scala:252), through the native event log's JSON lane
    where the store has one
  - ``GET /events/<id>.json`` / ``DELETE /events/<id>.json`` — fetch /
    delete one event (EventAPI.scala:131)
  - ``GET /events.json`` — filtered query: startTime/untilTime (ISO),
    entityType/entityId, event (repeatable), targetEntityType/Id,
    limit (default 20, -1 = all), reversed (requires entityType+Id)
    (EventAPI.scala:209)
  - ``GET /`` — {"status": "alive"}; ``GET /stats.json`` — per-app op
    counters (EventAPI.scala:324); ``GET /healthz`` (serving/http.py)
  - ``POST /webhooks/<name>.json`` (JSON) and ``POST /webhooks/<name>``
    (form) via the connector registry; GET checks connector existence
    (EventAPI.scala:352-454)

Observability, as in the JAX server: an accepted single event moves
the ingest freshness clock (``perfacct.note_ingest``), a request
answered 500 names its error in its flight record, and ``main`` sets
up structured JSON logging (``obs/logging.py``); the shared routes
(``/readyz``, ``/metrics``, ``/admin/*``) come from serving/http.py.
An accepted single event is observed by the data plane
(``obs/dataobs.py``: counts, entities, schema, payload bytes); the
bulk lanes observe inside their storage writers. The server touches no
device and imports no torch.
"""

from __future__ import annotations

import base64
import datetime as _dt
import json
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from predictionio_torch.data.backends.eventlog import (_ROW_ERRORS,
                                                       JsonRowsUnsupported)
from predictionio_torch.data.event import (Event, EventValidationError,
                                           _parse_time, validate_event)
from predictionio_torch.data.storage import (UNSET, Storage, StorageError,
                                             get_storage)
from predictionio_torch.obs import dataobs, flight, perfacct
from predictionio_torch.obs import logging as obs_logging
from predictionio_torch.serving import webhooks as webhook_registry
from predictionio_torch.serving.http import (HTTPServerBase,
                                             JSONRequestHandler,
                                             install_drain_handler)
from predictionio_torch.serving.stats import Stats
from predictionio_torch.serving.webhooks import ConnectorError

log = logging.getLogger(__name__)

DEFAULT_PORT = 7070  # ref: EventAPI.scala:494


class AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclass
class AuthData:
    """ref: EventAPI.scala AuthData(appId, channelId, events)."""

    app_id: int
    channel_id: Optional[int]
    events: list


class EventServerCore:
    """Transport-independent request handling (also used by tests)."""

    def __init__(self, storage: Optional[Storage] = None,
                 stats: Optional[Stats] = None):
        self.storage = storage or get_storage()
        self.stats = stats or Stats()

    # -- auth ---------------------------------------------------------------
    def authenticate(self, access_key: Optional[str],
                     channel_name: Optional[str]) -> AuthData:
        """ref: withAccessKey (EventAPI.scala:91)."""
        if not access_key:
            raise AuthError(401, "Missing accessKey.")
        key = self.storage.access_keys().get(access_key)
        if key is None:
            raise AuthError(401, "Invalid accessKey.")
        channel_id = None
        if channel_name is not None:
            channels = self.storage.channels().get_by_app_id(key.appid)
            ch = next((c for c in channels if c.name == channel_name), None)
            if ch is None:
                raise AuthError(400, "Invalid channel.")
            channel_id = ch.id
        return AuthData(app_id=key.appid, channel_id=channel_id,
                        events=list(key.events))

    # -- event CRUD ---------------------------------------------------------
    def create_event(self, auth: AuthData, payload: dict,
                     payload_bytes: Optional[int] = None) -> Tuple[int, dict]:
        if not isinstance(payload, dict):
            self.stats.update(auth.app_id, 400, "", "")
            return 400, {"message": "event must be a JSON object"}
        try:
            event = Event.from_dict(payload)
            validate_event(event)
        except (EventValidationError, ValueError, TypeError,
                AttributeError) as e:
            # bad field types / unparseable times are client errors too
            self.stats.update(auth.app_id, 400, payload.get("event", ""),
                              payload.get("entityType", ""))
            return 400, {"message": str(e)}
        if auth.events and event.event not in auth.events:
            # per-key event whitelist (ref: AccessKeys events field)
            self.stats.update(auth.app_id, 403, event.event,
                              event.entity_type)
            return 403, {"message": f"{event.event} events are not allowed"}
        try:
            event_id = self.storage.events().insert(event, auth.app_id,
                                                    auth.channel_id)
        except StorageError as e:
            return 500, {"message": str(e)}
        self.stats.update(auth.app_id, 201, event.event, event.entity_type)
        # freshness clock (obs/perfacct.py): the single-event lane; the
        # bulk lanes note inside their storage writers
        perfacct.note_ingest()
        # data plane (obs/dataobs.py): the 201 lane observes at full
        # fidelity (count, entities, schema, payload bytes); the storage
        # insert below the server stays observation-off
        dataobs.DATAOBS.observe_event(auth.app_id, event,
                                      payload_bytes=payload_bytes)
        return 201, {"eventId": event_id}

    def create_events_batch(self, auth: AuthData,
                            raw_body: bytes) -> Tuple[int, Any]:
        """``POST /batch/events.json`` (ref: EventAPI.scala:252): a JSON
        array of events in, an array of per-event statuses out (201 with
        the eventId, or 400 with the validation message — one bad event
        never fails its batchmates).

        The native lane hands the RAW request bytes to the event log
        (``EventLogEventStore.insert_json_batch``): parse, validation,
        wire packing and append in one GIL-released call, with no
        per-row Python objects. It engages when the store has it and
        the access key has no event whitelist (a whitelist needs a
        per-event allow/deny before the insert). Everything else, and
        payload shapes the native parser declines
        (``JsonRowsUnsupported``), takes the per-row lane below. No
        50-event cap as in the reference
        (MaxNumberOfEventsPerBatchRequest): large batches are the point
        of the native lane."""
        store = self.storage.events()
        native = getattr(store, "insert_json_batch", None)
        if native is not None and not auth.events:
            try:
                ids, codes, names, etypes = native(
                    raw_body, auth.app_id, auth.channel_id, strict=False)
            except JsonRowsUnsupported:
                pass  # the per-row lane below accepts more shapes
            except ValueError as e:
                return 400, {"message": str(e)}  # malformed body
            except StorageError as e:
                # an append I/O failure is a SERVER fault: a 400 would
                # make SDKs drop the events as permanently bad instead
                # of retrying
                return 500, {"message": str(e)}
            else:
                results = []
                for eid, code, name, etype in zip(ids, codes, names, etypes):
                    if code == 0:
                        results.append({"status": 201, "eventId": eid})
                        self.stats.update(auth.app_id, 201, name, etype)
                    else:
                        results.append({
                            "status": 400,
                            "message": _ROW_ERRORS.get(
                                code, f"validation error {code}"),
                        })
                        self.stats.update(auth.app_id, 400, name, etype)
                return 200, results
        try:
            payload = json.loads(raw_body)
        except json.JSONDecodeError as e:
            return 400, {"message": f"invalid JSON: {e}"}
        if not isinstance(payload, list):
            return 400, {"message": "batch events must be a JSON array"}
        results = []
        for item in payload:
            status, body = self.create_event(auth, item)
            entry = {"status": status}
            entry.update(body)
            results.append(entry)
        return 200, results

    def get_event(self, auth: AuthData, event_id: str) -> Tuple[int, dict]:
        event = self.storage.events().get(event_id, auth.app_id,
                                          auth.channel_id)
        if event is None:
            return 404, {"message": "Not Found"}
        return 200, event.to_dict(api_format=False)

    def delete_event(self, auth: AuthData, event_id: str) -> Tuple[int, dict]:
        found = self.storage.events().delete(event_id, auth.app_id,
                                             auth.channel_id)
        if not found:
            return 404, {"message": "Not Found"}
        return 200, {"message": "Found"}

    def query_events(self, auth: AuthData,
                     params: Dict[str, list]) -> Tuple[int, Any]:
        """ref: GET /events.json (EventAPI.scala:209)."""

        def one(name, default=None):
            vals = params.get(name)
            return vals[0] if vals else default

        try:
            start_time = _parse_iso(one("startTime"))
            until_time = _parse_iso(one("untilTime"))
        except ValueError as e:
            return 400, {"message": str(e)}
        entity_type = one("entityType")
        entity_id = one("entityId")
        try:
            limit = int(one("limit", "20"))
        except ValueError:
            return 400, {"message": "limit must be an integer."}
        if limit == 0 or limit < -1:
            return 400, {"message": "limit must be -1 (all) or positive."}
        reversed_flag = one("reversed", "false").lower() == "true"
        if reversed_flag and not (entity_type and entity_id):
            return 400, {"message": "the reversed parameter can only be "
                                    "used with both entityType and "
                                    "entityId specified."}
        events = self.storage.events().find(
            auth.app_id, channel_id=auth.channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=params.get("event"),
            target_entity_type=one("targetEntityType", UNSET),
            target_entity_id=one("targetEntityId", UNSET),
            limit=None if limit == -1 else limit, reversed=reversed_flag)
        if not events:
            return 404, {"message": "Not Found"}
        return 200, [e.to_dict(api_format=False) for e in events]

    # -- webhooks -----------------------------------------------------------
    def webhook_json(self, auth: AuthData, name: str,
                     payload: dict) -> Tuple[int, dict]:
        try:
            connector = webhook_registry.json_connector(name)
        except KeyError:
            return 404, {"message": f"webhook connection for {name} is not "
                                    "supported."}
        try:
            event_json = connector.to_event_json(payload)
        except ConnectorError as e:
            return 400, {"message": str(e)}
        return self.create_event(auth, event_json)

    def webhook_form(self, auth: AuthData, name: str,
                     fields: Dict[str, str]) -> Tuple[int, dict]:
        try:
            connector = webhook_registry.form_connector(name)
        except KeyError:
            return 404, {"message": f"webhook connection for {name} is not "
                                    "supported."}
        try:
            event_json = connector.to_event_json(fields)
        except ConnectorError as e:
            return 400, {"message": str(e)}
        return self.create_event(auth, event_json)

    def webhook_exists(self, name: str, form: bool) -> Tuple[int, dict]:
        lookup = (webhook_registry.form_connector if form
                  else webhook_registry.json_connector)
        try:
            lookup(name)
        except KeyError:
            return 404, {"message": f"webhook connection for {name} is not "
                                    "supported."}
        return 200, {"message": "Ok"}


def _parse_iso(s: Optional[str]) -> Optional[_dt.datetime]:
    if s is None:
        return None
    try:
        return _parse_time(s)  # same parser as event bodies (data/event.py)
    except ValueError:
        raise ValueError(f"Invalid time string: {s}")


class _EventRequestHandler(JSONRequestHandler):
    server_version = "PIOEventServer/0.1"

    @property
    def core(self) -> EventServerCore:
        return self.server_ref.core

    def _auth(self, params) -> AuthData:
        access_key = (params.get("accessKey") or [None])[0]
        if not access_key:
            # Basic credentials with the key as username (ref:
            # withAccessKey also accepts HTTP credentials,
            # EventAPI.scala:91)
            header = self.headers.get("Authorization", "")
            if header.startswith("Basic "):
                try:
                    decoded = base64.b64decode(header[6:]).decode()
                    access_key = decoded.split(":", 1)[0]
                except (ValueError, UnicodeDecodeError) as e:
                    # a garbled header means "no credentials" (401
                    # follows); leave a trace for operators
                    log.warning("ignoring malformed Basic auth header: %s",
                                e)
        channel = (params.get("channel") or [None])[0]
        return self.core.authenticate(access_key, channel)

    def _dispatch(self, method: str) -> None:
        url = urlparse(self.path)
        path = url.path
        params = parse_qs(url.query)
        try:
            if path == "/" and method == "GET":
                self._send(200, {"status": "alive"})
                return
            if path == "/stats.json" and method == "GET":
                auth = self._auth(params)
                self._send(200, self.core.stats.report(auth.app_id))
                return
            if path == "/events.json":
                auth = self._auth(params)
                if method == "POST":
                    body = self._read_body()
                    try:
                        payload = json.loads(body or b"{}")
                    except json.JSONDecodeError as e:
                        self._send(400, {"message": f"invalid JSON: {e}"})
                        return
                    self._send(*self.core.create_event(
                        auth, payload, payload_bytes=len(body)))
                elif method == "GET":
                    self._send(*self.core.query_events(auth, params))
                else:
                    self._send(405, {"message": "method not allowed"})
                return
            if path == "/batch/events.json":
                auth = self._auth(params)
                if method != "POST":
                    self._send(405, {"message": "method not allowed"})
                    return
                # RAW body bytes: the native lane parses them itself
                self._send(*self.core.create_events_batch(
                    auth, self._read_body()))
                return
            if path.startswith("/events/") and path.endswith(".json"):
                auth = self._auth(params)
                event_id = path[len("/events/"):-len(".json")]
                if method == "GET":
                    self._send(*self.core.get_event(auth, event_id))
                elif method == "DELETE":
                    self._send(*self.core.delete_event(auth, event_id))
                else:
                    self._send(405, {"message": "method not allowed"})
                return
            if path.startswith("/webhooks/"):
                name = path[len("/webhooks/"):]
                is_json = name.endswith(".json")
                if is_json:
                    name = name[:-len(".json")]
                auth = self._auth(params)
                if method == "GET":
                    self._send(*self.core.webhook_exists(name,
                                                         form=not is_json))
                    return
                if method != "POST":
                    self._send(405, {"message": "method not allowed"})
                    return
                if is_json:
                    try:
                        payload = self._read_json()
                    except json.JSONDecodeError as e:
                        self._send(400, {"message": f"invalid JSON: {e}"})
                        return
                    self._send(*self.core.webhook_json(auth, name, payload))
                else:
                    fields = {k: v[0] for k, v in parse_qs(
                        self._read_body().decode(),
                        keep_blank_values=True).items()}
                    self._send(*self.core.webhook_form(auth, name, fields))
                return
            self._send(404, {"message": "Not Found"})
        except AuthError as e:
            self._send(e.status, {"message": e.message})
        except Exception as e:  # noqa: BLE001 — answer 500, keep serving
            log.exception("event server error")
            flight.note_field("error", f"{type(e).__name__}: {e}")
            self._send(500, {"message": str(e)})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


class EventServer(HTTPServerBase):
    """ref: EventServer.createEventServer (EventAPI.scala:497)."""

    def __init__(self, storage: Optional[Storage] = None,
                 host: str = "0.0.0.0", port: int = DEFAULT_PORT,
                 stats: Optional[Stats] = None):
        self.core = EventServerCore(storage, stats)
        super().__init__(host, port, _EventRequestHandler)


def main(argv=None) -> None:
    """Standalone runner (ref: EventServer Run main, EventAPI.scala:519)."""
    import argparse

    parser = argparse.ArgumentParser(description="PredictionIO event server")
    parser.add_argument("--ip", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = parser.parse_args(argv)
    # structured JSON log lines with trace-id correlation (obs/logging)
    obs_logging.setup(level=logging.INFO)
    server = EventServer(host=args.ip, port=args.port)
    # SIGTERM closes the listening socket and drains in-flight events
    # before exit: a kill mid-request must not drop the connection
    install_drain_handler(server)
    server.serve_forever()


if __name__ == "__main__":
    main()
