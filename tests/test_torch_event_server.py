"""The port's event server against the JAX package's, on the CPU.

The cases of ``tests/test_servers.py`` (alive and auth, CRUD,
validation and the whitelist, query filters, channels, stats, webhooks
in JSON and form, the review regressions, the batch route's per-row and
native lanes, a whitelist forcing the per-row lane, malformed bodies)
go as one request sequence through both packages' ``EventServerCore``,
on memory stores (the per-row lane) and on ``eventlog`` stores (the
native lane), and a subset goes over HTTP to both ``EventServer``s.
Status codes and bodies must be equal once generated event ids and
clock times are normalised, and each store must hold the same events
afterwards. Stores made by either package's ``app new`` serve the
other's event server, and a key another process adds is seen on the
next request.
"""

import base64
import datetime as dt
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from urllib.parse import urlencode

import pytest

from predictionio_tpu.data.metadata import AccessKey as JaxAccessKey
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.serving import event_server as jax_es
from predictionio_tpu.serving.stats import Stats as JaxStats
from predictionio_tpu.tools import commands as jax_commands
from predictionio_torch.data.backends import localfs
from predictionio_torch.data.metadata import AccessKey
from predictionio_torch.data.storage import Storage
from predictionio_torch.serving import event_server as es
from predictionio_torch.serving.stats import Stats
from predictionio_torch.tools import commands

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KEY = "K" * 64                 # no whitelist
VIEW_KEY = "V" * 64            # whitelist: view
RATE_KEY = "R" * 64            # whitelist: rate
KINDS = ("memory", "eventlog")

BATCH_ROWS = [
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 5.0},
     "eventTime": "2026-01-01T00:00:00.000Z"},
    {"event": "", "entityType": "user", "entityId": "u2"},      # invalid
    {"event": "view", "entityType": "user", "entityId": "u3",
     "eventTime": "2026-01-01T01:00:00.000Z"},
]

MAILCHIMP = {
    "type": "subscribe", "fired_at": "2026-03-26 21:35:57",
    "data[id]": "8a25ff1d98", "data[list_id]": "a6b5da1054",
    "data[email]": "api@mailchimp.com", "data[email_type]": "html",
    "data[merges][EMAIL]": "api@mailchimp.com",
    "data[merges][FNAME]": "MailChimp", "data[merges][LNAME]": "API",
    "data[merges][INTERESTS]": "Group1,Group2",
    "data[ip_opt]": "10.20.10.30", "data[ip_signup]": "10.20.10.30",
}


def _ev(name, uid, minute=0, **extra):
    return {"event": name, "entityType": "user", "entityId": uid,
            "eventTime": f"2026-01-02T00:{minute:02d}:00Z", **extra}


def _q(**params):
    return {k: v if isinstance(v, list) else [v] for k, v in params.items()}


# (operation, access key, channel, argument); "get"/"delete" take the
# index of an event id in the order the responses gave them
SEQUENCE = [
    # alive and auth
    ("create", None, None, _ev("rate", "u1")),
    ("create", "WRONG", None, _ev("rate", "u1")),
    # CRUD
    ("create", KEY, None, {
        "event": "rate", "entityType": "user", "entityId": "u1",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": 5}, "eventTime": "2026-01-01T00:00:00Z"}),
    ("get", KEY, None, 0),
    ("delete", KEY, None, 0),
    ("get", KEY, None, 0),
    ("delete", KEY, None, 0),
    ("get", KEY, None, "no-such-id"),
    # validation and the whitelist
    ("create", KEY, None, _ev("$bogus", "u1")),
    ("create", VIEW_KEY, None, _ev("buy", "u1")),
    ("create", VIEW_KEY, None, _ev("view", "u1", 9)),
    ("create", KEY, None, ["not", "an", "object"]),
    ("create", KEY, None, _ev("rate", "", 3)),
    # query filters
    ("create", KEY, None, _ev("rate", "u1", 0)),
    ("create", KEY, None, _ev("rate", "u2", 1)),
    ("create", KEY, None, _ev("buy", "u1", 2)),
    ("query", KEY, None, _q()),
    ("query", KEY, None, _q(event="rate")),
    ("query", KEY, None, _q(event=["rate", "buy"], limit="2")),
    ("query", KEY, None, _q(entityType="user", entityId="u1",
                            reversed="true", limit="1")),
    ("query", KEY, None, _q(reversed="true")),
    ("query", KEY, None, _q(startTime="2026-01-02T00:01:00Z",
                            untilTime="2026-01-02T00:02:00Z")),
    ("query", KEY, None, _q(startTime="garbage")),
    ("query", KEY, None, _q(event="nope")),
    ("query", KEY, None, _q(limit="abc")),
    ("query", KEY, None, _q(limit="0")),
    ("query", KEY, None, _q(limit="-1")),
    # channels
    ("create", KEY, "live", _ev("rate", "u9")),
    ("query", KEY, "live", _q()),
    ("query", KEY, "nope", _q()),
    # webhooks
    ("wh_get", KEY, None, ("segmentio", False)),
    ("wh_get", KEY, None, ("nope", False)),
    ("wh_get", KEY, None, ("mailchimp", True)),
    ("wh_get", None, None, ("segmentio", False)),
    ("wh_json", KEY, None, ("segmentio", {
        "type": "identify", "userId": "u42",
        "timestamp": "2026-02-01T10:00:00Z",
        "traits": {"email": "x@y.z"}})),
    ("wh_json", KEY, None, ("segmentio", {
        "type": "track", "userId": "u", "timestamp": "2026-01-01T00:00:00Z"})),
    ("wh_json", KEY, None, ("segmentio", {"userId": "u"})),
    ("wh_json", KEY, None, ("nope", {})),
    ("wh_form", KEY, None, ("mailchimp", MAILCHIMP)),
    ("wh_form", KEY, None, ("mailchimp", {"x": "1"})),
    ("wh_form", KEY, None, ("mailchimp", {"type": "unsubscribe"})),
    # review regressions: 400s for a bad eventTime, target filters
    ("create", KEY, None, _ev("rate", "u1", eventTime="not-a-date")),
    ("create", KEY, None, _ev("rate", "u1", 4, targetEntityType="item",
                              targetEntityId="i1")),
    ("create", KEY, None, _ev("rate", "u1", 5, targetEntityType="item",
                              targetEntityId="i2")),
    ("query", KEY, None, _q(targetEntityType="item", targetEntityId="i2")),
    # the batch route: the store's lane, a whitelist's per-row lane,
    # malformed bodies
    ("batch", KEY, None, json.dumps(BATCH_ROWS).encode()),
    ("batch", RATE_KEY, None, json.dumps(BATCH_ROWS).encode()),
    ("batch", KEY, "live", json.dumps(BATCH_ROWS[:1]).encode()),
    ("batch", KEY, None, json.dumps({"not": "an array"}).encode()),
    ("batch", KEY, None, b"[{"),
    ("batch", KEY, None, b"[]"),
    ("stats", KEY, None, None),
    ("stats", VIEW_KEY, "live", None),
]


def _env(kind, root):
    env = {"PIO_STORAGE_SOURCES_S_TYPE": kind}
    if kind != "memory":
        env["PIO_STORAGE_SOURCES_S_PATH"] = str(root)
    return env


class Side:
    """One package's store, with an app, its ``live`` channel and the
    three fixed keys, and that package's EventServerCore over it."""

    def __init__(self, package, kind, root):
        jax = package == "jax"
        self.mod = jax_es if jax else es
        self.storage = (JaxStorage if jax else Storage).from_env(
            _env(kind, root))
        key_cls = JaxAccessKey if jax else AccessKey
        app = self.storage.apps().insert("parity")
        self.app_id = app.id
        self.storage.events().init(app.id)
        ch = self.storage.channels().insert("live", app.id)
        self.channel_id = ch.id
        self.storage.events().init(app.id, ch.id)
        for key, events in ((KEY, []), (VIEW_KEY, ["view"]),
                            (RATE_KEY, ["rate"])):
            self.storage.access_keys().insert(key_cls(key, app.id, events))
        self.core = self.mod.EventServerCore(
            self.storage, JaxStats() if jax else Stats())
        self.ids = []

    def run(self, op, key, channel, arg):
        try:
            auth = self.core.authenticate(key, channel)
        except self.mod.AuthError as e:
            return e.status, {"message": e.message}
        core = self.core
        if op == "create":
            out = core.create_event(auth, arg)
        elif op in ("get", "delete"):
            eid = self.ids[arg] if isinstance(arg, int) else arg
            out = (core.get_event if op == "get" else core.delete_event)(
                auth, eid)
        elif op == "query":
            out = core.query_events(auth, arg)
        elif op == "batch":
            out = core.create_events_batch(auth, arg)
        elif op == "stats":
            out = 200, core.stats.report(auth.app_id)
        elif op == "wh_get":
            out = core.webhook_exists(arg[0], form=arg[1])
        elif op == "wh_json":
            out = core.webhook_json(auth, *arg)
        else:
            out = core.webhook_form(auth, *arg)
        return out[0], self.normalise(out[1])

    def normalise(self, body):
        """Event ids by order of appearance; clock times as "*"."""
        if isinstance(body, list):
            return [self.normalise(b) for b in body]
        if not isinstance(body, dict):
            return body
        out = {}
        for k, v in body.items():
            if k == "eventId" and v is not None:
                if v not in self.ids:
                    self.ids.append(v)
                v = f"id{self.ids.index(v)}"
            elif k in ("creationTime", "startTime", "hour"):
                v = "*"
            out[k] = self.normalise(v)
        return out

    def stored(self, channel_id=None):
        return sorted(
            json.dumps({k: v for k, v in e.to_dict(api_format=True).items()
                        if k not in ("eventId", "creationTime")},
                       sort_keys=True)
            for e in self.storage.events().find(self.app_id,
                                                channel_id=channel_id))

    def close(self):
        close = getattr(self.storage.events(), "close", None)
        if close is not None:
            close()


@pytest.fixture(params=KINDS)
def sides(request, tmp_path):
    pair = (Side("jax", request.param, tmp_path / "jax"),
            Side("torch", request.param, tmp_path / "torch"))
    yield pair
    for side in pair:
        side.close()


def test_every_request_answers_like_jax(sides):
    jax, port = sides
    for j, (op, key, channel, arg) in enumerate(SEQUENCE):
        want = jax.run(op, key, channel, arg)
        got = port.run(op, key, channel, arg)
        assert got == want, (j, op, arg)


def test_stores_hold_the_same_events_afterwards(sides):
    jax, port = sides
    for request in SEQUENCE:
        jax.run(*request)
        port.run(*request)
    assert port.stored() == jax.stored()
    assert port.stored(port.channel_id) == jax.stored(jax.channel_id)
    assert len(port.stored()) > 10


def test_batch_lanes_answer_like_jax(sides):
    """The batch contract of tests/test_servers.py on both lanes: one
    bad event never fails its batchmates, the stats count both statuses,
    and a whitelisted key answers 403 per row."""
    jax, port = sides
    raw = json.dumps(BATCH_ROWS).encode()
    for side in sides:
        status, results = side.run("batch", KEY, None, raw)
        assert status == 200 and [r["status"] for r in results] == [
            201, 400, 201]
        assert "empty" in results[1]["message"]
        status, results = side.run("batch", RATE_KEY, None, raw)
        assert [r["status"] for r in results] == [201, 400, 403]
    assert port.run("stats", KEY, None, None) == jax.run(
        "stats", KEY, None, None)
    assert port.stored() == jax.stored()
    assert [json.loads(e)["event"] for e in port.stored()] == [
        "rate", "rate", "view"]


def test_native_lane_runs_on_eventlog_and_not_on_memory(tmp_path):
    """The eventlog store's insert_json_batch takes the whole body (one
    call), a whitelisted key's batch never reaches it, and a memory store
    has no native lane."""
    port = Side("torch", "eventlog", tmp_path)
    store = port.storage.events()
    calls = []
    real = store.insert_json_batch

    def counting(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    store.insert_json_batch = counting
    try:
        raw = json.dumps(BATCH_ROWS).encode()
        port.run("batch", KEY, None, raw)
        assert calls == [raw]
        port.run("batch", RATE_KEY, None, raw)
        assert calls == [raw]
    finally:
        port.close()
    memory = Side("torch", "memory", tmp_path)
    assert not hasattr(memory.storage.events(), "insert_json_batch")


def test_native_lane_faults_are_errors_not_retries(tmp_path):
    """An append I/O failure is a 500; anything but JsonRowsUnsupported
    or ValueError from the native lane propagates, never a silent retry
    on the per-row lane."""
    from predictionio_torch.data.storage import StorageError

    port = Side("torch", "eventlog", tmp_path)
    store = port.storage.events()
    raw = json.dumps(BATCH_ROWS).encode()
    try:
        def storage_fault(*a, **kw):
            raise StorageError("disk full")

        store.insert_json_batch = storage_fault
        assert port.run("batch", KEY, None, raw) == (
            500, {"message": "disk full"})

        def other_fault(*a, **kw):
            raise OSError("boom")

        store.insert_json_batch = other_fault
        with pytest.raises(OSError):
            port.run("batch", KEY, None, raw)
        assert port.stored() == []
    finally:
        port.close()


# -- over HTTP -----------------------------------------------------------------

def _http(method, url, body=None, headers=None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


HTTP_CASES = [
    ("GET", "/", None, {}),
    ("GET", "/healthz", None, {}),
    ("POST", "/events.json", json.dumps(_ev("rate", "u1")).encode(), {}),
    ("POST", f"/events.json?accessKey={KEY}", b"{not json", {}),
    ("POST", f"/events.json?accessKey={KEY}",
     json.dumps(_ev("rate", "u1", 7)).encode(), {}),
    ("GET", "/events.json", None,
     {"Authorization": "Basic " + base64.b64encode(
         f"{KEY}:".encode()).decode()}),
    ("GET", "/events.json", None, {"Authorization": "Basic !!!"}),
    ("PUT", f"/events.json?accessKey={KEY}", b"{}", {}),
    ("GET", f"/batch/events.json?accessKey={KEY}", None, {}),
    ("POST", f"/batch/events.json?accessKey={KEY}",
     json.dumps(BATCH_ROWS).encode(), {}),
    ("DELETE", f"/webhooks/segmentio.json?accessKey={KEY}", b"{}", {}),
    ("POST", f"/webhooks/segmentio.json?accessKey={KEY}", b"{bad", {}),
    ("POST", f"/webhooks/mailchimp?accessKey={KEY}",
     urlencode(MAILCHIMP).encode(),
     {"Content-Type": "application/x-www-form-urlencoded"}),
    ("GET", f"/events.json?accessKey={KEY}&limit=-1", None, {}),
    ("GET", "/nope", None, {}),
]


@pytest.mark.parametrize("kind", KINDS)
def test_http_routes_answer_like_jax(tmp_path, kind):
    sides = [Side("jax", kind, tmp_path / "jax"),
             Side("torch", kind, tmp_path / "torch")]
    servers = [jax_es.EventServer(storage=sides[0].storage,
                                  host="127.0.0.1", port=0).start(),
               es.EventServer(storage=sides[1].storage, host="127.0.0.1",
                              port=0).start()]
    try:
        for method, path, body, headers in HTTP_CASES:
            answers = []
            for side, server in zip(sides, servers):
                status, raw = _http(method, f"http://127.0.0.1:"
                                    f"{server.port}{path}", body, headers)
                try:
                    parsed = side.normalise(json.loads(raw))
                except ValueError:
                    parsed = None     # the stdlib's HTML error page
                answers.append((status, parsed))
            assert answers[1] == answers[0], (method, path)
        assert sides[1].stored() == sides[0].stored()
    finally:
        for server in servers:
            server.stop()
        for side in sides:
            side.close()


# -- stores shared between the packages ----------------------------------------

def _cross(maker, user, kind, tmp_path):
    """``maker``'s ``app_new`` makes the app; ``user``'s event server
    takes events with its key; ``maker``'s store reads them back."""
    env = _env(kind, tmp_path / "store")
    stores = {"jax": JaxStorage, "torch": Storage}
    mods = {"jax": (jax_es, jax_commands, JaxStats),
            "torch": (es, commands, Stats)}
    made = stores[maker].from_env(env)
    info = mods[maker][1].app_new("shared", storage=made)
    getattr(made.events(), "close", lambda: None)()

    served = stores[user].from_env(env)
    mod, _, stats = mods[user]
    core = mod.EventServerCore(served, stats())
    auth = core.authenticate(info.access_keys[0].key, None)
    assert auth.app_id == info.app.id
    assert core.create_event(auth, _ev("rate", "u1", 1, targetEntityType=
                                       "item", targetEntityId="i7"))[0] == 201
    status, rows = core.create_events_batch(
        auth, json.dumps(BATCH_ROWS).encode())
    assert [r["status"] for r in rows] == [201, 400, 201]
    getattr(served.events(), "close", lambda: None)()

    back = stores[maker].from_env(env)
    try:
        events = back.events().find(info.app.id)
        assert sorted((e.event, e.entity_id, e.target_entity_id)
                      for e in events) == [
            ("rate", "u1", "i1"), ("rate", "u1", "i7"),
            ("view", "u3", None)]
    finally:
        getattr(back.events(), "close", lambda: None)()


@pytest.mark.parametrize("kind", ("localfs", "eventlog"))
@pytest.mark.parametrize("maker,user", [("jax", "torch"), ("torch", "jax")])
def test_app_new_of_one_package_serves_the_other(tmp_path, kind, maker,
                                                 user):
    _cross(maker, user, kind, tmp_path)


def _new_key_in_another_process(env, app):
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_torch.tools.cli", "accesskey",
         "new", app], env={**os.environ, **env, "PYTHONPATH": ROOT},
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("Created new access key: "))
    return line.split(": ", 1)[1]


@pytest.mark.parametrize("kind", ("localfs", "eventlog"))
def test_a_key_added_by_another_process_is_seen_on_the_next_request(
        tmp_path, kind, monkeypatch):
    env = _env(kind, tmp_path / "store")
    storage = Storage.from_env(env)
    commands.app_new("live-keys", storage=storage)
    core = es.EventServerCore(storage, Stats())
    reads = []
    real_read = localfs._MetadataDoc._read

    def counting_read(doc):
        reads.append(1)
        return real_read(doc)

    monkeypatch.setattr(localfs._MetadataDoc, "_read", counting_read)
    with pytest.raises(es.AuthError):
        core.authenticate("not-yet", None)
    # the parsed copy serves while the file is unchanged
    for _ in range(5):
        with pytest.raises(es.AuthError):
            core.authenticate("not-yet", None)
    assert len(reads) <= 1
    key = _new_key_in_another_process(env, "live-keys")
    auth = core.authenticate(key, None)
    assert core.create_event(auth, _ev("rate", "u5"))[0] == 201
    assert len(reads) <= 2
    getattr(storage.events(), "close", lambda: None)()
