"""The port's commands, import/export, admin server and CLI against the
JAX package's, on the CPU, and the SIGTERM drain.

The cases of ``tests/test_tools.py`` (app lifecycle, data-delete,
channels, access keys, status, the JSONL and parquet round trips, an
invalid line, the columnar parquet lane, the admin server's routes) run
against both packages through one fixture; the CLIs' printed lines must
be equal once access keys are masked, and a file one package exports
the other imports. Parquet cases skip without pyarrow, which the port
does not depend on.
"""

import datetime as dt
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import predictionio_tpu.data.storage as jax_storage_mod
import predictionio_tpu.tools.admin as jax_admin
import predictionio_tpu.tools.cli as jax_cli
import predictionio_tpu.tools.commands as jax_commands
import predictionio_tpu.tools.eventdata as jax_eventdata
from predictionio_tpu.data.event import Event as JaxEvent
import predictionio_torch.data.storage as storage_mod
from predictionio_torch.data.event import Event
from predictionio_torch.serving import event_server as es
from predictionio_torch.serving import http as port_http
from predictionio_torch.tools import admin, cli, commands, eventdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTC = dt.timezone.utc
KEY_RE = re.compile(r"[A-Za-z0-9_-]{64}")

PACKAGES = {
    "jax": types.SimpleNamespace(
        commands=jax_commands, eventdata=jax_eventdata, admin=jax_admin,
        cli=jax_cli, storage=jax_storage_mod, Event=JaxEvent),
    "torch": types.SimpleNamespace(
        commands=commands, eventdata=eventdata, admin=admin, cli=cli,
        storage=storage_mod, Event=Event),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _memory(pkg):
    return pkg.storage.Storage.from_env(
        {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})


def _http(method, url, body=None):
    req = urllib.request.Request(
        url, method=method,
        data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else {}


# -- commands ------------------------------------------------------------------

def test_app_lifecycle(pkg):
    st = _memory(pkg)
    info = pkg.commands.app_new("myapp", "desc", st)
    assert info.app.name == "myapp" and info.app.description == "desc"
    assert len(info.access_keys) == 1 and len(info.access_keys[0].key) == 64
    assert info.access_keys[0].events == []
    with pytest.raises(pkg.commands.CommandError, match="already exists"):
        pkg.commands.app_new("myapp", storage=st)
    assert [i.app.name for i in pkg.commands.app_list(st)] == ["myapp"]
    st.events().insert(pkg.Event(event="e", entity_type="user",
                                 entity_id="u"), info.app.id)
    pkg.commands.app_delete("myapp", st)
    assert pkg.commands.app_list(st) == []
    assert st.access_keys().get(info.access_keys[0].key) is None
    with pytest.raises(pkg.commands.CommandError, match="does not exist"):
        pkg.commands.app_show("myapp", st)


def test_app_data_delete(pkg):
    st = _memory(pkg)
    info = pkg.commands.app_new("a1", storage=st)
    st.events().insert(pkg.Event(event="e", entity_type="user",
                                 entity_id="u"), info.app.id)
    assert len(st.events().find(info.app.id)) == 1
    pkg.commands.app_data_delete("a1", storage=st)
    assert st.events().find(info.app.id) == []


def test_channels(pkg):
    st = _memory(pkg)
    info = pkg.commands.app_new("capp", storage=st)
    ch = pkg.commands.channel_new("capp", "mobile", st)
    assert ch.name == "mobile"
    with pytest.raises(pkg.commands.CommandError):
        pkg.commands.channel_new("capp", "mobile", st)
    with pytest.raises(pkg.storage.StorageError, match="invalid channel"):
        pkg.commands.channel_new("capp", "no spaces!", st)
    st.events().insert(pkg.Event(event="e", entity_type="user",
                                 entity_id="u"), info.app.id, ch.id)
    assert len(st.events().find(info.app.id, channel_id=ch.id)) == 1
    pkg.commands.app_data_delete("capp", "mobile", st)
    assert st.events().find(info.app.id, channel_id=ch.id) == []
    with pytest.raises(pkg.commands.CommandError):
        pkg.commands.app_data_delete("capp", "nope", st)
    pkg.commands.channel_delete("capp", "mobile", st)
    assert pkg.commands.app_show("capp", st).channels == []
    assert st.channels().get(ch.id) is None


def test_accesskeys(pkg):
    st = _memory(pkg)
    pkg.commands.app_new("kapp", storage=st)
    key = pkg.commands.accesskey_new("kapp", ["rate", "buy"], st)
    assert sorted(key.events) == ["buy", "rate"]
    assert len(pkg.commands.accesskey_list("kapp", st)) == 2
    assert len(pkg.commands.accesskey_list(None, st)) == 2
    pkg.commands.accesskey_delete(key.key, st)
    assert len(pkg.commands.accesskey_list("kapp", st)) == 1
    with pytest.raises(pkg.commands.CommandError):
        pkg.commands.accesskey_delete("nope", st)


def test_status(pkg):
    assert pkg.commands.status(_memory(pkg)) == {
        "METADATA": True, "EVENTDATA": True, "MODELDATA": True}


def test_status_names_a_source_that_cannot_open(tmp_path, capsys,
                                                monkeypatch):
    """A source of a type no backend registers fails its repositories,
    and ``pio status`` exits 1 naming them."""
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs"),
           "PIO_STORAGE_SOURCES_RS_TYPE": "hbase",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "RS"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    storage_mod.set_storage(None)
    try:
        assert cli.main(["status"]) == 1
    finally:
        storage_mod.set_storage(None)
    assert capsys.readouterr().out.splitlines() == [
        "EVENTDATA: FAILED", "METADATA: OK", "MODELDATA: OK",
        "Unable to connect to all storage backends."]


# -- import / export -----------------------------------------------------------

def _seed(pkg, st, app_id, n=5):
    for k in range(n):
        st.events().insert(pkg.Event(
            event="rate", entity_type="user", entity_id=f"u{k}",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": k},
            event_time=dt.datetime(2026, 1, 1, 0, k, tzinfo=UTC)), app_id)


def _api_dicts(st, app_id):
    return sorted(json.dumps({k: v for k, v in e.to_dict(True).items()
                              if k not in ("eventId", "creationTime")},
                             sort_keys=True)
                  for e in st.events().find(app_id))


def test_jsonl_round_trip(pkg, tmp_path):
    st = _memory(pkg)
    info = pkg.commands.app_new("ioapp", storage=st)
    _seed(pkg, st, info.app.id)
    out = tmp_path / "events.jsonl"
    assert pkg.eventdata.export_events("ioapp", str(out), storage=st) == 5
    assert len(out.read_text().strip().splitlines()) == 5
    app2 = pkg.commands.app_new("ioapp2", storage=st).app
    assert pkg.eventdata.import_events("ioapp2", str(out), storage=st) == 5
    assert _api_dicts(st, app2.id) == _api_dicts(st, info.app.id)


@pytest.mark.parametrize("maker,reader", [("jax", "torch"), ("torch", "jax")])
def test_a_file_one_package_exports_the_other_imports(tmp_path, maker,
                                                      reader):
    a, b = PACKAGES[maker], PACKAGES[reader]
    st_a, st_b = _memory(a), _memory(b)
    info = a.commands.app_new("src", storage=st_a)
    _seed(a, st_a, info.app.id, n=7)
    st_a.events().insert(a.Event(
        event="$set", entity_type="user", entity_id="u9",
        properties={"plan": "pro", "tags": ["x", "y"]}, tags=("t1",),
        event_time=dt.datetime(2026, 1, 2, tzinfo=UTC)), info.app.id)
    path = str(tmp_path / "events.jsonl")
    assert a.eventdata.export_events("src", path, storage=st_a) == 8
    dst = b.commands.app_new("dst", storage=st_b).app
    assert b.eventdata.import_events("dst", path, storage=st_b) == 8
    assert _api_dicts(st_b, dst.id) == _api_dicts(st_a, info.app.id)


def test_import_invalid_line_names_its_position_as_jax_does(tmp_path):
    f = tmp_path / "bad.jsonl"
    f.write_text('{"event": "e", "entityType": "user", "entityId": "u"}\n'
                 '\n{"event": "$set"}\n')
    messages = []
    for name in ("jax", "torch"):
        p = PACKAGES[name]
        st = _memory(p)
        app = p.commands.app_new("bad", storage=st).app
        with pytest.raises(ValueError, match="bad.jsonl:3") as e:
            p.eventdata.import_events("bad", str(f), storage=st)
        assert st.events().find(app.id) == []   # nothing was written
        messages.append(str(e.value))
    assert messages[1] == messages[0]


def _write_parquet(pkg, path, dicts):
    pytest.importorskip("pyarrow")
    pkg.eventdata._write_parquet(path, dicts)


def test_parquet_round_trip(pkg, tmp_path):
    pytest.importorskip("pyarrow")
    st = _memory(pkg)
    info = pkg.commands.app_new("pqapp", storage=st)
    for n in range(4):
        st.events().insert(pkg.Event(
            event="rate", entity_type="user", entity_id=f"u{n}",
            target_entity_type="item", target_entity_id="i1",
            properties={"rating": float(n), "tags_test": ["a", "b"]},
            tags=("t1", "t2"),
            event_time=dt.datetime(2026, 1, 1, 0, n, tzinfo=UTC)),
            info.app.id)
    st.events().insert(pkg.Event(
        event="$set", entity_type="user", entity_id="u9",
        properties={"plan": "pro"},
        event_time=dt.datetime(2026, 1, 2, tzinfo=UTC)), info.app.id)
    out = tmp_path / "events.parquet"
    assert pkg.eventdata.export_events("pqapp", str(out), storage=st) == 5
    app2 = pkg.commands.app_new("pqapp2", storage=st).app
    assert pkg.eventdata.import_events("pqapp2", str(out), storage=st) == 5
    events = {e.entity_id: e for e in st.events().find(app2.id)}
    assert events["u2"].properties.get("rating") == 2.0
    assert events["u2"].properties.get("tags_test") == ["a", "b"]
    assert events["u2"].tags == ("t1", "t2")
    assert events["u9"].event == "$set"
    assert events["u9"].target_entity_type is None
    assert events["u9"].event_time == dt.datetime(2026, 1, 2, tzinfo=UTC)


def test_parquet_without_pyarrow_raises_runtime_error(tmp_path,
                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    st = _memory(PACKAGES["torch"])
    commands.app_new("nopq", storage=st)
    with pytest.raises(RuntimeError, match="pyarrow"):
        eventdata.export_events("nopq", str(tmp_path / "e.parquet"),
                                storage=st)


def _ratings_dicts(n=50):
    rng = np.random.default_rng(4)
    dicts = []
    for k in range(n):
        d = {"event": "rate" if k % 3 else "buy", "entityType": "user",
             "entityId": f"u{rng.integers(8)}", "targetEntityType": "item",
             "targetEntityId": f"i{rng.integers(5)}",
             "eventTime": f"2026-01-01T00:{k % 60:02d}:00+00:00"}
        if k % 3:
            d["properties"] = {"rating": float(k % 5) + 0.5}
        dicts.append(d)
    return dicts


def test_interaction_parquet_takes_the_columnar_lane(pkg, tmp_path,
                                                     monkeypatch):
    st = _memory(pkg)
    app = pkg.commands.app_new("colimp", storage=st).app
    path = str(tmp_path / "ratings.parquet")
    dicts = _ratings_dicts()
    _write_parquet(pkg, path, dicts)
    calls = []
    real = st.events().insert_columnar

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(st.events(), "insert_columnar", counting)
    assert pkg.eventdata.import_events("colimp", path, storage=st) == len(
        dicts)
    assert calls == [1]
    have = {(e.event, e.entity_id, e.target_entity_id,
             e.properties.get_opt("rating")) for e in st.events().find(app.id)}
    assert have == {(d["event"], d["entityId"], d["targetEntityId"],
                     d.get("properties", {}).get("rating")) for d in dicts}


def test_rich_properties_take_the_row_lane(pkg, tmp_path):
    st = _memory(pkg)
    app = pkg.commands.app_new("rowimp", storage=st).app
    path = str(tmp_path / "rich.parquet")
    _write_parquet(pkg, path, [
        {"event": "$set", "entityType": "item", "entityId": "i1",
         "properties": {"categories": ["a", "b"], "price": 9.5},
         "eventTime": "2026-01-01T00:00:00+00:00"},
        {"event": "view", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "eventTime": "2026-01-01T00:01:00+00:00"}])
    assert pkg.eventdata.import_events("rowimp", path, storage=st) == 2
    got = st.events().find(app.id)
    assert got[0].properties.get_opt("categories") == ["a", "b"]
    assert got[1].event == "view"


def test_columnar_lane_rejects_invalid_events_through_the_row_lane(
        pkg, tmp_path):
    st = _memory(pkg)
    pkg.commands.app_new("badimp", storage=st)
    path = str(tmp_path / "bad.parquet")
    _write_parquet(pkg, path, [
        {"event": "$set", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "eventTime": "2026-01-01T00:00:00+00:00"}])
    with pytest.raises(ValueError, match="bad.parquet:1"):
        pkg.eventdata.import_events("badimp", path, storage=st)


def test_columnar_lane_handles_mixed_no_target_rows(pkg, tmp_path):
    st = _memory(pkg)
    app = pkg.commands.app_new("miximp", storage=st).app
    path = str(tmp_path / "mix.parquet")
    _write_parquet(pkg, path, [
        {"event": "view", "entityType": "user", "entityId": "u1",
         "targetEntityType": "item", "targetEntityId": "i1",
         "eventTime": "2026-01-01T00:00:00+00:00"},
        {"event": "login", "entityType": "user", "entityId": "u2",
         "eventTime": "2026-01-01T00:01:00+00:00"}])
    assert pkg.eventdata.import_events("miximp", path, storage=st) == 2
    got = {e.entity_id: e for e in st.events().find(app.id)}
    assert got["u1"].target_entity_id == "i1"
    assert got["u2"].target_entity_id is None
    assert got["u2"].target_entity_type is None


def test_parquet_one_package_writes_the_other_reads(tmp_path):
    pytest.importorskip("pyarrow")
    path = str(tmp_path / "r.parquet")
    jax_eventdata._write_parquet(path, _ratings_dicts(20))
    port_rows = eventdata._read_parquet(path)
    assert port_rows == jax_eventdata._read_parquet(path)


# -- admin server --------------------------------------------------------------

def test_admin_routes(pkg):
    st = _memory(pkg)
    server = pkg.admin.AdminServer(storage=st, host="127.0.0.1",
                                   port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _http("GET", f"{base}/") == (200, {"status": "alive"})
        status, body = _http("POST", f"{base}/cmd/app", {"name": "adminapp"})
        assert status == 200 and body["name"] == "adminapp"
        assert body["accessKeys"] and body["status"] == 1
        assert _http("POST", f"{base}/cmd/app",
                     {"name": "adminapp"})[0] == 409
        status, body = _http("GET", f"{base}/cmd/app")
        assert [a["name"] for a in body["apps"]] == ["adminapp"]
        assert _http("DELETE", f"{base}/cmd/app/adminapp/data") == (
            200, {"status": 1, "message": "App data deleted: adminapp"})
        assert _http("DELETE", f"{base}/cmd/app/adminapp")[0] == 200
        assert _http("GET", f"{base}/cmd/app")[1]["apps"] == []
        assert _http("DELETE", f"{base}/cmd/app/ghost")[0] == 404
        assert _http("POST", f"{base}/cmd/app", {"nope": 1})[0] == 400
        assert _http("GET", f"{base}/nope")[0] == 404
        assert _http("GET", f"{base}/healthz") == (200, {"status": "alive"})
    finally:
        server.stop()


# -- the CLI -------------------------------------------------------------------

CLI_SEQUENCE = [
    ["app", "new", "cliapp", "--description", "an app"],
    ["app", "new", "cliapp"],
    ["app", "new", "other"],
    ["accesskey", "new", "cliapp", "rate", "buy"],
    ["app", "list"],
    ["app", "show", "cliapp"],
    ["app", "channel-new", "cliapp", "mobile"],
    ["app", "channel-new", "cliapp", "mobile"],
    ["app", "show", "cliapp"],
    ["accesskey", "list"],
    ["accesskey", "list", "--app", "other"],
    ["accesskey", "delete", "nope"],
    ["import", "--appname", "cliapp", "--input", "{dir}/in.jsonl"],
    ["import", "--appname", "cliapp", "--input", "{dir}/in.jsonl",
     "--channel", "mobile"],
    ["export", "--appname", "cliapp", "--output", "{dir}/out.jsonl"],
    ["app", "compact", "cliapp"],
    ["app", "data-delete", "cliapp", "--channel", "mobile"],
    ["app", "data-delete", "cliapp"],
    ["export", "--appname", "cliapp", "--output", "{dir}/empty.jsonl"],
    ["app", "channel-delete", "cliapp", "mobile"],
    ["app", "channel-delete", "cliapp", "mobile"],
    ["status"],
    ["app", "delete", "other"],
    ["app", "show", "other"],
    ["app", "list"],
]


def _cli_transcript(pkg, root, capsys, monkeypatch):
    root.mkdir()
    monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_TYPE", "localfs")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_PATH", str(root / "store"))
    (root / "in.jsonl").write_text("".join(
        json.dumps({"event": "rate", "entityType": "user",
                    "entityId": f"u{k}", "targetEntityType": "item",
                    "targetEntityId": f"i{k % 3}",
                    "properties": {"rating": k},
                    "eventTime": f"2026-01-01T00:0{k}:00Z"}) + "\n"
        for k in range(6)))
    pkg.storage.set_storage(None)
    lines = []
    try:
        for argv in CLI_SEQUENCE:
            rc = pkg.cli.main([a.format(dir=root) for a in argv])
            out = capsys.readouterr()
            err = [ln for ln in out.err.splitlines()
                   if ln.startswith("ERROR")]
            lines.append((argv, rc, KEY_RE.sub("<key>", out.out), err))
    finally:
        pkg.storage.set_storage(None)
    exported = [json.loads(ln) for ln in
                (root / "out.jsonl").read_text().splitlines()]
    return lines, exported


def test_cli_prints_the_jax_lines(tmp_path, capsys, monkeypatch):
    jax_lines, jax_out = _cli_transcript(PACKAGES["jax"], tmp_path / "jax",
                                         capsys, monkeypatch)
    lines, out = _cli_transcript(PACKAGES["torch"], tmp_path / "torch",
                                 capsys, monkeypatch)
    for got, want in zip(lines, jax_lines):
        assert got == want
    assert len(lines) == len(jax_lines) == len(CLI_SEQUENCE)

    def strip(rows):
        return sorted(json.dumps({k: v for k, v in r.items()
                                  if k not in ("eventId", "creationTime")},
                                 sort_keys=True) for r in rows)

    assert len(out) == 6 and strip(out) == strip(jax_out)


def test_the_new_commands_import_no_torch():
    code = ("import sys\n"
            "from predictionio_torch.tools import cli\n"
            "cli.build_parser()\n"
            "import predictionio_torch.serving.event_server\n"
            "import predictionio_torch.tools.admin\n"
            "from predictionio_torch.data import storage\n"
            "storage._load_backends()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["localfs", "eventlog"])
def test_cli_eventserver_serves_and_drains_on_sigterm(tmp_path, kind):
    """``cli eventserver`` starts with no card, takes a batch over HTTP
    and exits 0 on SIGTERM; an event log is closed cleanly on the way
    out (its index snapshot covers every record)."""
    env = {**os.environ, "PYTHONPATH": ROOT,
           "PIO_STORAGE_SOURCES_FS_TYPE": kind,
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store"),
           "PIO_DRAIN_TIMEOUT": "10"}
    st = storage_mod.Storage.from_env(
        {k: v for k, v in env.items() if k.startswith("PIO_STORAGE")})
    key = commands.app_new("srv", storage=st).access_keys[0].key
    getattr(st.events(), "close", lambda: None)()     # one writer
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.cli",
         "eventserver", "--ip", "127.0.0.1", "--port", str(port)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 60
        while True:
            try:
                assert _http("GET", f"{base}/healthz") == (
                    200, {"status": "alive"})
                break
            except urllib.error.URLError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
        status, rows = _http(
            "POST", f"{base}/batch/events.json?accessKey={key}",
            [{"event": "rate", "entityType": "user", "entityId": "u1",
              "targetEntityType": "item", "targetEntityId": "i1"}])
        assert status == 200 and rows[0]["status"] == 201
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "Event server running on 127.0.0.1" in proc.stdout.read()
    # a localfs event log is read once per process: read it afresh
    back = storage_mod.Storage.from_env(
        {k: v for k, v in env.items() if k.startswith("PIO_STORAGE")})
    app_id = back.apps().get_by_name("srv").id
    assert [e.entity_id for e in back.events().find(app_id)] == ["u1"]
    getattr(back.events(), "close", lambda: None)()
    if kind == "eventlog":
        snapshots = list((tmp_path / "store").rglob("index.bin"))
        assert len(snapshots) == 1
        log_files = [p for p in snapshots[0].parent.iterdir()
                     if p.name != "index.bin"]
        assert snapshots[0].stat().st_mtime_ns >= max(
            p.stat().st_mtime_ns for p in log_files)


# -- the SIGTERM drain ---------------------------------------------------------

def test_drain_answers_the_request_in_flight_then_stops(monkeypatch):
    st = _memory(PACKAGES["torch"])
    key = commands.app_new("slow", storage=st).access_keys[0].key
    events = st.events()
    real_insert = events.insert
    entered = threading.Event()

    def slow_insert(*a, **kw):
        entered.set()
        time.sleep(0.6)
        return real_insert(*a, **kw)

    monkeypatch.setattr(events, "insert", slow_insert)
    server = es.EventServer(storage=st, host="127.0.0.1", port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    answer = {}

    def post():
        answer["got"] = _http("POST", f"{base}/events.json?accessKey={key}",
                              {"event": "rate", "entityType": "user",
                               "entityId": "u1"})

    client = threading.Thread(target=post)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        client.start()
        assert entered.wait(10)
        assert server.inflight_count() == 1
        handler = port_http.install_drain_handler(server, timeout=10)
        assert signal.getsignal(signal.SIGTERM) is handler
        handler()
        drains = [t for t in threading.enumerate() if t.name == "pio-drain"]
        assert drains and not drains[0].daemon
        for t in drains:
            t.join(timeout=20)
            assert not t.is_alive()
        client.join(timeout=20)
        assert not client.is_alive()
    finally:
        signal.signal(signal.SIGTERM, previous)
        server.stop()
    assert answer["got"][0] == 201 and "eventId" in answer["got"][1]
    assert server.inflight_count() == 0 and not server._serving
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"{base}/healthz", timeout=5)


def test_requests_after_stop_on_an_open_connection_answer_503():
    import http.client

    st = _memory(PACKAGES["torch"])
    key = commands.app_new("late", storage=st).access_keys[0].key
    server = es.EventServer(storage=st, host="127.0.0.1", port=0).start()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        conn.request("GET", f"/events.json?accessKey={key}")
        assert conn.getresponse().read()
        deadline = time.monotonic() + 10   # the handler counts out after
        while server.inflight_count() and time.monotonic() < deadline:
            time.sleep(0.01)               # its response is written
        server.stop()
        assert server.wait_stopped(1)
        conn.request("POST", f"/events.json?accessKey={key}",
                     body=b'{"event": "rate", "entityType": "user", '
                          b'"entityId": "u1"}')
        resp = conn.getresponse()
        assert resp.status == 503
        assert json.loads(resp.read()) == {"message": "server is stopping"}
    finally:
        conn.close()
    assert st.events().find(st.apps().get_by_name("late").id) == []


def test_drain_timeout_reads_its_env(monkeypatch):
    monkeypatch.delenv("PIO_DRAIN_TIMEOUT", raising=False)
    assert port_http.drain_timeout() == 30.0
    monkeypatch.setenv("PIO_DRAIN_TIMEOUT", "2.5")
    assert port_http.drain_timeout() == 2.5
    monkeypatch.setenv("PIO_DRAIN_TIMEOUT", "soon")
    assert port_http.drain_timeout() == 30.0
    monkeypatch.setenv("PIO_DRAIN_TIMEOUT", "-1")
    assert port_http.drain_timeout() == 0.0
