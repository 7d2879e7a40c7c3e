"""The port's storage server and ``rest`` client against the JAX
package's, on the CPU.

One scripted DAO sequence (events: batch and single inserts, point
reads and deletes, every ``find`` filter, limits and order, the derived
property fold, ``find_columnar`` whole, filtered, limited and
entity-hash sharded, ``insert_columnar``; every metadata repository's
RPCs; model blobs; the errors a client sees) runs against a JAX server
over the JAX package's memory storage through the JAX client: that is
the reference. The same script then runs through the port's server and
client, and across the wire in both directions (the port's client
against a JAX server, the JAX client against a port server). Every
result must be equal: exact, since the same operations on the same data
give the same answers (event ids are random, so events are named by
their position in the script). The same pairs hold auth refusals, the
resumable bulk scan after a dropped connection, spool release and the
native JSON lane to the JAX behaviour.
"""

import datetime as dt
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401
from tests.torch_storage_tier import (JAX, PAIR_IDS, PAIRS, PORT, UTC,
                                      client, column_rows, event_key,
                                      memory_storage, pkg, servers)

torch.set_num_threads(1)


def _events(P):
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    h = dt.timedelta(hours=1)
    E = P.Event
    return [
        E(event="rate", entity_type="user", entity_id="u1",
          target_entity_type="item", target_entity_id="i1",
          properties={"rating": 4.5}, event_time=t0),
        E(event="buy", entity_type="user", entity_id="u1",
          target_entity_type="item", target_entity_id="i2",
          event_time=t0 + h),
        E(event="$set", entity_type="user", entity_id="u2",
          properties={"a": 1, "b": "x"}, event_time=t0 + 2 * h),
        E(event="rate", entity_type="user", entity_id="u3",
          target_entity_type="item", target_entity_id="i1",
          properties={"rating": 2.0}, event_time=t0 + 3 * h),
        E(event="$unset", entity_type="user", entity_id="u2",
          properties={"b": None}, event_time=t0 + 4 * h),
        E(event="rate", entity_type="user", entity_id="u2",
          target_entity_type="item", target_entity_id="i3",
          properties={"rating": 5.0}, event_time=t0 + 5 * h),
        E(event="view", entity_type="page", entity_id="p1",
          target_entity_type="item", target_entity_id="i1",
          event_time=t0 + 6 * h),
        E(event="$set", entity_type="item", entity_id="i1",
          properties={"cat": ["c1", "c2"]}, event_time=t0 + 7 * h),
    ]


def _finds(P):
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    return [
        {}, {"event_names": ["rate"]}, {"event_names": ["rate", "buy"]},
        {"start_time": t0 + dt.timedelta(hours=1),
         "until_time": t0 + dt.timedelta(hours=5)},
        {"entity_type": "user", "entity_id": "u2"},
        {"target_entity_type": None}, {"target_entity_type": "item"},
        {"target_entity_id": "i1"}, {"target_entity_type": P.storage.UNSET},
        {"limit": 3}, {"limit": 2, "reversed": True}, {"reversed": True},
        {"limit": -1},
    ]


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the class is the result
        return type(e).__name__
    return "no error"


def dao_script(st, P) -> list:
    """Run the script through Storage ``st`` of package ``P``; the
    results, with events named by position."""
    out = []
    ev = st.events()
    app = st.apps().insert("script", "the scripted app")
    out.append(("app", P.metadata.record_to_dict(app)))
    ev.init(app.id)
    ids = ev.insert_batch(_events(P)[:6], app.id)
    ids.append(ev.insert(_events(P)[6], app.id))
    ids += ev.insert_batch(_events(P)[7:], app.id)
    pos = {i: n for n, i in enumerate(ids)}

    def named(events):
        return [(pos.get(e.event_id, "?"), event_key(e)) for e in events]

    out.append(("ids", len(ids), len(set(ids))))
    out.append(("get", named([ev.get(ids[2], app.id)])))
    out.append(("get missing", ev.get("no-such-id", app.id)))
    for kw in _finds(P):
        out.append(("find", sorted(kw), named(ev.find(app.id, **kw))))
    props = ev.aggregate_properties(app.id, "user")
    out.append(("props", sorted((k, sorted(v.to_dict().items()))
                                for k, v in props.items())))
    out.append(("delete", ev.delete(ids[1], app.id),
                ev.delete(ids[1], app.id)))
    out.append(("after delete", named(ev.find(app.id))))
    for kw in ({}, {"event_names": ["rate"], "value_property": "rating"},
               {"value_property": "rating", "time_ordered": True},
               {"limit": 2, "value_property": "rating"},
               {"shard_index": 0, "shard_count": 2},
               {"shard_index": 1, "shard_count": 2, "limit": 1},
               {"entity_type": "user", "target_entity_type": "item",
                "value_property": "rating"}):
        cols = ev.find_columnar(app.id, **kw)
        out.append(("columnar", sorted(kw), column_rows(cols),
                    cols.entity_vocab, cols.target_vocab, cols.names))
    cols = P.storage.EventColumns(
        entity_codes=np.array([0, 1, 0], np.int32),
        target_codes=np.array([0, 1, -1], np.int32),
        name_codes=np.array([0, 0, 1], np.int32),
        values=np.array([4.5, np.nan, np.nan], np.float64),
        times_us=np.array([1_000_000, 2_000_000, 3_000_000], np.int64),
        entity_vocab=["anna", "a\0b"], target_vocab=["x1", "商品"],
        names=["rate", "$set"])
    ev.init(app.id + 1)
    out.append(("insert_columnar", ev.insert_columnar(
        cols, app.id + 1, entity_type="ユーザー", target_entity_type="item",
        value_property="rating")))
    back = ev.find_columnar(app.id + 1, value_property="rating")
    out.append(("columnar back", column_rows(back)))
    out.append(("rows back", sorted(event_key(e)
                                    for e in ev.find(app.id + 1))))
    out.append(("uninitialized", _error(lambda: ev.find(999))))
    out.append(("typo filter", _error(
        lambda: ev.find_columnar(app.id, event_name=["rate"]))))

    MD = P.metadata
    rd = MD.record_to_dict
    out.append(("dup app", _error(lambda: st.apps().insert("script"))))
    other = st.apps().insert("other")
    app.description = "changed"
    st.apps().update(app)
    out.append(("apps", [rd(a) for a in st.apps().get_all()],
                rd(st.apps().get(app.id)),
                rd(st.apps().get_by_name("other")),
                st.apps().get_by_name("none")))
    st.apps().put(MD.App(id=40, name="put-app"))
    st.apps().delete(other.id)
    out.append(("apps after", [rd(a) for a in st.apps().get_all()]))
    key = MD.AccessKey(key="k" * 64, appid=app.id, events=["rate"])
    out.append(("key insert", st.access_keys().insert(key)))
    st.access_keys().put(MD.AccessKey(key="p" * 64, appid=40, events=[]))
    out.append(("keys", rd(st.access_keys().get("k" * 64)),
                sorted(k.key[:1] for k in st.access_keys().get_all()),
                [rd(k) for k in st.access_keys().get_by_app_id(app.id)]))
    st.access_keys().delete("k" * 64)
    out.append(("key gone", st.access_keys().get("k" * 64)))
    ch = st.channels().insert("live", app.id)
    out.append(("channel", rd(ch), _error(
        lambda: st.channels().insert("bad name!", app.id))))
    st.channels().put(MD.Channel(id=30, name="copy", appid=app.id))
    out.append(("channels", [rd(c) for c in
                             st.channels().get_by_app_id(app.id)]))
    st.channels().delete(ch.id)
    out.append(("channel gone", st.channels().get(ch.id)))
    st.engine_manifests().insert(MD.EngineManifest(
        id="e1", version="1", name="engine one"))
    st.engine_manifests().put(MD.EngineManifest(id="e1", version="2",
                                                name="two"))
    out.append(("manifests", rd(st.engine_manifests().get("e1", "1")),
                st.engine_manifests().get("e1", "9"),
                sorted(m.version for m in st.engine_manifests().get_all())))
    st.engine_manifests().delete("e1", "2")
    t = dt.datetime(2026, 3, 1, tzinfo=UTC)
    for n, status in enumerate(("COMPLETED", "COMPLETED", "FAILED")):
        st.engine_instances().insert(MD.EngineInstance(
            id=f"inst-{n}", status=status,
            start_time=t + dt.timedelta(minutes=n), end_time=t,
            engine_id="e1", engine_version="1", engine_variant="default",
            engine_factory="f", batch=f"b{n}"))
    inst = st.engine_instances().get("inst-0")
    inst.status = "FAILED"
    st.engine_instances().update(inst)
    st.engine_instances().put(MD.EngineInstance(
        id="inst-9", status="COMPLETED", start_time=t - dt.timedelta(days=1),
        end_time=t, engine_id="e1", engine_version="1",
        engine_variant="default", engine_factory="f"))
    out.append(("instances",
                rd(st.engine_instances().get_latest_completed(
                    "e1", "1", "default")),
                [i.id for i in st.engine_instances().get_completed(
                    "e1", "1", "default")],
                sorted(i.id for i in st.engine_instances().get_all())))
    st.engine_instances().delete("inst-1")
    out.append(("instance gone", st.engine_instances().get("inst-1")))
    st.evaluation_instances().insert(MD.EvaluationInstance(
        id="ev-1", status="EVALCOMPLETED", start_time=t, end_time=t))
    out.append(("evaluations", [rd(i) for i in
                                st.evaluation_instances().get_completed()]))
    blob = bytes(range(256)) * 9
    st.models().insert(MD.Model(id="inst-0", models=blob))
    st.models().insert(MD.Model(id="inst-2", models=b"\x00"))
    out.append(("models", st.models().get("inst-0").models == blob,
                st.models().get("missing"), st.models().size("inst-0"),
                sorted((m["id"], m["bytes"], m["sha256"])
                       for m in st.models().list())))
    st.models().delete("inst-2")
    out.append(("model gone", st.models().get("inst-2")))
    return out


def _run_pair(server_pkg, client_pkg):
    S, C = pkg(server_pkg), pkg(client_pkg)
    with servers(S, 1) as (_, srvs):
        return dao_script(client(C, srvs), C)


@pytest.fixture(scope="module")
def reference():
    """The script through the JAX server and client."""
    return _run_pair(JAX, JAX)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_dao_script_matches_the_jax_server_and_client(pair, reference):
    got = _run_pair(*pair)
    assert len(got) == len(reference)
    for step, (a, b) in enumerate(zip(got, reference)):
        assert a == b, (step, a, b)


def _auth_outcomes(server_pkg, client_pkg) -> list:
    S, C = pkg(server_pkg), pkg(client_pkg)
    out = []
    with servers(S, 1, auth_key="sekret") as (_, srvs):
        for key in (None, "wrong", "sekret"):
            st = client(C, srvs, auth_key=key)
            try:
                out.append((key, "ok", len(st.apps().get_all())))
            except C.storage.StorageError as e:
                out.append((key, type(e).__name__,
                            str(e).split(": ", 1)[1]))
            out.append((key, st.client_for("METADATA").health_check()))
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_auth_refusals_match_jax(pair):
    """A missing or wrong ``X-PIO-Storage-Key`` is refused with the JAX
    server's 401 body, and the health probe reads False."""
    want = _auth_outcomes(JAX, JAX)
    assert want[0][1] == "StorageError" and "HTTP 401" in want[0][2]
    assert _auth_outcomes(*pair) == want


def _resumed_scan(server_pkg, client_pkg, monkeypatch):
    """A bulk scan whose first fetch drops after 100 bytes: the rows it
    returns and the offsets its fetches asked for."""
    S, C = pkg(server_pkg), pkg(client_pkg)
    offsets, state = [], {"first": True}
    real = urllib.request.urlopen

    class Dropping:
        def __init__(self, resp):
            self._resp, self._served = resp, False

        def read(self, n=-1):
            if self._served:
                self._resp.close()
                raise ConnectionResetError("injected drop")
            self._served = True
            return self._resp.read(100)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def flaky(req, timeout=None):
        url = getattr(req, "full_url", req)
        if "/storage/events/scan/" in url and "offset=" in url:
            offsets.append(int(url.rsplit("offset=", 1)[1]))
            if state["first"]:
                state["first"] = False
                return Dropping(real(req, timeout=timeout))
        return real(req, timeout=timeout)

    with servers(S, 1) as (_, srvs):
        st = client(C, srvs, retries=2)
        st.events().init(5)
        events = [C.Event(event="rate", entity_type="user",
                          entity_id=f"u{i}", target_entity_type="item",
                          target_entity_id=f"i{i % 7}",
                          properties={"rating": float(i)},
                          event_time=dt.datetime(2026, 1, 1, tzinfo=UTC)
                          + dt.timedelta(seconds=i)) for i in range(300)]
        st.events().insert_batch(events, 5)
        monkeypatch.setattr(urllib.request, "urlopen", flaky)
        cols = st.events().find_columnar(5, value_property="rating")
        monkeypatch.setattr(urllib.request, "urlopen", real)
        spools = srvs[0].scans.live_count()
        spool_dir = srvs[0].scans._dir
    return column_rows(cols), offsets, spools, os.path.exists(spool_dir)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_scan_resumes_after_a_dropped_connection_like_jax(pair, monkeypatch):
    """The second fetch resumes at the 100 bytes received; the scan is
    released once received and the spool directory goes with the
    server."""
    want = _resumed_scan(JAX, JAX, monkeypatch)
    got = _resumed_scan(*pair, monkeypatch)
    assert got == want
    rows, offsets, spools, dir_left = got
    assert len(rows) == 300 and offsets[:2] == [0, 100]
    assert spools == 0 and not dir_left


def test_scan_spools_are_reaped_after_their_ttl():
    """An abandoned scan's spool file is removed once its TTL passes,
    checked on the next access, as in the JAX registry."""
    P = pkg(PORT)
    reg = P.server._ScanRegistry(ttl=0.05)
    try:
        scan = reg.create(lambda f: f.write(b"x" * 10))
        path = reg.path_for(scan["scan_id"])["path"]
        assert scan["bytes"] == 10 and os.path.exists(path)
        import time

        time.sleep(0.12)
        assert reg.live_count() == 0 and not os.path.exists(path)
        assert reg.path_for(scan["scan_id"]) is None
    finally:
        reg.close()
    assert not os.path.exists(reg._dir)


def test_json_lane_over_rest_matches_a_local_event_log(tmp_path):
    """``insert_json_batch`` through the port's client reaches the
    server's event log encoder: the ids and codes it returns and the
    rows it stores equal a local event log's; a memory-backed server
    (either package's) answers "unsupported"."""
    P = pkg(PORT)
    rows = [{"event": "rate", "entityType": "user", "entityId": f"u{i}",
             "targetEntityType": "item", "targetEntityId": f"i{i % 3}",
             "properties": {"rating": float(i)},
             "eventTime": f"2026-01-01T00:00:0{i}.000Z"} for i in range(5)]
    rows.append({"event": "rate"})
    raw = json.dumps(rows).encode()

    def eventlog(name):
        return P.Storage.from_env({
            "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / name)})

    local = eventlog("local")
    local.events().init(1)
    want = local.events().insert_json_batch(raw, 1, strict=False)
    remote_backend = eventlog("remote")
    with servers(P, backends=[remote_backend]) as (_, srvs):
        st = client(P, srvs)
        st.events().init(1)
        got = st.events().insert_json_batch(raw, 1, strict=False)
        stored = sorted(event_key(e) for e in st.events().find(1))
    assert [len(got[0])] + list(got[1:]) == [len(want[0])] + list(want[1:])
    assert stored == sorted(event_key(e) for e in local.events().find(1))
    local.events().close()
    remote_backend.events().close()
    from predictionio_torch.data.backends.eventlog import JsonRowsUnsupported

    for server_pkg in (JAX, PORT):
        with servers(pkg(server_pkg), 1) as (_, srvs):
            st = client(P, srvs)
            st.events().init(1)
            with pytest.raises(JsonRowsUnsupported):
                st.events().insert_json_batch(raw, 1, strict=False)


@pytest.mark.parametrize("kind", ["memory", "eventlog"])
def test_compact_runs_on_the_server_backend(tmp_path, kind):
    """``compact`` through the client runs on the server's own store:
    None from a store that updates in place, the event log's stats from
    the log."""
    P = pkg(PORT)
    backend = (memory_storage(P) if kind == "memory" else P.Storage.from_env(
        {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
         "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / "el")}))
    with servers(P, backends=[backend]) as (_, srvs):
        st = client(P, srvs)
        app = st.apps().insert("rc")
        st.events().init(app.id)
        ids = st.events().insert_batch(
            [P.Event(event="rate", entity_type="user", entity_id=f"u{i}")
             for i in range(40)], app.id)
        for eid in ids[:30]:
            st.events().delete(eid, app.id)
        stats = st.events().compact(app.id)
        assert len(st.events().find(app.id)) == 10
    if kind == "memory":
        assert stats is None
    else:
        assert stats["dropped"] == 30
        assert stats["after_bytes"] < stats["before_bytes"]
        backend.events().close()


def test_keepalive_survives_short_circuit_responses():
    """Responses sent before the handler reads the request body (an
    auth denial, an unknown route) still drain it, so the next request
    on the same keep-alive connection parses cleanly."""
    import http.client

    P = pkg(PORT)
    with servers(P, 1, auth_key="sekret") as (_, srvs):
        conn = http.client.HTTPConnection("127.0.0.1", srvs[0].port)
        body = json.dumps({"app_id": 1, "junk": "x" * 4096})
        conn.request("POST", "/storage/events/init", body=body)
        resp = conn.getresponse()
        assert resp.status == 401 and json.loads(resp.read()) == {
            "message": "Invalid storage key."}
        conn.request("POST", "/storage/events/nope", body=body,
                     headers={"X-PIO-Storage-Key": "sekret"})
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("POST", "/storage/events/init",
                     body=json.dumps({"app_id": 1}),
                     headers={"X-PIO-Storage-Key": "sekret"})
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read()) == {"ok": True}
        conn.close()


def test_status_reads_a_dead_rest_source_as_down():
    """Every repository of a source whose server is gone reads False."""
    P = pkg(PORT)
    with servers(P, 1) as (_, srvs):
        st = client(P, srvs)
        assert st.verify_all_data_objects() == {
            "METADATA": True, "EVENTDATA": True, "MODELDATA": True}
    assert not any(st.verify_all_data_objects().values())
