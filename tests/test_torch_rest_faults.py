"""The port's ``rest`` tier under faults and at its edges, against the
JAX package's, on the CPU.

Each test runs one scenario through both packages (each its own server
and client) and holds the port's outcome to the JAX one: retries of
idempotent reads through a server that comes back, inserts that never
retry, a strict JSON batch's row error, a scan whose server restarts
between its two phases, an unreplicated tier with a shard down,
metadata and models on the first endpoint, rollbacks of failed batch
and metadata writes, the placement filter of the row scan, the server's
scan counters, the event server and ``pio app compact`` over a sharded
tier, keep-alive after a streamed response, a sliding scan TTL and an
engine server's ``/reload`` with the metadata home down. Endpoint URLs
are named by position; every comparison is exact.
"""

import http.client
import json
import threading
import time
import urllib.request

import pytest
import torch

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401
from tests.torch_storage_tier import (JAX, PORT, UTC, client, column_multiset,
                                      memory_storage, pkg, rate_events,
                                      rest_env, servers)

torch.set_num_threads(1)

BOTH = (JAX, PORT)


def _free_port(P) -> int:
    """A port a stopped server just left."""
    with servers(P, 1) as (_, srvs):
        return srvs[0].port


def _retries(name):
    """A dead endpoint: a read raises ``StorageUnavailableError`` after
    its retries, an insert at once; a server that comes up inside the
    retry budget is invisible to a read."""
    P = pkg(name)
    S = P.storage
    port = _free_port(P)
    st = P.Storage.from_env(rest_env([port], retries=0))
    with pytest.raises(S.StorageUnavailableError):
        st.apps().get_all()
    t0 = time.perf_counter()
    with pytest.raises(S.StorageUnavailableError):
        P.Storage.from_env(rest_env([port], retries=3)).events().insert(
            rate_events(P, n=1)[0], 1)
    insert_sec = time.perf_counter() - t0
    backend = memory_storage(P)
    backend.apps().insert("back")
    started = {}

    def bring_up():
        time.sleep(0.05)
        started["server"] = P.server.StorageServer(
            storage=backend, host="127.0.0.1", port=port).start()

    thread = threading.Thread(target=bring_up)
    thread.start()
    try:
        names = [a.name for a in P.Storage.from_env(
            rest_env([port], retries=8)).apps().get_all()]
    finally:
        thread.join(timeout=30)
        started["server"].stop()
    assert not thread.is_alive()
    return names, insert_sec < 0.2


def test_reads_retry_and_inserts_never_do_like_jax():
    assert _retries(PORT) == _retries(JAX) == (["back"], True)


def _strict_json(name, tmp_path):
    """A strict JSON batch with one bad row through a server over an
    event log: the row error arrives as the local store's clean
    ``StorageError``, nothing is appended, a malformed array is a
    ``ValueError``, and the server still takes a good batch."""
    P = pkg(name)
    backend = P.Storage.from_env({
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / name)})
    out = []
    with servers(P, backends=[backend]) as (_, srvs):
        st = client(P, srvs)
        app = st.apps().insert("strictjson")
        st.events().init(app.id)
        bad = json.dumps([
            {"event": "ok", "entityType": "u", "entityId": "u1"},
            {"event": "$badspecial", "entityType": "u", "entityId": "u2"},
        ]).encode()
        with pytest.raises(P.storage.StorageError) as err:
            st.events().insert_json_batch(bad, app.id, strict=True)
        out += [type(err.value).__name__, str(err.value),
                len(st.events().find(app.id))]
        with pytest.raises(ValueError):
            st.events().insert_json_batch(
                b'[{"event":"e","entityType":"u","entityId":"x"} '
                b'{"event":"f","entityType":"u","entityId":"y"}]',
                app.id, strict=True)
        out.append(st.events().insert_json_batch(json.dumps(
            [{"event": "ok", "entityType": "u", "entityId": "u1"}]).encode(),
            app.id)[1])
    backend.events().close()
    return out


def test_a_strict_json_row_error_is_the_local_error_like_jax(tmp_path):
    got, want = (_strict_json(name, tmp_path) for name in (PORT, JAX))
    assert got == want
    assert got[0] == "RowValidationError" and "HTTP 400" not in got[1]
    assert got[2:] == [0, [0]]


def _restart_mid_scan(name):
    """The server restarts (a fresh scan registry) between a scan's
    prepare and its fetch: the client prepares again and completes."""
    P = pkg(name)
    backend = memory_storage(P)
    holder = {"restarted": False}
    with servers(P, backends=[backend]) as (_, srvs):
        port = srvs[0].port
        holder["server"] = srvs[0]
        st = client(P, srvs, retries=2)
        st.events().init(3)
        st.events().insert_batch(rate_events(P, n=50), 3)
        store_cls = P.rest.RestEventStore
        fetch = store_cls._fetch_scan

        def fetch_after_restart(self, scan_id, total, spool):
            if not holder["restarted"]:
                holder["restarted"] = True
                holder["server"].stop()
                holder["server"] = P.server.StorageServer(
                    storage=backend, host="127.0.0.1", port=port).start()
            return fetch(self, scan_id, total, spool)

        store_cls._fetch_scan = fetch_after_restart
        try:
            cols = st.events().find_columnar(3, value_property="rating")
        finally:
            store_cls._fetch_scan = fetch
            holder["server"].stop()
    return column_multiset(cols), holder["restarted"]


def test_a_scan_survives_a_server_restart_like_jax():
    got, want = _restart_mid_scan(PORT), _restart_mid_scan(JAX)
    assert got == want and len(got[0]) == 50 and got[1]


def _unreplicated(name):
    """Two servers, no replicas: metadata and models live on the first;
    with the second down every read fails naming it, and the tier reads
    FAILED."""
    P = pkg(name)
    with servers(P, 2) as (backends, srvs):
        st = client(P, srvs)
        app = st.apps().insert("shapp")
        st.models().insert(P.metadata.Model(id="m1", models=b"\x00\x01"))
        pinned = [b.apps().get_by_name("shapp") is not None
                  for b in backends] + [b.models().get("m1") is not None
                                        for b in backends]
        st.events().init(app.id)
        st.events().insert_batch(rate_events(P, n=20), app.id)
        dead = f"http://127.0.0.1:{srvs[1].port}"
        srvs[1].stop()
        errors = []
        for read in (lambda: st.events().find(app.id),
                     lambda: st.events().find_columnar(app.id)):
            with pytest.raises(P.storage.StorageUnavailableError) as err:
                read()
            errors.append(dead in str(err.value))
        details = st.health_details()["EVENTDATA"]
        return (pinned, errors, [details[f"http://127.0.0.1:{s.port}"]
                                 for s in srvs],
                st.verify_all_data_objects()["EVENTDATA"],
                st.apps().get(app.id).name)


def test_an_unreplicated_tier_fails_loudly_like_jax():
    got, want = _unreplicated(PORT), _unreplicated(JAX)
    assert got == want
    assert got == ([True, False, True, False], [True, True], [True, False],
                   False, "shapp")


def _rollbacks(name):
    """Failed writes leave no copy a read would serve: a batch over both
    shards with one server of two down, and metadata writes with the
    successor replica down."""
    import datetime

    P = pkg(name)
    S, MD = P.storage, P.metadata
    out = []
    with servers(P, 2) as (backends, srvs):
        st = client(P, srvs, replicas=2)
        st.events().init(1)
        batch = rate_events(P, n=20)
        assert len({S.stable_hash(e.entity_id) % 2 for e in batch}) == 2
        srvs[0].stop()
        with pytest.raises(S.StorageUnavailableError):
            st.events().insert_batch(batch, 1)
        out.append(len(backends[1].events().find(1)))
    with servers(P, 3) as (backends, srvs):
        st = client(P, srvs, replicas=2)
        srvs[1].stop()
        t = datetime.datetime(2026, 3, 1, tzinfo=UTC)
        for write in (
                lambda: st.apps().insert("doomed"),
                lambda: st.engine_instances().insert(MD.EngineInstance(
                    id="doomed-inst", status="COMPLETED", start_time=t,
                    end_time=t, engine_id="e", engine_version="0",
                    engine_variant="default", engine_factory="f")),
                lambda: st.models().insert(MD.Model(id="doomed-m",
                                                    models=b"x"))):
            with pytest.raises(S.StorageUnavailableError):
                write()
        out += [backends[0].apps().get_by_name("doomed"),
                backends[0].engine_instances().get("doomed-inst"),
                backends[0].models().get("doomed-m")]
    return out


def test_failed_writes_roll_back_like_jax():
    assert _rollbacks(PORT) == _rollbacks(JAX) == [0, None, None, None]


def _placement_and_counters(name):
    """A server holding several shards' rows sends only the asked-for
    shards' (a row limit after the filter); its ``/storage/stats``
    counts each columnar scan and the rows it served."""
    P = pkg(name)
    with servers(P, 1) as (backends, srvs):
        backends[0].events().init(1)
        backends[0].events().insert_batch(rate_events(P, n=40), 1)
        store = P.rest.RestEventStore(P.rest._Transport(
            f"http://127.0.0.1:{srvs[0].port}", None, 10))
        full = [e.event_id for e in store.find(1)]
        only0 = [e.event_id for e in store.find(
            1, placement_shards=[0], placement_count=2)]
        limited = [e.event_id for e in store.find(
            1, placement_shards=[0], placement_count=2, limit=3)]
        pos = {eid: n for n, eid in enumerate(full)}
        store.find_columnar(1, value_property="rating")
        for h in range(2):
            store.find_columnar(1, shard_index=h, shard_count=2)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srvs[0].port}/storage/stats") as resp:
            stats = json.loads(resp.read())
    return ([pos[e] for e in only0], [pos[e] for e in limited],
            [(s["rows"], s["shard_index"], s["shard_count"])
             for s in stats["columnar_scans"]],
            stats["columnar_scan_count"], stats["columnar_rows_served"],
            stats["live_scan_spools"])


def test_placement_filter_and_scan_counters_match_jax():
    got, want = (_placement_and_counters(name) for name in BOTH)
    assert got == want
    only0, limited, scans, count, rows, spools = got
    assert 0 < len(only0) < 40 and limited == only0[:3]
    assert count == 3 and rows == 80 and spools == 0
    assert scans[1][0] + scans[2][0] == scans[0][0] == 40


def _event_server_and_compact(name, capsys):
    """The event server over a sharded tier routes each POSTed event by
    its entity and reads one back through the fan-out; ``pio app
    compact`` prints the shards' in-place answer."""
    P = pkg(name)
    es_mod = __import__(f"{name}.serving.event_server",
                        fromlist=["EventServer"])
    with servers(P, 2) as (backends, srvs):
        st = client(P, srvs)
        app = st.apps().insert("live-app")
        st.events().init(app.id)
        key = P.metadata.AccessKey.generate(app.id)
        st.access_keys().insert(key)
        es = es_mod.EventServer(storage=st, host="127.0.0.1", port=0).start()
        try:
            base = f"http://127.0.0.1:{es.port}"
            ids = []
            for i in range(12):
                req = urllib.request.Request(
                    f"{base}/events.json?accessKey={key.key}",
                    data=json.dumps({
                        "event": "rate", "entityType": "user",
                        "entityId": f"user_{i}", "targetEntityType": "item",
                        "targetEntityId": f"item_{i % 3}",
                        "properties": {"rating": float(1 + i % 5)},
                        "eventTime": "2026-03-01T00:00:00.000Z"}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req) as resp:
                    ids.append(json.loads(resp.read())["eventId"])
            with urllib.request.urlopen(
                    f"{base}/events/{ids[0]}.json?accessKey={key.key}"
            ) as resp:
                got = json.loads(resp.read())["entityId"]
        finally:
            es.stop()
        per_server = [sorted(e.entity_id for e in b.events().find(app.id))
                      for b in backends]
        P.storage.set_storage(st)
        try:
            capsys.readouterr()
            code = P.cli.main(["app", "compact", "live-app"])
            out = capsys.readouterr().out.splitlines()
        finally:
            P.storage.set_storage(None)
    return per_server, got, code, out


def test_event_server_and_compact_over_a_sharded_tier_like_jax(capsys):
    got = _event_server_and_compact(PORT, capsys)
    assert got == _event_server_and_compact(JAX, capsys)
    per_server, entity, code, out = got
    assert all(per_server) and sum(map(len, per_server)) == 12
    assert entity == "user_0" and code == 0
    assert out == ["Backend stores events in place; nothing to compact."]


def test_compact_prints_each_shards_stats_like_jax(capsys, monkeypatch):
    """A shard's stats and a shard that updates in place, each on its
    line, as the JAX console prints them."""
    lines = []
    for name in BOTH:
        P = pkg(name)
        st = memory_storage(P)
        st.apps().insert("compactapp")
        monkeypatch.setattr(P.commands, "app_compact", lambda *a, **k: [
            {"dropped": 1, "before_bytes": 10, "after_bytes": 5}, None])
        P.storage.set_storage(st)
        try:
            capsys.readouterr()
            assert P.cli.main(["app", "compact", "compactapp"]) == 0
            lines.append(capsys.readouterr().out.splitlines())
        finally:
            P.storage.set_storage(None)
    assert lines[0] == lines[1] == [
        "shard 0: Compacted: dropped 1 records, 10 -> 5 bytes",
        "shard 1: stores events in place; nothing to compact."]


def _keepalive_after_streaming(name):
    """After a streamed NDJSON find, the next request's body on the same
    connection is drained before its 404, and a third request parses."""
    P = pkg(name)
    with servers(P, 1) as (_, srvs):
        st = client(P, srvs)
        st.events().init(1)
        st.events().insert_batch(rate_events(P, n=6), 1)
        conn = http.client.HTTPConnection("127.0.0.1", srvs[0].port,
                                          timeout=10)
        try:
            conn.request("POST", "/storage/events/find",
                         json.dumps({"app_id": 1}).encode())
            r1 = conn.getresponse()
            n = len([x for x in r1.read().split(b"\n") if x])
            conn.request("POST", "/storage/events/bogus",
                         json.dumps({"app_id": 1, "junk": "x" * 200}).encode())
            r2 = conn.getresponse()
            r2.read()
            conn.request("GET", "/storage/stats")
            r3 = conn.getresponse()
            body = json.loads(r3.read())
        finally:
            conn.close()
    return n, r2.status, r3.status, sorted(body)


def test_keepalive_after_a_streamed_find_like_jax():
    got = _keepalive_after_streaming(PORT)
    assert got == _keepalive_after_streaming(JAX)
    assert got[:3] == (6, 404, 200)


def test_a_fetch_slides_the_scan_ttl():
    """A transfer that keeps fetching outlives the TTL; an idle scan is
    reaped after it (margins of 0.8 s against a 2 s TTL)."""
    P = pkg(PORT)
    reg = P.server._ScanRegistry(ttl=2.0)
    try:
        scan = reg.create(lambda f: f.write(b"x" * 64))
        time.sleep(1.2)
        assert reg.path_for(scan["scan_id"]) is not None
        time.sleep(1.2)
        assert reg.path_for(scan["scan_id"]) is not None
        time.sleep(2.5)
        assert reg.path_for(scan["scan_id"]) is None
    finally:
        reg.close()


def _reload_without_the_metadata_home(name):
    """An engine server over a replicated tier reloads its instance from
    the surviving replica after the metadata home stops, and answers."""
    import importlib

    P = pkg(name)
    es_mod = importlib.import_module(f"{name}.serving.engine_server")
    if name == PORT:
        from tests.torch_operator_fixtures import train_const
        device = {"device": "cpu"}
    else:
        from tests.test_servers import train_const
        device = {}
    with servers(P, 3) as (_, srvs):
        st = client(P, srvs, replicas=2)
        engine, _ = train_const(st)
        server = es_mod.EngineServer(engine, "const", host="127.0.0.1",
                                     port=0, storage=st, **device).start()
        try:
            srvs[0].stop()
            base = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(f"{base}/reload",
                                        timeout=30) as resp:
                status = resp.status
            req = urllib.request.Request(
                f"{base}/queries.json", data=json.dumps({"mult": 2}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                answer = json.loads(resp.read())
        finally:
            server.stop()
    return status, answer


def test_reload_survives_the_metadata_home_like_jax():
    assert _reload_without_the_metadata_home(PORT) == \
        _reload_without_the_metadata_home(JAX) == (200, {"result": 6.0})
