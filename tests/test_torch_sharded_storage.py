"""The port's sharded, replicated ``rest`` tier against the JAX
package's, on the CPU.

Each test builds the same storage-server layout in both packages
(three servers over memory storage unless it says otherwise), sends the
same seeded events and the same faults through each package's own
client, and holds the port's observable outcome to the JAX one,
exactly: which server holds which rows (``stable_hash(entity_id) % N``
routing, successor replicas), what reads return with a server stopped,
which writes succeed and which raise ``StorageUnavailableError`` naming
the down endpoint, the ``repair`` and ``repair_meta`` counts under the
same divergence, ``pio storagerepair``'s and ``pio status``'s lines
and exit codes. Endpoint URLs differ between the two layouts (their
ports), so results name servers by position.
"""

import contextlib
import dataclasses
import re

import pytest
import torch

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401
from tests.torch_storage_tier import (JAX, PORT, client, column_multiset,
                                      event_key, memory_storage, pkg,
                                      rate_events, servers)

torch.set_num_threads(1)

BOTH = (JAX, PORT)


def _by_position(text: str, srvs) -> str:
    """``text`` with endpoints named by position and the wall-clock
    seconds of an open circuit's next probe left out."""
    for n, s in enumerate(srvs):
        text = text.replace(f"http://127.0.0.1:{s.port}", f"<server {n}>")
    return re.sub(r"next probe in [0-9.]+s", "next probe in ...", text)


def _stamped(P, n=60, seed=0):
    """Seeded rate events with fixed ids, so both packages name the
    same rows."""
    return [e.with_id(f"ev{j}") for j, e in
            enumerate(rate_events(P, n=n, seed=seed))]


def _holdings(backends, app_id=1):
    return [sorted(e.event_id for e in b.events().find(app_id))
            for b in backends]


def _routing(name, replicas, n_servers):
    P = pkg(name)
    with servers(P, n_servers) as (backends, srvs):
        st = client(P, srvs, replicas=replicas)
        st.events().init(1)
        ids = st.events().insert_batch(_stamped(P), 1)
        st.events().insert(_stamped(P, n=1, seed=5)[0].with_id("single"), 1)
        st.events().init(2)
        cols = memory_storage(P)
        cols.events().init(1)
        cols.events().insert_batch(rate_events(P, n=40, seed=3), 1)
        n = st.events().insert_columnar(
            cols.events().find_columnar(1, value_property="rating"), 2,
            entity_type="user", target_entity_type="item",
            value_property="rating")
        bulk = [sorted(column_multiset(b.events().find_columnar(
            2, value_property="rating"))) for b in backends]
        merged = st.events().find_columnar(1, value_property="rating")
        return (ids, _holdings(backends), n, bulk, column_multiset(merged),
                sorted(event_key(e) for e in st.events().find(1)))


@pytest.mark.parametrize("replicas,n_servers", [(1, 2), (1, 3), (2, 3),
                                                (3, 3)])
def test_routing_and_replica_placement_match_jax(replicas, n_servers):
    """Row and bulk writes land on the same servers in both packages,
    and the merged reads return every row once."""
    got, want = (_routing(name, replicas, n_servers) for name in BOTH)
    assert got == want
    ids, holdings, n, _, merged, _ = got
    assert sum(map(len, holdings)) == replicas * len(ids) + replicas
    assert n == 40 and len(merged) == len(ids) + 1


def _outage(name, down):
    """Three servers, REPLICAS=2, server ``down`` stopped: what reads,
    status, writes and metadata calls do."""
    P = pkg(name)
    S = P.storage
    with servers(P, 3) as (backends, srvs):
        st = client(P, srvs, replicas=2)
        app = st.apps().insert("outage")
        st.events().init(app.id)
        events = _stamped(P)
        st.events().insert_batch(events, app.id)
        st.models().insert(P.metadata.Model(id="m", models=b"blob"))
        srvs[down].stop()
        out = {
            "find": sorted(event_key(e) for e in st.events().find(app.id)),
            "columnar": column_multiset(st.events().find_columnar(
                app.id, value_property="rating")),
            "newest": [event_key(e) for e in st.events().find(
                app.id, limit=5, reversed=True)],
            "host shards": [len(st.events().find_columnar(
                app.id, shard_index=h, shard_count=2)) for h in range(2)],
            "get": event_key(st.events().get("ev7", app.id)),
            "status": {repo: (d["serving"], d["degraded"],
                              [d["endpoints"][f"http://127.0.0.1:{s.port}"]
                               for s in srvs])
                       for repo, d in st.serving_status().items()},
            "details": {repo: [d[f"http://127.0.0.1:{s.port}"]
                               for s in srvs]
                        for repo, d in st.health_details().items()},
            "app": st.apps().get_by_name("outage").id,
            "model": st.models().get("m").models,
        }
        writes = []
        for u in range(13):
            e = dataclasses.replace(events[0], entity_id=f"u{u}",
                                    event_id=f"new{u}")
            # the class may be the circuit-open subclass, depending on
            # how many failures the endpoint's breaker has counted: the
            # outcome is that the write failed, naming the endpoint
            try:
                st.events().insert(e, app.id)
                writes.append((u, "ok"))
            except S.StorageUnavailableError as err:
                writes.append((u, "unavailable", f"<server {down}>" in
                               _by_position(str(err), srvs)))
        out["writes"] = writes
        try:
            st.apps().insert("second")
            out["meta write"] = "ok"
        except S.StorageUnavailableError as err:
            out["meta write"] = ("unavailable", f"<server {down}>" in
                                 _by_position(str(err), srvs))
        return out


@pytest.mark.parametrize("down", [0, 1, 2])
def test_failover_reads_and_loud_writes_match_jax(down):
    """With one of three servers down and REPLICAS=2, every read still
    returns every row (from a surviving replica), the tiers read serving
    and degraded (``serving_status``) with the down endpoint named
    (``health_details``), a write whose shard needs the down server raises
    ``StorageUnavailableError`` naming it while the others land, as in
    the JAX package."""
    got, want = (_outage(name, down) for name in BOTH)
    assert got == want
    assert len(got["find"]) == 60 and sum(got["host shards"]) == 60
    assert got["status"]["EVENTDATA"][:2] == (True, True)
    assert got["status"]["METADATA"][:2] == (True, True)
    assert got["details"]["EVENTDATA"] == [k != down for k in range(3)]
    assert {w[1] for w in got["writes"]} == {"ok", "unavailable"}
    assert all(w[2] for w in got["writes"] if w[1] != "ok")


def _rollbacks(name):
    """Two servers, REPLICAS=2, server 0 stopped: each failing write
    leaves nothing on the live server."""
    P = pkg(name)
    S = P.storage
    with servers(P, 2) as (backends, srvs):
        st = client(P, srvs, replicas=2)
        st.events().init(1)
        srvs[0].stop()

        def uid_for_shard(k):
            i = 0
            while S.stable_hash(f"user_{i}") % 2 != k:
                i += 1
            return f"user_{i}"

        out = []
        ev = rate_events(P, n=1)[0]
        for k in (0, 1):
            with pytest.raises(S.StorageUnavailableError):
                st.events().insert(dataclasses.replace(
                    ev, entity_id=uid_for_shard(k)), 1)
            out.append(len(backends[1].events().find(1)))
        with pytest.raises(S.StorageUnavailableError):
            st.events().insert_batch(rate_events(P, n=20), 1)
        out.append(len(backends[1].events().find(1)))
        return out


def test_partial_replica_writes_roll_back_like_jax():
    assert _rollbacks(PORT) == _rollbacks(JAX) == [0, 0, 0]


def _diverge_events(P, backends, case):
    """Make the replicas of app 1 diverge by writing straight into the
    servers' own storage, as a partial failure would."""
    S = P.storage
    rows = backends[1].events().find(1)
    if case == "replica lost rows":
        # server 1 replicates shard 0 (owner: server 0)
        lost = [e for e in rows if S.stable_hash(e.entity_id) % 3 == 0][:4]
        for e in lost:
            backends[1].events().delete(e.event_id, 1)
    elif case == "replica has orphans":
        shard = S.stable_hash("orphan_u") % 3
        base = rate_events(P, n=2, seed=9)
        for n, e in enumerate(base):
            backends[(shard + 1) % 3].events().insert(dataclasses.replace(
                e, entity_id="orphan_u", event_id=f"orphan{n}"), 1)
    elif case == "both":
        _diverge_events(P, backends, "replica lost rows")
        _diverge_events(P, backends, "replica has orphans")


def _repair(name, case):
    P = pkg(name)
    with servers(P, 3) as (backends, srvs):
        st = client(P, srvs, replicas=2)
        st.events().init(1)
        if case == "columnar copies":
            src = memory_storage(P)
            src.events().init(1)
            src.events().insert_batch(rate_events(P, n=45), 1)
            st.events().insert_columnar(
                src.events().find_columnar(1, value_property="rating"), 1,
                entity_type="user", target_entity_type="item",
                value_property="rating")
        else:
            st.events().insert_batch(_stamped(P, n=45), 1)
            _diverge_events(P, backends, case)
        first = st.events().repair(1)
        second = st.events().repair(1)
        holdings = ([sorted(event_key(e) for e in b.events().find(1))
                     for b in backends] if case == "columnar copies"
                    else _holdings(backends))
        return first, second, holdings


@pytest.mark.parametrize("case", ["replica lost rows", "replica has orphans",
                                  "both", "columnar copies"])
def test_event_repair_counts_match_jax(case):
    """``ShardedRestEventStore.repair`` copies back what a replica lost
    and deletes what the owner lacks, counting as the JAX repair does,
    then finds nothing to do; columnar-ingested copies (per-server ids)
    match by content."""
    got, want = _repair(PORT, case), _repair(JAX, case)
    assert got == want
    first, second, _ = got
    assert second == {"copied": 0, "deleted": 0}
    if case == "columnar copies":
        assert first == {"copied": 0, "deleted": 0}


def _diverge_meta(P, backends, case):
    MD = P.metadata
    owner, replica = backends[0], backends[1]
    if case == "replica lost an instance":
        replica.engine_instances().delete("inst-1")
    elif case == "replica has a stale app":
        app = replica.apps().get_by_name("repl-app")
        app.description = "stale"
        replica.apps().update(app)
    elif case == "replica has an extra model":
        replica.models().insert(MD.Model(id="orphan", models=b"zz"))
    elif case == "replica has other model bytes":
        replica.models().insert(MD.Model(id="inst-1", models=b"changed"))
    elif case == "blank owner":
        for a in owner.apps().get_all():
            owner.apps().delete(a.id)


def _repair_meta(name, case):
    import datetime as dt

    P = pkg(name)
    MD = P.metadata
    with servers(P, 3) as (backends, srvs):
        st = client(P, srvs, replicas=2)
        app = st.apps().insert("repl-app")
        st.access_keys().insert(MD.AccessKey(key="k" * 64, appid=app.id,
                                             events=[]))
        st.channels().insert("live", app.id)
        st.engine_manifests().insert(MD.EngineManifest(id="eng", version="0",
                                                       name="eng"))
        t = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
        st.engine_instances().insert(MD.EngineInstance(
            id="inst-1", status="COMPLETED", start_time=t, end_time=t,
            engine_id="eng", engine_version="0", engine_variant="default",
            engine_factory="f"))
        st.models().insert(MD.Model(id="inst-1", models=b"\x01\x02"))
        _diverge_meta(P, backends, case)
        rest_client = st.client_for("METADATA")
        try:
            first = rest_client.repair_meta()
        except P.storage.StorageError as e:
            return type(e).__name__, _by_position(str(e), srvs)
        second = rest_client.repair_meta()
        same = [MD.record_to_dict(r) for r in backends[0].engine_instances(
        ).get_all()] == [MD.record_to_dict(r) for r in
                         backends[1].engine_instances().get_all()]
        blobs = [sorted((m["id"], m["sha256"]) for m in b.models().list())
                 for b in backends[:2]]
        return first, second, same, blobs[0] == blobs[1], \
            backends[2].apps().get_all() == []


@pytest.mark.parametrize("case", ["replica lost an instance",
                                  "replica has a stale app",
                                  "replica has an extra model",
                                  "replica has other model bytes",
                                  "blank owner"])
def test_metadata_repair_counts_match_jax(case):
    """``RestStorageClient.repair_meta``: owner-authoritative over the
    first R endpoints, blobs compared by sha256, a blank owner refused;
    the counts (or the refusal) equal the JAX client's."""
    got, want = _repair_meta(PORT, case), _repair_meta(JAX, case)
    assert got == want
    if case == "blank owner":
        assert got[0] == "StorageError" and "refused" in got[1]
    else:
        assert got[0]["copied"] + got[0]["deleted"] == 1
        assert got[1:] == ({"copied": 0, "deleted": 0}, True, True, True)


@contextlib.contextmanager
def _installed(P, st):
    P.storage.set_storage(st)
    try:
        yield
    finally:
        P.storage.set_storage(None)


def _cli_run(P, argv, capsys, srvs):
    code = P.cli.main(argv)
    lines = _by_position(capsys.readouterr().out, srvs).splitlines()
    # endpoints print sorted by URL, whose ports differ between layouts:
    # compare each block's endpoint lines as a set
    blocks = []
    for line in lines:
        if line.startswith("  ") and blocks:
            blocks[-1][1].append(line)
        else:
            blocks.append((line, []))
    return code, [(head, sorted(rest)) for head, rest in blocks]


def _storagerepair(name, capsys, layout):
    P = pkg(name)
    n, replicas = {"replicated": (3, 2), "unreplicated": (2, 1)}[layout]
    with servers(P, n) as (backends, srvs):
        st = client(P, srvs, replicas=replicas)
        app = st.apps().insert("repair-app")
        st.events().init(app.id)
        st.events().insert_batch(_stamped(P, n=45), app.id)
        if layout == "replicated":
            _diverge_events(P, backends, "both")
            backends[1].apps().delete(app.id)
        with _installed(P, st):
            runs = []
            for _ in range(2):
                try:
                    runs.append(_cli_run(P, ["storagerepair", "--appname",
                                             "repair-app"], capsys, srvs))
                except P.storage.StorageError as e:
                    runs.append((type(e).__name__,
                                 _by_position(str(e), srvs),
                                 capsys.readouterr().out.splitlines()))
        return runs


@pytest.mark.parametrize("layout", ["replicated", "unreplicated"])
def test_storagerepair_cli_matches_jax(layout, capsys):
    """``pio storagerepair``: the same lines and exit code as the JAX
    console, repairing both tiers and then finding nothing; on an
    unreplicated source both tiers are skipped and the command fails."""
    got, want = (_storagerepair(name, capsys, layout) for name in BOTH)
    assert got == want
    if layout == "replicated":
        assert got[0][0] == 0 and [head for head, _ in got[1][1]] == [
            "Event replica repair for app repair-app: 0 rows copied, "
            "0 rows deleted",
            "Metadata/model replica repair: 0 records copied, 0 records "
            "deleted"]
    else:
        # both tiers skipped: the console reports the events tier's
        # StorageError and exits 1
        assert got[0][0] == 1 and [head for head, _ in got[0][1]] == [
            "Events: skipped (EVENTDATA is sharded but not replicated "
            "(REPLICAS=1) — nothing to repair)",
            "Metadata/models: skipped (METADATA/MODELDATA is not a "
            "replicated rest source — nothing to repair (configure "
            "REPLICAS>1 on its source))"]


def _status(name, capsys, stop):
    P = pkg(name)
    with servers(P, 3) as (_, srvs):
        st = client(P, srvs, replicas=2)
        for k in stop:
            srvs[k].stop()
        with _installed(P, st):
            return _cli_run(P, ["status"], capsys, srvs)


@pytest.mark.parametrize("stop", [(), (2,), (0,), (0, 1)],
                         ids=["all-up", "event-only", "meta-home",
                              "meta-tier"])
def test_status_exit_codes_match_jax(stop, capsys):
    """``pio status``: 0 with everything up, 2 while every tier still
    serves through replicas, 1 when a tier cannot serve; each endpoint
    named, as the JAX console prints them."""
    got, want = (_status(name, capsys, stop) for name in BOTH)
    assert got == want
    assert got[0] == {(): 0, (2,): 2, (0,): 2, (0, 1): 1}[stop]


@pytest.mark.parametrize("ports,replicas", [((7001, 7002), 3),
                                            ((7001,), 2)])
def test_impossible_replica_counts_are_refused_like_jax(ports, replicas):
    from tests.torch_storage_tier import rest_env

    messages = []
    for name in BOTH:
        P = pkg(name)
        with pytest.raises(P.storage.StorageError) as err:
            P.Storage.from_env(rest_env(ports, replicas)).events()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_unsharded_sources_refuse_repair_like_jax():
    """``repair_events`` on a plain source is a CommandError (nothing to
    check), in both packages."""
    outcomes = []
    for name in BOTH:
        P = pkg(name)
        st = memory_storage(P)
        st.apps().insert("plain")
        with pytest.raises(P.commands.CommandError) as err:
            P.commands.repair_events("plain", storage=st)
        with pytest.raises(P.commands.CommandError) as meta_err:
            P.commands.repair_metadata(storage=st)
        outcomes.append((str(err.value), str(meta_err.value)))
    assert outcomes[0] == outcomes[1]
