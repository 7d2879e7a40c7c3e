"""The port's sqlite backend against the JAX package's, on the CPU.

Both packages write the same schema with the same microsecond time
encoding, so a database file one writes, the other reads: every record
and event equal, exactly (the same bytes are read back). Also held to
the JAX backend: reopen persistence, strict uninitialized tables,
index ordering and limits, a batch in one transaction, the model blob
inventory, and the health probe's live round trip.
"""

import datetime as dt

import pytest
import torch

from tests.torch_storage_tier import JAX, PORT, UTC, event_key, pkg

torch.set_num_threads(1)


def _sqlite(P, path):
    return P.Storage.from_env({"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
                               "PIO_STORAGE_SOURCES_DB_PATH": str(path)})


def _write(P, st):
    MD = P.metadata
    app = st.apps().insert("shared", "written by one package")
    st.events().init(app.id)
    ch = st.channels().insert("live", app.id)
    st.events().init(app.id, ch.id)
    t0 = dt.datetime(2026, 3, 1, 12, 30, 0, 123456, tzinfo=UTC)
    events = [P.Event(event="rate", entity_type="user", entity_id=f"u{j % 4}",
                      target_entity_type="item", target_entity_id=f"i{j % 3}",
                      properties={"rating": 0.5 * j, "tags": ["a", "b"]},
                      event_time=t0 + dt.timedelta(microseconds=7 * j)
                      ).with_id(f"e{j}") for j in range(12)]
    st.events().insert_batch(events[:10], app.id)
    st.events().insert(events[10], app.id, ch.id)
    st.events().insert(events[11], app.id)
    st.access_keys().insert(MD.AccessKey(key="k" * 64, appid=app.id,
                                         events=["rate"]))
    st.engine_manifests().insert(MD.EngineManifest(id="eng", version="1",
                                                   name="engine"))
    for n, status in enumerate(("COMPLETED", "FAILED", "COMPLETED")):
        st.engine_instances().insert(MD.EngineInstance(
            id=f"inst-{n}", status=status,
            start_time=t0 + dt.timedelta(minutes=n), end_time=t0,
            engine_id="eng", engine_version="1", engine_variant="default",
            engine_factory="f"))
    st.evaluation_instances().insert(MD.EvaluationInstance(
        id="ev-1", status="EVALCOMPLETED", start_time=t0, end_time=t0))
    st.models().insert(MD.Model(id="inst-0", models=b"\x00\x01binary\xff"))
    return app.id, ch.id


def _read(P, st, app_id, ch_id):
    rd = P.metadata.record_to_dict
    return {
        "apps": [rd(a) for a in st.apps().get_all()],
        "channels": [rd(c) for c in st.channels().get_by_app_id(app_id)],
        "keys": [rd(k) for k in st.access_keys().get_all()],
        "manifests": [rd(m) for m in st.engine_manifests().get_all()],
        "latest": rd(st.engine_instances().get_latest_completed(
            "eng", "1", "default")),
        "completed": [i.id for i in st.engine_instances().get_completed(
            "eng", "1", "default")],
        "evaluations": [rd(i) for i in
                        st.evaluation_instances().get_completed()],
        "events": [(e.event_id, event_key(e))
                   for e in st.events().find(app_id)],
        "channel events": [e.event_id for e in
                           st.events().find(app_id, ch_id)],
        "newest": [e.event_id for e in st.events().find(
            app_id, limit=3, reversed=True)],
        "window": [e.event_id for e in st.events().find(
            app_id, start_time=dt.datetime(2026, 3, 1, 12, 30, 0, 123470,
                                           tzinfo=UTC),
            until_time=dt.datetime(2026, 3, 1, 12, 30, 0, 123505,
                                   tzinfo=UTC))],
        "u1": [e.event_id for e in st.events().find(
            app_id, entity_type="user", entity_id="u1")],
        "model": st.models().get("inst-0").models,
        "size": st.models().size("inst-0"),
        "inventory": st.models().list(),
        "props": sorted((k, sorted(v.to_dict().items())) for k, v in
                        st.events().aggregate_properties(app_id,
                                                         "user").items()),
    }


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX),
                                           (PORT, PORT)],
                         ids=["jax-writes-port-reads",
                              "port-writes-jax-reads",
                              "port-writes-port-reads"])
def test_a_database_file_written_by_one_package_reads_in_the_other(
        tmp_path, writer, reader):
    """What the reader sees equals what the JAX package reads back from
    a file it wrote itself."""
    W, R = pkg(writer), pkg(reader)
    st = _sqlite(W, tmp_path / "shared.db")
    ids = _write(W, st)
    st.client_for("METADATA").close()
    got = _read(R, _sqlite(R, tmp_path / "shared.db"), *ids)
    J = pkg(JAX)
    ref = _sqlite(J, tmp_path / "ref.db")
    want = _read(J, ref, *_write(J, ref))
    assert got == want
    assert len(got["events"]) == 11 and got["channel events"] == ["e10"]


@pytest.mark.parametrize("name", [JAX, PORT])
def test_strictness_ordering_and_health_like_jax(tmp_path, name):
    """An uninitialized table raises, removing a missing one is a no-op,
    ``find`` orders by event time either way with a limit, and the
    health probe fails once the connection is closed."""
    P = pkg(name)
    st = _sqlite(P, tmp_path / "db")
    app = st.apps().insert("strict")
    with pytest.raises(P.storage.StorageError):
        st.events().find(app.id)
    st.events().remove(app.id)
    st.events().init(app.id)
    assert st.events().find(app.id) == []
    for m in (5, 1, 3):
        st.events().insert(P.Event(
            event="e", entity_type="u", entity_id=f"x{m}",
            event_time=dt.datetime(2026, 1, 1, 0, m, tzinfo=UTC)), app.id)
    minutes = lambda evs: [e.event_time.minute for e in evs]  # noqa: E731
    assert minutes(st.events().find(app.id)) == [1, 3, 5]
    assert minutes(st.events().find(app.id, reversed=True)) == [5, 3, 1]
    assert minutes(st.events().find(app.id, limit=2)) == [1, 3]
    assert st.verify_all_data_objects() == {
        "METADATA": True, "EVENTDATA": True, "MODELDATA": True}
    with pytest.raises(P.storage.StorageError):
        st.apps().insert("strict")
    st.client_for("METADATA").close()
    assert not any(st.verify_all_data_objects().values())


def test_a_batch_is_one_transaction_and_moves_the_ingest_clock(
        tmp_path, monkeypatch):
    """A batch whose table was never initialized writes nothing; a
    committed batch notes one ingest on the freshness clock."""
    from predictionio_torch.obs import perfacct

    P = pkg(PORT)
    notes = []
    monkeypatch.setattr(perfacct, "note_ingest",
                        lambda ts=None: notes.append(ts))
    st = _sqlite(P, tmp_path / "db")
    events = [P.Event(event="rate", entity_type="user", entity_id=f"u{j}")
              for j in range(5)]
    with pytest.raises(P.storage.StorageError):
        st.events().insert_batch(events, 7)
    assert notes == []
    st.events().init(7)
    ids = st.events().insert_batch(events, 7)
    assert len(set(ids)) == 5 and len(st.events().find(7)) == 5
    assert len(notes) == 1
