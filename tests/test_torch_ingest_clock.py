"""The bulk ingest lanes move the freshness clock, as the JAX lanes do.

``pio_model_staleness_seconds`` counts how long the oldest event not
yet in a servable model has waited. The JAX package notes an ingest on
every accepted batch of its bulk lanes (``insert_batch``,
``insert_json_batch``, ``insert_columnar``); the same calls on the
port's memory, localfs and eventlog stores must leave the port's
``perfacct`` ledger in the state the JAX ledger is left in: an ingest
horizon set, the gauge above zero until a publish, zero after it.
"""

import datetime as dt
import json

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import EventColumns as JaxColumns
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import perfacct as jax_perfacct
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import EventColumns, Storage
from predictionio_torch.obs import metrics, perfacct

CASES = [("memory", "insert_batch"), ("localfs", "insert_batch"),
         ("eventlog", "insert_batch"), ("eventlog", "insert_json_batch"),
         ("memory", "insert_columnar"), ("localfs", "insert_columnar"),
         ("eventlog", "insert_columnar")]

ROWS = [("u1", "i1", 4.0), ("u2", "i1", 3.5), ("u1", "i2", 5.0)]


def _store(package, kind, root):
    env = {"PIO_STORAGE_SOURCES_S_TYPE": kind}
    if kind != "memory":
        env["PIO_STORAGE_SOURCES_S_PATH"] = str(root / package)
    storage = (JaxStorage if package == "jax" else Storage).from_env(env)
    app = storage.apps().insert("clock")
    storage.events().init(app.id)
    return storage, app.id


def _ingest(package, storage, app_id, lane):
    event_cls = JaxEvent if package == "jax" else Event
    cols_cls = JaxColumns if package == "jax" else EventColumns
    events = storage.events()
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    if lane == "insert_batch":
        events.insert_batch([
            event_cls(event="rate", entity_type="user", entity_id=u,
                      target_entity_type="item", target_entity_id=i,
                      properties={"rating": v},
                      event_time=t0 + dt.timedelta(seconds=k))
            for k, (u, i, v) in enumerate(ROWS)], app_id)
    elif lane == "insert_json_batch":
        raw = json.dumps([
            {"event": "rate", "entityType": "user", "entityId": u,
             "targetEntityType": "item", "targetEntityId": i,
             "properties": {"rating": v},
             "eventTime": f"2026-01-01T00:00:0{k}.000Z"}
            for k, (u, i, v) in enumerate(ROWS)]).encode()
        ids = events.insert_json_batch(raw, app_id)[0]
        assert all(ids)
    else:
        users = sorted({u for u, _, _ in ROWS})
        items = sorted({i for _, i, _ in ROWS})
        cols = cols_cls(
            entity_codes=np.array([users.index(u) for u, _, _ in ROWS],
                                  np.int32),
            target_codes=np.array([items.index(i) for _, i, _ in ROWS],
                                  np.int32),
            name_codes=np.zeros(len(ROWS), np.int32),
            values=np.array([v for _, _, v in ROWS], np.float64),
            times_us=np.arange(len(ROWS), dtype=np.int64) * 1_000_000,
            entity_vocab=users, target_vocab=items, names=["rate"])
        assert events.insert_columnar(
            cols, app_id, entity_type="user", target_entity_type="item",
            value_property="rating") == len(ROWS)


def _staleness(registry) -> float:
    return registry.get("pio_model_staleness_seconds").labels().value


@pytest.mark.parametrize("kind,lane", CASES)
def test_bulk_lanes_move_the_ingest_clock_like_jax(kind, lane, tmp_path):
    states, waited_by = {}, {}
    for package, acct, registry in (
            ("jax", jax_perfacct, jax_metrics.REGISTRY),
            ("port", perfacct, metrics.REGISTRY)):
        storage, app_id = _store(package, kind, tmp_path)
        acct.LEDGER.clear()
        try:
            before = acct.LEDGER.snapshot()["last_ingest_unix"]
            _ingest(package, storage, app_id, lane)
            snap = acct.LEDGER.snapshot()
            waited = acct.LEDGER.staleness_seconds(
                now=snap["last_ingest_unix"] + 5.0)
            gauge = _staleness(registry)
            waited_by[package] = waited
            acct.LEDGER.note_publish()
            after = acct.LEDGER.snapshot()
            states[package] = {
                "horizon_before": before,
                "horizon_set": snap["last_ingest_unix"] is not None,
                # the oldest unreflected ingest is at or before the last
                # one, which the snapshot rounds to the millisecond
                "waited_5s": waited >= 5.0 - 1e-3,
                "gauge_is_waited": gauge == waited,
                "staleness_after_publish": after["staleness_seconds"],
                "gauge_after_publish": _staleness(registry)}
        finally:
            acct.LEDGER.clear()
            if kind == "eventlog":
                storage.events().close()
    assert states["port"] == states["jax"]
    port = states["port"]
    assert port["horizon_before"] is None and port["horizon_set"]
    assert port["waited_5s"] and port["gauge_is_waited"]
    # the port notes each accepted batch once, so its clock counts from
    # the last ingest (the JAX default columnar lane notes twice)
    assert abs(waited_by["port"] - 5.0) <= 1e-3
    assert port["staleness_after_publish"] == 0.0
    assert port["gauge_after_publish"] == 0.0
