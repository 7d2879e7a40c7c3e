"""The port's data plane (``obs/dataobs.py``) against the JAX package's.

The same seeded inputs go through both packages' sketches and
``DataObs`` in one process (``_hash_u64`` keys on Python's ``hash()``,
which is salted per process, so the two are comparable only inside
one): count-min estimates, space-saving heavy hitters, HyperLogLog and
quantile estimates must be equal; ``report()`` after the event
server's 201 lane, the bulk lanes, the stream tail, query coverage, a
schema freeze and the drift after it must be equal but for the clock
readings. The engine server's coverage hook, each package's bulk
storage lanes after ``flush()``, and the worker thread that ends once
idle are held here too.
"""

import collections
import json
import threading
import time
import types

import numpy as np
import pytest

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import EventColumns as JaxColumns
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.obs import dataobs as jax_dataobs
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import EventColumns, Storage
from predictionio_torch.obs import dataobs
from predictionio_torch.serving.engine_server import EngineServer

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

PACKAGES = {"jax": (jax_dataobs, JaxEvent, JaxColumns, JaxStorage),
            "port": (dataobs, Event, EventColumns, Storage)}


def zipf_keys(n=40_000, a=1.4, seed=42):
    rng = np.random.default_rng(seed)
    return [f"u{d}" for d in rng.zipf(a, n)]


def _sketch_outputs(mod):
    keys = zipf_keys()
    exact = collections.Counter(keys)
    uniq = list(exact)
    cms = mod.CountMinSketch(width=1024, depth=4)
    cms.update(mod._hash_u64(uniq),
               np.fromiter(exact.values(), np.int64, len(exact)))
    ss = mod.SpaceSaving(capacity=64)
    for lo in range(0, len(keys), 4096):
        ss.offer_counts(collections.Counter(keys[lo:lo + 4096]))
    hll = mod.HyperLogLog(p=11)
    for lo in range(0, len(keys), 8192):
        hll.add_hashes(mod._hash_u64(keys[lo:lo + 8192]))
    qs = mod.QuantileSketch(budget=128)
    sample = np.random.default_rng(7).lognormal(3.0, 1.0, 20_000)
    for lo in range(0, sample.size, 4096):
        qs.update(sample[lo:lo + 4096])
    return {
        "hashes": mod._hash_u64(uniq[:50]).tolist(),
        "cms": [cms.estimate(k) for k, _ in exact.most_common(30)]
        + [cms.estimate("never-seen")],
        "cms_total": cms.total,
        "space_saving": ss.top(20),
        "hll": hll.estimate(),
        "quantiles": [qs.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
        "summary": qs.summary(),
    }


def test_sketches_match_jax():
    port, jax = _sketch_outputs(dataobs), _sketch_outputs(jax_dataobs)
    assert port == jax
    # and they are what the sketches promise on this stream
    exact = collections.Counter(zipf_keys())
    top = {k: (c, e) for k, c, e in port["space_saving"]}
    for key, true in exact.most_common(5):
        count, err = top[key]
        assert count >= true and count - err <= true
    assert abs(port["hll"] - len(exact)) / len(exact) <= 0.05


def _drive(pkg: str) -> dict:
    """One seeded sequence through a fresh ``DataObs`` of ``pkg``:
    the 201 lane, a freeze, drift after it, the bulk lanes, the tail
    and query coverage; -> its report with the clock readings out."""
    mod, event_cls, cols_cls, _ = PACKAGES[pkg]
    obs = mod.DataObs()
    rng = np.random.default_rng(3)
    users = [f"u{int(d)}" for d in rng.zipf(1.5, 300)]

    def ev(props, name="rate", user="u1", target="i1"):
        return event_cls(event=name, entity_type="user", entity_id=user,
                         target_entity_type="item", target_entity_id=target,
                         properties=props)

    for k, user in enumerate(users[:40]):
        obs.observe_event(1, ev({"rating": float(k % 5) + 0.5,
                                 "note": "x"}, user=user,
                                target=f"i{k % 7}"), payload_bytes=80 + k)
    obs.freeze_schemas("inst-1")
    obs.observe_event(1, ev({"rating": 4.0, "note": "x", "src": "web"}))
    obs.observe_event(1, ev({"rating": "5", "note": "x"}))
    for _ in range(40):
        obs.observe_event(1, ev({"rating": 4.0}))
    obs.observe_event(2, ev({}, name="view"))
    batch = [ev({"rating": 1.0}, user=u, target=f"i{j % 3}")
             for j, u in enumerate(users[40:120])]
    obs.observe_events(1, batch)
    obs.observe_batch(3, [b"buy"] * 5, entity_ids=[b"u1"] * 5,
                      target_ids=[b"i9"] * 5,
                      payload_lens=np.arange(5, dtype=np.int64) + 10)
    names = sorted(set(users))
    cols = cols_cls(
        entity_codes=np.array([names.index(u) for u in users], np.int32),
        target_codes=(np.arange(len(users)) % 4).astype(np.int32),
        name_codes=np.zeros(len(users), np.int32),
        values=np.linspace(0.5, 5.0, len(users)),
        times_us=np.arange(len(users), dtype=np.int64),
        entity_vocab=names, target_vocab=["i0", "i1", "i2", "i3"],
        names=["rate"])
    obs.observe_columnar(4, cols)
    obs.observe_tail(4, cols)
    for refs, unknown in ((1, 0), (1, 1), (2, 1), (1, 0)):
        obs.note_query(refs, unknown)
    assert obs.flush(timeout=10.0)
    report = obs.report(top_n=10)
    for key in ("eps",):
        report.pop(key)
    report["quantiles"].pop("interarrival_ms")
    report["schema"].pop("frozen_at")
    for change in report["schema"]["changes"]:
        change.pop("ts", None)
    return report


def test_report_after_every_seam_matches_jax():
    port, jax = _drive("port"), _drive("jax")
    assert port == jax
    changes = {(c["change"], c["field"]) for c in port["schema"]["changes"]}
    assert {("added", "src"), ("retyped", "rating"),
            ("vanished", "note")} <= changes
    assert port["unknown_ratio"] == 0.4 and port["queries_seen"] == 5
    assert port["tail_events_total"] == 300


class _Deployment:
    def __init__(self, users, items):
        self.models = [types.SimpleNamespace(
            user_ids=BiMap({u: j for j, u in enumerate(users)}),
            item_ids=BiMap({i: j for j, i in enumerate(items)}))]


QUERIES = [{"user": "u1", "num": 3}, {"user": "nobody", "num": 3},
           {"item": "i2"}, {"item": "gone"},
           {"items": ["i1", "i3", "zz"], "user": "u2"},
           {"features": [1, 2]}, ["not", "a", "dict"]]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_engine_server_coverage_hook(pkg):
    """Both engine servers' ``_note_query_coverage`` over the same
    deployment and queries give the same refs and unknown count."""
    server_cls, mod = ((JaxServer, jax_dataobs) if pkg == "jax"
                       else (EngineServer, dataobs))
    fake = types.SimpleNamespace(
        deployment=_Deployment(["u1", "u2"], ["i1", "i2", "i3"]),
        _deployment_lock=threading.Lock())
    mod.DATAOBS.reset()
    try:
        for q in QUERIES:
            server_cls._note_query_coverage(fake, q)
        report = mod.DATAOBS.report()
        # refs: u1, nobody, i2, gone, u2 + i1, i3, zz -> 8, unknown 3
        assert (report["queries_seen"], report["unknown_ratio"]) == (
            8, round(3 / 8, 4))
    finally:
        mod.DATAOBS.reset()


def _bulk(pkg, kind, root):
    mod, event_cls, cols_cls, storage_cls = PACKAGES[pkg]
    env = {"PIO_STORAGE_SOURCES_S_TYPE": kind}
    if kind != "memory":
        env["PIO_STORAGE_SOURCES_S_PATH"] = str(root / pkg)
    storage = storage_cls.from_env(env)
    app = storage.apps().insert("bulk")
    events = storage.events()
    events.init(app.id)
    mod.DATAOBS.reset()
    try:
        events.insert_batch([event_cls(
            event="rate", entity_type="user", entity_id=f"u{k % 6}",
            target_entity_type="item", target_entity_id=f"i{k % 4}",
            properties={"rating": float(k % 5)}) for k in range(30)], app.id)
        cols = cols_cls(
            entity_codes=np.arange(12, dtype=np.int32) % 5,
            target_codes=np.arange(12, dtype=np.int32) % 3,
            name_codes=np.zeros(12, np.int32),
            values=np.linspace(1.0, 4.0, 12),
            times_us=np.arange(12, dtype=np.int64),
            entity_vocab=[f"u{j}" for j in range(5)],
            target_vocab=[f"i{j}" for j in range(3)], names=["buy"])
        events.insert_columnar(cols, app.id, entity_type="user",
                               target_entity_type="item",
                               value_property="rating")
        if kind == "eventlog":
            events.insert_json_batch(json.dumps([
                {"event": "view", "entityType": "user", "entityId": "u9",
                 "eventTime": "2026-01-01T00:00:00.000Z"}] * 3).encode(),
                app.id)
        assert mod.DATAOBS.flush(timeout=10.0)
        report = mod.DATAOBS.report()
        return {"events_total": report["events_total"],
                "rates": sorted((r["event"], r["count"])
                                for r in report["rates"]),
                "cardinality": report["entities"]["cardinality"]}
    finally:
        mod.DATAOBS.reset()
        if kind == "eventlog":
            events.close()


@pytest.mark.parametrize("kind", ["memory", "localfs", "eventlog"])
def test_bulk_lanes_observe_like_jax(kind, tmp_path):
    port, jax = _bulk("port", kind, tmp_path), _bulk("jax", kind, tmp_path)
    assert port == jax
    assert port["events_total"] == 42 + (3 if kind == "eventlog" else 0)


def test_worker_ends_once_idle_and_restarts():
    obs = dataobs.DataObs()
    obs.observe_batch(1, [b"rate"] * 3, entity_ids=[b"u1"] * 3)
    assert obs.flush(timeout=5.0)
    worker = obs._worker
    assert worker is not None
    worker.join(timeout=10.0)
    assert not worker.is_alive()
    obs.observe_batch(1, [b"rate"], entity_ids=[b"u2"])
    assert obs.flush(timeout=5.0)
    assert obs.report()["events_total"] == 4
    again = obs._worker
    if again is not None:
        again.join(timeout=10.0)
        assert not again.is_alive()


def test_timeline_carries_the_data_series():
    from predictionio_torch.obs import timeline

    tl = timeline.Timeline(interval=0.0, capacity=8)
    dataobs.DATAOBS.note_query(4, 1)
    tl.sample(force=True)
    series = tl.series()["series"]
    assert series["data.unknown_ratio"][-1][1] == 0.25
    assert {"data.eps", "data.skew", "prof.overhead"} <= set(series)
    assert time.time() - series["data.eps"][-1][0] < 60
