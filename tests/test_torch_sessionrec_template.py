"""The port's sessionrec template (``predictionio_torch/templates/
sessionrec.py``) against the JAX package's, on the CPU.

The same seeded events (three event names the template reads, one it
does not, tied times, a user with a single event) go into a JAX store
and a port store, memory and eventlog backends both:

- ``SeqDataSource.read_training`` + ``SeqPreparator.prepare`` give the
  JAX package's prepared sequences exactly (vocabularies, codes, times),
  on the columnar path and on the row path;
- ``read_eval``'s leave-last-out fold is the JAX fold: the same training
  columns and the same (query, actual) pairs;
- an engine instance the JAX package trained deploys on the port
  (``prepare_deploy``) and answers like the JAX deployment (the same ids,
  scores within 1e-5), and the port's own ``pio train`` of the template
  learns the next item.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.models.sessionrec import (
    SessionRecParams as JaxSessionRecParams)
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import sessionrec as jax_seq_t
from predictionio_tpu.workflow.deploy import (
    prepare_deploy as jax_prepare_deploy)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import EngineInstance, Model
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.models.sessionrec import SessionRecParams
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import sessionrec as seq_t
from predictionio_torch.workflow.deploy import prepare_deploy
from tests.test_torch_sessionrec import jitted_flax_init
from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

UTC = dt.timezone.utc
ctx = DeviceContext("cpu")
jax_ctx = MeshContext()
N_USERS, N_ITEMS = 20, 9


def _events():
    """(name, user, item, second) rows: seeded walks through the item
    cycle with tied times, a 'like' the template ignores, a one-event
    user."""
    rng = np.random.default_rng(5)
    rows = []
    for u in range(N_USERS):
        start = int(rng.integers(N_ITEMS))
        for t in range(int(rng.integers(3, 12))):
            name = ("view", "buy", "rate", "like")[int(rng.integers(4))]
            rows.append((name, f"u{u}", f"i{(start + t) % N_ITEMS}",
                         int(t // 2)))
    rows.append(("view", "solo", "i1", 3))
    return rows


class Twin:
    """A JAX store and a port store of one backend holding the same
    events, each installed as its package's storage."""

    def __init__(self, backend, tmp_path):
        def env(side):
            if backend == "memory":
                return {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"}
            return {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                    "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / side)}

        self.port = Storage.from_env(env("port"))
        self.jax = JaxStorage.from_env(env("jax"))
        app_id = self.port.apps().insert("seqapp").id
        assert self.jax.apps().insert("seqapp").id == app_id
        for store, cls in ((self.port, Event), (self.jax, JaxEvent)):
            store.events().init(app_id)
            store.events().insert_batch([
                cls(event=name, entity_type="user", entity_id=u,
                    target_entity_type="item", target_entity_id=i,
                    event_time=dt.datetime(2026, 1, 1, tzinfo=UTC)
                    + dt.timedelta(seconds=s))
                for name, u, i, s in _events()], app_id)
        set_storage(self.port)
        jax_set_storage(self.jax)

    def close(self):
        for store in (self.port, self.jax):
            close = getattr(store.events(), "close", None)
            if close is not None:
                close()
        set_storage(None)
        jax_set_storage(None)


@pytest.fixture(params=["memory", "eventlog"])
def twin(request, tmp_path):
    tw = Twin(request.param, tmp_path)
    yield tw
    tw.close()


def _prepared(module, context, **params):
    ds = module.SeqDataSource(module.SeqDataSourceParams(app_name="seqapp",
                                                         **params))
    return module.SeqPreparator(None).prepare(context,
                                              ds.read_training(context))


@pytest.mark.parametrize("columnar", [True, False])
def test_prepared_sequences_equal_jax(twin, columnar):
    got = _prepared(seq_t, ctx, columnar=columnar)
    want = _prepared(jax_seq_t, jax_ctx, columnar=columnar)
    assert list(got.user_ids.keys()) == list(want.user_ids.keys())
    assert list(got.item_ids.keys()) == list(want.item_ids.keys())
    for name in ("user_idx", "item_idx", "times"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(got.user_idx) == sum(r[0] != "like" for r in _events())


def test_leave_last_out_fold_equals_jax(twin):
    params = dict(app_name="seqapp", eval_enabled=True, eval_query_num=4)
    (got,) = seq_t.SeqDataSource(
        seq_t.SeqDataSourceParams(**params)).read_eval(ctx)
    (want,) = jax_seq_t.SeqDataSource(
        jax_seq_t.SeqDataSourceParams(**params)).read_eval(jax_ctx)
    assert got[1] == want[1] == {"protocol": "leave-last-out"}
    assert got[2] == want[2]
    assert all(q["user"] != "solo" for q, _ in got[2])
    a, b = got[0].columns, want[0].columns
    assert a.user_vocab == b.user_vocab and a.item_vocab == b.item_vocab
    for name in ("user_idx", "item_idx", "times"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert seq_t.SeqDataSource(seq_t.SeqDataSourceParams(
        app_name="seqapp")).read_eval(ctx) == []


FAST = dict(dim=16, heads=2, layers=1, max_len=8, dropout=0.0, epochs=3,
            batch_size=16)


def test_jax_trained_instance_answers_like_the_jax_deployment(monkeypatch,
                                                              twin):
    monkeypatch.setenv("PIO_INDEX_KERNEL", "on")
    jax_engine = jax_seq_t.sessionrec_engine()
    with jitted_flax_init():
        jax_instance = jax_run_train(
            jax_engine, jax_seq_t.default_engine_params(
                "seqapp", algo_params=JaxSessionRecParams(**FAST)),
            engine_id="seq",
            engine_factory="predictionio_tpu.templates.sessionrec."
                           "sessionrec_engine",
            storage=twin.jax, ctx=jax_ctx)
    want = jax_prepare_deploy(jax_engine, jax_instance, jax_ctx, twin.jax)
    instance = EngineInstance(**{
        f.name: getattr(jax_instance, f.name)
        for f in dataclasses.fields(EngineInstance)})
    twin.port.engine_instances().insert(instance)
    twin.port.models().insert(Model(
        id=instance.id, models=twin.jax.models().get(instance.id).models))
    got = prepare_deploy(seq_t.sessionrec_engine(), instance, ctx, twin.port)
    assert type(got.models[0]).__module__ == (
        "predictionio_torch.models.sessionrec")
    queries = [{"user": "u0", "num": 3}, {"user": "u4", "num": 50},
               {"user": "u5", "num": 9, "excludeSeen": True},
               {"items": ["i2", "i3"], "num": 4},
               {"items": ["i7"], "num": 9, "excludeSeen": True},
               {"user": "ghost", "num": 3}]
    for q in queries:
        a, b = got.query(q)["itemScores"], want.query(q)["itemScores"]
        assert [s["item"] for s in a] == [s["item"] for s in b], q
        np.testing.assert_allclose([s["score"] for s in a],
                                   [s["score"] for s in b], atol=1e-5,
                                   err_msg=str(q))
    for a, b in zip(got.query_batch(queries), map(got.query, queries)):
        assert ([s["item"] for s in a["itemScores"]]
                == [s["item"] for s in b["itemScores"]])
        np.testing.assert_allclose([s["score"] for s in a["itemScores"]],
                                   [s["score"] for s in b["itemScores"]],
                                   atol=1e-5)
    assert got.models[0].retrieval_stats()["kernel"]["engaged"]


def test_port_engine_trains_and_predicts_the_next_item():
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})
    set_storage(storage)
    try:
        app = storage.apps().insert("cycle")
        storage.events().init(app.id)
        storage.events().insert_batch([
            Event(event="view", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item",
                  target_entity_id=f"i{(u + t) % 8}",
                  event_time=dt.datetime(2026, 1, 1, 0, 0, t, tzinfo=UTC))
            for u in range(24) for t in range(12)], app.id)
        engine = seq_t.sessionrec_engine()
        ep = seq_t.default_engine_params("cycle", algo_params=SessionRecParams(
            dim=32, heads=2, layers=1, max_len=12, dropout=0.0, epochs=25,
            batch_size=32, learning_rate=3e-3))
        model = engine.train(ctx, ep).models[0]
        algo = engine.make_algorithms(ep)[0]
        hits = sum(algo.predict(model, {"user": f"u{u}", "num": 1})
                   ["itemScores"][0]["item"] == f"i{(u + 12) % 8}"
                   for u in range(8))
        assert hits >= 6
        assert algo.predict(model, {"items": ["i2", "i3", "i4"], "num": 1}
                            )["itemScores"][0]["item"] == "i5"
        assert algo.predict(model, {"user": "nobody"}) == {"itemScores": []}
    finally:
        set_storage(None)
