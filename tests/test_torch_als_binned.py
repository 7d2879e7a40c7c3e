"""ALS from prebuilt sides and the binned lane of the engine, on the CPU.

- ``ALSTrainer.from_sides`` trains to exactly the factors of the COO
  constructor (``solver="direct"``, f32), over both binning routes.
- The port's ``from_sides`` against JAX ``ALSTrainer.from_sides``, each
  over the sides its own ``bin_columnar`` made of the same events, from
  the JAX trainer's initial factors, with ``tests/test_torch_als.py``'s
  tolerances: direct/f32 factors to a relative Frobenius error of 1e-4
  and held-out RMSE to 1e-5; CG/bf16 within 3x the spread the JAX
  trainer shows against itself under a 1e-6 nudge of its start, RMSE to
  1e-2.
- ``recommendation_engine`` trained through ``workflow/train`` on an
  ``eventlog`` store: the binned lane runs one ``bin_columnar``; a
  retrain on unchanged events makes no scan and trains the same factors
  from the layout cache; one more event changes the fingerprint and
  bins again. With ``solver="direct"`` the answers equal those of
  ``binned=False`` (bit for bit: the same layout) and those of the JAX
  engine trained on its own log of the same events (a problem whose
  predictions converge from any start: rank 2, lambda 1, 40 iterations;
  scores to 1e-4, items equal but for near-ties within that). ``pio
  train`` logs the lane; the two-tower engine trains from
  ``read_prepared``.
"""

import datetime as dt
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.data.backends.eventlog import (
    EventLogEventStore as JaxStore)
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine)
from predictionio_tpu.workflow.deploy import (
    prepare_deploy as jax_prepare_deploy)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch.core.params import EngineParams
from predictionio_torch.data.backends.eventlog import EventLogEventStore
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import (Storage, get_storage,
                                             set_storage)
from predictionio_torch.models.twotower import TwoTowerParams
from predictionio_torch.ops import als, ragged
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates.recommendation import (
    RecoDataSourceParams, recommendation_engine)
from predictionio_torch.templates.twotower import twotower_engine
from predictionio_torch.tools import cli
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.train import run_train

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

UTC = dt.timezone.utc
RECO_FACTORY = "predictionio_torch.templates.recommendation.recommendation_engine"
JAX_FACTORY = "predictionio_tpu.templates.recommendation.recommendation_engine"
PRECISION = {
    "direct-f32": dict(solver="direct", compute_dtype="float32",
                       cg_dtype="float32"),
    "cg-bf16": {},     # the defaults: jacobi CG, 6 steps, bf16
}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ratings(n_users=300, n_items=200, nnz=7000, seed=4):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.zipf(1.3, nnz) % n_items
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
    r = 3.0 + np.einsum("nk,nk->n", U[u], V[i]) / 2.0 + rng.normal(0, .3, nnz)
    return u, i, np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0).astype(np.float32)


@pytest.mark.parametrize("native", [False, True])
def test_from_sides_trains_identically_to_the_coo_constructor(monkeypatch,
                                                              native):
    if native:
        monkeypatch.setattr(ragged, "_NATIVE_MIN_NNZ", 0)
    u, i, v = _ratings(500, 200, 40_000)
    cfg = als.ALSConfig(rank=8, iterations=3, block_size=512,
                        **PRECISION["direct-f32"])
    want = als.ALSTrainer((u, i, v), 500, 200, cfg, device="cpu").run()
    user = als.build_compressed_side(u, i, v, 500, cfg, 1, None)
    item = als.build_compressed_side(i, u, v, 200, cfg, 1, None)
    trainer = als.ALSTrainer.from_sides(user, item, 500, 200, len(v), cfg,
                                        device="cpu")
    assert not trainer.cache_hit and trainer.bin_sec == 0.0
    got = trainer.run()
    np.testing.assert_array_equal(want.user_factors, got.user_factors)
    np.testing.assert_array_equal(want.item_factors, got.item_factors)


def _binned_pair(tmp_path, n_users=300, n_items=200):
    """Both packages' bin_columnar over their own log of the same rate
    events (ids first seen in user order), every 20th held out."""
    u, i, r = _ratings(n_users, n_items)
    order = np.lexsort((np.arange(len(u)), u))      # users first seen 0..
    u, i, r = u[order], i[order], r[order]
    out = []
    for cls, store_cls in ((Event, EventLogEventStore), (JaxEvent, JaxStore)):
        store = store_cls(str(tmp_path / cls.__module__))
        store.init(1)
        t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
        store.insert_batch([cls(
            event="rate", entity_type="user", entity_id=f"u{uu}",
            target_entity_type="item", target_entity_id=f"i{ii}",
            properties={"rating": float(rr)},
            event_time=t0 + dt.timedelta(seconds=j))
            for j, (uu, ii, rr) in enumerate(zip(u, i, r))], 1)
        out.append(store.bin_columnar(
            1, value_property="rating", entity_type="user",
            event_names=["rate"], target_entity_type="item", skip_mod=20,
            skip_rem=0, block_size=64,
            row_cost_slots=als.als_row_cost_slots(8)))
        store.close()
    return out


def _jax_from_sides(binned, kw, X0=None, Y0=None):
    t = jax_als.ALSTrainer.from_sides(
        jax_als.side_layout_from_binned(binned.user_side),
        jax_als.side_layout_from_binned(binned.item_side),
        len(binned.entity_vocab), len(binned.target_vocab), binned.n_rows,
        jax_als.ALSConfig(**kw))
    if X0 is not None:
        t._X, t._Y = jnp.asarray(X0), jnp.asarray(Y0)
    return t


@pytest.mark.parametrize("precision", sorted(PRECISION))
def test_from_sides_matches_jax_from_sides_on_one_binned_log(tmp_path,
                                                             precision):
    port_binned, jax_binned = _binned_pair(tmp_path)
    held = tuple(np.asarray(a) for a in port_binned.holdout)
    kw = dict(rank=8, iterations=3, reg=0.05, block_size=64,
              **PRECISION[precision])
    ref = _jax_from_sides(jax_binned, kw)
    trainer = als.ALSTrainer.from_sides(
        als.side_layout_from_binned(port_binned.user_side),
        als.side_layout_from_binned(port_binned.item_side),
        len(port_binned.entity_vocab), len(port_binned.target_vocab),
        port_binned.n_rows, als.ALSConfig(**kw), device="cpu")
    user, item = trainer.sides()
    np.testing.assert_array_equal(user.idx.numpy(), np.asarray(ref._ud[0]))
    np.testing.assert_array_equal(item.idx.numpy(), np.asarray(ref._it[0]))
    assert trainer.transfer_bytes == ref.transfer_bytes
    X0, Y0 = np.array(ref._X), np.array(ref._Y)
    trainer.X, trainer.Y = torch.tensor(X0), torch.tensor(Y0)
    want = ref.run()
    got = trainer.run()
    if precision == "direct-f32":
        tol_u = tol_i = 1e-4
        tol_rmse = 1e-5
    else:
        base = want
        spread_u = spread_i = 0.0
        for seed in range(3):
            noise = np.random.default_rng(seed).normal(size=X0.shape)
            nudged = _jax_from_sides(
                jax_binned, kw, (X0 * (1.0 + 1e-6 * noise)).astype(np.float32),
                Y0).run()
            spread_u = max(spread_u, _rel(nudged.user_factors,
                                          base.user_factors))
            spread_i = max(spread_i, _rel(nudged.item_factors,
                                          base.item_factors))
        tol_u, tol_i = 3 * spread_u, 3 * spread_i
        tol_rmse = 1e-2
    assert _rel(got.user_factors, want.user_factors) <= tol_u
    assert _rel(got.item_factors, want.item_factors) <= tol_i
    assert abs(als.predict_rmse(got, held)
               - jax_als.predict_rmse(want, held)) <= tol_rmse


# -- the engine on an eventlog store ---------------------------------------------

ALS_PARAMS = {"rank": 2, "num_iterations": 40, "lambda_": 1.0,
              "block_size": 64, "solver": "direct",
              "compute_dtype": "float32", "cg_dtype": "float32"}


def _engine_events(cls, n_users=40, n_items=25, seed=3):
    """Planted rank-2 half-star ratings over 80% of the user x item
    grid."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 2))
    V = rng.normal(size=(n_items, 2))
    uu, ii = (a.ravel() for a in np.meshgrid(np.arange(n_users),
                                              np.arange(n_items),
                                              indexing="ij"))
    keep = rng.random(len(uu)) < 0.8
    uu, ii = uu[keep], ii[keep]
    r = 3.0 + np.einsum("nk,nk->n", U[uu], V[ii]) + rng.normal(
        0, 0.05, len(uu))
    r = np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    return [cls(event="rate", entity_type="user", entity_id=f"u{a}",
                target_entity_type="item", target_entity_id=f"i{b}",
                properties={"rating": float(c)},
                event_time=t0 + dt.timedelta(seconds=j))
            for j, (a, b, c) in enumerate(zip(uu, ii, r))]


def _el_env(path):
    return {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(path)}


def _variant(factory, binned=True):
    return {"engineFactory": factory,
            "datasource": {"name": "", "params": {"app_name": "reco",
                                                  "binned": binned}},
            "algorithms": [{"name": "als", "params": ALS_PARAMS}]}


QUERIES = ([{"user": f"u{j}", "num": 5} for j in range(0, 40, 3)]
           + [{"item": f"i{j}", "num": 4} for j in range(0, 25, 5)]
           + [{"user": "u1", "num": 6, "blacklist": ["i0", "i1"]}])


def _train(storage, binned=True):
    engine = recommendation_engine()
    ctx = DeviceContext("cpu")
    instance = run_train(engine, engine.engine_params_from_variant(
        _variant(RECO_FACTORY, binned)), engine_id="reco", ctx=ctx,
        storage=storage)
    assert instance.status == "COMPLETED"
    return prepare_deploy(engine, instance, ctx, storage)


def test_engine_takes_the_binned_lane_and_the_layout_cache(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    storage = Storage.from_env(_el_env(tmp_path / "port"))
    app = storage.apps().insert("reco")
    events = storage.events()
    events.init(app.id)
    events.insert_batch(_engine_events(Event), app.id)
    set_storage(storage)
    try:
        first = _train(storage)
        assert events.bin_columnar_calls == 1
        again = _train(storage)          # unchanged events: the cache
        assert events.bin_columnar_calls == 1
        monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc-coo"))
        columnar = _train(storage, binned=False)
        assert events.bin_columnar_calls == 1
        assert len(list((tmp_path / "bc-coo").glob("*.bin"))) == 1
        answers = [first.query(q) for q in QUERIES]
        assert [again.query(q) for q in QUERIES] == answers
        assert [columnar.query(q) for q in QUERIES] == answers
        for a, b in ((first, again), (first, columnar)):
            np.testing.assert_array_equal(a.models[0].item_factors,
                                          b.models[0].item_factors)
        # one more event: a new fingerprint, so the next train bins
        monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
        events.insert(Event(event="rate", entity_type="user",
                            entity_id="u-new", target_entity_type="item",
                            target_entity_id="i0",
                            properties={"rating": 4.0}), app.id)
        fresh = _train(storage)
        assert events.bin_columnar_calls == 2
        assert "u-new" in fresh.models[0].user_ids
    finally:
        set_storage(None)
        events.close()

    jax_storage = JaxStorage.from_env(_el_env(tmp_path / "jax"))
    jax_app = jax_storage.apps().insert("reco")
    jax_storage.events().init(jax_app.id)
    jax_storage.events().insert_batch(_engine_events(JaxEvent), jax_app.id)
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc-jax"))
    jax_engine = jax_recommendation_engine()
    jax_set_storage(jax_storage)
    try:
        jax_instance = jax_run_train(
            jax_engine, jax_engine.engine_params_from_variant(
                _variant(JAX_FACTORY)), engine_id="reco",
            engine_factory=JAX_FACTORY, storage=jax_storage,
            ctx=MeshContext())
        jax_deployment = jax_prepare_deploy(jax_engine, jax_instance,
                                            MeshContext(), jax_storage)
        jax_answers = [jax_deployment.query(q) for q in QUERIES]
    finally:
        jax_set_storage(None)
        jax_storage.events().close()
    for q, got, want in zip(QUERIES, answers, jax_answers):
        got, want = got["itemScores"], want["itemScores"]
        assert len(got) == len(want), q
        by_item = {w["item"]: w["score"] for w in want}
        for g, w in zip(got, want):
            assert abs(g["score"] - w["score"]) <= 1e-4, q
            assert (g["item"] == w["item"]
                    or abs(by_item.get(g["item"], -1e9) - g["score"]) <= 1e-4
                    ), q


def test_cli_train_logs_the_binned_lane(tmp_path, monkeypatch, caplog):
    env = _el_env(tmp_path / "store")
    for key, value in {**env, "PIO_BIN_CACHE_DIR": str(tmp_path / "bc")
                       }.items():
        monkeypatch.setenv(key, value)
    storage = Storage.from_env(env)
    app = storage.apps().insert("reco")
    storage.events().init(app.id)
    storage.events().insert_batch(_engine_events(Event), app.id)
    storage.events().close()     # the log has one writer at a time
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({**_variant(RECO_FACTORY),
                                       "engineId": "reco-cli"}))
    set_storage(None)
    try:
        for lane in ("'cache_hit': False", "'cache_hit': True"):
            caplog.clear()
            with caplog.at_level(logging.INFO,
                                 logger="predictionio_torch.models.als"):
                assert cli.main(["train", "--engine-json", str(engine_json),
                                 "--device", "cpu"]) == 0
            lines = [r.getMessage() for r in caplog.records
                     if "ALS trained on the binned lane" in r.getMessage()]
            assert len(lines) == 1 and lane in lines[0], lines
            # close the log (one writer at a time) for the next train
            get_storage().events().close()
            set_storage(None)
    finally:
        set_storage(None)


def test_twotower_engine_trains_from_read_prepared(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    storage = Storage.from_env(_el_env(tmp_path))
    app = storage.apps().insert("tt")
    storage.events().init(app.id)
    storage.events().insert_batch(_engine_events(Event), app.id)
    set_storage(storage)
    try:
        engine = twotower_engine()
        ep = EngineParams(
            data_source_params=("", RecoDataSourceParams(app_name="tt")),
            preparator_params=("", None),
            algorithm_params_list=[("twotower", TwoTowerParams(
                dim=8, embed_dim=8, hidden=(8,), epochs=1, batch_size=64))],
            serving_params=("", None))
        result = engine.train(DeviceContext("cpu"), ep)
        model = result.models[0]
        assert len(model.user_ids) == 40 and len(model.item_ids) == 25
        assert storage.events().bin_columnar_calls == 0
    finally:
        set_storage(None)
        storage.events().close()
