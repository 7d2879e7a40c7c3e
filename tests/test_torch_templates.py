"""The similar-product and e-commerce templates of the port against the
JAX package, on the CPU.

The same events go into a JAX memory store and a port memory store.

- The JAX template suite's cases (``tests/test_templates.py``
  ``TestSimilarProduct``, ``TestECommerce``, ``TestECommerceLookupCache``
  and ``TestColumnarRowEquivalence``), run on the port.
- Training data: each DataSource reads the same users, items,
  categories and interaction rows as the JAX one (columnar and row
  reads), and each algorithm's COO — view counts, latest like/dislike,
  latest rating, which the port folds with numpy — is the set of
  triples the JAX algorithm's dicts give.
- Factors: from the JAX trainer's initial factors, one alternation of
  the port's ALS over that COO gives user and item factors within a
  relative Frobenius error of 2e-3 of the JAX alternation's, the
  per-alternation bound of ``tests/test_torch_als.py`` (the default
  bf16 Jacobi CG; sums in another order).
- Blobs: an instance the JAX package trained deploys on the port and
  answers the JAX suite's queries, filters included, with the same ids
  and scores within 1e-5 of the JAX deployment's, through the masked
  scorer and through the retrieval index (``topk_dot``'s plain version
  with ``PIO_INDEX_KERNEL=on``).
- The vanilla template trains and answers as the JAX one does.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import ecommerce as jax_ecom_t
from predictionio_tpu.templates import similarproduct as jax_simprod_t
from predictionio_tpu.templates import vanilla as jax_vanilla_t
from predictionio_tpu.workflow.deploy import (
    prepare_deploy as jax_prepare_deploy)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import EngineInstance, Model
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.ops import als
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import ecommerce as ecom_t
from predictionio_torch.templates import similarproduct as simprod_t
from predictionio_torch.templates import vanilla as vanilla_t
from predictionio_torch.workflow.deploy import prepare_deploy

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

UTC = dt.timezone.utc
ctx = DeviceContext("cpu")
jax_ctx = MeshContext()


def _t(minute):
    return dt.datetime(2026, 1, 1, 0, 0, tzinfo=UTC) + dt.timedelta(
        minutes=minute)


class Twin:
    """A JAX memory store and a port memory store, each installed as its
    package's storage, that every ``put`` writes the same event into."""

    def __init__(self, name):
        env = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"}
        self.port = Storage.from_env(env)
        self.jax = JaxStorage.from_env(env)
        self.app_id = self.port.apps().insert(name).id
        assert self.jax.apps().insert(name).id == self.app_id
        self.port.events().init(self.app_id)
        self.jax.events().init(self.app_id)
        set_storage(self.port)
        jax_set_storage(self.jax)

    def put(self, event, etype, eid, tetype=None, teid=None, props=None,
            minute=0):
        for store, cls in ((self.port, Event), (self.jax, JaxEvent)):
            store.events().insert(cls(
                event=event, entity_type=etype, entity_id=eid,
                target_entity_type=tetype, target_entity_id=teid,
                properties=props or {}, event_time=_t(minute)), self.app_id)


@pytest.fixture()
def twin_factory():
    def make(name):
        return Twin(name)

    yield make
    set_storage(None)
    jax_set_storage(None)


@pytest.fixture()
def simprod_app(twin_factory):
    """The JAX suite's similar-product events."""
    tw = twin_factory("simprod")
    for u in ["u1", "u2", "u3", "u4"]:
        tw.put("$set", "user", u)
    cats = {"i1": ["a"], "i2": ["a", "b"], "i3": ["b"], "i4": ["c"]}
    for i, cs in cats.items():
        tw.put("$set", "item", i, props={"categories": cs})
    views = [("u1", "i1"), ("u1", "i2"), ("u2", "i1"), ("u2", "i2"),
             ("u3", "i3"), ("u4", "i1"), ("u4", "i2"), ("u4", "i3"),
             ("u4", "i4")]
    for m, (u, i) in enumerate(views):
        tw.put("view", "user", u, "item", i, minute=m)
    likes = [("u1", "i1", "like"), ("u1", "i2", "like"),
             ("u2", "i1", "like"), ("u2", "i2", "like"),
             ("u3", "i4", "dislike"), ("u4", "i3", "like")]
    for m, (u, i, e) in enumerate(likes):
        tw.put(e, "user", u, "item", i, minute=30 + m)
    return tw


@pytest.fixture()
def ecom_app(twin_factory):
    """The JAX suite's e-commerce events."""
    tw = twin_factory("ecom")
    for u in ["u1", "u2", "u3"]:
        tw.put("$set", "user", u)
    cats = {"i1": ["a"], "i2": ["a"], "i3": ["b"], "i4": ["b"]}
    for i, cs in cats.items():
        tw.put("$set", "item", i, props={"categories": cs})
    rates = [("u1", "i1", 5.0, 0), ("u1", "i2", 4.0, 1),
             ("u2", "i1", 4.0, 2), ("u2", "i2", 5.0, 3),
             ("u2", "i3", 1.0, 4), ("u3", "i3", 5.0, 5),
             ("u3", "i4", 4.0, 6),
             ("u1", "i1", 1.0, 7)]   # u1 re-rates i1 later: latest wins
    for u, i, r, m in rates:
        tw.put("rate", "user", u, "item", i, props={"rating": r}, minute=m)
    return tw


def _synthetic(tw, n_users=60, n_items=40, n=2400, seed=3):
    """Seeded events at a size where ALS has work: $set users (a few
    unset: their rows are dropped) and items with categories, views with
    repeats, like/dislike flips, rates with re-ratings."""
    rng = np.random.default_rng(seed)
    for u in range(n_users - 3):
        tw.put("$set", "user", f"u{u}")
    for i in range(n_items):
        cats = sorted({f"c{c}" for c in rng.integers(0, 5, 1 + i % 3)})
        tw.put("$set", "item", f"i{i}", props={"categories": cats})
    users = rng.integers(0, n_users, n)
    items = rng.zipf(1.3, n) % n_items
    for m, (u, i) in enumerate(zip(users, items)):
        tw.put("view", "user", f"u{u}", "item", f"i{i}", minute=m)
        if m % 3 == 0:
            tw.put("like" if rng.random() < 0.6 else "dislike", "user",
                   f"u{u}", "item", f"i{i}", minute=m)
        if m % 2 == 0:
            tw.put("rate", "user", f"u{u}", "item", f"i{i}",
                   props={"rating": float(rng.integers(1, 11)) / 2.0},
                   minute=m)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the JAX suite's cases -------------------------------------------------------

class TestSimilarProduct:
    def test_datasource_reads(self, simprod_app):
        ds = simprod_t.SimilarProductDataSource(
            simprod_t.SimilarProductDSParams(app_name="simprod"))
        td = ds.read_training(ctx)
        assert td.users == ["u1", "u2", "u3", "u4"]
        assert td.items == ["i1", "i2", "i3", "i4"]
        assert td.item_categories["i2"] == ["a", "b"]
        assert len(td.view_events) == 9
        assert ("u3", "i4", False) in td.like_events

    def test_train_and_similar(self, simprod_app):
        engine = simprod_t.similar_product_engine()
        ep = simprod_t.default_engine_params(
            "simprod",
            als_params=simprod_t.SimilarProductParams(rank=4,
                                                      num_iterations=10),
            like_params=simprod_t.SimilarProductParams(rank=4,
                                                       num_iterations=10))
        result = engine.train(ctx, ep)
        assert len(result.models) == 2
        recs = result.models[0].similar(["i1"], num=3)
        # i1 and i2 are co-viewed -> i2 tops the similar list for i1
        assert recs and recs[0][0] == "i2"
        assert all(item != "i1" for item, _ in recs)

    def test_filters(self, simprod_app):
        engine = simprod_t.similar_product_engine()
        ep = simprod_t.default_engine_params(
            "simprod",
            als_params=simprod_t.SimilarProductParams(rank=4,
                                                      num_iterations=10))
        model = engine.train(ctx, ep).models[0]
        recs = model.similar(["i1"], num=4, categories={"b"})
        assert recs and all(item in {"i2", "i3"} for item, _ in recs)
        recs = model.similar(["i1"], num=4, white_list={"i3"})
        assert all(item == "i3" for item, _ in recs)
        recs = model.similar(["i1"], num=4, black_list={"i2"})
        assert all(item != "i2" for item, _ in recs)
        assert model.similar(["zzz"], num=4) == []

    def test_standardizing_serving(self):
        serving = simprod_t.StandardizingServing.create()
        jax_serving = jax_simprod_t.StandardizingServing.create()
        preds = [
            {"itemScores": [{"item": "a", "score": 10.0},
                            {"item": "b", "score": 20.0},
                            {"item": "c", "score": 30.0}]},
            {"itemScores": [{"item": "b", "score": 1.0},
                            {"item": "c", "score": 2.0},
                            {"item": "d", "score": 3.0}]},
        ]
        out = serving.serve({"num": 2}, preds)
        assert [s["item"] for s in out["itemScores"]] == ["c", "d"]
        assert out["itemScores"][0]["score"] == pytest.approx(1.0, abs=1e-6)
        assert out["itemScores"][1]["score"] == pytest.approx(1.0, abs=1e-6)
        out1 = serving.serve({"num": 1}, preds)
        assert [s["item"] for s in out1["itemScores"]] == ["c"]
        assert out1["itemScores"][0]["score"] == pytest.approx(32.0)
        same = [{"itemScores": [{"item": "a", "score": 5.0},
                                {"item": "b", "score": 5.0}]}]
        assert all(s["score"] == 0.0 for s in
                   serving.serve({"num": 2}, same)["itemScores"])
        for q in ({"num": 2}, {"num": 1}, {"num": 4}):
            assert serving.serve(q, preds) == jax_serving.serve(q, preds)


def _ecom_model(**algo_kw):
    engine = ecom_t.ecommerce_engine()
    ep = ecom_t.default_engine_params(
        "ecom", algo_params=ecom_t.ECommAlgorithmParams(
            app_name="ecom", rank=4, num_iterations=10, **algo_kw))
    result = engine.train(ctx, ep)
    return engine.make_algorithms(ep)[0], result.models[0]


class TestECommerce:
    def test_datasource_and_latest_rating_dedupe(self, ecom_app):
        td = ecom_t.ECommDataSource(
            ecom_t.ECommDSParams(app_name="ecom")).read_training(ctx)
        assert len(td.rate_events) == 8
        algo, model = _ecom_model()
        assert model.user_factors.shape == (3, 4)
        assert model.item_factors.shape == (4, 4)
        _, _, (u, i, r) = algo.training_coo(td)
        assert dict(zip(zip(u.tolist(), i.tolist()), r.tolist()))[
            (0, 0)] == 1.0           # u1's later rating of i1

    def test_predict_known_user(self, ecom_app):
        algo, model = _ecom_model()
        out = algo.predict(model, {"user": "u2", "num": 2})
        assert out["itemScores"] and len(out["itemScores"]) <= 2

    def test_category_and_blacklist(self, ecom_app):
        algo, model = _ecom_model()
        out = algo.predict(model, {"user": "u1", "num": 4,
                                   "categories": ["b"]})
        assert all(s["item"] in {"i3", "i4"} for s in out["itemScores"])
        out = algo.predict(model, {"user": "u1", "num": 4,
                                   "blackList": ["i1", "i2", "i3", "i4"]})
        assert out["itemScores"] == []

    def test_unseen_only_filters_seen_items(self, ecom_app):
        ecom_app.put("buy", "user", "u1", "item", "i2", minute=40)
        algo, model = _ecom_model(unseen_only=True, seen_events=["buy"])
        out = algo.predict(model, {"user": "u1", "num": 4})
        assert all(s["item"] != "i2" for s in out["itemScores"])

    def test_unavailable_items_constraint(self, ecom_app):
        ecom_app.put("$set", "constraint", "unavailableItems",
                     props={"items": ["i1", "i2", "i3", "i4"]}, minute=41)
        algo, model = _ecom_model()
        assert algo.predict(model, {"user": "u2", "num": 4})[
            "itemScores"] == []

    def test_new_user_falls_back_to_recent_views(self, ecom_app):
        ecom_app.put("$set", "user", "u9")
        ecom_app.put("view", "user", "u9", "item", "i1", minute=42)
        algo, model = _ecom_model()
        out = algo.predict(model, {"user": "u9", "num": 3})
        assert out["itemScores"], "new user with recent views gets recs"
        assert all(s["item"] != "i1" or s["score"] > 0
                   for s in out["itemScores"])
        assert algo.predict(model, {"user": "u10", "num": 3})[
            "itemScores"] == []


class TestECommerceLookupCache:
    """Serve-time lookups are TTL-cached (the reference scans storage in
    every request)."""

    def _spy(self, monkeypatch):
        calls = {"n": 0}
        real = ecom_t.store.find_by_entity

        def counting(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)

        monkeypatch.setattr(ecom_t.store, "find_by_entity", counting)
        return calls

    def test_ttl_cache_bounds_storage_scans(self, ecom_app, monkeypatch):
        algo, model = _ecom_model(unseen_only=True, lookup_ttl_sec=60.0)
        calls = self._spy(monkeypatch)
        for _ in range(5):
            algo.predict(model, {"user": "u2", "num": 2})
        assert calls["n"] == 2, calls["n"]
        algo.predict(model, {"user": "u1", "num": 2})
        algo.predict(model, {"user": "u1", "num": 2})
        assert calls["n"] == 3

    def test_ttl_zero_restores_reference_behavior(self, ecom_app,
                                                  monkeypatch):
        algo, model = _ecom_model(unseen_only=True, lookup_ttl_sec=0.0)
        calls = self._spy(monkeypatch)
        algo.predict(model, {"user": "u2", "num": 2})
        algo.predict(model, {"user": "u2", "num": 2})
        assert calls["n"] == 4

    def test_cached_results_still_filter_seen(self, ecom_app):
        algo, model = _ecom_model(unseen_only=True, seen_events=["rate"],
                                  lookup_ttl_sec=60.0)
        for _ in range(2):
            out = algo.predict(model, {"user": "u2", "num": 4})
            assert not {"i1", "i2", "i3"} & {s["item"] for s in
                                               out["itemScores"]}


class TestColumnarRowEquivalence:
    def test_similarproduct(self, simprod_app):
        row, col = (simprod_t.SimilarProductDataSource(
            simprod_t.SimilarProductDSParams(app_name="simprod",
                                             columnar=flag)
        ).read_training(ctx) for flag in (False, True))
        assert col.users == row.users and col.items == row.items
        assert col.item_categories == row.item_categories
        assert sorted(col.view_events) == sorted(row.view_events)
        assert ({(u, i): v for u, i, v in col.like_events}
                == {(u, i): v for u, i, v in row.like_events})
        assert sorted(col.like_events) == sorted(row.like_events)

    def test_ecommerce(self, ecom_app):
        row, col = (ecom_t.ECommDataSource(
            ecom_t.ECommDSParams(app_name="ecom", columnar=flag)
        ).read_training(ctx) for flag in (False, True))
        assert col.users == row.users and col.items == row.items
        assert sorted(col.rate_events) == sorted(row.rate_events)
        assert ({(u, i): r for u, i, r in col.rate_events}
                == {(u, i): r for u, i, r in row.rate_events})

    def test_ecommerce_trains_identically(self, ecom_app):
        engine = ecom_t.ecommerce_engine()
        out = {}
        for flag in (False, True):
            ep = ecom_t.default_engine_params("ecom")
            ep.data_source_params[1].columnar = flag
            result = engine.train(ctx, ep)
            algo = engine.make_algorithms(ep)[0]
            out[flag] = algo.predict(result.models[0],
                                     {"user": "u1", "num": 3})
        assert out[True] == out[False]


# -- parity with the JAX package --------------------------------------------------

DATASOURCES = {
    "similarproduct": (simprod_t.SimilarProductDataSource,
                       simprod_t.SimilarProductDSParams,
                       jax_simprod_t.SimilarProductDataSource,
                       jax_simprod_t.SimilarProductDSParams,
                       ("users", "items", "item_categories", "view_events",
                        "like_events")),
    "ecommerce": (ecom_t.ECommDataSource, ecom_t.ECommDSParams,
                  jax_ecom_t.ECommDataSource, jax_ecom_t.ECommDSParams,
                  ("users", "items", "item_categories", "rate_events")),
}


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("template", sorted(DATASOURCES))
def test_training_data_equals_jax(twin_factory, template, columnar):
    """Every field the JAX training data has, equal, in the same row
    order."""
    tw = twin_factory("app")
    _synthetic(tw)
    ds, params, jax_ds, jax_params, fields = DATASOURCES[template]
    td = ds(params(app_name="app", columnar=columnar)).read_training(ctx)
    want = jax_ds(jax_params(app_name="app", columnar=columnar)
                  ).read_training(jax_ctx)
    for name in fields:
        assert getattr(td, name) == getattr(want, name), name


def _jax_coo(algo_name, params, jax_td):
    """The COO the JAX algorithm trains on, from its own dict fold."""
    if algo_name == "ecomm":
        algo = jax_ecom_t.ECommAlgorithm(params)
        users = JaxBiMap.string_int(jax_td.users)
        items = JaxBiMap.string_int(jax_td.items)
        latest = {}
        for u, i, r in jax_td.rate_events:
            if u in users and i in items:
                latest[(users[u], items[i])] = float(r)
        pairs = [(u, i, r) for (u, i), r in latest.items()]
    else:
        cls = (jax_simprod_t.SimilarProductAlgorithm if algo_name == "als"
               else jax_simprod_t.LikeAlgorithm)
        algo = cls(params)
        users = JaxBiMap.string_int(jax_td.users)
        items = JaxBiMap.string_int(jax_td.items)
        pairs = [(users[u], items[i], r)
                 for (u, i), r in algo._interactions(jax_td).items()
                 if u in users and i in items]
    return (np.array([p[0] for p in pairs], np.int64),
            np.array([p[1] for p in pairs], np.int64),
            np.array([p[2] for p in pairs], np.float32),
            len(users), len(items))


ALGOS = {
    "als": ("similarproduct", lambda: simprod_t.SimilarProductAlgorithm,
            simprod_t.SimilarProductParams,
            jax_simprod_t.SimilarProductParams),
    "likealgo": ("similarproduct", lambda: simprod_t.LikeAlgorithm,
                 simprod_t.SimilarProductParams,
                 jax_simprod_t.SimilarProductParams),
    "ecomm": ("ecommerce", lambda: ecom_t.ECommAlgorithm,
              ecom_t.ECommAlgorithmParams,
              jax_ecom_t.ECommAlgorithmParams),
}


def _sorted_triples(u, i, r):
    order = np.lexsort((i, u))
    return u[order], i[order], r[order]


@pytest.mark.parametrize("algo_name", sorted(ALGOS))
def test_algorithm_coo_and_one_alternation_match_jax(twin_factory,
                                                     algo_name):
    """The port's numpy folds give the JAX dicts' triples exactly; from
    the JAX trainer's factors, one alternation over them lands within
    2e-3 (relative Frobenius) of the JAX alternation, three times in a
    row (likealgo's against a JAX trainer with a float32 CG matvec, as
    the port trains it)."""
    tw = twin_factory("app")
    _synthetic(tw)
    template, algo_cls, params_cls, jax_params_cls = ALGOS[algo_name]
    ds, dsp, jax_ds, jax_dsp, _ = DATASOURCES[template]
    td = ds(dsp(app_name="app")).read_training(ctx)
    jax_td = jax_ds(jax_dsp(app_name="app")).read_training(jax_ctx)
    kw = dict(rank=6, num_iterations=3, block_size=64)
    algo = algo_cls()(params_cls(**kw))
    user_ids, item_ids, (u, i, r) = algo.training_coo(td)
    ju, ji, jr, n_users, n_items = _jax_coo(algo_name, jax_params_cls(**kw),
                                            jax_td)
    assert (len(user_ids), len(item_ids)) == (n_users, n_items)
    for got, want in zip(_sorted_triples(u, i, r),
                         _sorted_triples(ju, ji, jr)):
        np.testing.assert_array_equal(got, want)

    cfg = algo.als_config(algo.params)
    # likealgo's dislikes (-1) put confidences below 1: the port solves
    # that train with a float32 CG matvec (ops/als.py ``matvec_dtype``),
    # and the JAX trainer it is held to is given the same; the view
    # counts and the ratings keep the config's bf16
    cg_dtype = "float32" if algo_name == "likealgo" else cfg.cg_dtype
    ref = jax_als.ALSTrainer((ju, ji, jr), n_users, n_items,
                             jax_als.ALSConfig(**{**dataclasses.asdict(cfg),
                                                  "cg_dtype": cg_dtype}))
    trainer = als.ALSTrainer((u, i, r), n_users, n_items, cfg, device="cpu")
    assert trainer.cg_dtype == cg_dtype
    for _ in range(3):
        trainer.X = torch.tensor(np.array(ref._X))
        trainer.Y = torch.tensor(np.array(ref._Y))
        ref.step_n(1)
        trainer.step_n(1)
        assert _rel(trainer.X.numpy(), np.array(ref._X)) <= 2e-3
        assert _rel(trainer.Y.numpy(), np.array(ref._Y)) <= 2e-3


# -- JAX-trained blobs on the port ------------------------------------------------

def _port_deployment(tw, jax_instance):
    """The JAX instance and its blob in the port's store, deployed by the
    port on the CPU."""
    blob = tw.jax.models().get(jax_instance.id).models
    instance = EngineInstance(**{
        f.name: getattr(jax_instance, f.name)
        for f in dataclasses.fields(EngineInstance)})
    tw.port.engine_instances().insert(instance)
    tw.port.models().insert(Model(id=instance.id, models=blob))
    return instance


SUITES = {
    "similarproduct": (
        "simprod", jax_simprod_t.similar_product_engine,
        simprod_t.similar_product_engine,
        lambda: jax_simprod_t.default_engine_params(
            "simprod",
            als_params=jax_simprod_t.SimilarProductParams(
                rank=4, num_iterations=10),
            like_params=jax_simprod_t.SimilarProductParams(
                rank=4, num_iterations=10)),
        [{"items": ["i1"], "num": 3}, {"items": ["i1"], "num": 4},
         {"items": ["i1"], "num": 4, "categories": ["b"]},
         {"items": ["i1"], "num": 4, "whiteList": ["i3"]},
         {"items": ["i1"], "num": 4, "blackList": ["i2"]},
         {"items": ["i1", "i3"], "num": 2}, {"items": ["i2"], "num": 1},
         {"items": ["zzz"], "num": 4}]),
    "ecommerce": (
        "ecom", jax_ecom_t.ecommerce_engine, ecom_t.ecommerce_engine,
        lambda: jax_ecom_t.default_engine_params(
            "ecom", algo_params=jax_ecom_t.ECommAlgorithmParams(
                app_name="ecom", rank=4, num_iterations=10,
                unseen_only=True, seen_events=["buy"])),
        [{"user": "u2", "num": 2}, {"user": "u1", "num": 4},
         {"user": "u1", "num": 4, "categories": ["b"]},
         {"user": "u1", "num": 4, "blackList": ["i1", "i2", "i3", "i4"]},
         {"user": "u3", "num": 4, "whiteList": ["i1", "i2"]},
         {"user": "u9", "num": 3}, {"user": "u10", "num": 3}]),
}


@pytest.mark.parametrize("kernel", ["auto", "on"])
@pytest.mark.parametrize("template", sorted(SUITES))
def test_jax_trained_blob_answers_like_the_jax_deployment(
        request, monkeypatch, template, kernel):
    monkeypatch.setenv("PIO_INDEX_KERNEL", kernel)
    app = "simprod" if template == "similarproduct" else "ecom"
    tw = request.getfixturevalue(f"{app}_app")
    if template == "ecommerce":
        tw.put("buy", "user", "u1", "item", "i2", minute=40)
        tw.put("$set", "constraint", "unavailableItems",
               props={"items": ["i4"]}, minute=41)
        tw.put("$set", "user", "u9")
        tw.put("view", "user", "u9", "item", "i1", minute=42)
    _, jax_engine_fn, engine_fn, jax_ep, queries = SUITES[template]
    jax_engine = jax_engine_fn()
    factory = ("predictionio_tpu.templates.similarproduct."
               "similar_product_engine" if template == "similarproduct"
               else "predictionio_tpu.templates.ecommerce.ecommerce_engine")
    jax_instance = jax_run_train(jax_engine, jax_ep(), engine_id=template,
                                 engine_factory=factory, storage=tw.jax,
                                 ctx=jax_ctx)
    want = jax_prepare_deploy(jax_engine, jax_instance, jax_ctx, tw.jax)
    instance = _port_deployment(tw, jax_instance)
    got = prepare_deploy(engine_fn(), instance, ctx, tw.port)
    for model in got.models:
        assert type(model).__module__.startswith("predictionio_torch.")
    answered = 0
    for q in queries:
        a, b = got.query(q)["itemScores"], want.query(q)["itemScores"]
        assert [s["item"] for s in a] == [s["item"] for s in b], q
        np.testing.assert_allclose([s["score"] for s in a],
                                   [s["score"] for s in b], atol=1e-5,
                                   err_msg=str(q))
        answered += bool(a)
    assert answered >= 4
    if template == "similarproduct" and kernel == "on":
        plan = got.models[0].retrieval_stats()["kernel"]
        assert plan["engaged"] and plan["device"] == "cpu"


# -- the vanilla scaffold --------------------------------------------------------

@pytest.mark.parametrize("mult", [1, 3])
def test_vanilla_engine_answers_like_jax(mult):
    result = vanilla_t.vanilla_engine().train(
        ctx, vanilla_t.default_engine_params(app_name="v", mult=mult))
    jax_result = jax_vanilla_t.vanilla_engine().train(
        jax_ctx, jax_vanilla_t.default_engine_params(app_name="v",
                                                     mult=mult))
    assert result.models == jax_result.models == [{"mult": mult}]
    algo = vanilla_t.VanillaAlgorithm(vanilla_t.VanillaAlgoParams(mult=mult))
    jax_algo = jax_vanilla_t.VanillaAlgorithm(
        jax_vanilla_t.VanillaAlgoParams(mult=mult))
    for q in ({"q": 2.0}, {"q": -1.5}, {}):
        assert algo.predict(result.models[0], q) == jax_algo.predict(
            jax_result.models[0], q)
    assert algo.predict(result.models[0], {"q": 2.0}) == {"p": 2.0 * mult}
