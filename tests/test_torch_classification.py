"""The port's classification template and models
(``predictionio_torch/templates/classification.py``,
``models/classification.py``) against the JAX package's, on the CPU.

The same ``$set`` entities (three labels, count features, an entity
missing a required property) go into a JAX and a port memory store:

- the DataSource reads the same labeled points, and ``read_eval``'s k
  folds are the JAX folds (training arrays and (query, actual) pairs);
- naive Bayes: ``pi``/``theta`` within 1e-6 of the JAX model's and of a
  float64 host computation; logistic regression: weights within 1e-4
  after 200 full-batch Adam steps from zero (the same standardization);
  both predict the JAX labels on a seeded batch, one query at a time and
  batched;
- ``engine.eval`` gives the JAX predictions fold by fold;
- an instance the JAX package trained with both algorithms deploys on
  the port and each algorithm answers as the JAX one does;
- ``batch_predict_dense`` of an empty fold is empty.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from predictionio_tpu.core.params import EngineParams as JaxEngineParams
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.models import classification as jax_cls
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import classification as jax_cls_t
from predictionio_tpu.workflow.deploy import (
    prepare_deploy as jax_prepare_deploy)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import EngineInstance, Model
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.models import batch_predict_dense
from predictionio_torch.models import classification as cls
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import classification as cls_t
from predictionio_torch.workflow.deploy import prepare_deploy

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

ctx = DeviceContext("cpu")
jax_ctx = MeshContext()
BASES = {0.0: [8.0, 1.0, 1.0], 1.0: [1.0, 1.0, 8.0], 2.0: [2.0, 7.0, 2.0]}


@pytest.fixture()
def cls_app():
    env = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"}
    port, jax = Storage.from_env(env), JaxStorage.from_env(env)
    app_id = port.apps().insert("cls").id
    assert jax.apps().insert("cls").id == app_id
    rng = np.random.default_rng(0)
    rows = []
    # 16/15/15 rows: with balanced classes the bias gradient at the zero
    # init is 0 up to rounding, and Adam's first step moves it +-lr on
    # the sign of that rounding alone
    for n in range(46):
        label = float(n % 3)
        attrs = np.maximum(np.array(BASES[label])
                           + rng.integers(-1, 2, size=3), 0.0)
        rows.append((f"u{n}", {"plan": label, "attr0": float(attrs[0]),
                               "attr1": float(attrs[1]),
                               "attr2": float(attrs[2])}))
    rows.append(("incomplete", {"plan": 1.0}))
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    for store, ev in ((port, Event), (jax, JaxEvent)):
        store.events().init(app_id)
        store.events().insert_batch([
            ev(event="$set", entity_type="user", entity_id=eid,
               properties=props, event_time=t0 + dt.timedelta(seconds=j))
            for j, (eid, props) in enumerate(rows)], app_id)
    set_storage(port)
    jax_set_storage(jax)
    yield port, jax
    set_storage(None)
    jax_set_storage(None)


def _queries(n=40, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 10, size=(n, 3)).astype(np.float32)


def test_datasource_and_folds_equal_jax(cls_app):
    params = dict(app_name="cls", eval_k=3)
    ds = cls_t.ClassificationDataSource(cls_t.ClassificationDSParams(**params))
    jds = jax_cls_t.ClassificationDataSource(
        jax_cls_t.ClassificationDSParams(**params))
    got, want = ds.read_training(ctx), jds.read_training(jax_ctx)
    assert got.features.shape == (46, 3)
    assert np.array_equal(got.features, want.features)
    assert np.array_equal(got.labels, want.labels)
    folds, jax_folds = ds.read_eval(ctx), jds.read_eval(jax_ctx)
    assert len(folds) == len(jax_folds) == 3
    for (td, ei, qa), (jtd, jei, jqa) in zip(folds, jax_folds):
        assert ei == jei and qa == jqa
        assert np.array_equal(td.features, jtd.features)
        assert np.array_equal(td.labels, jtd.labels)


def test_naive_bayes_matches_jax_and_float64(cls_app):
    td = cls_t.ClassificationDataSource(
        cls_t.ClassificationDSParams(app_name="cls")).read_training(ctx)
    for lam in (1.0, 0.3):
        model = cls.train_naive_bayes(td, lam, device="cpu")
        ref = jax_cls.train_naive_bayes(
            jax_cls.LabeledVectors(td.features, td.labels), lam)
        assert np.array_equal(model.class_labels, ref.class_labels)
        np.testing.assert_allclose(model.pi, ref.pi, atol=1e-6)
        np.testing.assert_allclose(model.theta, ref.theta, atol=1e-6)
        # float64 from the raw counts
        x = td.features.astype(np.float64)
        onehot = td.labels[:, None] == model.class_labels[None, :]
        counts, sums = onehot.sum(axis=0), onehot.T.astype(float) @ x
        pi = np.log(counts + lam) - np.log(len(x) + 3 * lam)
        theta = np.log(sums + lam) - np.log(sums.sum(1, keepdims=True)
                                            + 3 * lam)
        np.testing.assert_allclose(model.pi, pi, atol=1e-6)
        np.testing.assert_allclose(model.theta, theta, atol=1e-6)
        q = _queries()
        assert np.array_equal(model.predict_batch(q), ref.predict_batch(q))
        assert [model.predict(r) for r in q[:5]] == [ref.predict(r)
                                                     for r in q[:5]]


def test_logistic_regression_matches_jax(cls_app):
    td = cls_t.ClassificationDataSource(
        cls_t.ClassificationDSParams(app_name="cls")).read_training(ctx)
    p = cls.LogisticRegressionParams()
    model = cls.train_logistic_regression(td, p, device="cpu")
    ref = jax_cls.train_logistic_regression(
        jax_cls.LabeledVectors(td.features, td.labels),
        jax_cls.LogisticRegressionParams())
    np.testing.assert_allclose(model.feature_mean, ref.feature_mean)
    np.testing.assert_allclose(model.feature_std, ref.feature_std)
    np.testing.assert_allclose(model.weights, ref.weights, atol=1e-4)
    np.testing.assert_allclose(model.bias, ref.bias, atol=1e-4)
    q = _queries(seed=2)
    assert np.array_equal(model.predict_batch(q), ref.predict_batch(q))
    assert model.predict([8.0, 1.0, 1.0]) == 0.0
    assert model.predict([1.0, 1.0, 8.0]) == 1.0


def test_eval_predictions_equal_jax(cls_app):
    got = cls_t.classification_engine().eval(
        ctx, cls_t.default_engine_params("cls", eval_k=3))
    want = jax_cls_t.classification_engine().eval(
        jax_ctx, jax_cls_t.default_engine_params("cls", eval_k=3))
    assert len(got) == len(want) == 3
    total = correct = 0
    for (ei, qpa), (jei, jqpa) in zip(got, want):
        assert ei == jei and qpa == jqpa
        total += len(qpa)
        correct += sum(p["label"] == a["label"] for _q, p, a in qpa)
    assert total == 46 and correct / total >= 0.8


def test_jax_trained_instance_answers_like_the_jax_deployment(cls_app):
    port, jax = cls_app
    jax_engine = jax_cls_t.classification_engine()
    jax_ep = JaxEngineParams(
        data_source_params=("", jax_cls_t.ClassificationDSParams(
            app_name="cls")),
        algorithm_params_list=[
            ("naive", jax_cls.NaiveBayesParams(lambda_=0.5)),
            ("logistic", jax_cls.LogisticRegressionParams(iterations=60))])
    jax_instance = jax_run_train(
        jax_engine, jax_ep, engine_id="cls",
        engine_factory="predictionio_tpu.templates.classification."
                       "classification_engine", storage=jax, ctx=jax_ctx)
    want = jax_prepare_deploy(jax_engine, jax_instance, jax_ctx, jax)
    instance = EngineInstance(**{
        f.name: getattr(jax_instance, f.name)
        for f in dataclasses.fields(EngineInstance)})
    port.engine_instances().insert(instance)
    port.models().insert(Model(id=instance.id,
                               models=jax.models().get(instance.id).models))
    got = prepare_deploy(cls_t.classification_engine(), instance, ctx, port)
    assert [type(m) for m in got.models] == [cls.NaiveBayesModel,
                                             cls.LogisticRegressionModel]
    queries = [{"features": [float(v) for v in r]} for r in _queries(20, 3)]
    for algo, model, jalgo, jmodel in zip(got.algorithms, got.models,
                                          want.algorithms, want.models):
        assert [algo.predict(model, q) for q in queries] == [
            jalgo.predict(jmodel, q) for q in queries]
        indexed = list(enumerate(queries))
        assert algo.batch_predict(model, indexed) == jalgo.batch_predict(
            jmodel, indexed)
    assert got.query(queries[0]) == want.query(queries[0])


def test_batch_predict_dense_of_an_empty_fold():
    model = cls.NaiveBayesModel(np.array([0.0, 1.0]), np.zeros(2),
                                np.zeros((2, 3))).to("cpu")
    assert batch_predict_dense(model, []) == []
