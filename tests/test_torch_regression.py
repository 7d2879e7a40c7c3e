"""The port's regression template and models
(``predictionio_torch/templates/regression.py``, ``models/regression.py``)
against the JAX package's, on the CPU.

A seeded ``lr_data.txt`` (``y = x . TRUE_W`` plus noise, the JAX suite's
``tests/test_regression.py`` data):

- the file DataSource parses the JAX points, and each of ``read_eval``'s
  k folds is the JAX fold;
- SGD (MLlib's ``stepSize / sqrt(t)``, no intercept) and ridge (the
  normal equations, the intercept unshrunk) give the JAX weights within
  1e-5 (a ridge intercept near 100 within 1e-6 of itself) and recover
  ``TRUE_W``; collinear columns stay finite;
- the engine's ``AverageServing`` over three step sizes answers as the
  JAX engine's within 1e-5, and ``engine.eval``'s MeanSquareError is the
  JAX one within 1e-6;
- a pickled JAX ``LinearModel`` loads on the port and predicts the same;
  an empty file fails the sanity check.
"""

import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.core.evaluation import MeanSquareError as JaxMSE
from predictionio_tpu.models import regression as jax_reg
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import regression as jax_reg_t
from predictionio_torch.core.evaluation import MeanSquareError
from predictionio_torch.models import regression as reg
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import regression as reg_t
from predictionio_torch.workflow.deploy import load_blob

torch.set_num_threads(2)

ctx = DeviceContext("cpu")
jax_ctx = MeshContext()
TRUE_W = np.array([2.0, -1.0, 0.5], dtype=np.float32)


def _points(n=120, seed=0, noise=0.01, offset=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (x @ TRUE_W + offset
         + noise * rng.normal(size=n)).astype(np.float32)
    return x, y


@pytest.fixture()
def data_file(tmp_path):
    x, y = _points()
    path = tmp_path / "lr_data.txt"
    with open(path, "w") as f:
        for yi, xi in zip(y, x):
            f.write(f"{yi} " + " ".join(str(v) for v in xi) + "\n")
    return str(path)


def test_datasource_and_each_fold_equal_jax(data_file):
    ds = reg_t.FileRegressionDataSource(
        reg_t.RegressionDSParams(filepath=data_file, eval_k=3))
    jds = jax_reg_t.FileRegressionDataSource(
        jax_reg_t.RegressionDSParams(filepath=data_file, eval_k=3))
    td, jtd = ds.read_training(ctx), jds.read_training(jax_ctx)
    assert td.features.shape == (120, 3)
    assert np.array_equal(td.features, jtd.features)
    assert np.array_equal(td.targets, jtd.targets)
    folds, jax_folds = ds.read_eval(ctx), jds.read_eval(jax_ctx)
    assert len(folds) == len(jax_folds) == 3
    for (t, ei, qa), (jt, jei, jqa) in zip(folds, jax_folds):
        assert ei == jei and qa == jqa and len(qa) == 40
        assert np.array_equal(t.features, jt.features)
        assert np.array_equal(t.targets, jt.targets)


@pytest.mark.parametrize("intercept", [False, True])
def test_sgd_matches_jax_and_recovers_the_weights(intercept):
    x, y = _points()
    p = dict(iterations=400, step_size=0.2, intercept=intercept)
    model = reg.train_sgd_regression(reg.RegressionData(x, y),
                                     reg.SGDRegressionParams(**p), "cpu")
    ref = jax_reg.train_sgd_regression(jax_reg.RegressionData(x, y),
                                       jax_reg.SGDRegressionParams(**p))
    np.testing.assert_allclose(model.weights, ref.weights, atol=1e-5)
    assert model.intercept == pytest.approx(ref.intercept, abs=1e-5)
    np.testing.assert_allclose(model.weights, TRUE_W, atol=0.05)
    if not intercept:
        assert model.intercept == 0.0


def test_ridge_matches_jax_and_keeps_the_intercept():
    x, y = _points(n=200, seed=5, offset=100.0)
    for p in (dict(reg=1e-6), dict(reg=10.0, intercept=True),
              dict(reg=1e-3, intercept=False)):
        model = reg.train_ridge_regression(reg.RegressionData(x, y),
                                           reg.RidgeRegressionParams(**p),
                                           "cpu")
        ref = jax_reg.train_ridge_regression(
            jax_reg.RegressionData(x, y), jax_reg.RidgeRegressionParams(**p))
        np.testing.assert_allclose(model.weights, ref.weights, atol=1e-5)
        # the float32 Gramians sum in another order: relative to |y|
        assert model.intercept == pytest.approx(ref.intercept, rel=1e-6,
                                                abs=1e-5)
    shrunk = reg.train_ridge_regression(
        reg.RegressionData(x, y), reg.RidgeRegressionParams(reg=10.0), "cpu")
    assert shrunk.intercept == pytest.approx(100.0, abs=1.0)
    exact = reg.train_ridge_regression(
        reg.RegressionData(x, y), reg.RidgeRegressionParams(reg=1e-6), "cpu")
    np.testing.assert_allclose(exact.weights, TRUE_W, atol=0.02)


def test_ridge_collinear_features_stay_finite():
    x, y = _points()
    x_dup = np.concatenate([x, x[:, :1]], axis=1)
    model = reg.train_ridge_regression(reg.RegressionData(x_dup, y),
                                       reg.RidgeRegressionParams(reg=1e-6),
                                       "cpu")
    assert np.isfinite(model.weights).all()
    np.testing.assert_allclose(model.predict_batch(x_dup), y, atol=0.05)


def test_average_serving_and_eval_match_jax(data_file):
    engine, jax_engine = reg_t.regression_engine(), jax_reg_t.regression_engine()
    ep = reg_t.default_engine_params(data_file)
    jep = jax_reg_t.default_engine_params(data_file)
    models = engine.train(ctx, ep).models
    jax_models = jax_engine.train(jax_ctx, jep).models
    assert len(models) == 3
    q = {"features": [1.0, 1.0, 1.0]}
    serve = engine.make_serving(ep).serve(
        q, [a.predict(m, q) for a, m in zip(engine.make_algorithms(ep),
                                            models)])
    jserve = jax_engine.make_serving(jep).serve(
        q, [a.predict(m, q) for a, m in zip(jax_engine.make_algorithms(jep),
                                            jax_models)])
    assert serve == pytest.approx(jserve, abs=1e-5)
    assert serve == pytest.approx(1.5, abs=0.1)
    ep3 = reg_t.default_engine_params(data_file, eval_k=3, step_sizes=[0.2])
    results = engine.eval(ctx, ep3)
    jresults = jax_engine.eval(
        jax_ctx, jax_reg_t.default_engine_params(data_file, eval_k=3,
                                                 step_sizes=[0.2]))
    mse = MeanSquareError().calculate(ctx, results)
    assert mse == pytest.approx(JaxMSE().calculate(jax_ctx, jresults),
                                abs=1e-6)
    assert mse < 0.05


def test_a_pickled_jax_linear_model_predicts_the_same():
    x, y = _points()
    ref = jax_reg.train_ridge_regression(jax_reg.RegressionData(x, y),
                                         jax_reg.RidgeRegressionParams())
    model = load_blob(pickle.dumps(ref))
    assert type(model) is reg.LinearModel
    algo = reg.RidgeRegressionAlgorithm(reg.RidgeRegressionParams())
    jalgo = jax_reg.RidgeRegressionAlgorithm(jax_reg.RidgeRegressionParams())
    queries = [(j, {"features": [float(v) for v in x[j]]}) for j in range(5)]
    assert algo.batch_predict(model, queries) == jalgo.batch_predict(
        ref, queries)
    assert algo.predict(model, queries[0][1]) == jalgo.predict(
        ref, queries[0][1])
    assert algo.batch_predict(model, []) == []


def test_empty_data_file_fails_the_sanity_check(tmp_path):
    path = tmp_path / "empty.txt"
    path.write_text("\n")
    ep = reg_t.default_engine_params(str(path), step_sizes=[0.1])
    with pytest.raises(ValueError, match="no labeled points"):
        reg_t.regression_engine().train(ctx, ep)
