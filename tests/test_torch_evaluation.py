"""The port's evaluation half against the JAX package's, on the CPU.

- Port twins of every test in ``tests/test_evaluation.py``: the metric
  family, MetricEvaluator's ranking, ``best.json`` and renderings, the
  lower-is-better order, secondary metrics, FastEval's prefix caches,
  ``run_evaluation``'s EvaluationInstance bookkeeping, the rule that a
  NaN score never wins, and the ALS ``lambda_`` grid (one grid run per
  fold, the sequential path's scores within the JAX test's rtol 1e-4 /
  atol 1e-5 and its ranking).
- Parity on the same eval data: the tagged results of both packages'
  sample engines give equal metric scores, leaderboards and
  ``to_json()`` (exactly: the same arithmetic on the same numbers).
- ``run_evaluation`` of an ALS ``lambda_`` sweep on both packages over
  the same events in memory stores: the two draw different initial
  factors (``jax.random`` and ``torch.Generator``), so each candidate's
  ``sqrt(score)`` (a held-out rating RMSE) is held to 0.02, the band of
  ``test_torch_als.py::test_engine_trains_on_the_port_like_the_jax_engine``.
- An EvaluationInstance written by either package's localfs backend
  reads back in the other, field for field.
- ``python -m predictionio_torch.tools.cli eval`` on the CPU.
"""

import datetime as dt
import json
import logging
import math
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.core import Engine as JaxEngine
from predictionio_tpu.core import EngineParams as JaxEngineParams
from predictionio_tpu.core import evaluation as jax_evaluation
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.metadata import (
    EvaluationInstance as JaxEvaluationInstance)
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.models.als import ALSParams as JaxALSParams
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_reco
from predictionio_tpu.workflow.evaluate import (
    run_evaluation as jax_run_evaluation)
from predictionio_torch.core import Engine, EngineParams
from predictionio_torch.core.evaluation import (AverageMetric,
                                                EngineParamsGenerator,
                                                Evaluation, FunctionMetric,
                                                MetricEvaluator,
                                                OptionAverageMetric,
                                                StdevMetric, SumMetric)
from predictionio_torch.core.fast_eval import FastEvalEngineWorkflow
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import EvaluationInstance
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.models.als import ALSParams
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import recommendation as reco
from predictionio_torch.tools import cli
from predictionio_torch.workflow.evaluate import run_evaluation

from tests import sample_engine as jax_sample
from tests.torch_sample_engine import (Algo0, DataSource0, IdParams,
                                       Preparator0, Serving0)

torch.set_num_threads(2)

ctx = DeviceContext("cpu")
UTC = dt.timezone.utc


@pytest.fixture()
def port_storage():
    """A fresh in-memory port storage, installed as the port's singleton."""
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    set_storage(storage)
    yield storage
    set_storage(None)


def make_eval_data(scores):
    """One fold whose qpa triples carry the given 'actual' scores."""
    return [(None, [(i, i, s) for i, s in enumerate(scores)])]


class ActualMetric(AverageMetric):
    def calculate_qpa(self, q, p, a):
        return float(a)


class OptionalMetric(OptionAverageMetric):
    def calculate_qpa(self, q, p, a):
        return None if a is None else float(a)


class StdevOfActual(StdevMetric):
    def calculate_qpa(self, q, p, a):
        return float(a)


class SumOfActual(SumMetric):
    def calculate_qpa(self, q, p, a):
        return float(a)


def test_metric_family():
    data = make_eval_data([1.0, 2.0, 3.0, 4.0])
    assert ActualMetric().calculate(ctx, data) == 2.5
    assert SumOfActual().calculate(ctx, data) == 10.0
    assert StdevOfActual().calculate(ctx, data) == pytest.approx(
        math.sqrt(1.25))
    assert OptionalMetric().calculate(ctx, make_eval_data([1.0, None, 3.0])
                                      ) == 2.0
    two_folds = make_eval_data([1.0, 2.0]) + make_eval_data([3.0, 4.0])
    assert ActualMetric().calculate(ctx, two_folds) == 2.5
    assert math.isnan(ActualMetric().calculate(ctx, []))


def make_engine():
    return Engine(data_source_classes={"ds": DataSource0},
                  preparator_classes={"prep": Preparator0},
                  algorithm_classes={"algo": Algo0},
                  serving_classes={"serve": Serving0})


def make_params(algo_id):
    return EngineParams(
        data_source_params=("ds", IdParams(id=1)),
        preparator_params=("prep", IdParams(id=2)),
        algorithm_params_list=[("algo", IdParams(id=algo_id))],
        serving_params=("serve", IdParams(id=0)))


def test_metric_evaluator_ranks_and_saves_best(tmp_path):
    metric = FunctionMetric(lambda q, p, a: float(p.algo_id), name="algo-id")
    evaluation = Evaluation(engine=make_engine(), metric=metric)
    candidates = [make_params(3), make_params(7), make_params(5)]
    best_json = tmp_path / "best.json"
    result = MetricEvaluator(best_json_path=str(best_json)).evaluate(
        ctx, evaluation, candidates)
    assert result.best_idx == 1
    assert result.best_score == 7.0
    assert result.metric_header == "algo-id"
    saved = json.loads(best_json.read_text())
    assert saved["algorithmParamsList"][0]["params"]["id"] == 7
    assert "7.0000" in result.to_one_liner()
    parsed = json.loads(result.to_json())
    assert parsed["bestIdx"] == 1 and len(parsed["engineParamsScores"]) == 3
    assert "<table" in result.to_html()


def test_best_json_is_written_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    metric = FunctionMetric(lambda q, p, a: float(p.algo_id), name="m")
    MetricEvaluator().evaluate(ctx, Evaluation(engine=make_engine(),
                                               metric=metric),
                               [make_params(1), make_params(2)])
    assert list(tmp_path.iterdir()) == []


def test_lower_is_better_ordering():
    class LossMetric(FunctionMetric):
        higher_is_better = False

    metric = LossMetric(lambda q, p, a: float(p.algo_id), name="loss")
    result = MetricEvaluator().evaluate(
        ctx, Evaluation(engine=make_engine(), metric=metric),
        [make_params(3), make_params(7)])
    assert result.best_idx == 0


def test_secondary_metrics_reported():
    m1 = FunctionMetric(lambda q, p, a: float(p.algo_id), name="primary")
    m2 = FunctionMetric(lambda q, p, a: float(q.q), name="mean-q")
    evaluation = Evaluation(engine=make_engine(), metric=m1, metrics=[m2])
    result = MetricEvaluator().evaluate(ctx, evaluation, [make_params(2)])
    assert result.other_metric_headers == ["mean-q"]
    assert len(result.engine_params_scores[0].other_scores) == 1


def test_fast_eval_memoizes_prefixes():
    """ref: FastEvalEngineTest.scala — shared prefixes computed once."""
    engine = make_engine()
    workflow = FastEvalEngineWorkflow(engine, ctx)
    eps = [make_params(3), make_params(3), make_params(9)]
    results = [workflow.eval(ep) for ep in eps]
    assert workflow.counts == {"read": 1, "prepare": 1, "train": 2,
                               "predict": 2, "grid_dispatches": 0}
    assert str(results[0]) == str(results[1])
    ep_new_ds = make_params(3)
    ep_new_ds.data_source_params = ("ds", IdParams(id=42))
    workflow.eval(ep_new_ds)
    assert workflow.counts["read"] == 2
    assert workflow.counts["prepare"] == 2
    assert workflow.counts["train"] == 3
    assert str(engine.eval(ctx, eps[0])) == str(results[0])


def test_run_evaluation_persists_instance(port_storage):
    metric = FunctionMetric(lambda q, p, a: float(p.algo_id), name="m")
    evaluation = Evaluation(engine=make_engine(), metric=metric)
    gen = EngineParamsGenerator([make_params(3), make_params(8)])
    result = run_evaluation(evaluation, generator=gen,
                            evaluation_class="tests.MyEval",
                            generator_class="tests.MyGen", batch="b1",
                            ctx=ctx, storage=port_storage)
    assert result.best_score == 8.0
    instances = port_storage.evaluation_instances().get_completed()
    assert len(instances) == 1
    inst = instances[0]
    assert inst.status == "EVALCOMPLETED"
    assert (inst.evaluation_class, inst.engine_params_generator_class,
            inst.batch) == ("tests.MyEval", "tests.MyGen", "b1")
    assert inst.evaluator_results == result.to_one_liner()
    assert "8.0000" in inst.evaluator_results
    assert json.loads(inst.evaluator_results_json)["bestScore"] == 8.0
    assert "<table" in inst.evaluator_results_html
    assert inst.end_time >= inst.start_time


def test_run_evaluation_failure_marks_instance(port_storage):
    class BoomMetric(FunctionMetric):
        def calculate(self, ctx, eval_data):
            raise RuntimeError("boom")

    evaluation = Evaluation(engine=make_engine(),
                            metric=BoomMetric(lambda q, p, a: 0.0))
    with pytest.raises(RuntimeError):
        run_evaluation(evaluation, engine_params_list=[make_params(1)],
                       ctx=ctx, storage=port_storage)
    instances = port_storage.evaluation_instances().get_all()
    assert [i.status for i in instances] == ["FAILED"]
    with pytest.raises(ValueError, match="engine_params_list or generator"):
        run_evaluation(evaluation, ctx=ctx, storage=port_storage)


def test_nan_score_never_wins_lower_is_better():
    """A NaN-scored candidate (no eval data) ranks worst even when
    higher_is_better=False (the sign flip must not make NaN +inf)."""

    class LossMetric(FunctionMetric):
        higher_is_better = False

    metric = LossMetric(lambda q, p, a: float(p.algo_id), name="loss")
    evaluation = Evaluation(engine=make_engine(), metric=metric)
    calls = {"n": 0}

    def eval_fn(c, ep):
        calls["n"] += 1
        if calls["n"] == 1:
            return []
        return evaluation.engine.eval(c, ep)

    result = MetricEvaluator().evaluate(
        ctx, evaluation, [make_params(9), make_params(4)], eval_fn=eval_fn)
    assert result.best_idx == 1
    assert result.best_score == 4.0


# -- parity with the JAX package on the same eval data ----------------------------

def _jax_engine():
    return JaxEngine(data_source_classes={"ds": jax_sample.DataSource0},
                     preparator_classes={"prep": jax_sample.Preparator0},
                     algorithm_classes={"algo": jax_sample.Algo0},
                     serving_classes={"serve": jax_sample.Serving0})


def _jax_params(algo_id):
    return JaxEngineParams(
        data_source_params=("ds", jax_sample.IdParams(id=1)),
        preparator_params=("prep", jax_sample.IdParams(id=2)),
        algorithm_params_list=[("algo", jax_sample.IdParams(id=algo_id))],
        serving_params=("serve", jax_sample.IdParams(id=0)))


def _score(q, p, a):
    # NaN for the candidate whose tag is 6, to exercise the NaN rule
    return float("nan") if p.algo_id == 6 else (p.algo_id - 5.0) ** 2 + q.q


@pytest.mark.parametrize("higher_is_better", [True, False])
def test_scores_leaderboard_and_json_match_jax(higher_is_better, caplog):
    ids = [3, 7, 6, 5, 9, 4]
    port_cls = type("Port", (FunctionMetric,),
                    {"higher_is_better": higher_is_better})
    jax_cls = type("Jax", (jax_evaluation.FunctionMetric,),
                   {"higher_is_better": higher_is_better})
    with caplog.at_level(logging.INFO):
        got = MetricEvaluator().evaluate(
            ctx, Evaluation(engine=make_engine(),
                            metric=port_cls(_score, name="sq"),
                            metrics=[FunctionMetric(
                                lambda q, p, a: float(a.q), name="aq")]),
            [make_params(i) for i in ids])
        port_board = [r.message for r in caplog.records
                      if r.name == "predictionio_torch.core.evaluation"]
        want = jax_evaluation.MetricEvaluator().evaluate(
            MeshContext(), jax_evaluation.Evaluation(
                engine=_jax_engine(), metric=jax_cls(_score, name="sq"),
                metrics=[jax_evaluation.FunctionMetric(
                    lambda q, p, a: float(a.q), name="aq")]),
            [_jax_params(i) for i in ids])
    jax_board = [r.message for r in caplog.records
                 if r.name == "predictionio_tpu.core.evaluation"]
    assert port_board == jax_board and len(port_board) == 2 * len(ids)
    assert got.to_json() == want.to_json()
    assert got.to_one_liner() == want.to_one_liner()
    assert got.to_html() == want.to_html()
    assert ids[got.best_idx] != 6        # NaN never wins


# -- the ALS grid through pio eval --------------------------------------------------

def _ratings(n_users=30, n_items=12, per_user=6):
    """tests/test_evaluation.py's events: each user rates 6 of 12 items."""
    rng = np.random.default_rng(5)
    out, m = [], 0
    for u in range(n_users):
        for i in rng.choice(n_items, size=per_user, replace=False):
            out.append((f"u{u}", f"i{int(i)}", float(1 + (u * int(i)) % 5),
                        dt.datetime(2026, 1, 1, tzinfo=UTC)
                        + dt.timedelta(minutes=m)))
            m += 1
    return out


def _store_events(storage, event_cls, app="grid-app"):
    app_rec = storage.apps().insert(app)
    storage.events().init(app_rec.id)
    storage.events().insert_batch([event_cls(
        event="rate", entity_type="user", entity_id=u,
        target_entity_type="item", target_entity_id=i,
        properties={"rating": r}, event_time=t)
        for u, i, r, t in _ratings()], app_rec.id)


def _grid_candidates(regs, package=reco, params_cls=ALSParams,
                     ep_cls=EngineParams, eval_k=2):
    return [ep_cls(
        data_source_params=("", package.RecoDataSourceParams(
            app_name="grid-app", columnar=False, eval_k=eval_k)),
        preparator_params=("", None),
        algorithm_params_list=[("als", params_cls(
            rank=4, num_iterations=3, lambda_=reg, block_size=32,
            compute_dtype="float32", cg_dtype="float32"))],
        serving_params=("", None)) for reg in regs]


def _rating_mse(q, p, a):
    match = [s["score"] for s in p["itemScores"] if s["item"] == a["item"]]
    if not match:
        return None
    return (match[0] - a["rating"]) ** 2


class RatingMSE(AverageMetric):
    """tests/test_evaluation.py's metric: the squared error of the held
    out rating, where the held out item is among the top ``num``."""

    higher_is_better = False

    def calculate_qpa(self, q, p, a):
        return _rating_mse(q, p, a)


# the same metric on the JAX package, under the same name (its header)
JaxRatingMSE = type("RatingMSE", (jax_evaluation.AverageMetric,), {
    "higher_is_better": False,
    "calculate_qpa": lambda self, q, p, a: _rating_mse(q, p, a)})


REGS = [0.01, 0.05, 0.1, 0.5, 1.0, 5.0]


def test_als_reg_grid_single_run_per_fold_matches_sequential(port_storage):
    """A 6-point reg grid: one grid run per fold, the sequential path's
    scores (rtol 1e-4, atol 1e-5) and ranking."""
    _store_events(port_storage, Event)
    candidates = _grid_candidates(REGS)
    metric = RatingMSE()
    engine = reco.recommendation_engine()
    wf = FastEvalEngineWorkflow(engine, ctx)
    assert wf.prefetch_grid(candidates) == len(REGS)
    assert wf.counts["grid_dispatches"] == 2
    assert wf.counts["train"] == 0
    grid_scores = [metric.calculate(ctx, wf.eval(ep)) for ep in candidates]
    assert wf.counts["train"] == 0     # scoring hit the seeded cache only
    wf_seq = FastEvalEngineWorkflow(engine, ctx)
    seq_scores = [metric.calculate(ctx, wf_seq.eval(ep))
                  for ep in candidates]
    assert wf_seq.counts["train"] == len(REGS)
    np.testing.assert_allclose(grid_scores, seq_scores, rtol=1e-4, atol=1e-5)
    assert np.argsort(grid_scores).tolist() == np.argsort(seq_scores).tolist()


def test_grid_prefetch_declines_heterogeneous_candidates(port_storage):
    import dataclasses

    _store_events(port_storage, Event)
    candidates = _grid_candidates([0.01, 0.1])
    slot_name, p1 = candidates[1].algorithm_params_list[0]
    candidates[1].algorithm_params_list[0] = (
        slot_name, dataclasses.replace(p1, rank=8))
    wf = FastEvalEngineWorkflow(reco.recommendation_engine(), ctx)
    assert wf.prefetch_grid(candidates) == 0
    assert wf.counts["grid_dispatches"] == 0


def test_run_evaluation_uses_grid_path(port_storage, caplog):
    _store_events(port_storage, Event)
    candidates = _grid_candidates([0.01, 0.1, 1.0])
    evaluation = Evaluation(engine=reco.recommendation_engine(),
                            metric=RatingMSE())
    with caplog.at_level(logging.INFO,
                         logger="predictionio_torch.core.fast_eval"):
        result = run_evaluation(evaluation, engine_params_list=candidates,
                                ctx=ctx, storage=port_storage)
    assert any("grid tuning: 3 candidates trained in 2 grid run(s)"
               in r.message for r in caplog.records)
    assert not any("falling back" in r.message for r in caplog.records)
    assert len(result.engine_params_scores) == 3
    assert result.best_idx in range(3)


def test_run_evaluation_grid_failure_falls_back_with_a_warning(
        port_storage, caplog, monkeypatch):
    """As in the JAX package, a failing grid run falls back to the
    sequential path, logged at warning level with the exception."""
    from predictionio_torch.models.als import ALSAlgorithm

    def boom(*args, **kwargs):
        raise MemoryError("grid factors do not fit")

    monkeypatch.setattr(ALSAlgorithm, "grid_train", boom)
    _store_events(port_storage, Event)
    evaluation = Evaluation(engine=reco.recommendation_engine(),
                            metric=RatingMSE())
    with caplog.at_level(logging.WARNING):
        result = run_evaluation(evaluation,
                                engine_params_list=_grid_candidates(
                                    [0.01, 0.1]),
                                ctx=ctx, storage=port_storage)
    warned = [r for r in caplog.records if r.levelno == logging.WARNING
              and "falling back" in r.message]
    assert len(warned) == 1 and "MemoryError" in warned[0].message
    assert len(result.engine_params_scores) == 2
    assert port_storage.evaluation_instances().get_completed()


def _planted_events(event_cls, n_users=120, n_items=80, nnz=3000, seed=8):
    """Planted rank-4 half-star ratings over Zipf-popular items (the
    events of test_torch_als.py's engine test)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.zipf(1.3, nnz) % n_items
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
    r = 3.0 + np.einsum("nk,nk->n", U[u], V[i]) / 2.0 + rng.normal(0, .3, nnz)
    r = np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    return [event_cls(event="rate", entity_type="user", entity_id=f"u{a}",
                      target_entity_type="item", target_entity_id=f"i{b}",
                      properties={"rating": float(c)},
                      event_time=t0 + dt.timedelta(seconds=j))
            for j, (a, b, c) in enumerate(zip(u, i, r))]


def _sweep(package, params_cls, ep_cls):
    """A ``lambda_`` sweep at rank 8, 10 iterations, 3 folds; every item
    is scored (``eval_query_num`` = the catalog), so the metric is the
    held-out rating MSE of every fold. (At ``lambda_`` 0.01 the JAX
    package's default CG diverges on this data, so the sweep starts at
    0.05.)"""
    return [ep_cls(
        data_source_params=("", package.RecoDataSourceParams(
            app_name="grid-app", columnar=False, eval_k=3,
            eval_query_num=80)),
        preparator_params=("", None),
        algorithm_params_list=[("als", params_cls(
            rank=8, num_iterations=10, lambda_=reg, block_size=64))],
        serving_params=("", None)) for reg in (0.05, 0.1, 0.5, 1.0, 5.0)]


def _insert(storage, events):
    app = storage.apps().insert("grid-app")
    storage.events().init(app.id)
    storage.events().insert_batch(events, app.id)


def test_run_evaluation_matches_jax_per_candidate(port_storage):
    """Both packages' ``pio eval`` of one sweep (each through its grid
    path) over the same events: each candidate's held-out RMSE within
    0.02 (different random starts), the
    same metric header and the same best candidate."""
    _insert(port_storage, _planted_events(Event))
    got = run_evaluation(
        Evaluation(engine=reco.recommendation_engine(), metric=RatingMSE()),
        engine_params_list=_sweep(reco, ALSParams, EngineParams), ctx=ctx,
        storage=port_storage)

    from predictionio_tpu.data.storage import set_storage as jax_set_storage

    jax_storage = JaxStorage.from_env({"PIO_STORAGE_SOURCES_M_TYPE":
                                       "memory"})
    _insert(jax_storage, _planted_events(JaxEvent))
    jax_set_storage(jax_storage)
    try:
        want = jax_run_evaluation(
            jax_evaluation.Evaluation(engine=jax_reco.recommendation_engine(),
                                      metric=JaxRatingMSE()),
            engine_params_list=_sweep(jax_reco, JaxALSParams,
                                      JaxEngineParams),
            storage=jax_storage, ctx=MeshContext())
    finally:
        jax_set_storage(None)
    got_rmse = np.sqrt([s.score for s in got.engine_params_scores])
    want_rmse = np.sqrt([s.score for s in want.engine_params_scores])
    assert np.all(np.isfinite(got_rmse)) and got_rmse.max() < 3.5
    np.testing.assert_allclose(got_rmse, want_rmse, rtol=0, atol=0.02)
    assert got.metric_header == want.metric_header
    assert got.best_idx == want.best_idx


# -- EvaluationInstance across packages ----------------------------------------------

def _instance(cls, iid):
    t = dt.datetime(2026, 3, 1, 12, 0, tzinfo=UTC)
    return cls(id=iid, status="EVALCOMPLETED", start_time=t,
               end_time=t + dt.timedelta(seconds=5),
               evaluation_class="pkg.Eval",
               engine_params_generator_class="pkg.Gen", batch="nightly",
               env={"K": "V"}, evaluator_results="[m: 1.0000] best params idx=0",
               evaluator_results_html="<h2>x</h2>",
               evaluator_results_json='{"bestIdx": 0}')


def test_evaluation_instances_cross_between_packages(tmp_path):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path)}
    Storage.from_env(env).evaluation_instances().insert(
        _instance(EvaluationInstance, "from-port"))
    jax_repo = JaxStorage.from_env(env).evaluation_instances()
    assert vars(jax_repo.get("from-port")) == vars(
        _instance(JaxEvaluationInstance, "from-port"))
    jax_repo.insert(_instance(JaxEvaluationInstance, "from-jax"))
    repo = Storage.from_env(env).evaluation_instances()
    assert vars(repo.get("from-jax")) == vars(
        _instance(EvaluationInstance, "from-jax"))
    assert sorted(i.id for i in repo.get_completed()) == [
        "from-jax", "from-port"]


# -- pio eval ------------------------------------------------------------------------

EVAL_MODULE = '''
from predictionio_torch.core.evaluation import (AverageMetric,
                                                EngineParamsGenerator,
                                                Evaluation)
from predictionio_torch.core.params import EngineParams
from predictionio_torch.models.als import ALSParams
from predictionio_torch.templates import recommendation as reco


class RatingMSE(AverageMetric):
    higher_is_better = False

    def calculate_qpa(self, q, p, a):
        match = [s["score"] for s in p["itemScores"] if s["item"] == a["item"]]
        return (match[0] - a["rating"]) ** 2 if match else None


Eval = Evaluation(engine=reco.recommendation_engine(), metric=RatingMSE())


class Gen(EngineParamsGenerator):
    def __init__(self):
        super().__init__([EngineParams(
            data_source_params=("", reco.RecoDataSourceParams(
                app_name="grid-app", columnar=False, eval_k=2)),
            algorithm_params_list=[("als", ALSParams(
                rank=4, num_iterations=3, lambda_=reg, block_size=32))])
            for reg in (0.01, 0.1, 1.0)])
'''


def test_cli_eval_on_the_cpu(tmp_path, monkeypatch, capsys):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    _store_events(Storage.from_env(env), Event)
    (tmp_path / "my_eval.py").write_text(EVAL_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    set_storage(None)
    try:
        assert cli.main(["eval", "my_eval.Eval", "my_eval.Gen",
                         "--batch", "b", "--device", "cpu"]) == 0
    finally:
        set_storage(None)
        sys.modules.pop("my_eval", None)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    (inst,) = Storage.from_env(env).evaluation_instances().get_completed()
    assert line == inst.evaluator_results and line.startswith("[RatingMSE: ")
    assert (inst.evaluation_class, inst.engine_params_generator_class,
            inst.batch) == ("my_eval.Eval", "my_eval.Gen", "b")
    assert len(json.loads(inst.evaluator_results_json)[
        "engineParamsScores"]) == 3


def test_cli_eval_resolves_jax_paths_under_the_port(capsys):
    assert cli.main(["eval", "predictionio_tpu.no_such_module.Eval",
                     "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "No module named 'predictionio_torch.no_such_module'" in err
    assert cli.main(["eval", "predictionio_tpu.core.evaluation.MetricEvaluator",
                     "--device", "cpu"]) == 1
    assert "is not an Evaluation" in capsys.readouterr().err
