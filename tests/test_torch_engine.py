"""The port's DASE engine wiring against the JAX package's, on the CPU.

A port twin of ``tests/sample_engine.py`` (``tests/torch_sample_engine.py``)
goes through the ``tests/test_engine.py`` matrix on ``predictionio_torch``:
train wiring, multi-algorithm training, sanity checks, stop-after-read
and -prepare, unknown components, the two-ctor protocol, the built-in
servings and variant parsing. ``Engine.eval`` (folds, one
``batch_predict`` per algorithm regrouped per query index, Serving)
must give the JAX engine's tagged results exactly: the components
print alike in both packages, so their ``str`` must be equal. Then the
train-persistence path (``run_train`` saving a ``PersistentModel``
through its manifest and ``prepare_deploy`` loading it back) and the
``tests/test_fake_workflow.py`` cases of ``FakeRun`` and ``no_save``.
"""

import pickle

import pytest

from predictionio_tpu.core import Engine as JaxEngine
from predictionio_tpu.core import EngineParams as JaxEngineParams
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_torch.core import (AverageServing, Engine, EngineParams,
                                     FirstServing, IdentityPreparator)
from predictionio_torch.core.params import EmptyParams, params_from_dict
from predictionio_torch.core.persistent_model import PersistentModelManifest
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.workflow.config import WorkflowParams
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.fake import FakeEvalResult, FakeRun, fake_run
from predictionio_torch.workflow.train import run_train

from tests import sample_engine as jax_sample
from tests.torch_sample_engine import (Algo0, AlgoNoParams, AlgoPersistent,
                                       DataSource0, IdParams, Prediction,
                                       Preparator0, Query, Serving0)

ctx = DeviceContext("cpu")


@pytest.fixture()
def port_storage():
    """A fresh in-memory port storage, installed as the port's singleton."""
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    set_storage(storage)
    yield storage
    set_storage(None)


def make_engine():
    return Engine(
        data_source_classes={"ds": DataSource0},
        preparator_classes={"prep": Preparator0},
        algorithm_classes={"algo": Algo0, "noparams": AlgoNoParams,
                           "persistent": AlgoPersistent},
        serving_classes={"serve": Serving0, "first": FirstServing},
    )


def make_params(algo_ids=(3,), algo="algo"):
    return EngineParams(
        data_source_params=("ds", IdParams(id=1)),
        preparator_params=("prep", IdParams(id=2)),
        algorithm_params_list=[(algo, IdParams(id=i)) for i in algo_ids],
        serving_params=("serve", IdParams(id=9)),
    )


def test_train_wiring_single_algo():
    result = make_engine().train(ctx, make_params())
    (model,) = result.models
    assert model.algo_id == 3
    assert model.pd.prep_id == 2
    assert model.pd.td.ds_id == 1


def test_train_multi_algorithm():
    result = make_engine().train(ctx, make_params(algo_ids=(3, 4, 5)))
    assert [m.algo_id for m in result.models] == [3, 4, 5]
    assert all(m.pd.td.ds_id == 1 for m in result.models)


def test_sanity_check_failure_propagates():
    ep = make_params()
    ep.data_source_params = ("ds", IdParams(id=1, fail_sanity=True))
    with pytest.raises(ValueError, match="TD sanity failure"):
        make_engine().train(ctx, ep)
    result = make_engine().train(ctx, ep,
                                 WorkflowParams(skip_sanity_check=True))
    assert result.models is not None


def test_stop_after_read_and_prepare():
    e = make_engine()
    r1 = e.train(ctx, make_params(), WorkflowParams(stop_after_read=True))
    assert r1.stopped_after == "read"
    assert r1.models is None and r1.training_data.ds_id == 1
    r2 = e.train(ctx, make_params(), WorkflowParams(stop_after_prepare=True))
    assert r2.stopped_after == "prepare"
    assert r2.prepared_data.prep_id == 2


@pytest.mark.parametrize("algo_ids", [(3,), (3, 4), (2, 5, 7)])
def test_eval_wiring(algo_ids):
    results = make_engine().eval(ctx, make_params(algo_ids=algo_ids))
    assert len(results) == 2  # 2 folds
    for fold, (ei, qpa) in enumerate(results):
        assert ei.ds_id == 1 and ei.fold == fold
        assert len(qpa) == 2
        for q, p, a in qpa:
            assert a.q == q.q
            # serving sums algo ids: every algorithm's prediction arrived
            assert p.algo_id == sum(algo_ids)
            assert p.q == q.q
    jax_engine = JaxEngine(
        data_source_classes={"ds": jax_sample.DataSource0},
        preparator_classes={"prep": jax_sample.Preparator0},
        algorithm_classes={"algo": jax_sample.Algo0},
        serving_classes={"serve": jax_sample.Serving0})
    jax_results = jax_engine.eval(MeshContext(), JaxEngineParams(
        data_source_params=("ds", jax_sample.IdParams(id=1)),
        preparator_params=("prep", jax_sample.IdParams(id=2)),
        algorithm_params_list=[("algo", jax_sample.IdParams(id=i))
                               for i in algo_ids],
        serving_params=("serve", jax_sample.IdParams(id=9))))
    assert str(results) == str(jax_results)


def test_eval_with_no_eval_data_is_empty():
    """The default ``DataSource.read_eval`` gives no folds."""
    from predictionio_torch.core import DataSource

    class TrainOnly(DataSource):
        def read_training(self, ctx):
            return None

    engine = make_engine()
    engine.data_source_classes["train-only"] = TrainOnly
    ep = make_params()
    ep.data_source_params = ("train-only", EmptyParams())
    assert engine.eval(ctx, ep) == []


def test_unknown_component_name():
    with pytest.raises(KeyError, match="DataSource"):
        ep = make_params()
        ep.data_source_params = ("nope", IdParams())
        make_engine().train(ctx, ep)


def test_empty_algorithm_list_rejected():
    ep = make_params()
    ep.algorithm_params_list = []
    with pytest.raises(ValueError):
        make_engine().train(ctx, ep)


def test_doer_create_no_params_ctor():
    ep = make_params()
    ep.algorithm_params_list = [("noparams", EmptyParams())]
    result = make_engine().train(ctx, ep)
    assert result.models[0].algo_id == -1


def test_builtin_servings():
    assert FirstServing.create().serve(
        None, [Prediction(1, 0), Prediction(2, 0)]).algo_id == 1
    assert AverageServing.create().serve(None, [1.0, 2.0, 3.0]) == 2.0
    td = object()
    assert IdentityPreparator.create().prepare(ctx, td) is td


def test_variant_to_engine_params():
    variant = {
        "id": "default",
        "engineFactory": "ignored.Here",
        "datasource": {"name": "ds", "params": {"id": 7}},
        "preparator": {"name": "prep", "params": {"id": 8}},
        "algorithms": [
            {"name": "algo", "params": {"id": 1}},
            {"name": "algo", "params": {"id": 2}},
        ],
        "serving": {"name": "serve", "params": {"id": 9}},
    }
    ep = make_engine().engine_params_from_variant(variant)
    assert ep.data_source_params == ("ds", IdParams(id=7))
    assert [p.id for _, p in ep.algorithm_params_list] == [1, 2]
    result = make_engine().train(ctx, ep)
    assert [m.algo_id for m in result.models] == [1, 2]


def test_variant_unknown_param_fails_fast():
    with pytest.raises(ValueError, match="unknown params"):
        make_engine().engine_params_from_variant({
            "engineFactory": "x.Y",
            "datasource": {"name": "ds", "params": {"bogus": 1}},
            "algorithms": [{"name": "algo", "params": {}}]})


def test_params_from_dict():
    p = params_from_dict(IdParams, {"id": 5})
    assert p == IdParams(id=5)
    assert params_from_dict(None, {}) == EmptyParams()
    with pytest.raises(ValueError):
        params_from_dict(None, {"x": 1})


# -- train persistence -----------------------------------------------------------

def test_persistent_model_path(port_storage, tmp_path, monkeypatch):
    """A PersistentModel saves itself at ``run_train``; the Models repo
    holds its manifest, and ``prepare_deploy`` loads it through the
    manifest's class (ref: EngineWorkflowTest train-persistence)."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    engine = make_engine()
    instance = run_train(engine, make_params(algo="persistent"),
                         engine_id="e", ctx=ctx, storage=port_storage)
    assert instance.status == "COMPLETED"
    blob = pickle.loads(port_storage.models().get(instance.id).models)
    assert blob == [PersistentModelManifest(
        class_name="PersistentModel0", module_name="tests.torch_sample_engine")]
    assert (tmp_path / "persistent_models" / instance.id).exists()
    deployment = prepare_deploy(engine, instance, ctx, port_storage)
    assert deployment.query(Query(q=1)).algo_id == 3


def test_plain_models_pickle_whole(port_storage):
    engine = make_engine()
    instance = run_train(engine, make_params(algo_ids=(3, 4)),
                         engine_id="e", ctx=ctx, storage=port_storage)
    blob = pickle.loads(port_storage.models().get(instance.id).models)
    assert [m.algo_id for m in blob] == [3, 4]
    deployment = prepare_deploy(engine, instance, ctx, port_storage)
    p = deployment.query(Query(q=42))
    assert (p.q, p.algo_id) == (42, 3 + 4)


# -- FakeRun ---------------------------------------------------------------------

def test_fake_run_executes_fn_through_eval_plumbing(port_storage):
    seen = []

    def fn(c):
        assert isinstance(c, DeviceContext) and c.device.type == "cpu"
        seen.append("ran")
        return 42

    assert fake_run(fn, ctx=ctx, storage=port_storage) == 42
    assert seen == ["ran"]
    # the run went through the real evaluation workflow: an instance was
    # created and completed, but no_save kept results out of the store
    instances = port_storage.evaluation_instances().get_all()
    assert len(instances) == 1
    assert instances[0].status == "EVALCOMPLETED"
    assert instances[0].evaluation_class == "FakeRun"
    assert instances[0].evaluator_results == ""
    assert instances[0].evaluator_results_json == ""


def test_fake_run_class_api(port_storage):
    assert FakeRun(lambda c: "ok").run(ctx, storage=port_storage) == "ok"


def test_fake_eval_result_no_save():
    r = FakeEvalResult()
    assert r.no_save is True
    assert "FakeEvalResult" in r.to_one_liner()


def test_fake_run_defaults_to_the_card(port_storage, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FakeRun(lambda c: None).run(storage=port_storage)
