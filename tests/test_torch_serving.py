"""The serving slice as a whole: a JAX-trained instance served by both
packages' engine servers must give the same answers.

A tiny ALS model is trained once with the JAX package into a localfs
store (rank 8, f32, as tests/test_stream.py trains). The JAX
``EngineServer`` and the port's ``EngineServer(device="cpu")`` deploy
it from that same store — the port reading the JAX blob through its
remapping unpickler and the JAX factory path through
``resolve_engine_factory`` — and get the same ``POST /queries.json``
list: every answer must hold the same items in the same order, scores
equal to 1e-5 (f32 products summed in another order).
"""

import datetime as _dt
import json
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine)
from predictionio_tpu.workflow.train import run_train
from predictionio_torch.core.engine import resolve_engine_factory
from predictionio_torch.data.metadata import EngineInstance, Model
from predictionio_torch.data.storage import Storage
from predictionio_torch.models.als import ALSAlgorithm, als_model_from_arrays
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.serving.engine_server import deploy
from predictionio_torch.tools import cli
from predictionio_torch.workflow.deploy import latest_completed_instance_id

from tests.test_storage import make_storage

torch.set_num_threads(1)

JAX_FACTORY = "predictionio_tpu.templates.recommendation.recommendation_engine"
ENGINE_ID = "torch_parity"
N_USERS, N_ITEMS = 30, 40

QUERIES = [
    {"user": "u1", "num": 5},
    {"user": "u7", "num": 12},
    {"user": "u2", "num": 100},                        # k beyond the catalog
    {"user": "u3", "num": 6, "blacklist": ["i1", "i2", "nope"]},
    {"user": "u4", "num": 4, "whitelist": ["i3", "i5", "i8", "i9"]},
    {"item": "i3", "num": 5},
    {"item": "i10", "num": 8, "blacklist": ["i11"]},
    {"user": "no-such-user", "num": 5},
    {"item": "no-such-item", "num": 5},
]


def _store_env(tmp_path):
    return {
        "PIO_STORAGE_SOURCES_S_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "store"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "events",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "models",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One JAX training run into a localfs store, served by JAX."""
    tmp_path = tmp_path_factory.mktemp("torch_serving")
    storage = make_storage("localfs", tmp_path)
    jax_set_storage(storage)
    try:
        app = storage.apps().insert("parity")
        storage.events().init(app.id)
        rng = np.random.default_rng(3)
        now = _dt.datetime.now(tz=_dt.timezone.utc)
        storage.events().insert_batch([
            Event(event="rate", entity_type="user",
                  entity_id=f"u{rng.integers(N_USERS)}",
                  target_entity_type="item",
                  target_entity_id=f"i{rng.integers(N_ITEMS)}",
                  properties={"rating": float(rng.integers(1, 11)) / 2},
                  event_time=now)
            for _ in range(500)], app.id)
        engine = jax_recommendation_engine()
        ep = engine.engine_params_from_variant({
            "datasource": {"params": {"app_name": "parity"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 8, "num_iterations": 4, "compute_dtype": "float32",
                "cg_dtype": "float32", "cg_iters": 8}}],
        })
        instance = run_train(engine, ep, engine_id=ENGINE_ID,
                             engine_factory=JAX_FACTORY, storage=storage)
        assert instance.status == "COMPLETED"
        server = JaxServer(engine, ENGINE_ID, host="127.0.0.1", port=0,
                           storage=storage, micro_batch=False).start()
    finally:
        jax_set_storage(None)
    try:
        yield tmp_path, instance, server
    finally:
        server.stop()


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _same_answer(a, b):
    assert [e["item"] for e in a["itemScores"]] == \
        [e["item"] for e in b["itemScores"]]
    np.testing.assert_allclose([e["score"] for e in a["itemScores"]],
                               [e["score"] for e in b["itemScores"]],
                               rtol=1e-5, atol=1e-5)


def _port_server(tmp_path, instance, **kw):
    storage = Storage.from_env(_store_env(tmp_path))
    assert latest_completed_instance_id(storage, ENGINE_ID) == instance.id
    engine = resolve_engine_factory(instance.engine_factory)()
    return deploy(engine, ENGINE_ID, host="127.0.0.1", port=0,
                  storage=storage, device="cpu", **kw)


@pytest.mark.parametrize("index_kernel", ["auto", "on"])
def test_port_answers_like_jax(world, monkeypatch, index_kernel):
    """``on`` runs the topk_dot kernel's plain version in the port (the
    JAX server stays on its XLA scorer: both are exact)."""
    tmp_path, instance, jax_server = world
    monkeypatch.setenv("PIO_INDEX_KERNEL", index_kernel)
    server = _port_server(tmp_path, instance, micro_batch=False)
    try:
        status = _get(server.port, "/")
        assert status["engineInstanceId"] == instance.id
        assert status["device"] == "cpu"
        plan = status["retrieval"][0]["kernel"]
        assert plan["engaged"] == (index_kernel == "on")
        for q in QUERIES:
            _same_answer(_post(server.port, q), _post(jax_server.port, q))
    finally:
        server.stop()


def test_micro_batched_burst_answers_like_jax(world):
    tmp_path, instance, jax_server = world
    server = _port_server(tmp_path, instance, micro_batch=True)
    try:
        # item-only queries fail the batch path (KeyError, as in the JAX
        # package), so a batch holding one is re-run one query at a time
        burst = [{"user": f"u{j % N_USERS}", "num": 5} if j % 6 else
                 {"item": f"i{j}", "num": 4} for j in range(24)]
        answers = [None] * len(burst)

        def send(j):
            answers[j] = _post(server.port, burst[j])

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(len(burst))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for q, got in zip(burst, answers):
            _same_answer(got, _post(jax_server.port, q))
        hist = _get(server.port, "/")["batcher"]
        assert hist["dispatches"] >= 1
    finally:
        server.stop()


def test_reload_and_unknown_routes(world):
    tmp_path, instance, _ = world
    server = _port_server(tmp_path, instance, micro_batch=False)
    try:
        assert _get(server.port, "/reload")["engineInstanceId"] == instance.id
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/reload?instance=missing")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.port, {"num": 3})     # neither user nor item
        assert e.value.code == 400
    finally:
        server.stop()


def test_reload_reports_a_failed_warmup_as_500(world, monkeypatch):
    """A deployment that cannot warm up (a kernel that fails to build or
    launch) is a server error, not a missing instance; the live one
    keeps serving."""
    tmp_path, instance, jax_server = world
    server = _port_server(tmp_path, instance, micro_batch=False)
    try:
        def broken(self, model, ctx):
            raise RuntimeError("topk_dot launch failed (test)")

        monkeypatch.setattr(ALSAlgorithm, "warmup", broken)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/reload")
        assert e.value.code == 500
        assert "topk_dot launch failed" in json.loads(e.value.read())[
            "message"]
        q = QUERIES[0]
        _same_answer(_post(server.port, q), _post(jax_server.port, q))
    finally:
        server.stop()


@pytest.mark.parametrize("backend", ["memory", "localfs"])
def test_port_written_instance_serves(tmp_path, backend):
    """What chip_smoke.py's serve phase does on the card, small and on
    the CPU: factors -> ``als_model_from_arrays`` -> an instance and its
    blob written through the port's storage -> the port's engine server.
    Answers against a float64 host computation under (score desc, id
    asc); a localfs instance the port wrote is also the JAX package's
    latest completed one."""
    rng = np.random.default_rng(9)
    U = rng.normal(size=(12, 6)).astype(np.float32)
    V = rng.normal(size=(50, 6)).astype(np.float32)
    users = [f"u{j}" for j in range(12)]
    items = [f"i{j}" for j in range(50)]
    model = als_model_from_arrays(U, V, users, items, rank=6,
                                  index_kernel="on")
    env = ({"PIO_STORAGE_SOURCES_M_TYPE": "memory"} if backend == "memory"
           else _store_env(tmp_path))
    storage = Storage.from_env(env)
    now = _dt.datetime.now(tz=_dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id="port-written", status="COMPLETED", start_time=now, end_time=now,
        engine_id=ENGINE_ID, engine_version="0", engine_variant="default",
        engine_factory=JAX_FACTORY,
        algorithms_params=json.dumps([{"name": "als", "params": {
            "rank": 6, "index_kernel": "on"}}])))
    storage.models().insert(Model(id="port-written",
                                  models=pickle.dumps([model])))
    if backend == "localfs":
        jax_instance = JaxStorage.from_env(env).engine_instances(
            ).get_latest_completed(ENGINE_ID, "0", "default")
        assert jax_instance.id == "port-written"
    engine = resolve_engine_factory(JAX_FACTORY)()
    server = deploy(engine, ENGINE_ID, host="127.0.0.1", port=0,
                    storage=storage, device="cpu", micro_batch=False)
    try:
        assert _get(server.port, "/")["retrieval"][0]["kernel"]["engaged"]
        for q, qvec, banned in (
                ({"user": "u3", "num": 7}, U[3], set()),
                ({"user": "u4", "num": 5, "blacklist": ["i0", "i7"]},
                 U[4], {0, 7}),
                ({"item": "i9", "num": 6}, V[9], {9})):
            scores = V.astype(np.float64) @ qvec.astype(np.float64)
            cand = np.array([j for j in range(50) if j not in banned])
            order = cand[np.lexsort((cand, -scores[cand]))][:q["num"]]
            got = _post(server.port, q)["itemScores"]
            assert [e["item"] for e in got] == [items[j] for j in order]
            np.testing.assert_allclose([e["score"] for e in got],
                                       scores[order], rtol=1e-5, atol=1e-5)
        assert _post(server.port, {"user": "ghost"}) == {"itemScores": []}
    finally:
        server.stop()


def test_cli_resolves_a_jax_engine_json(tmp_path):
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({"id": "default", "engineFactory": JAX_FACTORY}))
    engine, variant = cli.engine_from_json(str(path))
    algo = engine.algorithm_classes["als"]
    assert algo.__module__ == "predictionio_torch.models.als"
    args = cli.build_parser().parse_args(
        ["deploy", "--engine-json", str(path), "--device", "cpu",
         "--port", "0"])
    assert args.device == "cpu" and args.func is cli.cmd_deploy


def test_device_context_needs_cuda_unless_asked_for_cpu():
    ctx = DeviceContext(device="cpu", seed=5)
    assert ctx.device.type == "cpu" and ctx.data_parallel_size() == 1
    assert torch.rand(3, generator=ctx.rng()).shape == (3,)
    if torch.cuda.is_available():
        assert DeviceContext().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceContext()
