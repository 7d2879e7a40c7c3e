"""The slice end to end on the CPU: the Recommendation (ALS) engine
trained by the port's ``cli train`` over three port storage servers
(EVENTDATA sharded, everything at ``REPLICAS=2``) and deployed by
``cli deploy`` in a second process that shares nothing with the first
but the ``rest`` tier — the port's counterpart of JAX
``test_train_on_host_a_deploy_on_host_b``.

The rest read merges per-shard scans, so its rows (and the first-seen
id orders that number the factor rows) come in shard order. The events'
times are therefore laid out in that same order, and the reference
train reads them from one memory store in time order: the two trains
then see the same layout, the same initial factors and the same
arithmetic on the CPU, so the factors and the held-out RMSE are held
equal to 1e-6 of the largest factor magnitude and 1e-9. The second
process's answers equal the first process's deployment of the same
instance: scores to 1e-6, ids exact.

Also here: a JAX-trained ALS blob and instance written through the JAX
``rest`` client into a port storage server, deployed by the port through
its own client: the answers equal the JAX deployment's (scores to 1e-5:
the JAX package scores in f32 on its device, the port in f32 through
``topk_dot``'s plain version), which exercises the
``predictionio_tpu.`` -> ``predictionio_torch.`` unpickling of a blob
that crossed the wire.
"""

import datetime as dt
import json
import os

import numpy as np
import torch

from tests.test_torch_variant import _deploy_and_query
from tests.torch_operator_fixtures import port_operator_state  # noqa: F401
from tests.torch_storage_tier import (JAX, PORT, UTC, memory_storage, pkg,
                                      rest_env, servers)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECO = "predictionio_torch.templates.recommendation.recommendation_engine"
ALS_PARAMS = {"rank": 8, "num_iterations": 6, "lambda_": 0.05,
              "block_size": 64}


def _ratings(P, n_users=90, n_items=60, nnz=2400, seed=11):
    """Seeded rate events, every 20th held out as (user, item, rating);
    the training events' times follow their owner shard of three."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    r = np.round(np.clip(rng.normal(3.5, 1.0, nnz), 1, 5) * 2) / 2
    held = [(f"u{a}", f"i{b}", float(c))
            for j, (a, b, c) in enumerate(zip(u, i, r)) if j % 20 == 0]
    keep = [j for j in range(nnz) if j % 20]
    shard = [P.storage.stable_hash(f"u{u[j]}") % 3 for j in keep]
    order = [keep[k] for k in np.lexsort((keep, shard))]
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    events = [P.Event(event="rate", entity_type="user", entity_id=f"u{u[j]}",
                      target_entity_type="item", target_entity_id=f"i{i[j]}",
                      properties={"rating": float(r[j])},
                      event_time=t0 + dt.timedelta(seconds=s))
              for s, j in enumerate(order)]
    return events, held


def _variant(factory, engine_id):
    return {"engineFactory": factory, "engineId": engine_id,
            "datasource": {"name": "", "params": {"app_name": "reco"}},
            "algorithms": [{"name": "als", "params": ALS_PARAMS}]}


def _held_rmse(model, held) -> float:
    pred = [float(model.user_factors[model.user_ids[uu]]
                  @ model.item_factors[model.item_ids[ii]])
            if uu in model.user_ids and ii in model.item_ids else 0.0
            for uu, ii, _ in held]
    return float(np.sqrt(np.mean((np.array(pred)
                                  - np.array([c for *_, c in held])) ** 2)))


def _load(storage, engine_id):
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.templates.recommendation import \
        recommendation_engine
    from predictionio_torch.workflow.deploy import prepare_deploy

    instance = storage.engine_instances().get_latest_completed(
        engine_id, "0", "default")
    assert instance is not None and instance.status == "COMPLETED"
    return prepare_deploy(recommendation_engine(), instance,
                          DeviceContext("cpu"), storage)


def _train(P, storage, env, engine_json, monkeypatch):
    """``cli train --device cpu`` with ``storage`` as the process's
    storage (None: built from ``env``)."""
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    P.storage.set_storage(storage)
    try:
        assert P.cli.main(["train", "--engine-json", str(engine_json),
                           "--device", "cpu"]) == 0
    finally:
        P.storage.set_storage(None)


def test_train_over_the_rest_tier_then_deploy_in_a_second_process(
        tmp_path, monkeypatch):
    P = pkg(PORT)
    events, held = _ratings(P)

    ref = memory_storage(P)
    app = ref.apps().insert("reco")
    ref.events().init(app.id)
    ref.events().insert_batch(events, app.id)
    ej_ref = tmp_path / "ref.json"
    ej_ref.write_text(json.dumps(_variant(RECO, "reco-mem")))
    _train(P, ref, {}, ej_ref, monkeypatch)
    want = _load(ref, "reco-mem")

    with servers(P, 3) as (backends, srvs):
        env = rest_env([s.port for s in srvs], replicas=2, retries=1)
        tier = P.Storage.from_env(env)
        app = tier.apps().insert("reco")
        tier.events().init(app.id)
        tier.events().insert_batch(events, app.id)
        # rows on exactly two of the three servers
        assert sum(len(b.events().find(app.id)) for b in backends) == \
            2 * len(events)
        ej = tmp_path / "engine.json"
        ej.write_text(json.dumps(_variant(RECO, "reco-rest")))
        _train(P, None, env, ej, monkeypatch)
        got = _load(tier, "reco-rest")

        # the instance row and the blob sit on both metadata replicas
        inst = tier.engine_instances().get_latest_completed(
            "reco-rest", "0", "default")
        for b in backends[:2]:
            assert b.engine_instances().get(inst.id) is not None
            assert b.models().get(inst.id) is not None
        assert backends[2].engine_instances().get(inst.id) is None

        g, w = got.models[0], want.models[0]
        assert list(g.user_ids.keys()) == list(w.user_ids.keys())
        assert list(g.item_ids.keys()) == list(w.item_ids.keys())
        scale = max(np.abs(w.user_factors).max(),
                    np.abs(w.item_factors).max())
        for a, b in ((g.user_factors, w.user_factors),
                     (g.item_factors, w.item_factors)):
            assert np.abs(a - b).max() <= 1e-6 * scale
        rmse, rmse_ref = _held_rmse(g, held), _held_rmse(w, held)
        assert rmse < 1.2 and abs(rmse - rmse_ref) <= 1e-9, (rmse, rmse_ref)

        users = [f"u{j}" for j in (0, 7, 19, 33) if f"u{j}" in g.user_ids]
        items = [f"i{j}" for j in (2, 5) if f"i{j}" in g.item_ids]
        queries = [{"user": uu, "num": 6} for uu in users]
        queries += [{"item": ii, "num": 4} for ii in items]
        queries.append({"user": users[0], "num": 5, "blacklist": items})
        local = [got.query(q) for q in queries]

        sub_env = {**{k: v for k, v in os.environ.items()
                      if not k.startswith("PIO_STORAGE_")},
                   **env, "PYTHONPATH": ROOT}
        answers, code, modules = _deploy_and_query(ej, sub_env, queries)
    assert code == 0 and modules == []
    for q, a, b in zip(queries, answers, local):
        assert [s["item"] for s in a["itemScores"]] == \
            [s["item"] for s in b["itemScores"]], q
        np.testing.assert_allclose([s["score"] for s in a["itemScores"]],
                                   [s["score"] for s in b["itemScores"]],
                                   rtol=0, atol=1e-6)


def test_a_jax_trained_blob_crosses_a_port_server_and_deploys(tmp_path):
    """The JAX engine trains on its memory store; its instance and blob
    go through the JAX ``rest`` client into a port server; the port
    deploys them through its own client and answers like the JAX
    deployment."""
    from predictionio_tpu.parallel.mesh import MeshContext
    from predictionio_tpu.templates.recommendation import \
        recommendation_engine as jax_engine
    from predictionio_tpu.workflow.deploy import prepare_deploy as jax_deploy
    from predictionio_tpu.workflow.train import run_train as jax_train

    J, P = pkg(JAX), pkg(PORT)
    events, _ = _ratings(J, nnz=1200)
    jst = memory_storage(J)
    app = jst.apps().insert("reco")
    jst.events().init(app.id)
    jst.events().insert_batch(events, app.id)
    factory = "predictionio_tpu.templates.recommendation.recommendation_engine"
    engine = jax_engine()
    J.storage.set_storage(jst)
    try:
        instance = jax_train(engine, engine.engine_params_from_variant(
            _variant(factory, "reco-jax")), engine_id="reco-jax",
            engine_factory=factory, storage=jst, ctx=MeshContext())
        jax_deployment = jax_deploy(engine, instance, MeshContext(), jst)
    finally:
        J.storage.set_storage(None)

    with servers(P, 1) as (_, srvs):
        env = rest_env([srvs[0].port])
        jclient = J.Storage.from_env(env)
        jclient.engine_instances().insert(instance)
        jclient.models().insert(jst.models().get(instance.id))
        port_deployment = _load(P.Storage.from_env(env), "reco-jax")
    model = jax_deployment.models[0]
    users = list(model.user_ids.keys())[:5]
    items = list(model.item_ids.keys())[:3]
    for q in ([{"user": uu, "num": 5} for uu in users]
              + [{"item": ii, "num": 4} for ii in items]):
        a = port_deployment.query(q)["itemScores"]
        b = jax_deployment.query(q)
        b = b["itemScores"] if isinstance(b, dict) else b.item_scores
        b = [s if isinstance(s, dict) else {"item": s.item,
                                             "score": s.score} for s in b]
        assert [s["item"] for s in a] == [s["item"] for s in b], q
        np.testing.assert_allclose([s["score"] for s in a],
                                   [s["score"] for s in b],
                                   rtol=0, atol=1e-5)
