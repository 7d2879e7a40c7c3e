"""The replay acceptance test of the port's deployed-engine slice
(``predictionio_torch/workflow/replay.py``, ``obs/quality.py``).

One seeded event log goes into a memory store of each package, and
each package trains the recommendation engine on it on the CPU (ALS,
rank 4, the direct solver in float32, 5 iterations). The two trainers
draw their initial factors from different generators (``jax.random``
and ``torch.Generator``), so the port's trainer is started from the
JAX trainer's draw, as ``tests/test_torch_als.py`` does. Both engine
servers run in this process on port 0. Queries sent to the port server
are captured by its flight recorder (``PIO_FLIGHT_PAYLOADS``), fetched
back through ``/admin/flight`` and replayed against both servers with
the port's ``replay``: ``compare_answers`` must report a mean top-k
overlap of at least 0.99, any differing id only at a near-tie, and
every shared score within the ALS answer band of
``tests/test_torch_serving.py`` (rtol = atol = 1e-5); the two trainers'
scores differed by at most 2.6e-5 on scores up to 4.9 when this was
written. ``pio replay`` does the same from the command line.
"""

from __future__ import annotations

import datetime as dt
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.ops import als as port_als
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.templates.recommendation import recommendation_engine
from predictionio_torch.tools import cli
from predictionio_torch.workflow import replay as replay_mod
from predictionio_torch.workflow.train import run_train
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.serving.engine_server import EngineServer as JaxServer
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine)
from predictionio_tpu.workflow.train import run_train as jax_run_train

from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state)

UTC = dt.timezone.utc
ENGINE_ID = "torch_replay"
SEED = 3
N_USERS, N_ITEMS = 40, 30


def _events(cls, n=1500, seed=0):
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    return [cls(event="rate", entity_type="user",
                entity_id=f"u{rng.integers(N_USERS)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.zipf(1.3) % N_ITEMS}",
                properties={"rating": float(rng.integers(1, 6))},
                event_time=t0 + dt.timedelta(seconds=j))
            for j in range(n)]


def _variant(factory):
    return {"engineFactory": factory,
            "datasource": {"params": {"app_name": "reco"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": 5, "lambda_": 0.1,
                "seed": SEED, "solver": "direct",
                "compute_dtype": "float32", "cg_dtype": "float32"}}]}


def _store(storage_cls, event_cls):
    storage = storage_cls.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    app = storage.apps().insert("reco")
    storage.events().init(app.id)
    storage.events().insert_batch(_events(event_cls), app.id)
    return storage


@pytest.fixture(scope="module")
def servers():
    """Both packages trained on the same events, both servers started,
    once for the module; yields (port URL, JAX URL)."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield from _servers(monkeypatch)


def _servers(monkeypatch):
    jax_storage = _store(JaxStorage, JaxEvent)
    jax_engine = jax_recommendation_engine()
    factory = "predictionio_tpu.templates.recommendation.recommendation_engine"
    jax_set_storage(jax_storage)
    try:
        jax_instance = jax_run_train(
            jax_engine, jax_engine.engine_params_from_variant(
                _variant(factory)), engine_id=ENGINE_ID,
            engine_factory=factory, storage=jax_storage, ctx=MeshContext())
    finally:
        jax_set_storage(None)
    assert jax_instance.status == "COMPLETED"

    # start the port's trainer from the JAX trainer's initial factors
    key_users, key_items = jax.random.split(jax.random.PRNGKey(SEED))
    keys = [key_users, key_items]

    def jax_draw(gen, n_groups, n_real, rank):
        return torch.tensor(np.array(jax_als._init_factors(
            keys.pop(0), n_groups, n_real, rank)))

    monkeypatch.setattr(port_als, "_init_factors", jax_draw)
    storage = _store(Storage, Event)
    engine = recommendation_engine()
    set_storage(storage)
    try:
        instance = run_train(
            engine, engine.engine_params_from_variant(_variant(
                "predictionio_torch.templates.recommendation."
                "recommendation_engine")), engine_id=ENGINE_ID,
            ctx=DeviceContext("cpu"), storage=storage)
    finally:
        set_storage(None)
    assert instance.status == "COMPLETED" and keys == []

    with no_thread_left():
        jax_server = JaxServer(jax_engine, ENGINE_ID, host="127.0.0.1",
                               port=0, storage=jax_storage,
                               micro_batch=False).start()
        try:
            port_server = EngineServer(
                engine, ENGINE_ID, host="127.0.0.1", port=0,
                storage=storage, device="cpu", micro_batch=False).start()
            try:
                yield (f"http://127.0.0.1:{port_server.port}",
                       f"http://127.0.0.1:{jax_server.port}")
            finally:
                port_server.stop()
        finally:
            jax_server.stop()


def _post(base, payload):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(payload).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.load(resp)


def _queries():
    rng = np.random.default_rng(11)
    users = [f"u{j}" for j in rng.choice(N_USERS, 16, replace=False)]
    items = [f"i{j}" for j in rng.choice(N_ITEMS, 6, replace=False)]
    return ([{"user": u, "num": 10} for u in users]
            + [{"item": i, "num": 5} for i in items]
            + [{"user": users[0], "num": 8, "blacklist": items[:3]},
               {"user": "nobody", "num": 3}])


def _same_up_to_near_ties(base, cand, tol):
    """Ids equal slot by slot, or differing only where the two scores
    are within ``tol``; the scores of the shared ids within the band."""
    b = {e["item"]: e["score"] for e in base["itemScores"]}
    c = {e["item"]: e["score"] for e in cand["itemScores"]}
    assert len(b) == len(c)
    for eb, ec in zip(base["itemScores"], cand["itemScores"]):
        assert eb["item"] == ec["item"] or abs(
            eb["score"] - ec["score"]) <= tol, (eb, ec)
    shared = sorted(set(b) & set(c))
    np.testing.assert_allclose([c[i] for i in shared],
                               [b[i] for i in shared],
                               rtol=1e-5, atol=1e-5)


def test_replay_of_captured_queries_agrees_with_the_jax_server(
        servers, monkeypatch, capsys):
    monkeypatch.setenv("PIO_FLIGHT_PAYLOADS", "64")
    monkeypatch.setenv("PIO_ADMIN_TOKEN", "replay-token")
    port_url, jax_url = servers
    queries = _queries()
    for q in queries:
        _post(port_url, q)
    payloads = replay_mod.fetch_payloads(port_url)
    assert [p["payload"] for p in payloads][-len(queries):] == queries
    report = replay_mod.replay(
        payloads[-len(queries):],
        candidate=replay_mod.http_target(port_url),
        baseline=replay_mod.http_target(jax_url), k=10)
    assert report["diffed"] == len(queries)
    assert report["errors"] == {"baseline": 0, "candidate": 0}
    assert report["mean_overlap"] >= 0.99, report
    assert report["mean_score_delta"] <= 1e-4, report
    for q in queries:
        _same_up_to_near_ties(_post(jax_url, q), _post(port_url, q),
                              tol=1e-4)
    # the same through the command line: the report lands on the
    # port server's quality surface
    assert cli.main(["replay", "--url", jax_url, "--baseline",
                     port_url, "-n", str(len(queries)), "--k", "10",
                     "--fail-under", "0.99"]) == 0
    out = capsys.readouterr().out
    assert f"replayed {len(queries)} logged quer(ies)" in out
    req = urllib.request.Request(
        port_url + "/admin/quality",
        headers={"Authorization": "Bearer replay-token"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        pushed = json.load(resp)["replay"]
    assert pushed["n"] == len(queries)
    assert pushed["mean_overlap"] >= 0.99
    assert "queries" not in pushed


def test_fetch_payloads_explains_redaction(servers, monkeypatch):
    monkeypatch.setenv("PIO_FLIGHT_PAYLOADS", "8")
    monkeypatch.delenv("PIO_ADMIN_TOKEN", raising=False)
    port_url, _ = servers
    _post(port_url, {"user": "u1", "num": 3})
    with pytest.raises(RuntimeError, match="PIO_ADMIN_TOKEN"):
        replay_mod.fetch_payloads(port_url)
