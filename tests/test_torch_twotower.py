"""The two-tower training slice of the port against the JAX package.

- Trainer parity: the JAX trainer's initial state is carried into the
  port's trainer (``twotower_state_from_jax``) and JAX's epoch orders
  are passed in, so both walk the same batches from the same point.
  f32 runs agree epoch for epoch (losses 1e-4 / 1e-5, item vectors
  1e-3 / 1e-4, the JAX package's own kernel-vs-XLA trainer tolerances),
  with the kernels' plain versions and with the torch forms, and with a
  tail MLP under AdamW; bf16 within looser bounds (the logits round to
  bf16 at the same points, but sums run in another order).
- Kernel plan: the JAX package's selection cases on the CPU, and on a
  CUDA device both kernels whatever the flags (planned without touching
  a device).
- Data path: the same localfs events read by both packages' DataSource
  and Preparator give equal vocabularies, indices and ratings.
- Template end to end on the port's memory store, ``pio train`` and
  ``pio deploy`` through the port's CLI on the CPU, and a JAX-trained
  two-tower instance deployed by the port answering like the JAX
  package's deployment.
"""

import datetime as dt
import json

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.ops.twotower import TwoTowerConfig as JaxConfig
from predictionio_tpu.ops.twotower import TwoTowerTrainer as JaxTrainer
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates import recommendation as jax_reco
from predictionio_tpu.templates.twotower import (
    twotower_engine as jax_twotower_engine)
from predictionio_tpu.workflow.deploy import (
    prepare_deploy as jax_prepare_deploy)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.models.twotower import TwoTowerModel
from predictionio_torch.ops import twotower as tt
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import recommendation as reco
from predictionio_torch.templates.twotower import twotower_engine
from predictionio_torch.tools import cli
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.train import run_train

from tests.test_storage import make_storage
from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

JAX_FACTORY = "predictionio_tpu.templates.twotower.twotower_engine"
UTC = dt.timezone.utc


def _positives(n=520, n_users=80, n_items=50, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n), rng.integers(0, n_items, n),
            n_users, n_items)


def _carry(jax_trainer) -> tt.TwoTowerState:
    """The JAX trainer's current state as the port's, on the CPU."""
    tables, acc, dense, opt_state = jax_trainer._state
    adam = opt_state[0]

    def host(tree):
        return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)

    return tt.twotower_state_from_jax(
        host(tables), host(acc), host(dense), host(adam.mu), host(adam.nu),
        np.array(adam.count), device="cpu")


def _jax_orders(seed, n, epochs):
    base = jax.random.PRNGKey(seed + 1)
    return [np.asarray(jax.random.permutation(jax.random.fold_in(base, e), n))
            for e in range(epochs)]


@pytest.mark.parametrize("extra,l_tol,v_tol", [
    (dict(compute_dtype="float32", flash_ce_kernel="on",
          embed_update_kernel="on"), (1e-4, 1e-5), (1e-3, 1e-4)),
    (dict(compute_dtype="float32", flash_ce_kernel="off",
          embed_update_kernel="off"), (1e-4, 1e-5), (1e-3, 1e-4)),
    (dict(compute_dtype="float32", hidden=(16,)), (1e-4, 1e-5),
     (1e-3, 1e-4)),
    (dict(compute_dtype="bfloat16", flash_ce_kernel="on",
          embed_update_kernel="on"), (1e-3, 1e-3), (5e-2, 2e-2)),
], ids=["f32-kernels", "f32-torch-forms", "f32-adamw-tail", "bf16-kernels"])
def test_trainer_matches_jax_trainer_from_carried_state(extra, l_tol, v_tol):
    u, i, n_users, n_items = _positives()
    base = dict(dim=8, epochs=2, batch_size=128, seed=7, learning_rate=1e-2,
                **extra)
    ref = JaxTrainer((u, i, None), n_users, n_items, JaxConfig(**base))
    state = _carry(ref)
    port = tt.TwoTowerTrainer((u, i, None), n_users, n_items,
                              tt.TwoTowerConfig(**base), device="cpu",
                              state=state)
    on = extra.get("flash_ce_kernel") == "on"
    assert port.kernel_plan["flash_ce"] is on
    assert port.kernel_plan["embed_update"] is on
    l_ref = ref.run()
    l_port = port.run(perms=_jax_orders(7, len(u), 2))
    np.testing.assert_allclose(l_port, l_ref, rtol=l_tol[0], atol=l_tol[1])
    e_ref, e_port = ref.embeddings(l_ref), port.embeddings(l_port)
    for got, want in ((e_port.item_vecs, e_ref.item_vecs),
                      (e_port.user_vecs, e_ref.user_vecs)):
        np.testing.assert_allclose(got, want, rtol=v_tol[0], atol=v_tol[1])


def test_trainer_learns_on_its_own_init_and_order():
    """Without a carried state the port draws its own init and epoch
    orders (torch generators seeded from cfg.seed): losses fall and the
    vectors are unit-norm."""
    u, i, n_users, n_items = _positives()
    cfg = tt.TwoTowerConfig(dim=8, epochs=6, batch_size=128, seed=3,
                            learning_rate=1e-2)
    emb = tt.twotower_train((u, i, None), n_users, n_items, cfg,
                            device="cpu")
    assert emb.losses[-1] < emb.losses[0]
    np.testing.assert_allclose(np.linalg.norm(emb.item_vecs, axis=1), 1.0,
                               atol=1e-5)


# -- kernel plan ---------------------------------------------------------------

def _plan(batch=256, device="cpu", **flags):
    cfg = tt.TwoTowerConfig(dim=8, batch_size=batch, **flags)
    return tt.plan_kernels(cfg, batch, torch.device(device))


def test_kernel_plan_auto_is_off_on_cpu():
    plan = _plan()
    assert plan["flash_ce"] is False and plan["embed_update"] is False
    assert "auto" in plan["flash_ce_reason"]


def test_kernel_plan_on_engages_the_plain_versions_on_cpu():
    plan = _plan(flash_ce_kernel="on", embed_update_kernel="on")
    assert plan["flash_ce"] is True and plan["embed_update"] is True


def test_kernel_plan_env_beats_config(monkeypatch):
    monkeypatch.setenv("PIO_TT_FLASH_CE", "off")
    monkeypatch.setenv("PIO_TT_EMBED_UPDATE", "off")
    plan = _plan(flash_ce_kernel="on", embed_update_kernel="on")
    assert plan["flash_ce"] is False and plan["embed_update"] is False
    monkeypatch.setenv("PIO_TT_FLASH_CE", "on")
    assert _plan()["flash_ce"] is True


def test_kernel_plan_small_batch_is_ineligible():
    for device in ("cpu", "cuda:0"):
        plan = _plan(batch=64, device=device, flash_ce_kernel="on")
        assert plan["flash_ce"] is False
        assert "batch 64 < 128" in plan["flash_ce_reason"]
    plan = _plan(temperature=0.01, device="cuda:0")
    assert plan["flash_ce"] is False and "direct-exp" in (
        plan["flash_ce_reason"])


def test_kernel_plan_on_a_cuda_device_ignores_the_flags(monkeypatch):
    """No flag and no environment takes a kernel off the card."""
    monkeypatch.setenv("PIO_TT_FLASH_CE", "off")
    monkeypatch.setenv("PIO_TT_EMBED_UPDATE", "off")
    plan = _plan(device="cuda:0", flash_ce_kernel="off",
                 embed_update_kernel="off")
    assert plan["flash_ce"] is True and plan["embed_update"] is True
    assert plan["device"] == "cuda:0"


def test_unported_options_raise_naming_their_roadmap_item():
    """``shard_embeddings`` with no mesh, or a mesh whose ``model`` axis
    has one rank, keeps the tables whole, as the JAX trainer does: both
    train as the JAX trainer with the option set (f32 tolerances of the
    carried-state test). Worlds of several processes:
    ``tests/test_torch_sharded_twotower.py``."""
    from predictionio_torch.parallel.mesh import create_mesh

    u, i, n_users, n_items = _positives()
    base = dict(dim=8, epochs=2, batch_size=128, seed=7, learning_rate=1e-2,
                compute_dtype="float32", shard_embeddings=True)
    ref = JaxTrainer((u, i, None), n_users, n_items, JaxConfig(**base))
    state = _carry(ref)
    l_ref = ref.run()
    e_ref = ref.embeddings(l_ref)
    for mesh in (None, create_mesh({"data": 1, "model": 1})):
        port = tt.TwoTowerTrainer((u, i, None), n_users, n_items,
                                  tt.TwoTowerConfig(**base), device="cpu",
                                  state=state, mesh=mesh)
        assert port.slabs == {"user": (0, n_users), "item": (0, n_items)}
        l_port = port.run(perms=_jax_orders(7, len(u), 2))
        np.testing.assert_allclose(l_port, l_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(port.embeddings().item_vecs,
                                   e_ref.item_vecs, rtol=1e-3, atol=1e-4)


# -- data path -----------------------------------------------------------------

def _seed_block_events(storage, event_cls, app_name, channel=None):
    """30 users x 12 items in two blocks: users 0-14 rate items 0-5 high
    and 6-11 low, users 15-29 the other way round; a few buys. With
    ``channel`` (the JAX package's storage only) the events go into a
    new channel of the app."""
    app = storage.apps().insert(app_name)
    channel_id = (None if channel is None
                  else storage.channels().insert(channel, app.id).id)
    storage.events().init(app.id, channel_id)
    rng = np.random.default_rng(42)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    events = []
    for u in range(30):
        liked = range(6) if u < 15 else range(6, 12)
        disliked = range(6, 12) if u < 15 else range(6)
        for items, rating, p in ((liked, 5.0, 0.8), (disliked, 1.0, 0.5)):
            for i in items:
                if rng.random() < p:
                    events.append(dict(
                        event="rate", entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}",
                        properties={"rating": rating},
                        event_time=t0 + dt.timedelta(minutes=len(events))))
        if u % 7 == 0:
            events.append(dict(
                event="buy", entity_type="user", entity_id=f"u{u}",
                target_entity_type="item", target_entity_id=f"i{u % 12}",
                event_time=t0 + dt.timedelta(minutes=len(events))))
    storage.events().insert_batch([event_cls(**e) for e in events], app.id,
                                  channel_id)
    return len(events)


@pytest.mark.parametrize("columnar,channel", [
    (True, None), (False, None), (True, "mobile")])
def test_both_packages_read_the_same_prepared_ratings(tmp_path, columnar,
                                                      channel):
    jax_storage = make_storage("localfs", tmp_path)
    n = _seed_block_events(jax_storage, JaxEvent, "reco-read", channel)
    params = {"app_name": "reco-read", "columnar": columnar,
              "channel_name": channel}
    jax_set_storage(jax_storage)
    try:
        ds = jax_reco.RecoDataSource(jax_reco.RecoDataSourceParams(**params))
        want = jax_reco.RecoPreparator().prepare(
            None, ds.read_training(MeshContext()))
    finally:
        jax_set_storage(None)
    set_storage(Storage.from_env({
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}))
    try:
        ds = reco.RecoDataSource(reco.RecoDataSourceParams(**params))
        got = reco.RecoPreparator().prepare(
            None, ds.read_training(DeviceContext("cpu")))
    finally:
        set_storage(None)
    assert len(got.user_idx) == n
    assert list(got.user_ids.keys()) == list(want.user_ids.keys())
    assert list(got.item_ids.keys()) == list(want.item_ids.keys())
    np.testing.assert_array_equal(got.user_idx, want.user_idx)
    np.testing.assert_array_equal(got.item_idx, want.item_idx)
    np.testing.assert_array_equal(got.ratings, want.ratings)


# -- template, CLI and deploy ---------------------------------------------------

VARIANT = {
    "engineFactory": "predictionio_torch.templates.twotower.twotower_engine",
    "datasource": {"name": "", "params": {"app_name": "tt-app"}},
    "algorithms": [{"name": "twotower", "params": {
        "dim": 8, "epochs": 25, "batch_size": 64, "learning_rate": 1e-2,
        "min_rating": 3.0}}],
}


def _block_heavy(answer) -> bool:
    items = [e["item"] for e in answer["itemScores"]]
    return len(items) == 4 and sum(int(i[1:]) < 6 for i in items) >= 3


def test_template_end_to_end_on_the_memory_store():
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    _seed_block_events(storage, Event, "tt-app")
    set_storage(storage)
    try:
        engine = twotower_engine()
        ctx = DeviceContext("cpu")
        instance = run_train(engine, engine.engine_params_from_variant(
            VARIANT), engine_id="tt", ctx=ctx, storage=storage)
        assert instance.status == "COMPLETED"
        deployment = prepare_deploy(engine, instance, ctx, storage)
    finally:
        set_storage(None)
    model = deployment.models[0]
    assert isinstance(model, TwoTowerModel)
    assert model.train_losses[-1] < model.train_losses[0]
    # u3 rates block-0 items 5.0 and block-1 items 1.0; min_rating=3
    # keeps the positives, so its answers are block-0 heavy
    assert _block_heavy(deployment.query({"user": "u3", "num": 4}))
    assert deployment.query({"user": "nobody", "num": 3}) == {
        "itemScores": []}


def test_cli_train_then_deploy_on_the_cpu(tmp_path, monkeypatch):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    _seed_block_events(Storage.from_env(env), Event, "tt-app")
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({**VARIANT, "engineId": "tt-cli"}))
    set_storage(None)
    try:
        assert cli.main(["train", "--engine-json", str(engine_json),
                         "--device", "cpu"]) == 0
    finally:
        set_storage(None)
    storage = Storage.from_env(env)
    instance = storage.engine_instances().get_latest_completed(
        "tt-cli", "0", "default")
    assert instance is not None
    assert json.loads(instance.algorithms_params)[0]["params"]["dim"] == 8
    deployment = prepare_deploy(twotower_engine(), instance,
                                DeviceContext("cpu"), storage)
    assert _block_heavy(deployment.query({"user": "u3", "num": 4}))


def test_jax_trained_instance_deploys_on_the_port_with_equal_answers(
        tmp_path):
    jax_storage = make_storage("localfs", tmp_path)
    _seed_block_events(jax_storage, JaxEvent, "tt-app")
    engine = jax_twotower_engine()
    ep = engine.engine_params_from_variant({**VARIANT,
                                            "engineFactory": JAX_FACTORY})
    jax_set_storage(jax_storage)
    try:
        instance = jax_run_train(engine, ep, engine_id="tt-jax",
                                 engine_factory=JAX_FACTORY,
                                 storage=jax_storage, ctx=MeshContext())
    finally:
        jax_set_storage(None)
    jax_deployment = jax_prepare_deploy(engine, instance, MeshContext(),
                                        jax_storage)
    storage = Storage.from_env({
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")})
    port_instance = storage.engine_instances().get(instance.id)
    deployment = prepare_deploy(twotower_engine(), port_instance,
                                DeviceContext("cpu"), storage)
    assert isinstance(deployment.models[0], TwoTowerModel)
    for q in ({"user": "u3", "num": 4}, {"user": "u20", "num": 6},
              {"item": "i2", "num": 5}, {"user": "u9", "num": 3,
                                         "blacklist": ["i0", "i1"]},
              {"user": "nobody", "num": 3}):
        got, want = deployment.query(q), jax_deployment.query(q)
        assert [e["item"] for e in got["itemScores"]] == \
            [e["item"] for e in want["itemScores"]], q
        np.testing.assert_allclose(
            [e["score"] for e in got["itemScores"]],
            [e["score"] for e in want["itemScores"]], rtol=1e-5, atol=1e-5)


HYBRID_FACTORY = "predictionio_tpu.templates.twotower.twotower_hybrid_engine"
HYBRID_VARIANT = {
    "engineFactory": HYBRID_FACTORY,
    "datasource": {"name": "", "params": {"app_name": "tt-app"}},
    "algorithms": [
        {"name": "als", "params": {"rank": 4, "num_iterations": 4,
                                   "block_size": 32}},
        {"name": "twotower", "params": {"dim": 4, "epochs": 4,
                                        "batch_size": 32}}],
}


def test_jax_trained_hybrid_deploys_on_the_port_and_port_training_raises(
        tmp_path):
    """The ALS + two-tower hybrid: a JAX-trained instance deploys on the
    port and averages the same scores. Training it with the port raised
    at ALS until ALS training was ported; now the port trains both
    algorithms to a COMPLETED instance whose deployment answers."""
    from predictionio_tpu.templates.twotower import (
        twotower_hybrid_engine as jax_hybrid_engine)
    from predictionio_torch.templates.twotower import twotower_hybrid_engine

    jax_storage = make_storage("localfs", tmp_path)
    _seed_block_events(jax_storage, JaxEvent, "tt-app")
    engine = jax_hybrid_engine()
    jax_set_storage(jax_storage)
    try:
        instance = jax_run_train(
            engine, engine.engine_params_from_variant(HYBRID_VARIANT),
            engine_id="tt-h", engine_factory=HYBRID_FACTORY,
            storage=jax_storage, ctx=MeshContext())
    finally:
        jax_set_storage(None)
    jax_deployment = jax_prepare_deploy(engine, instance, MeshContext(),
                                        jax_storage)
    storage = Storage.from_env({
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")})
    port_engine = twotower_hybrid_engine()
    deployment = prepare_deploy(port_engine,
                                storage.engine_instances().get(instance.id),
                                DeviceContext("cpu"), storage)
    for q in ({"user": "u1", "num": 3}, {"user": "u22", "num": 5}):
        got, want = deployment.query(q), jax_deployment.query(q)
        assert [e["item"] for e in got["itemScores"]] == \
            [e["item"] for e in want["itemScores"]]
        np.testing.assert_allclose(
            [e["score"] for e in got["itemScores"]],
            [e["score"] for e in want["itemScores"]], rtol=1e-5, atol=1e-5)

    set_storage(storage)
    try:
        port_instance = run_train(
            port_engine, port_engine.engine_params_from_variant(
                HYBRID_VARIANT), engine_id="tt-h-port",
            ctx=DeviceContext("cpu"), storage=storage)
        port_deployment = prepare_deploy(port_engine, port_instance,
                                         DeviceContext("cpu"), storage)
    finally:
        set_storage(None)
    trained = [i for i in storage.engine_instances().get_all()
               if i.engine_id == "tt-h-port"]
    assert [i.status for i in trained] == ["COMPLETED"]
    answer = port_deployment.query({"user": "u1", "num": 3})["itemScores"]
    assert len(answer) == 3
    assert all(np.isfinite(e["score"]) for e in answer)
