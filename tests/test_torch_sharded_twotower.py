"""Two-tower training of the port across gloo processes, on the CPU,
against the JAX package.

``TwoTowerTrainer(..., mesh=)`` splits the batch over ``data`` (each
rank looks up and runs the tails on its share, the tower outputs are
gathered and the loss is the whole batch's; the tail gradients are
summed and the table gradients gathered, so every rank applies the
whole batch's rowwise Adagrad) and, with ``shard_embeddings``, the
tables and their accumulators over ``model`` in contiguous slabs. Each
world is spawned once for the module (``tests/torch_world.py``):

- two ranks: DP (``{"data": 2}``, with and without a tail MLP) and TP
  (``{"data": 1, "model": 2}``, and with uneven slabs against the port's
  one-process trainer); a TP checkpoint saved by rank 0 alone and
  resumed by both, against the uninterrupted run; a restore whose
  directory is not shared, which raises on rank 1;
- four ranks: DP x TP (``{"data": 2, "model": 2}``);
- two ranks running ``pio train`` (``cli.main``) of the two-tower engine
  over one localfs store, twice with a checkpoint directory.

Every run starts from the JAX trainer's carried-over state and walks the
JAX trainer's epoch orders. Losses and both tables, f32, are held to the
JAX trainer on a mesh of the same axis sizes over ``jax.devices()[:n]``
and to the unsharded JAX trainer at the port's trainer tolerances
(losses rtol 1e-4 / atol 1e-5, vectors 1e-3 / 1e-4), and every rank's
losses and tables are equal.
"""

import json
import pickle

import jax
import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.twotower import TwoTowerModel as JaxModel
from predictionio_tpu.ops.als import ALSFactors
from predictionio_tpu.ops.twotower import TwoTowerConfig as JaxConfig
from predictionio_tpu.ops.twotower import TwoTowerTrainer as JaxTrainer
from predictionio_tpu.parallel.mesh import create_mesh as jax_mesh
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage
from predictionio_torch.ops import twotower as tt

from tests.test_torch_twotower import (VARIANT, _carry, _jax_orders,
                                       _seed_block_events)
from tests.torch_world import run_world

EPOCHS = 2
L_TOL, V_TOL = (1e-4, 1e-5), (1e-3, 1e-4)

_WORKER = """
import os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.core.checkpoint import TrainCheckpointer
from predictionio_torch.ops import twotower as tt
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import create_mesh

out = sys.argv[1]
assert mh.initialize_from_env(device="cpu")
r = mh.process_index()
with open(out + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)


def trainer(case, **over):
    cfg = tt.TwoTowerConfig(**{**case["cfg"], **over})
    return tt.TwoTowerTrainer(case["pos"], case["n_users"], case["n_items"],
                              cfg, device="cpu", mesh=create_mesh(case["axes"]),
                              state=tt.twotower_state_from_jax(
                                  *case["state"], device="cpu"))


def result(t, losses):
    emb = t.embeddings(losses)
    return {"losses": losses, "user_vecs": emb.user_vecs,
            "item_vecs": emb.item_vecs, "plan": dict(t.kernel_plan),
            "slabs": dict(t.slabs), "batch": t.batch,
            "flops": t.matmul_flops_per_step(),
            "tables": {s: t._whole(s, t.tables[s]).numpy()
                       for s in tt.SIDES}}


res = {}
for name, case in cases.items():
    if case.get("checkpoint"):
        ckpt = out + "/ckpt"
        first = trainer(case, checkpoint_dir=ckpt)
        first.run(1, perms=case["perms"])
        saved = {s: first._whole(s, first.tables[s]).numpy()
                 for s in tt.SIDES}
        resumed = trainer(case, checkpoint_dir=ckpt)
        res[name] = {"on_disk": sorted(os.listdir(ckpt)),
                     "saved_tables": saved,
                     "resumed_epochs": resumed._epochs_done,
                     "resumed_tables": {
                         s: resumed._whole(s, resumed.tables[s]).numpy()
                         for s in tt.SIDES},
                     **result(resumed, resumed.run(perms=case["perms"]))}
        # a directory that is not shared: rank 1 finds no checkpoint
        ck = TrainCheckpointer(out + ("/desync" if r == 0
                                      else f"/desync_private{r}"),
                               fingerprint="desync")
        ck.maybe_save(3, {"x": 3})
        try:
            res[name]["desync"] = repr(ck.restore())
        except RuntimeError as e:
            res[name]["desync"] = str(e)
    else:
        t = trainer(case)
        res[name] = result(t, t.run(perms=case["perms"]))
with open(out + f"/rank{r}.pkl", "wb") as f:
    pickle.dump(res, f)
"""


def _positives(n_users, n_items, n=300, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_users, n), rng.integers(0, n_items, n)


def _case(axes, n_users=40, n_items=24, seed=3, **cfg):
    u, i = _positives(n_users, n_items, seed=seed)
    cfg = dict(dim=8, epochs=EPOCHS, batch_size=64, seed=5,
               learning_rate=1e-2, compute_dtype="float32", **cfg)
    state = _carry(JaxTrainer((u, i, None), n_users, n_items,
                              JaxConfig(**cfg)))
    tables = {s: state.tables[s].numpy() for s in tt.SIDES}
    acc = {s: state.acc[s].numpy() for s in tt.SIDES}

    def layers(tree):
        return {s: [{k: a.numpy() for k, a in layer.items()}
                    for layer in tree[s]] for s in tt.SIDES}

    return {"axes": axes, "cfg": cfg, "pos": (u, i, None),
            "n_users": n_users, "n_items": n_items,
            "state": (tables, acc, layers(state.dense),
                      layers(state.adam_mu), layers(state.adam_nu),
                      state.adam_count),
            "perms": _jax_orders(cfg["seed"], len(u), EPOCHS)}


def _cases_world2():
    tp = {"data": 1, "model": 2}
    return {
        "dp": _case({"data": 2}),
        "dp_mlp": _case({"data": 2}, hidden=(16,)),
        "tp": _case(tp, shard_embeddings=True),
        # 41 and 40 users, 13 and 12 items a rank
        "tp_uneven": _case(tp, n_users=81, n_items=25, shard_embeddings=True),
        "tp_checkpoint": {**_case(tp, seed=4, shard_embeddings=True),
                          "checkpoint": True},
    }


def _cases_world4():
    return {"dp_tp": _case({"data": 2, "model": 2}, shard_embeddings=True)}


def _spawn(tmp_path_factory, name, cases):
    out = tmp_path_factory.mktemp(name)
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    n = int(np.prod(list(next(iter(cases.values()))["axes"].values())))
    run_world(_WORKER, n, args=[out])
    results = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return cases, results


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory, "world2", _cases_world2())


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory, "world4", _cases_world4())


def _same_on_every_rank(results, name):
    first = results[0][name]
    for other in results[1:]:
        np.testing.assert_array_equal(other[name]["losses"], first["losses"])
        for side in tt.SIDES:
            np.testing.assert_array_equal(other[name]["tables"][side],
                                          first["tables"][side])
        np.testing.assert_array_equal(other[name]["item_vecs"],
                                      first["item_vecs"])
        np.testing.assert_array_equal(other[name]["user_vecs"],
                                      first["user_vecs"])
    return first


def _jax_run(case, mesh_axes=None):
    """The JAX trainer (on a mesh of ``mesh_axes`` over the first
    devices, else unsharded) from the same initial state: the losses,
    the serving vectors and the raw tables."""
    u, i, _ = case["pos"]
    mesh = None
    if mesh_axes is not None:
        n = int(np.prod(list(mesh_axes.values())))
        mesh = jax_mesh(mesh_axes, jax.devices()[:n])
    t = JaxTrainer((u, i, None), case["n_users"], case["n_items"],
                   JaxConfig(**case["cfg"]), mesh=mesh)
    losses = t.run()
    emb = t.embeddings(losses)
    tables = {s: np.asarray(t._state[0][s]) for s in tt.SIDES}
    return losses, emb, tables


def _hold(got, losses, emb, tables):
    np.testing.assert_allclose(got["losses"], losses, rtol=L_TOL[0],
                               atol=L_TOL[1])
    for side, vecs in (("user", emb.user_vecs), ("item", emb.item_vecs)):
        np.testing.assert_allclose(got[f"{side}_vecs"], vecs, rtol=V_TOL[0],
                                   atol=V_TOL[1])
        np.testing.assert_allclose(got["tables"][side], tables[side],
                                   rtol=V_TOL[0], atol=V_TOL[1])


def _check_against_jax(cases, results, name):
    case = cases[name]
    got = _same_on_every_rank(results, name)
    assert got["losses"][-1] < got["losses"][0]
    axes = {"data": 1, "model": 1, **case["axes"]}
    _hold(got, *_jax_run(case, axes))
    _hold(got, *_jax_run(case))
    return got


@pytest.mark.parametrize("name", ["dp", "dp_mlp"])
def test_data_parallel_matches_jax_on_a_mesh_and_unsharded(world2, name):
    cases, results = world2
    got = _check_against_jax(cases, results, name)
    assert got["plan"]["flash_ce"] is False
    assert got["plan"]["flash_ce_reason"] == "multi-device mesh"
    assert got["batch"] == 64
    # per rank: the whole batch's logits, the tails over half the batch
    widths = tt.tail_widths(tt.TwoTowerConfig(**cases[name]["cfg"]))
    from predictionio_torch.obs import perfacct

    assert got["flops"] == perfacct.twotower_matmul_flops(64, 8, widths,
                                                          tail_rows=32)


def test_tensor_parallel_matches_jax_on_a_mesh_and_unsharded(world2):
    cases, results = world2
    _check_against_jax(cases, results, "tp")
    assert [r["tp"]["slabs"] for r in results] == [
        {"user": (0, 20), "item": (0, 12)},
        {"user": (20, 40), "item": (12, 24)}]


def test_uneven_slabs_match_the_one_process_trainer(world2):
    cases, results = world2
    case = cases["tp_uneven"]
    got = _same_on_every_rank(results, "tp_uneven")
    assert [r["tp_uneven"]["slabs"] for r in results] == [
        {"user": (0, 41), "item": (0, 13)},
        {"user": (41, 81), "item": (13, 25)}]
    one = tt.TwoTowerTrainer(
        case["pos"], case["n_users"], case["n_items"],
        tt.TwoTowerConfig(**{**case["cfg"], "shard_embeddings": False}),
        device="cpu", state=tt.twotower_state_from_jax(*case["state"],
                                                       device="cpu"))
    losses = one.run(perms=case["perms"])
    # on the CPU the slabs' lookups and updates are the one table's, bit
    # for bit: a row comes from one rank and zeros from the others
    np.testing.assert_array_equal(got["losses"], losses)
    for side in tt.SIDES:
        np.testing.assert_array_equal(got["tables"][side],
                                      one.tables[side].numpy())
    _hold(got, *_jax_run(case))


def test_data_and_tensor_parallel_on_a_world_of_four(world4):
    cases, results = world4
    _check_against_jax(cases, results, "dp_tp")
    assert sorted(tuple(sorted(r["dp_tp"]["slabs"].items()))
                  for r in results) == sorted(
        2 * [(("item", (0, 12)), ("user", (0, 20))),
             (("item", (12, 24)), ("user", (20, 40)))])


def test_checkpoint_across_processes_resumes_and_desync_raises(world2):
    cases, results = world2
    got = _same_on_every_rank(results, "tp_checkpoint")
    # rank 0 alone wrote, the whole tables; both ranks resumed them
    assert got["on_disk"] == ["ckpt_1.pkl"]
    for r in results:
        assert r["tp_checkpoint"]["resumed_epochs"] == 1
        for side in tt.SIDES:
            np.testing.assert_array_equal(
                r["tp_checkpoint"]["resumed_tables"][side],
                r["tp_checkpoint"]["saved_tables"][side])
    # the resumed run ends where an uninterrupted one does
    _hold(got, *_jax_run(cases["tp_checkpoint"], {"data": 1, "model": 2}))
    assert results[0]["tp_checkpoint"]["desync"].startswith("(3, ")
    assert results[1]["tp_checkpoint"]["desync"].startswith(
        "checkpoint desync: process 0 restored epoch 3 but process 1 found "
        "no checkpoint")


# -- pio train across two processes ---------------------------------------

_TRAIN = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.data.storage import Storage
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates.twotower import twotower_engine
from predictionio_torch.tools import cli
from predictionio_torch.workflow.deploy import prepare_deploy

out, engine_json = sys.argv[1], sys.argv[2]
ids = []
for run in range(2):
    assert cli.main(["train", "--engine-json", engine_json,
                     "--device", "cpu"]) == 0
    fresh = Storage.from_env()
    ids.append(fresh.engine_instances().get_latest_completed(
        "tt-2proc", "0", "default").id)
r = mh.process_index()
res = {"ids": ids, "world": mh.process_count()}
if r == 1:
    fresh = Storage.from_env()
    engine = twotower_engine()
    for run, iid in enumerate(ids):
        dep = prepare_deploy(engine, fresh.engine_instances().get(iid),
                             ctx=DeviceContext("cpu"), storage=fresh)
        model = dep.models[0]
        res[f"answer{run}"] = dep.query({"user": "u3", "num": 4})
        np.savez(out + f"/model{run}.npz", U=model.user_factors,
                 V=model.item_factors)
        res["users"] = list(model.user_ids.keys())
        res["items"] = list(model.item_ids.keys())
        res[f"losses{run}"] = list(model.train_losses)
mh.barrier("tt_cli_done")
with open(out + f"/rank{r}.json", "w") as f:
    json.dump(res, f)
"""


def test_two_process_pio_train_of_the_two_tower_engine(tmp_path):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "FS"
    _seed_block_events(Storage.from_env(env), Event, "tt-app")
    variant = json.loads(json.dumps(VARIANT))
    variant["engineId"] = "tt-2proc"
    variant["algorithms"][0]["params"].update(
        epochs=4, checkpoint_dir=str(tmp_path / "ckpt"))
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(variant))
    out = tmp_path / "out"
    out.mkdir()
    run_world(_TRAIN, 2, args=[out, engine_json], env=env)
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    # both ranks returned the same COMPLETED ids; one row and one blob a
    # run (process 0 alone writes)
    assert res[0]["ids"] == res[1]["ids"] and res[0]["world"] == 2
    storage = Storage.from_env(env)
    instances = storage.engine_instances().get_all()
    assert sorted(i.id for i in instances) == sorted(res[0]["ids"])
    assert {i.status for i in instances} == {"COMPLETED"}
    for iid in res[0]["ids"]:
        assert storage.models().get(iid) is not None
    # the second train resumed the first's last checkpoint (epoch 4, the
    # same run): the same vectors and losses
    first, second = (np.load(out / f"model{k}.npz") for k in range(2))
    np.testing.assert_array_equal(first["U"], second["U"])
    np.testing.assert_array_equal(first["V"], second["V"])
    assert res[1]["losses0"] == res[1]["losses1"]
    assert len(res[1]["losses0"]) == 4
    # rank 1's deploy answers as the JAX package's model over the stored
    # vectors does
    jax_model = JaxModel(ALSFactors(first["U"], first["V"]),
                         JaxBiMap.string_int(res[1]["users"]),
                         JaxBiMap.string_int(res[1]["items"]))
    want = jax_model.recommend("u3", 4)
    got = res[1]["answer0"]["itemScores"]
    assert [e["item"] for e in got] == [i for i, _ in want]
    np.testing.assert_allclose([e["score"] for e in got],
                               [s for _, s in want], rtol=1e-5)
