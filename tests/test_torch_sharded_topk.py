"""Sharded top-k serving of the port on a world of gloo processes, on
the CPU, against the JAX package: the six cases of
``tests/test_sharded_topk.py`` on a world of 2, and one on a world of 3
with uneven slabs (84, 84 and 82 of 250 items; 3, 3 and 1 of 7, k over
every slab; 2, 2 and an empty one of 4).

The item table is split into one contiguous slab per rank
(``ops.topk.ShardedTopKScorer``); each rank's slab top-k goes through
the ``topk_dot`` wrapper (its plain version on CPU tensors) and the
candidate lists are all-gathered and re-ranked. Each world is spawned
once for the module (``tests/torch_world.py``); every rank scores the
same queries and writes its answers, which the tests hold against JAX
``make_sharded_topk`` / ``ShardedTopKScorer`` on the 8-device CPU mesh
and against the single-device ``TopKScorer`` of both packages: indices
exactly, scores at rtol 1e-5, and every rank's answers equal.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.als import ALSModel as JaxALSModel
from predictionio_tpu.ops.als import ALSFactors
from predictionio_tpu.ops.topk import ShardedTopKScorer as JaxSharded
from predictionio_tpu.ops.topk import TopKScorer as JaxTopK
from predictionio_tpu.ops.topk import make_sharded_topk
from predictionio_tpu.parallel.mesh import create_mesh, named_sharding
from predictionio_torch.ops.topk import TopKScorer

from tests.torch_world import run_world

_WORKER = """
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.models.als import ALSAlgorithm, ALSModel, ALSParams
from predictionio_torch.ops.topk import ShardedTopKScorer
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.parallel.mesh import create_mesh

out = sys.argv[1]
assert mh.initialize_from_env(device="cpu")
r = mh.process_index()
mesh = create_mesh()
with open(out + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)
results = {}
for name, case in cases.items():
    if case["kind"] == "score":
        sc = ShardedTopKScorer(case["items"], mesh, device="cpu")
        results[name] = [sc.score(case["users"], k, excl)
                         for k, excl in case["calls"]]
    elif case["kind"] == "exclude_top1":
        sc = ShardedTopKScorer(case["items"], mesh, device="cpu")
        _, base = sc.score(case["users"], case["k"],
                           np.full((len(case["users"]), 1), -1, np.int32))
        excl = base[:, :1].astype(np.int32)
        results[name] = [(excl, excl), sc.score(case["users"], case["k"],
                                                excl)]
    elif case["kind"] == "model":
        uf, itf = case["user_factors"], case["item_factors"]
        model = ALSModel(uf, itf,
                         BiMap.from_vocab([f"u{i}" for i in range(len(uf))]),
                         BiMap.from_vocab([f"i{i}" for i in range(len(itf))])
                         ).to("cpu")
        base = model.recommend("u2", 5, exclude_items=["i3", "i7"])
        sim = model.similar_items("i4", 6)
        model.enable_sharded_serving(mesh)
        assert type(model.scorer()).__name__ == "ShardedTopKScorer"
        got = model.recommend("u2", 5, exclude_items=["i3", "i7"])
        results[name] = [base, got, sim, model.similar_items("i4", 6)]
        try:
            model.upsert_rows(item_rows=[("i1", np.zeros(8, np.float32))])
        except ValueError as e:
            assert "sharded" in str(e)
        else:
            raise AssertionError("an item-row patch reached a sharded model")
    elif case["kind"] == "pickle":
        uf, itf = case["user_factors"], case["item_factors"]
        model = ALSModel(uf, itf,
                         BiMap.from_vocab([f"u{i}" for i in range(len(uf))]),
                         BiMap.from_vocab([f"i{i}" for i in range(len(itf))])
                         ).to("cpu")
        model.enable_sharded_serving(mesh)
        algo = ALSAlgorithm(ALSParams())
        persisted = algo.make_persistent_model(model)
        restored = pickle.loads(pickle.dumps(persisted))
        assert restored.sharded_axis == "data"
        loaded = algo.load_persistent_model(
            restored, DeviceContext("cpu", mesh=mesh))
        assert isinstance(loaded.scorer(), ShardedTopKScorer)
        # a context whose mesh lacks the axis clears it
        other = pickle.loads(pickle.dumps(model))
        single = algo.load_persistent_model(
            other, DeviceContext("cpu", mesh=create_mesh({"model": -1,
                                                          "data": 1})))
        assert single.sharded_axis is None
        results[name] = [loaded.recommend("u1", 3), model.recommend("u1", 3),
                         single.recommend("u1", 3)]
with open(out + f"/results{r}.pkl", "wb") as f:
    pickle.dump(results, f)
"""


def _setup(n_items=256, rank=16, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(n_items, rank)).astype(np.float32)
    users = rng.normal(size=(batch, rank)).astype(np.float32)
    return users, items


def _factors(seed, n_users, n_items, rank=8):
    rng = np.random.default_rng(seed)
    return ALSFactors(
        user_factors=rng.normal(size=(n_users, rank)).astype(np.float32),
        item_factors=rng.normal(size=(n_items, rank)).astype(np.float32))


def _cases_world2():
    users, items = _setup()
    excl4 = np.full((4, 4), -1, np.int32)
    u2, i2 = _setup(batch=2)
    u3, i3 = _setup(n_items=16, batch=2)
    u4, i4 = _setup(n_items=250, batch=3, seed=2)
    u4[0] = -np.abs(u4[0])
    f5, f6 = _factors(3, 6, 40), _factors(4, 5, 24)
    return {
        "single_device": dict(kind="score", users=users, items=items,
                              calls=[(10, excl4)]),
        "exclusions": dict(kind="exclude_top1", users=u2, items=i2, k=5),
        "k_over_slab": dict(kind="score", users=u3, items=i3,
                            calls=[(12, np.full((2, 1), -1, np.int32))]),
        "padding": dict(kind="score", users=u4, items=i4,
                        calls=[(5, None), (40, None)]),
        "model": dict(kind="model", user_factors=f5.user_factors,
                      item_factors=f5.item_factors),
        "pickle": dict(kind="pickle", user_factors=f6.user_factors,
                       item_factors=f6.item_factors),
    }


def _cases_world3():
    users, items = _setup(n_items=250, batch=5, seed=9)
    users[1] = -np.abs(users[1])
    rng = np.random.default_rng(10)
    excl = rng.integers(-1, 250, size=(5, 7)).astype(np.int32)
    u_small, i_small = _setup(n_items=7, batch=2, seed=11)
    return {
        "uneven": dict(kind="score", users=users, items=items,
                       calls=[(5, None), (40, excl), (100, excl[:, :3]),
                              (250, None)]),
        # slabs of 3, 3 and 1 items: k over every slab
        "tiny": dict(kind="score", users=u_small, items=i_small,
                     calls=[(7, None), (4, np.array([[0, 6], [3, -1]],
                                                    np.int32))]),
        "empty_slab": dict(kind="score", users=u_small, items=i_small[:4],
                           calls=[(4, None), (3, np.array([[1, -1], [2, 3]],
                                                          np.int32))]),
    }


def _spawn(tmp_path_factory, name, cases, n):
    out = tmp_path_factory.mktemp(name)
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    run_world(_WORKER, n, args=[out])
    results = []
    for r in range(n):
        with open(out / f"results{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return cases, results


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory, "world2", _cases_world2(), 2)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _spawn(tmp_path_factory, "world3", _cases_world3(), 3)


def _replicated(results, name):
    """Every rank's answers to case ``name``, checked equal; rank 0's."""
    first = results[0][name]
    for other in results[1:]:
        for a, b in zip(first, other[name]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    return first


def _jax_sharded(users, items, k, excl):
    mesh = create_mesh({"data": 8})
    fn = make_sharded_topk(mesh, "data", items.shape[0], k)
    s, i = fn(jnp.asarray(users),
              jax.device_put(jnp.asarray(items),
                             named_sharding(mesh, "data", None)),
              jnp.asarray(excl))
    return np.asarray(s), np.asarray(i)


def _hold(got, items, users, k, excl):
    """Port answers against both single-device scorers: indices exact,
    scores at rtol 1e-5."""
    s, i = got
    for ref in (TopKScorer(items, device="cpu"), JaxTopK(items)):
        r_s, r_i = ref.score(users, k, exclude_idx=excl)
        np.testing.assert_array_equal(i, r_i)
        np.testing.assert_allclose(s, r_s, rtol=1e-5)


def test_sharded_matches_single_device(world2):
    cases, results = world2
    c = cases["single_device"]
    (got,) = _replicated(results, "single_device")
    k, excl = c["calls"][0]
    _hold(got, c["items"], c["users"], k, excl)
    j_s, j_i = _jax_sharded(c["users"], c["items"], k, excl)
    np.testing.assert_array_equal(got[1], j_i)
    np.testing.assert_allclose(got[0], j_s, rtol=1e-5)


def test_sharded_respects_global_exclusions(world2):
    cases, results = world2
    c = cases["exclusions"]
    (excl, _), got = _replicated(results, "exclusions")
    for b in range(2):
        assert excl[b, 0] not in got[1][b]
    _hold(got, c["items"], c["users"], c["k"], excl)
    np.testing.assert_array_equal(
        got[1], _jax_sharded(c["users"], c["items"], c["k"], excl)[1])


def test_k_larger_than_shard_slab(world2):
    # 16 items over 2 ranks: slabs of 8 < k = 12 (k_loc = slab)
    cases, results = world2
    c = cases["k_over_slab"]
    (got,) = _replicated(results, "k_over_slab")
    k, excl = c["calls"][0]
    _hold(got, c["items"], c["users"], k, excl)
    np.testing.assert_array_equal(
        got[1], _jax_sharded(c["users"], c["items"], k, excl)[1])


def test_sharded_scorer_class_with_padding(world2):
    cases, results = world2
    c = cases["padding"]
    answers = _replicated(results, "padding")
    jax_scorer = JaxSharded(c["items"], create_mesh({"data": 8}))
    for (k, excl), got in zip(c["calls"], answers):
        assert (got[1] < 250).all() and (got[1] >= 0).all()
        _hold(got, c["items"], c["users"], k, excl)
        j_s, j_i = jax_scorer.score(c["users"], k)
        np.testing.assert_array_equal(got[1], j_i)
        np.testing.assert_allclose(got[0], j_s, rtol=1e-5)


def _jax_model(c):
    n_u, n_i = len(c["user_factors"]), len(c["item_factors"])
    return JaxALSModel(
        ALSFactors(c["user_factors"], c["item_factors"]),
        JaxBiMap.string_int([f"u{i}" for i in range(n_u)]),
        JaxBiMap.string_int([f"i{i}" for i in range(n_i)]))


def test_als_model_sharded_serving_parity(world2):
    cases, results = world2
    base, got, sim, sharded_sim = _replicated(results, "model")
    assert [i for i, _ in got] == [i for i, _ in base]
    assert [i for i, _ in sharded_sim] == [i for i, _ in sim]
    jax_model = _jax_model(cases["model"])
    jax_model.enable_sharded_serving(create_mesh({"data": 8}))
    want = jax_model.recommend("u2", 5, exclude_items=["i3", "i7"])
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-5)
    assert ([i for i, _ in sharded_sim]
            == [i for i, _ in jax_model.similar_items("i4", 6)])


def test_sharded_serving_survives_persistence_roundtrip(world2):
    cases, results = world2
    loaded, original, single = _replicated(results, "pickle")
    assert loaded == original == single
    jax_model = _jax_model(cases["pickle"])
    jax_model.enable_sharded_serving(create_mesh({"data": 8}))
    assert [i for i, _ in loaded] == [i for i, _ in jax_model.recommend(
        "u1", 3)]


@pytest.mark.parametrize("name", ["uneven", "tiny", "empty_slab"])
def test_uneven_slabs_on_a_world_of_three(world3, name):
    cases, results = world3
    c = cases[name]
    answers = _replicated(results, name)
    for (k, excl), got in zip(c["calls"], answers):
        _hold(got, c["items"], c["users"], k, excl)
        assert len(set(got[1][0].tolist())) == got[1].shape[1]
