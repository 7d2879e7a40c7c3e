"""The port's retrieval index and ALS model against the JAX package's.

``ExactIndex(kernel="on")`` runs the ``topk_dot`` kernel's plain
version on the CPU in the port and the Pallas kernel in interpret mode
in the JAX package; ``kernel="auto"`` on the CPU takes each package's
scorer. Models are built from the same numpy factors — JAX through
``ALSFactors``, the port through ``als_model_from_arrays`` — and every
answer must agree: same ids in the same order, scores to 1e-5 (f32
products summed in another order; no exact ties in the data).
"""

import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.index import make_index as jax_make_index
from predictionio_tpu.models.als import ALSAlgorithm as JaxALSAlgorithm
from predictionio_tpu.models.als import ALSModel as JaxALSModel
from predictionio_tpu.models.als import ALSParams as JaxALSParams
from predictionio_tpu.ops.als import ALSFactors
from predictionio_torch.index import make_index
from predictionio_torch.index.exact import ExactIndex
from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                           als_model_from_arrays)
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.workflow.deploy import load_blob

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
VECS = np.random.default_rng(42).normal(size=(900, 12)).astype(np.float32)


def _same(port_out, jax_out):
    (s, i), (js, ji) = port_out, jax_out
    np.testing.assert_allclose(s, js, **TOL)
    assert np.array_equal(np.asarray(i), np.asarray(ji))


def _indexes(kernel, vecs=VECS):
    port = make_index(vecs.copy(), backend="exact", kernel=kernel,
                      device="cpu")
    return port, jax_make_index(vecs.copy(), backend="exact", kernel=kernel)


@pytest.mark.parametrize("kernel", ["on", "auto"])
def test_search_matches_jax(kernel):
    port, jax_index = _indexes(kernel)
    assert isinstance(port, ExactIndex)
    assert port.kernel_plan["engaged"] == (kernel == "on")
    q = np.random.default_rng(1).normal(size=(3, 12)).astype(np.float32)
    excl = np.array([[3, 7], [-1, -1], [899, 5]], np.int32)
    _same(port.search(q, 10, excl), jax_index.search(q, 10, excl))
    _same(port.search(q[0], 5), jax_index.search(q[0], 5))


@pytest.mark.parametrize("kernel", ["on", "auto"])
def test_upsert_overwrite_and_append_match_jax(kernel):
    port, jax_index = _indexes(kernel)
    q = np.random.default_rng(2).normal(size=(12,)).astype(np.float32)
    probe = (q / np.linalg.norm(q)).astype(np.float32)
    for index in (port, jax_index):
        index.upsert(np.array([5]), 50.0 * probe)
    _same(port.search(probe, 3), jax_index.search(probe, 3))
    assert int(port.search(probe, 3)[1][0, 0]) == 5
    for index in (port, jax_index):
        index.upsert(np.array([len(index)]), 99.0 * probe)
    assert len(port) == len(jax_index) == 901
    _same(port.search(probe, 3), jax_index.search(probe, 3))
    assert port.search(probe, 2)[1][0].tolist() == [900, 5]


def test_k_beyond_catalog_takes_the_scorer_route():
    port, jax_index = _indexes("on")
    q = np.random.default_rng(3).normal(size=(1, 12)).astype(np.float32)
    s, i = port.search(q, 5000)
    assert s.shape == (1, 900) and sorted(i[0].tolist()) == list(range(900))
    _same((s, i), jax_index.search(q, 5000))


def test_empty_index_and_stats():
    index = ExactIndex(device="cpu")
    s, i = index.search(np.zeros((2, 4), np.float32), 5)
    assert s.shape == (2, 0) and i.shape == (2, 0)
    stats = make_index(VECS, kernel="on", device="cpu").stats()
    assert stats["kernel"] == {"engaged": True, "reason": "forced on",
                               "device": "cpu"}
    assert "kernel_launches" in stats and stats["size"] == 900


@pytest.mark.parametrize("flag", ["on", "auto", "off"])
def test_kernel_flag_cannot_take_the_kernel_off_the_card(monkeypatch, flag):
    """On a CUDA device the kernel serves whatever the flag says; the
    plan is made without touching the card, so this runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("PIO_INDEX_KERNEL", flag)
    index = ExactIndex(kernel="auto", device="cuda:0")
    index._vectors = VECS
    index._plan_kernel()
    assert index.kernel_plan == {"engaged": True, "reason": "cuda device",
                                 "device": "cuda:0"}


def test_ivf_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="not ported"):
        make_index(VECS, backend="ivf", device="cpu")


# -- ALS model ----------------------------------------------------------------

N_USERS, N_ITEMS, RANK = 20, 200, 8


def _models(index_kernel="on"):
    rng = np.random.default_rng(11)
    U = rng.normal(size=(N_USERS, RANK)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, RANK)).astype(np.float32)
    users = [f"u{j}" for j in range(N_USERS)]
    items = [f"i{j}" for j in range(N_ITEMS)]
    jax_model = JaxALSModel(
        ALSFactors(user_factors=U.copy(), item_factors=V.copy()),
        JaxBiMap.string_int(users), JaxBiMap.string_int(items),
        index_kernel=index_kernel)
    port = als_model_from_arrays(U, V, users, items, rank=RANK,
                                 index_kernel=index_kernel).to("cpu")
    return port, jax_model


def _same_recs(a, b):
    assert [n for n, _ in a] == [n for n, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b], **TOL)


@pytest.mark.parametrize("index_kernel", ["on", "auto"])
def test_recommend_and_similar_items_match_jax(index_kernel):
    port, jax_model = _models(index_kernel)
    _same_recs(port.recommend("u1", 5, exclude_items=["i3", "i9", "nope"]),
               jax_model.recommend("u1", 5, exclude_items=["i3", "i9", "nope"]))
    _same_recs(port.recommend("u2", 7, candidate_items=["i1", "i5", "i8"]),
               jax_model.recommend("u2", 7, candidate_items=["i1", "i5", "i8"]))
    assert port.recommend("ghost", 5) == jax_model.recommend("ghost", 5) == []
    _same_recs(port.similar_items("i0", 10), jax_model.similar_items("i0", 10))
    blacklist = [f"i{j}" for j in range(100, 180)]   # 80 > the cap of 64
    sims = port.similar_items("i0", 10, exclude_items=blacklist)
    assert sims and all(n != "i0" for n, _ in sims)
    _same_recs(sims, jax_model.similar_items("i0", 10,
                                             exclude_items=blacklist))


def test_predict_and_batch_predict_match_jax():
    port, jax_model = _models()
    algo, jax_algo = ALSAlgorithm(ALSParams(rank=RANK)), \
        JaxALSAlgorithm(JaxALSParams(rank=RANK))
    for q in ({"user": "u2", "num": 3}, {"item": "i4", "num": 3},
              {"user": "u3", "num": 4, "blacklist": ["i1"]},
              {"user": "u3", "whitelist": ["i1", "i2"]},
              {"user": "nobody"}):
        a, b = algo.predict(port, q), jax_algo.predict(jax_model, q)
        _same_recs([(e["item"], e["score"]) for e in a["itemScores"]],
                   [(e["item"], e["score"]) for e in b["itemScores"]])
    queries = [(0, {"user": "u1", "num": 4}), (1, {"user": "ghost"}),
               (2, {"user": "u5", "num": 2})]
    a = dict(algo.batch_predict(port, queries))
    b = dict(jax_algo.batch_predict(jax_model, queries))
    assert sorted(a) == sorted(b)
    for qi in a:
        _same_recs([(e["item"], e["score"]) for e in a[qi]["itemScores"]],
                   [(e["item"], e["score"]) for e in b[qi]["itemScores"]])
    with pytest.raises(KeyError):   # item-only queries, as in the JAX package
        algo.batch_predict(port, [(0, {"item": "i1"})])


def test_patched_item_is_retrievable_like_jax():
    port, jax_model = _models()
    port.retrieval_index()
    jax_model.retrieval_index()
    vec = 40.0 * port.item_factors[4] / np.linalg.norm(port.item_factors[4])
    for model in (port, jax_model):
        assert model.upsert_rows(item_rows=[("brand_new", vec)],
                                 user_rows=[("u0", vec[:RANK])]) == (0, 1)
    _same_recs(port.similar_items("i4", 3), jax_model.similar_items("i4", 3))
    assert port.similar_items("i4", 3)[0][0] == "brand_new"
    _same_recs(port.recommend("u0", 5), jax_model.recommend("u0", 5))


def test_apply_patch_matches_jax():
    port, jax_model = _models()
    patch = {"itemRows": [["fresh", [0.5] * RANK]],
             "userRows": [["u3", [1.0] * RANK], ["newbie", [0.25] * RANK]]}
    assert ALSAlgorithm(ALSParams(rank=RANK)).apply_patch(port, patch)
    assert JaxALSAlgorithm(JaxALSParams(rank=RANK)).apply_patch(jax_model,
                                                                patch)
    for user in ("u3", "newbie"):
        _same_recs(port.recommend(user, 6), jax_model.recommend(user, 6))
    with pytest.raises(ValueError):
        ALSAlgorithm(ALSParams(rank=RANK)).apply_patch(
            port, {"itemRows": [["bad", [1.0, 2.0]]]})


def test_device_state_never_pickles_and_jax_pickles_load():
    port, jax_model = _models()
    port.retrieval_index()
    clone = pickle.loads(pickle.dumps(port))
    assert clone._index is None and clone.device is None
    clone.to("cpu")
    _same_recs(clone.similar_items("i0", 3), port.similar_items("i0", 3))
    # a JAX model blob loads into the port's classes
    [loaded] = load_blob(pickle.dumps([jax_model]))
    assert type(loaded).__module__ == "predictionio_torch.models.als"
    assert type(loaded.user_ids).__module__ == "predictionio_torch.data.bimap"
    loaded.to("cpu")
    _same_recs(loaded.recommend("u1", 5), jax_model.recommend("u1", 5))


def test_warmup_builds_the_index_on_the_context_device():
    port, _ = _models()
    ALSAlgorithm(ALSParams(rank=RANK)).warmup(port, DeviceContext("cpu"))
    stats = port.retrieval_stats()
    assert stats["backend"] == "exact" and stats["kernel"]["device"] == "cpu"
