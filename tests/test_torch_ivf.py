"""The port's IVF index against the JAX package's.

Both are host numpy, so for the same vectors and seed the k-means
centroids must agree within 1e-6, the inverted lists must be equal, the
recall-gated ``nprobe`` and the measured recall equal, and every search
the same ids with scores within 1e-6: flat, int8, after an upsert, and
with exclusions. ``make_index(backend="ivf")`` builds it, and an ALS
model serves through it on the CPU.
"""

import numpy as np
import pytest

from predictionio_tpu.index.ivf import IVFIndex as JaxIVF
from predictionio_torch.index import MEASURED_RECALL, make_index
from predictionio_torch.index.ivf import IVFIndex
from predictionio_torch.models.als import als_model_from_arrays
from predictionio_torch.obs import metrics

TOL = dict(rtol=0, atol=1e-6)


def _vectors(n=600, d=16, seed=9):
    rng = np.random.default_rng(seed)
    # clustered, so nprobe has something to tune against
    centers = rng.normal(size=(12, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, 12, n)]
            + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)


def _same_index(port, jax):
    np.testing.assert_allclose(port._centroids, jax._centroids, **TOL)
    assert len(port._lists) == len(jax._lists)
    for a, b in zip(port._lists, jax._lists):
        assert np.array_equal(a, b)
    assert port.nprobe == jax.nprobe
    assert port.measured_recall == jax.measured_recall
    assert port.stats() == jax.stats()


def _same_search(port, jax, q, k, exclude=None):
    (s, i), (js, ji) = port.search(q, k, exclude), jax.search(q, k, exclude)
    assert np.array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    return i


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_build_search_and_upsert_equal_jax(quantize):
    vecs = _vectors()
    port = IVFIndex(quantize=quantize, seed=5)
    jax = JaxIVF(quantize=quantize, seed=5)
    port.build(vecs)
    jax.build(vecs)
    port.build_seconds = jax.build_seconds = 0.0   # wall time, not compared
    _same_index(port, jax)
    assert port.measured_recall >= port.recall_floor
    q = np.random.default_rng(1).normal(size=(7, 16)).astype(np.float32)
    _same_search(port, jax, q, 10)
    excl = np.array([[3, 17, -1], [0, 1, 2]] + [[-1, -1, -1]] * 5)
    got = _same_search(port, jax, q, 5, excl)
    assert not np.isin(got[0], [3, 17]).any()
    # upsert: overwrite two rows and append three, under the FIXED
    # quantizer (centroids move only on rebuild)
    rows = np.array([4, 10, 600, 601, 602])
    new = np.random.default_rng(2).normal(size=(5, 16)).astype(np.float32)
    port.upsert(rows, new)
    jax.upsert(rows, new)
    _same_index(port, jax)
    assert len(port) == 603
    _same_search(port, jax, np.vstack([q, new]), 10)


def test_explicit_nprobe_is_measured_not_tuned():
    vecs = _vectors(seed=3)
    port, jax = IVFIndex(nlist=16, nprobe=2, seed=1), JaxIVF(nlist=16,
                                                           nprobe=2, seed=1)
    port.build(vecs)
    jax.build(vecs)
    assert port.nprobe == jax.nprobe == 2
    assert port.measured_recall == jax.measured_recall


def test_make_index_builds_ivf_and_exports_its_recall(monkeypatch):
    monkeypatch.setenv("PIO_INDEX_BACKEND", "ivf")
    vecs = _vectors(n=300, seed=4)
    index = make_index(vecs, kernel="on", device="cpu", max_exclude=64)
    assert isinstance(index, IVFIndex)
    assert MEASURED_RECALL.labels("ivf").value == index.measured_recall
    text = metrics.REGISTRY.render()
    assert 'pio_index_recall{backend="ivf"}' in text
    assert 'pio_index_size_items{backend="ivf"} 300' in text


def test_an_als_model_serves_through_ivf(monkeypatch):
    monkeypatch.setenv("PIO_INDEX_BACKEND", "ivf")
    rng = np.random.default_rng(6)
    items = _vectors(n=200, d=8, seed=6)
    users = rng.normal(size=(10, 8)).astype(np.float32)
    model = als_model_from_arrays(users, items,
                                  [f"u{k}" for k in range(10)],
                                  [f"i{k}" for k in range(200)])
    model.to("cpu")
    assert model.retrieval_index().backend == "ivf"
    got = model.recommend("u3", 5, exclude_items=["i7"])
    truth = np.argsort(-(items @ users[3]), kind="stable")
    truth = [f"i{k}" for k in truth if k != 7][:5]
    assert [item for item, _ in got] == truth
    assert model.retrieval_stats()["backend"] == "ivf"
