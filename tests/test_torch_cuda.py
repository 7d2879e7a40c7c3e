"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (a CUDA kernel has no CPU mode). The file imports nothing of JAX,
so it runs on a machine without JAX too:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py imports JAX for the JAX package's
tests). ``chip_smoke.py`` runs a wider grid of the same check.
"""

import numpy as np
import pytest
import torch

from predictionio_torch.index.exact import ExactIndex
from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                           als_model_from_arrays)
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.ops.topk import TopKScorer

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("I,D,B,k,E", [
    (513, 32, 8, 8, 8), (26_744, 64, 1, 16, 1), (66_000, 128, 128, 128, 64),
    (900, 12, 3, 10, 2), (7, 4, 1, 7, 1),
])
def test_kernel_matches_plain_version(cuda, I, D, B, k, E):
    rng = np.random.default_rng(I + k)
    q = torch.tensor(rng.normal(size=(B, D)).astype(np.float32), device=cuda)
    items = torch.tensor(rng.normal(size=(I, D)).astype(np.float32),
                         device=cuda)
    excl = torch.tensor(rng.integers(-2, I + 3, size=(B, E)),
                        dtype=torch.int32, device=cuda)
    before = tkd.launches.value
    s, i = tkd.topk_dot(q, items, excl, k)
    torch.cuda.synchronize()
    assert tkd.launches.value == before + 1
    rs, ri = tkd.topk_dot_reference(q, items, excl, k)
    live = rs > -1e29
    # the kernel sums in another order than cuBLAS: scores agree to
    # 1e-5 * |q| * max|item|, and ids agree except across near-ties
    tol = 1e-5 * q.norm(dim=1, keepdim=True) * items.norm(dim=1).max()
    assert bool((((s - rs).abs() <= tol) | ~live).all())
    got = torch.gather(q @ items.T, 1, i.long())
    assert bool(((i == ri) | ((got - rs).abs() <= tol) | ~live).all())


def test_index_on_the_card_answers_like_the_cpu(cuda):
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(5000, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    excl = np.array([[1, 2], [-1, -1], [4999, 7], [3, 3]], np.int32)
    gpu = ExactIndex(device=cuda)
    gpu.build(vecs)
    cpu = ExactIndex(kernel="on", device="cpu")
    cpu.build(vecs)
    assert gpu.kernel_plan["engaged"]
    before = tkd.launches.value
    s, i = gpu.search(q, 10, excl)
    assert tkd.launches.value == before + 1
    cs, ci = cpu.search(q, 10, excl)
    np.testing.assert_allclose(s, cs, rtol=1e-5, atol=1e-4)
    assert np.array_equal(i, ci)


def test_small_catalog_stays_on_the_card(cuda, monkeypatch):
    """A small table makes the host route look cheaper, and the
    environment asks for it: on the card, shapes outside the kernel's
    caps and micro-batches still score on the card."""
    monkeypatch.setenv("PIO_SERVE_PLACEMENT", "host")

    def no_host(*_a, **_k):
        raise AssertionError("the host route ran while the card was there")

    monkeypatch.setattr(TopKScorer, "_score_host", no_host)
    rng = np.random.default_rng(8)
    U = rng.normal(size=(300, 32)).astype(np.float32)
    V = rng.normal(size=(1000, 32)).astype(np.float32)
    users = [f"u{j}" for j in range(300)]
    model = als_model_from_arrays(U, V, users, [f"i{j}" for j in range(1000)],
                                  rank=32).to(cuda)
    index = model.retrieval_index()
    no_excl = torch.full((200, 1), -1, dtype=torch.int32)
    for q, k in ((U[:3], 200),          # k bucket 256 > MAX_K
                 (U[:200], 10)):        # B bucket 256 > MAX_BATCH
        before = tkd.launches.value
        s, i = index.search(q, k)
        assert tkd.launches.value == before     # the scorer, not the kernel
        rs, ri = tkd.topk_dot_reference(torch.tensor(q), torch.tensor(V),
                                        no_excl[:len(q)], k)
        np.testing.assert_allclose(s, rs.numpy(), rtol=1e-5, atol=1e-4)
        assert np.array_equal(i, ri.numpy())
    queries = [(j, {"user": f"u{j}", "num": 10}) for j in range(64)]
    got = dict(ALSAlgorithm(ALSParams(rank=32)).batch_predict(model, queries))
    _, ri = tkd.topk_dot_reference(torch.tensor(U[:64]), torch.tensor(V),
                                   no_excl[:64], 10)
    for j in range(64):
        assert [e["item"] for e in got[j]["itemScores"]] == \
            [f"i{int(x)}" for x in ri[j]]
    assert model.scorer().placement == index._fallback().placement == "device"
