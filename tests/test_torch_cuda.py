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
from predictionio_torch.ops.kernels import embed_update as eu
from predictionio_torch.ops.kernels import flash_ce as fce
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.ops.topk import TopKScorer
from predictionio_torch.ops.twotower import TwoTowerConfig, TwoTowerTrainer

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_matches_plain(q, items, excl, k, s, i):
    """The kernel's answer against topk_dot_reference: the kernel sums in
    another order than cuBLAS, so scores agree to 1e-5 * |q| * max|item|,
    and ids agree except across near-ties of the reference."""
    rs, ri = tkd.topk_dot_reference(q, items, excl, k)
    live = rs > -1e29
    tol = 1e-5 * q.norm(dim=1, keepdim=True) * items.norm(dim=1).max()
    assert bool((((s - rs).abs() <= tol) | ~live).all())
    got = torch.gather(q @ items.T, 1, i.long())
    assert bool(((i == ri) | ((got - rs).abs() <= tol) | ~live).all())


@pytest.mark.parametrize("I,D,B,k,E", [
    (513, 32, 8, 8, 8), (26_744, 64, 1, 16, 1), (66_000, 128, 128, 128, 64),
    (900, 12, 3, 10, 2), (7, 4, 1, 7, 1), (1_000_000, 128, 1, 16, 1),
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
    _assert_matches_plain(q, items, excl, k, s, i)


def _adversarial(name, I, D, B, device):
    """``rising``: rows ordered so that every query's scores rise along
    the table (each block's buffer fills in every batch and it sorts
    again and again); ``identical``: every row the same (all ties)."""
    rng = np.random.default_rng(I + B)
    direction = rng.normal(size=D).astype(np.float32)
    direction /= np.linalg.norm(direction)
    q = direction + 0.01 * rng.normal(size=(B, D)).astype(np.float32)
    if name == "rising":
        items = (np.linspace(0.1, 10.0, I, dtype=np.float32)[:, None]
                 * direction[None, :])
    else:
        items = np.repeat(rng.normal(size=(1, D)).astype(np.float32), I, 0)
    return (torch.tensor(q, device=device),
            torch.tensor(items, device=device))


@pytest.mark.parametrize("name", ["rising", "identical"])
@pytest.mark.parametrize("I,D,B,k", [(26_744, 64, 1, 16),
                                     (66_000, 128, 8, 128),
                                     (1_000_000, 128, 1, 16)])
def test_kernel_on_adversarial_tables(cuda, name, I, D, B, k):
    q, items = _adversarial(name, I, D, B, cuda)
    excl = torch.full((B, 1), -1, dtype=torch.int32, device=cuda)
    before = tkd.launches.value
    s, i = tkd.topk_dot(q, items, excl, k)
    torch.cuda.synchronize()
    assert tkd.launches.value == before + 1
    _assert_matches_plain(q, items, excl, k, s, i)
    if name == "identical":   # all ties: the lowest ids, in order
        assert bool((i == torch.arange(k, device=cuda,
                                       dtype=torch.int32)).all())
    else:                     # the last rows of the table, best last
        assert bool((i[:, 0] >= I - k).all())


def test_repeated_calls_are_bit_identical(cuda):
    """200 back-to-back calls over alternating shapes each give the bits
    of their shape's first call: the last block of every search puts its
    ticket counter back to 0."""
    rng = np.random.default_rng(11)
    shapes = [(26_744, 64, 1, 16, 1), (66_000, 128, 8, 128, 4),
              (513, 32, 3, 8, 2), (1_000_000, 128, 1, 16, 1)]
    cases = []
    for I, D, B, k, E in shapes:
        q = torch.tensor(rng.normal(size=(B, D)).astype(np.float32),
                         device=cuda)
        items = torch.tensor(rng.normal(size=(I, D)).astype(np.float32),
                             device=cuda)
        excl = torch.tensor(rng.integers(-1, I, size=(B, E)),
                            dtype=torch.int32, device=cuda)
        cases.append((q, items, excl, k))
    outs = [[] for _ in cases]
    for n in range(200):
        j = n % len(cases)
        outs[j].append(tkd.topk_dot(*cases[j]))
    torch.cuda.synchronize()
    for case, got in zip(cases, outs):
        _assert_matches_plain(*case, *got[0])
        for s, i in got[1:]:
            assert torch.equal(s, got[0][0]) and torch.equal(i, got[0][1])


def test_calls_on_two_streams_at_once(cuda):
    """Searches issued on two streams run concurrently, each with its
    own ticket counters, and answer as on one stream."""
    rng = np.random.default_rng(12)
    cases = []
    for I, D, B, k in ((200_000, 64, 1, 16), (150_000, 128, 4, 32)):
        q = torch.tensor(rng.normal(size=(B, D)).astype(np.float32),
                         device=cuda)
        items = torch.tensor(rng.normal(size=(I, D)).astype(np.float32),
                             device=cuda)
        excl = torch.full((B, 1), -1, dtype=torch.int32, device=cuda)
        cases.append((q, items, excl, k))
    want = [tkd.topk_dot(*c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(20):
        for j in (0, 1):
            with torch.cuda.stream(streams[j]):
                got[j].append(tkd.topk_dot(*cases[j]))
    torch.cuda.synchronize()
    for j in (0, 1):
        _assert_matches_plain(*cases[j], *want[j])
        for s, i in got[j]:
            assert torch.equal(s, want[j][0]) and torch.equal(i, want[j][1])


def test_block_counts_give_the_same_bits(cuda):
    """Each item's dot is summed in the same order whatever the grid, and
    the merge is exact: every block count gives the planner's bits."""
    rng = np.random.default_rng(13)
    q = torch.tensor(rng.normal(size=(2, 64)).astype(np.float32), device=cuda)
    items = torch.tensor(rng.normal(size=(26_744, 64)).astype(np.float32),
                         device=cuda)
    excl = torch.full((2, 1), -1, dtype=torch.int32, device=cuda)
    s0, i0 = tkd.topk_dot(q, items, excl, 16)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for blocks in (1, 7, 132, 264, 1000):
        plan = tkd.plan_blocks(26_744, 16, 2, sm_count, blocks)
        s, i = tkd._launch(q, items, excl, 16, plan)
        assert torch.equal(s, s0) and torch.equal(i, i0)


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


def _ce_batch(B, D, seed, device, uniform_w=True, n_pad=17):
    """Unit-norm towers with in-batch duplicate users and items and a
    zero-weight tail (the masking surface of the loss)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, D)).astype(np.float32)
    v = rng.normal(size=(B, D)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    w = (np.ones(B, np.float32) if uniform_w
         else (0.5 + 4.0 * rng.random(B)).astype(np.float32))
    w[-n_pad:] = 0.0
    return (torch.tensor(u, device=device), torch.tensor(v, device=device),
            torch.tensor(rng.integers(0, B // 3, B), device=device),
            torch.tensor(rng.integers(0, B // 4, B), device=device),
            torch.tensor(w, device=device))


def _ce_loss_and_grads(fn, u, v, u_idx, i_idx, w, cdt):
    u = u.clone().requires_grad_(True)
    v = v.clone().requires_grad_(True)
    loss = fn(u, v, u_idx, i_idx, w, 0.07, cdt)
    loss.backward()
    return loss.detach(), u.grad, v.grad


@pytest.mark.parametrize("B,D,cdt,uniform_w", [
    (128, 8, torch.float32, True), (130, 16, torch.float32, False),
    (1000, 64, torch.float32, False), (1000, 128, torch.bfloat16, True),
    (200, 24, torch.bfloat16, False), (4096, 256, torch.bfloat16, True),
    (130, 64, torch.bfloat16, False),
])
def test_flash_ce_kernel_matches_plain_version(cuda, B, D, cdt, uniform_w):
    """Forward and both backward kernels against the plain version,
    with the tolerances of the JAX package's kernel tests: f32 loss
    1e-5, grads 1e-4 / 1e-6; bf16 loss 5e-3, grads 1e-1 / 2e-3 (bf16
    logits round at other points when summed in another order). The
    grads also hold with an atol scaled to their size (1e-4 / 2e-3 of
    max|ref|) and a relative norm error of at most 1e-4 / 2e-2, which
    the absolute atol alone does not ensure at large B."""
    batch = _ce_batch(B, D, B + D, cuda, uniform_w)
    before = fce.launches.value
    lk, duk, dvk = _ce_loss_and_grads(fce.flash_ce, *batch, cdt)
    torch.cuda.synchronize()
    assert fce.launches.value == before + 3
    lr, dur, dvr = _ce_loss_and_grads(fce.flash_ce_reference, *batch, cdt)
    l_rtol, g_rtol, g_atol = ((1e-5, 1e-4, 1e-6) if cdt == torch.float32
                              else (5e-3, 1e-1, 2e-3))
    torch.testing.assert_close(lk, lr, rtol=l_rtol, atol=0)
    scaled, norm_tol = ((1e-4, 1e-4) if cdt == torch.float32
                        else (2e-3, 2e-2))
    for g, r in ((duk, dur), (dvk, dvr)):
        torch.testing.assert_close(g, r, rtol=g_rtol, atol=g_atol)
        torch.testing.assert_close(g, r, rtol=g_rtol,
                                   atol=scaled * float(r.abs().max()))
        assert float((g - r).norm() / r.norm()) <= norm_tol


def test_flash_ce_kernel_is_deterministic(cuda):
    """Two calls at the train shape give the same loss, du and dv bit
    for bit: each block writes its own partial and torch sums them in a
    fixed order, with no atomics."""
    batch = _ce_batch(8192, 128, 3, cuda)
    first = _ce_loss_and_grads(fce.flash_ce, *batch, torch.bfloat16)
    second = _ce_loss_and_grads(fce.flash_ce, *batch, torch.bfloat16)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,E,B,vocab", [(64, 24, 37, 64), (50, 8, 24, 6),
                                         (100_000, 128, 8192, 100_000)])
def test_embed_update_kernel_matches_plain_version(cuda, N, E, B, vocab):
    rng = np.random.default_rng(N + B)
    table = torch.tensor(rng.normal(size=(N, E)).astype(np.float32),
                         device=cuda)
    idx = torch.tensor(rng.integers(0, vocab, B), device=cuda)
    grad = torch.tensor(rng.normal(size=(B, E)).astype(np.float32),
                        device=cuda)
    scale = torch.tensor(rng.random(B).astype(np.float32), device=cuda)
    expected = eu.embed_update_reference(table.clone(), idx, grad, scale)
    before = eu.launches.value
    got = eu.embed_update(table, idx, grad, scale)
    torch.cuda.synchronize()
    assert eu.launches.value == before + 1 and got is table
    torch.testing.assert_close(table, expected, rtol=1e-5, atol=1e-6)


def test_trainer_on_the_card_launches_both_kernels(cuda):
    """A small two-tower run on the card: every step launches the three
    flash_ce kernels and two embed_update kernels, with the flags asking
    for neither; losses fall and the vectors are unit-norm."""
    rng = np.random.default_rng(1)
    u, i = rng.integers(0, 300, 2000), rng.integers(0, 200, 2000)
    cfg = TwoTowerConfig(dim=16, epochs=3, batch_size=256, seed=2,
                         learning_rate=1e-2, flash_ce_kernel="off",
                         embed_update_kernel="off")
    trainer = TwoTowerTrainer((u, i, None), 300, 200, cfg, device=cuda)
    assert trainer.kernel_plan["flash_ce"] and \
        trainer.kernel_plan["embed_update"]
    f0, e0 = fce.launches.value, eu.launches.value
    losses = trainer.run()
    steps = 3 * trainer.steps_per_epoch
    assert fce.launches.value - f0 == 3 * steps
    assert eu.launches.value - e0 == 2 * steps
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    emb = trainer.embeddings(losses)
    np.testing.assert_allclose(np.linalg.norm(emb.item_vecs, axis=1), 1.0,
                               atol=1e-5)
