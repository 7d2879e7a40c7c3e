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
from predictionio_torch.ops import als
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


# -- ALS training (PyTorch ops on the card; no kernel of its own) ---------------

def _als_ratings(n_users, n_items, nnz, seed):
    """Planted half-star ratings; item ids spread past 2^16, so the
    index wire carries idx_hi; the last 50 users rate nothing."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users - 50, nnz)
    i = (rng.zipf(1.3, nnz) * 7919) % n_items
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
    r = 3.0 + np.einsum("nk,nk->n", U[u], V[i]) / 2.0 + rng.normal(0, .3, nnz)
    return u, i, np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0).astype(np.float32)


ALS_PRECISION = {
    "direct-f32": dict(solver="direct", compute_dtype="float32",
                       cg_dtype="float32"),
    "cg-bf16": {},
}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("precision", sorted(ALS_PRECISION))
def test_als_half_step_on_the_card_matches_the_cpu(cuda, precision):
    """One compressed half-step with idx_hi present, on the card and on
    the CPU from the same inputs. Direct/f32 to rtol 1e-4 (atol 1e-5 of
    the largest factor): cuBLAS, the batched solve and index_add_'s
    atomics sum in other orders. CG/bf16 to a relative Frobenius error
    of 1e-2, the bound the CPU tests hold it to against the JAX package.
    Empty groups are exactly 0 on both."""
    n_users, n_items = 600, 70_000
    u, i, r = _als_ratings(n_users, n_items, 20_000, seed=3)
    cfg = als.ALSConfig(rank=16, reg=0.05, block_size=128,
                        **ALS_PRECISION[precision])
    side = als.build_compressed_side(u, i, r, n_users, cfg, 1, None)
    assert side.idx_hi is not None and side.affine is not None
    G = side.groups_per_shard
    rng = np.random.default_rng(4)
    Y = np.zeros((72_000, 16), np.float32)
    Y[:n_items] = 0.3 * rng.normal(size=(n_items, 16))
    X_prev = (0.3 * rng.normal(size=(G, 16))).astype(np.float32)
    idx = side.idx_lo.astype(np.int32) | (side.idx_hi.astype(np.int32) << 16)
    step = als.make_half_step(cfg, side.row_block, side.group_block, G,
                              val_affine=side.affine)
    host = [torch.from_numpy(a) for a in
            (Y, X_prev, idx, side.val, side.seg, side.counts)]
    want = step(*host).numpy()
    got = step(*(t.to(cuda) for t in host))
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    assert np.all(got[side.counts == 0] == 0.0)
    assert np.all(np.isfinite(got))
    if precision == "direct-f32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("precision", sorted(ALS_PRECISION))
def test_als_trainer_on_the_card_matches_the_cpu(cuda, precision):
    """Three iterations on the card against three on the CPU; both start
    from the same factors (drawn on the host from cfg.seed). The index
    streams recombine on the card to the host's int32 indexes.
    Direct/f32: factors to a relative Frobenius error of 1e-4, held-out
    RMSE to 1e-5. CG/bf16: the 6-step CG is short of convergence on
    groups of a few ratings, where a flipped bf16 rounding moves the
    iterate far, so the factors must stay within 3x the spread the CPU
    trainer shows against itself when its start is nudged by 1e-6 (the
    largest of three nudges), and the RMSE within 1e-2 (the CPU tests'
    bound against the JAX package)."""
    n_users, n_items = 600, 70_000
    u, i, r = _als_ratings(n_users, n_items, 20_000, seed=5)
    hold = np.arange(len(r)) % 20 == 0
    train = (u[~hold], i[~hold], r[~hold])
    held = (u[hold], i[hold], r[hold])
    cfg = als.ALSConfig(rank=16, iterations=3, reg=0.05, block_size=128,
                        **ALS_PRECISION[precision])

    def cpu_run(nudge=0.0, seed=0):
        t = als.ALSTrainer(train, n_users, n_items, cfg, device="cpu")
        noise = np.random.default_rng(seed).normal(size=tuple(t.X.shape))
        t.X = t.X * (1.0 + nudge * torch.from_numpy(noise).float())
        return t, t.run()

    host_trainer, want = cpu_run()
    trainer = als.ALSTrainer(train, n_users, n_items, cfg, device=cuda)
    for dev_arr, host_arr in zip(
            [a for side in trainer.sides() for a in side.args()],
            [a for side in host_trainer.sides() for a in side.args()]):
        assert torch.equal(dev_arr.cpu(), host_arr)
    got = trainer.compile().run()
    rmse, rmse_cpu = als.predict_rmse(got, held), als.predict_rmse(want, held)
    if precision == "direct-f32":
        tol_u = tol_i = 1e-4
        tol_rmse = 1e-5
    else:
        nudged = [cpu_run(1e-6, seed)[1] for seed in range(3)]
        tol_u = 3 * max(_rel(f.user_factors, want.user_factors)
                        for f in nudged)
        tol_i = 3 * max(_rel(f.item_factors, want.item_factors)
                        for f in nudged)
        tol_rmse = 1e-2
    assert _rel(got.user_factors, want.user_factors) <= tol_u
    assert _rel(got.item_factors, want.item_factors) <= tol_i
    assert abs(rmse - rmse_cpu) <= tol_rmse


def test_als_cg_bf16_on_the_card_matches_the_cpu_one_alternation_at_a_time(
        cuda):
    """The default precision (Jacobi CG, 6 steps, bf16) held to a fixed
    bound: at each of 3 iterations the card's trainer starts from the
    CPU trainer's current factors. One ``step_n(1)`` on the card gives
    user factors within a relative Frobenius error of 2e-3 of the CPU
    alternation's, and the card's item side, called on the CPU's new
    user factors, item factors within 2e-3 of the CPU's (readings on an
    H100: 6.3e-5 and 7.9e-5 at most). Every item has dozens of ratings
    here (300 items, ids spread past 2^16): on items of one rating at
    rank 16 a last-bit difference in the CG's f32 sums flips a bf16
    rounding and moves the item by percents (0.9-3.0% card against CPU
    on the Zipf data above, 4.3% between the JAX package and the port on
    the CPU)."""
    n_users, n_items = 600, 70_000
    rng = np.random.default_rng(5)
    u = rng.integers(0, n_users - 50, 20_000)
    item_row = rng.integers(0, 300, 20_000)
    r = 3.0 + np.einsum("nk,nk->n", rng.normal(size=(n_users, 4))[u],
                        rng.normal(size=(300, 4))[item_row]) / 2.0
    r = np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0).astype(np.float32)
    keep = np.arange(len(r)) % 20 != 0
    train = (u[keep], item_row[keep] * 233, r[keep])
    cfg = als.ALSConfig(rank=16, iterations=3, reg=0.05, block_size=128)
    host = als.ALSTrainer(train, n_users, n_items, cfg, device="cpu")
    trainer = als.ALSTrainer(train, n_users, n_items, cfg, device=cuda)
    _, item = trainer.sides()
    for _ in range(3):
        Y_prev = host.Y.to(cuda)
        trainer.X, trainer.Y = host.X.to(cuda), Y_prev
        host.step_n(1)
        trainer.step_n(1)
        assert _rel(trainer.X.cpu().numpy(), host.X.numpy()) <= 2e-3
        Y_card = item(host.X.to(cuda), Y_prev)
        torch.cuda.synchronize()
        assert _rel(Y_card.cpu().numpy(), host.Y.numpy()) <= 2e-3
