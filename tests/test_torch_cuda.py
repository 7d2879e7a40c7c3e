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
from predictionio_torch.ops import twotower as tt
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


@pytest.mark.parametrize("precision", sorted(ALS_PRECISION))
def test_als_from_sides_on_the_card_matches_the_cpu(cuda, precision,
                                                    tmp_path, monkeypatch):
    """The event log's fused scan+bin of 20,000 ratings (every 20th held
    out), then ``ALSTrainer.from_sides`` for three iterations on the card
    and on the CPU from the same start (drawn on the host from
    cfg.seed), and once more on the card from the layout cache's
    read-only mapping. The tolerances of the COO test above: direct/f32
    factors to a relative Frobenius error of 1e-4 and RMSE to 1e-5;
    CG/bf16 within 3x the CPU trainer's spread under a 1e-6 nudge of its
    start, RMSE to 1e-2."""
    from predictionio_torch.data.backends.eventlog import EventLogEventStore
    from predictionio_torch.data.storage import EventColumns

    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    n_users, n_items = 600, 70_000
    u, i, r = _als_ratings(n_users, n_items, 20_000, seed=5)
    store = EventLogEventStore(str(tmp_path / "log"))
    store.init(1)
    try:
        store.insert_columnar(EventColumns(
            entity_codes=u.astype(np.int32), target_codes=i.astype(np.int32),
            name_codes=np.zeros(len(u), np.int32), values=r.astype(np.float64),
            times_us=np.arange(len(u), dtype=np.int64),
            entity_vocab=[f"u{j}" for j in range(n_users)],
            target_vocab=[f"i{j}" for j in range(n_items)], names=["rate"]),
            1, entity_type="user", target_entity_type="item",
            value_property="rating")
        binned = store.bin_columnar(
            1, value_property="rating", skip_mod=20, skip_rem=0,
            block_size=128, row_cost_slots=als.als_row_cost_slots(16))
    finally:
        store.close()
    held = tuple(np.asarray(a) for a in binned.holdout)
    sides = (als.side_layout_from_binned(binned.user_side),
             als.side_layout_from_binned(binned.item_side))
    counts = (len(binned.entity_vocab), len(binned.target_vocab),
              binned.n_rows)
    cfg = als.ALSConfig(rank=16, iterations=3, reg=0.05, block_size=128,
                        **ALS_PRECISION[precision])

    def run(device, user, item, nudge=0.0, seed=0):
        t = als.ALSTrainer.from_sides(user, item, *counts, cfg,
                                      device=device)
        noise = np.random.default_rng(seed).normal(size=tuple(t.X.shape))
        t.X = t.X * (1.0 + nudge * torch.from_numpy(noise).float().to(
            t.X.device))
        return t.run()

    want = run("cpu", *sides)
    got = run(cuda, *sides)
    als.save_layout("card", *sides, *counts)
    cached = als.load_layout("card")
    assert not cached.user_side.val.flags.writeable
    from_cache = run(cuda, cached.user_side, cached.item_side)
    if precision == "direct-f32":
        tol_u = tol_i = 1e-4
        tol_rmse = 1e-5
    else:
        nudged = [run("cpu", *sides, 1e-6, seed) for seed in range(3)]
        tol_u = 3 * max(_rel(f.user_factors, want.user_factors)
                        for f in nudged)
        tol_i = 3 * max(_rel(f.item_factors, want.item_factors)
                        for f in nudged)
        tol_rmse = 1e-2
    for f in (got, from_cache):
        assert _rel(f.user_factors, want.user_factors) <= tol_u
        assert _rel(f.item_factors, want.item_factors) <= tol_i
        assert abs(als.predict_rmse(f, held)
                   - als.predict_rmse(want, held)) <= tol_rmse


# -- the front door: events over HTTP to answers on the card -------------------

def test_events_posted_to_the_event_server_train_als_on_the_card(
        cuda, tmp_path, monkeypatch):
    """An eventlog app made by ``app new`` and filled through the port's
    EventServer over HTTP (the batch route's native lane) trains ALS on
    the card on the binned lane, and its answers come through
    ``topk_dot``: the launch counter rises, and the items are the float64
    host top-k of the trained factors."""
    import json
    import urllib.request

    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.models.als import PreparedRatings
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.serving.event_server import EventServer
    from predictionio_torch.templates.recommendation import (
        RecoDataSource, RecoDataSourceParams)
    from predictionio_torch.tools import commands

    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    storage = Storage.from_env({
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / "el")})
    key = commands.app_new("card", storage=storage).access_keys[0].key
    u, i, r = _als_ratings(300, 2000, 8000, seed=11)
    server = EventServer(storage=storage, host="127.0.0.1", port=0).start()
    set_storage(storage)
    try:
        for s in range(0, len(u), 2000):
            body = json.dumps([
                {"event": "rate", "entityType": "user",
                 "entityId": f"u{int(a)}", "targetEntityType": "item",
                 "targetEntityId": f"i{int(b)}",
                 "properties": {"rating": float(c)}}
                for a, b, c in zip(u[s:s + 2000], i[s:s + 2000],
                                   r[s:s + 2000])]).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/batch/events.json"
                f"?accessKey={key}", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                rows = json.loads(resp.read())
            assert [x["status"] for x in rows] == [201] * len(rows)
        server.stop()
        td = RecoDataSource(RecoDataSourceParams(app_name="card")) \
            .read_training(None)
        assert td.binned_request is not None
        algo = ALSAlgorithm(ALSParams(rank=16, num_iterations=5,
                                      lambda_=0.05))
        model = algo.train(DeviceContext(cuda), PreparedRatings(
            binned_request=td.binned_request, fingerprint=td.fingerprint))
        assert algo.last_train["lane"] == "binned"
        assert algo.last_train["ratings"] == len(u)
        model = model.to(cuda)
        U = model.user_factors.astype(np.float64)
        V = model.item_factors.astype(np.float64)
        names = model.item_ids.inverse()
        before = tkd.launches.value
        for user in ("u0", "u7", "u42"):
            got = algo.predict(model, {"user": user, "num": 10})
            scores = V @ U[model.user_ids[user]]
            want = np.lexsort((np.arange(len(V)), -scores))[:10]
            served = [e["item"] for e in got["itemScores"]]
            tol = 1e-4 * max(1.0, float(np.abs(scores).max()))
            for name, j in zip(served, want):
                assert name == names[int(j)] or abs(
                    scores[model.item_ids[name]] - scores[j]) <= tol
        assert tkd.launches.value >= before + 3
    finally:
        set_storage(None)
        server.stop()
        storage.events().close()


# -- grid training and pio eval on the card -------------------------------------

GRID = dict(regs=[0.05, 0.1, 0.2, 0.05], alphas=[0.5, 0.5, 0.3, 0.5],
            iterations=[3, 3, 3, 2], cg_iters=[6, 6, 6, 4])


@pytest.mark.parametrize("implicit", [False, True])
def test_als_grid_on_the_card_matches_the_cpu(cuda, implicit):
    """The grid on the card against the grid on the CPU from the same
    seed, in f32 with the direct solver (the same arithmetic, summed in
    another order: ``index_add_``'s float atomics, cuBLAS's blocking).
    Explicit: every candidate's factors to a relative Frobenius error of
    1e-4 and its held-out RMSE to 1e-5, as
    test_als_trainer_on_the_card_matches_the_cpu holds one train.
    Implicit: on this data a 1e-6 nudge of the CPU grid's start moves
    its user factors by more than 1e-4 after 3 iterations, so each
    candidate must stay within 3x the spread the CPU grid shows against
    itself under such a nudge (the largest of two, measured here)."""
    n_users, n_items = 600, 70_000
    u, i, r = _als_ratings(n_users, n_items, 20_000, seed=5)
    hold = np.arange(len(r)) % 20 == 0
    train = (u[~hold], i[~hold], r[~hold])
    held = (u[hold], i[hold], r[hold])
    cfg = als.ALSConfig(rank=16, iterations=3, reg=0.05, implicit=implicit,
                        alpha=0.5, block_size=128,
                        **ALS_PRECISION["direct-f32"])

    def cpu_run(nudge=0.0, seed=0):
        t = als.ALSGridTrainer(train, n_users, n_items, cfg, device="cpu",
                               **GRID)
        noise = np.random.default_rng(seed).normal(size=tuple(t.Y.shape))
        t.Y = t.Y * (1.0 + nudge * torch.from_numpy(noise).float())
        return t.run()

    want = cpu_run()
    got = als.als_grid_train(train, n_users, n_items, cfg, device=cuda,
                             **GRID)
    tol = {"user_factors": [1e-4] * 4, "item_factors": [1e-4] * 4}
    if implicit:
        spread = [cpu_run(1e-6, seed) for seed in range(2)]
        tol = {k: [3 * max(_rel(getattr(f[g], k), getattr(want[g], k))
                           for f in spread) for g in range(4)]
               for k in tol}
    for g, (a, b) in enumerate(zip(got, want)):
        for k in tol:
            assert _rel(getattr(a, k), getattr(b, k)) <= tol[k][g], (g, k)
        if not implicit:
            assert abs(als.predict_rmse(a, held)
                       - als.predict_rmse(b, held)) <= 1e-5


@pytest.mark.parametrize("precision", sorted(ALS_PRECISION))
def test_als_grid_budget_freeze_on_the_card(cuda, precision):
    """On the card each candidate ends near a sequential card train at
    its own reg, iterations and CG steps, from the same seed (not bit
    for bit: the atomics' order varies): direct/f32 to a relative
    Frobenius error of 1e-4, CG/bf16 by held-out RMSE within 1e-2
    (test_torch_als.py's CG/bf16 bound)."""
    import dataclasses

    n_users, n_items = 600, 2000
    u, i, r = _als_ratings(n_users, n_items, 20_000, seed=23)
    hold = np.arange(len(r)) % 20 == 0
    train = (u[~hold], i[~hold], r[~hold])
    held = (u[hold], i[hold], r[hold])
    cfg = als.ALSConfig(rank=16, iterations=3, reg=0.05, block_size=128,
                        **ALS_PRECISION[precision])
    grid = als.als_grid_train(train, n_users, n_items, cfg, device=cuda,
                              **GRID)
    for g in range(4):
        seq = als.als_train(train, n_users, n_items, dataclasses.replace(
            cfg, reg=GRID["regs"][g], iterations=GRID["iterations"][g],
            cg_iters=GRID["cg_iters"][g]), device=cuda)
        if precision == "direct-f32":
            assert _rel(grid[g].user_factors, seq.user_factors) <= 1e-4
            assert _rel(grid[g].item_factors, seq.item_factors) <= 1e-4
        else:
            assert abs(als.predict_rmse(grid[g], held)
                       - als.predict_rmse(seq, held)) <= 1e-2


def test_run_evaluation_takes_the_grid_path_on_the_card(cuda, caplog):
    """A 3-candidate lambda sweep through ``run_evaluation`` on a memory
    store trains on the card's grid path (one grid run per fold, no
    fallback) and stores an EVALCOMPLETED instance."""
    import datetime as dt
    import logging

    from predictionio_torch.core.evaluation import AverageMetric, Evaluation
    from predictionio_torch.core.fast_eval import FastEvalEngineWorkflow
    from predictionio_torch.core.params import EngineParams
    from predictionio_torch.data.event import Event
    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.templates import recommendation as reco
    from predictionio_torch.workflow.evaluate import run_evaluation

    class RatingMSE(AverageMetric):
        higher_is_better = False

        def calculate_qpa(self, q, p, a):
            match = [s["score"] for s in p["itemScores"]
                     if s["item"] == a["item"]]
            return (match[0] - a["rating"]) ** 2 if match else None

    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    app = storage.apps().insert("grid-app")
    storage.events().init(app.id)
    u, i, r = _als_ratings(300, 400, 6000, seed=25)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    storage.events().insert_batch([Event(
        event="rate", entity_type="user", entity_id=f"u{int(a)}",
        target_entity_type="item", target_entity_id=f"i{int(b)}",
        properties={"rating": float(c)},
        event_time=t0 + dt.timedelta(seconds=j))
        for j, (a, b, c) in enumerate(zip(u, i, r))], app.id)
    candidates = [EngineParams(
        data_source_params=("", reco.RecoDataSourceParams(
            app_name="grid-app", columnar=False, eval_k=3,
            eval_query_num=400)),
        algorithm_params_list=[("als", ALSParams(
            rank=8, num_iterations=5, lambda_=reg, block_size=256))])
        for reg in (0.05, 0.1, 0.5)]
    evaluation = Evaluation(engine=reco.recommendation_engine(),
                            metric=RatingMSE())
    set_storage(storage)
    try:
        with caplog.at_level(logging.INFO):
            result = run_evaluation(evaluation, engine_params_list=candidates,
                                    ctx=DeviceContext(cuda), storage=storage)
        seq = FastEvalEngineWorkflow(evaluation.engine, DeviceContext(cuda))
        seq_scores = [RatingMSE().calculate(None, seq.eval(ep))
                      for ep in candidates]
    finally:
        set_storage(None)
    assert any("grid tuning: 3 candidates trained in 3 grid run(s)"
               in rec.message for rec in caplog.records)
    assert not any("falling back" in rec.message for rec in caplog.records)
    assert seq.counts["train"] == 3 and seq.counts["grid_dispatches"] == 0
    scores = [s.score for s in result.engine_params_scores]
    assert np.all(np.isfinite(scores))
    np.testing.assert_allclose(np.sqrt(scores), np.sqrt(seq_scores),
                               atol=1e-2)
    (inst,) = storage.evaluation_instances().get_completed()
    assert inst.evaluator_results == result.to_one_liner()


def test_als_grid_equals_sequential_trains_bit_for_bit(cuda):
    """Where no group sums more than two nonzero row partials (so
    ``index_add_``'s atomic order cannot change a sum), a grid candidate
    on the card has the bits of its sequential train: the Gramians come
    from the same GEMMs, and the rhs and the CG matvecs go one call per
    candidate (``ops.als._bmv``). MovieLens-100K-shaped ratings (943
    users, 1,682 items, uniform), rank 64, f32, 3 iterations."""
    import dataclasses

    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import PreparedRatings
    from predictionio_torch.parallel.context import DeviceContext

    rng = np.random.default_rng(31)
    u = rng.integers(0, 943, 66_000)
    i = rng.integers(0, 1682, 66_000)
    r = rng.integers(1, 6, 66_000).astype(np.float32)
    pd = PreparedRatings(user_ids=BiMap.from_vocab([f"u{j}" for j in range(943)]),
                         item_ids=BiMap.from_vocab([f"i{j}" for j in range(1682)]),
                         user_idx=u, item_idx=i, ratings=r)
    base = ALSParams(rank=64, num_iterations=3, compute_dtype="float32",
                     cg_dtype="float32")
    params = [dataclasses.replace(base, lambda_=reg)
              for reg in (0.01, 0.1, 1.0)]
    ctx = DeviceContext(cuda)
    grid = ALSAlgorithm.grid_train(ctx, pd, params)
    for model, p in zip(grid, params):
        seq = ALSAlgorithm(p).train(ctx, pd)
        np.testing.assert_array_equal(model.user_factors, seq.user_factors)
        np.testing.assert_array_equal(model.item_factors, seq.item_factors)


# -- the streaming freshness lane on the card ------------------------------------

def _host_fold(Y, rows, x0, cfg):
    """fold_in_solve's normal equations solved in float64 on the host (an
    empty group keeps its warm start)."""
    Y = np.asarray(Y, np.float64)
    K = Y.shape[1]
    out = np.array(x0, np.float64)
    for g, (idx, val) in enumerate(rows):
        if len(idx) == 0:
            continue
        Yg, r = Y[idx], np.asarray(val, np.float64)
        if cfg.implicit:
            A = (cfg.alpha * (Yg * r[:, None]).T @ Yg + Y.T @ Y
                 + cfg.reg * np.eye(K))
            b = Yg.T @ (1.0 + cfg.alpha * r)
        else:
            A = Yg.T @ Yg + cfg.reg * len(idx) * np.eye(K)
            b = Yg.T @ r
        out[g] = np.linalg.solve(A, b)
    return out


@pytest.mark.parametrize("solver", ["cg", "direct"])
@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_solve_on_the_card_matches_the_cpu(cuda, implicit, solver):
    """At rank 64: every folded factor within a relative L2 error of 1e-3
    of the float64 solve of the same normal equations (the CG is f32 with
    16 Jacobi steps), and the card's factors within a relative Frobenius
    error of 1e-4 of the CPU's (the sums run in another order)."""
    rng = np.random.default_rng(17)
    Y = (rng.normal(size=(3000, 64)) * 0.3).astype(np.float32)
    rows = [(rng.integers(0, 3000, n).astype(np.int32),
             (rng.integers(1, 11, n) / 2.0).astype(np.float32))
            for n in list(rng.integers(1, 400, 40)) + [0, 1, 8192]]
    x0 = (rng.normal(size=(len(rows), 64)) * 0.1).astype(np.float32)
    cfg = als.ALSConfig(rank=64, reg=0.05, implicit=implicit, alpha=0.5,
                        solver=solver)
    got = als.fold_in_solve(Y, rows, cfg, x0=x0, device=cuda)
    cpu = als.fold_in_solve(Y, rows, cfg, x0=x0, device="cpu")
    want = _host_fold(Y, rows, x0, cfg)
    err = (np.linalg.norm(got - want, axis=1)
           / np.linalg.norm(want, axis=1))
    assert float(err.max()) <= 1e-3
    np.testing.assert_array_equal(got[-3], x0[-3])
    assert np.linalg.norm(got - cpu) <= 1e-4 * np.linalg.norm(cpu)


def test_online_delta_step_on_the_card_matches_the_cpu(cuda):
    """Touched rows equal; vectors within atol 1e-5, losses within rtol
    1e-5 of the CPU run (f32 products summed in another order)."""
    rng = np.random.default_rng(19)

    def unit(n, d):
        v = rng.normal(size=(n, d)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    U, V = unit(20_000, 128), unit(30_000, 128)
    u_rows = rng.integers(0, 20_000, 2048)
    i_rows = rng.integers(0, 30_000, 2048)
    w = rng.random(2048).astype(np.float32)
    got = tt.online_delta_step(U, V, u_rows, i_rows, weight=w, steps=4,
                               temp=0.07, device=cuda)
    cpu = tt.online_delta_step(U, V, u_rows, i_rows, weight=w, steps=4,
                               temp=0.07, device="cpu")
    np.testing.assert_array_equal(got[0], cpu[0])
    np.testing.assert_array_equal(got[2], cpu[2])
    np.testing.assert_allclose(got[1], cpu[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[3], cpu[3], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[4], cpu[4], rtol=1e-5)
    assert got[4][-1] < got[4][0]


def _check_top(model, q, got, k):
    """A served answer against the float64 host top-k of the served
    tables: scores within 1e-5 * |q| * max|item|, items equal except
    across near-ties."""
    U = model.user_factors.astype(np.float64)
    V = model.item_factors.astype(np.float64)
    names = model.item_ids.inverse()
    if "user" in q:
        qv = U[model.user_ids[q["user"]]]
        allowed = np.arange(len(V))
    else:
        row = model.item_ids[q["item"]]
        qv = V[row]
        allowed = np.delete(np.arange(len(V)), row)
    scores = V @ qv
    want = allowed[np.lexsort((allowed, -scores[allowed]))][:k]
    tol = 1e-5 * np.linalg.norm(qv) * np.linalg.norm(V, axis=1).max()
    served = got["itemScores"]
    assert len(served) == k
    for entry, j in zip(served, want):
        assert abs(entry["score"] - scores[j]) <= tol
        assert entry["item"] == names[int(j)] or abs(
            scores[model.item_ids[entry["item"]]] - scores[j]) <= tol


def test_a_folded_model_answers_through_topk_dot_on_the_card(
        cuda, tmp_path, monkeypatch):
    """An ALS engine trained on the card, served by an EngineServer on the
    card and patched by a StreamUpdater whose folds run on the card: the
    new user's and the new item's answers come through ``topk_dot`` and
    are the float64 host top-k of the patched tables."""
    import datetime as dt

    from predictionio_torch.data.event import Event
    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    from predictionio_torch.workflow import stream
    from predictionio_torch.workflow.train import run_train

    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    storage = Storage.from_env({
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / "el")})
    app = storage.apps().insert("card")
    storage.events().init(app.id)
    u, i, r = _als_ratings(300, 2000, 8000, seed=23)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)

    def rate(user, item, value, k=0):
        return Event(event="rate", entity_type="user", entity_id=user,
                     target_entity_type="item", target_entity_id=item,
                     properties={"rating": float(value)},
                     event_time=t0 + dt.timedelta(seconds=k))

    storage.events().insert_batch(
        [rate(f"u{a}", f"i{b}", c, k)
         for k, (a, b, c) in enumerate(zip(u, i, r))], app.id)
    set_storage(storage)
    engine = recommendation_engine()
    ctx = DeviceContext(cuda)
    server = None
    try:
        instance = run_train(engine, engine.engine_params_from_variant({
            "datasource": {"params": {"app_name": "card"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 16, "num_iterations": 5, "lambda_": 0.05}}]}),
            engine_id="card", ctx=ctx, storage=storage)
        server = EngineServer(engine, "card", host="127.0.0.1", port=0,
                              storage=storage, device=cuda).start()
        updater = stream.StreamUpdater(engine, "card", storage=storage,
                                       ctx=ctx, instance=instance,
                                       patch_servers=[server])
        assert updater._folders[0].device.type == "cuda"
        old = [f"u{int(a)}" for a in u[:3]]
        storage.events().insert_batch(
            [rate("card_new_u", f"i{int(b)}", 4.5) for b in i[:4]]
            + [rate(name, "card_new_i", 4.0) for name in old], app.id)
        before = tkd.launches.value
        stats = updater.poll_once()
        assert stats["published"] and stats["events"] == 7
        model = server.deployment.models[0]
        for q in ({"user": "card_new_u", "num": 10},
                  {"item": "card_new_i", "num": 10}):
            _check_top(model, q, server.deployment.query(q), 10)
        assert tkd.launches.value >= before + 2
    finally:
        set_storage(None)
        if server is not None:
            server.stop()
        storage.events().close()


# -- the engine-project path: similar products at rank 10, checkpoints -----------

@pytest.mark.parametrize("D", [10, 6])
@pytest.mark.parametrize("B,k,E", [(1, 16, 2), (1, 8, 1), (4, 16, 64)])
def test_kernel_at_a_rank_not_a_multiple_of_4_matches_plain(cuda, D, B, k, E):
    """The similar-product model serves its exclusion-only queries at
    its ALS rank (10 by default): ranks that are not a multiple of 4
    take the kernel's scalar-load path. Row-normalized items, as that
    model's table is."""
    rng = np.random.default_rng(D * 100 + k + E)
    items = rng.normal(size=(26_744, D)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    q = torch.tensor(items[rng.integers(0, 26_744, (B, 3))].sum(axis=1),
                     device=cuda)
    items = torch.tensor(items, device=cuda)
    excl = torch.tensor(rng.integers(-1, 26_744, size=(B, E)),
                        dtype=torch.int32, device=cuda)
    before = tkd.launches.value
    s, i = tkd.topk_dot(q, items, excl, k)
    torch.cuda.synchronize()
    assert tkd.launches.value == before + 1
    _assert_matches_plain(q, items, excl, k, s, i)


def test_similar_product_model_serves_through_the_kernel(cuda):
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.similarproduct import SimilarProductModel

    rng = np.random.default_rng(4)
    names = [f"i{j}" for j in range(3000)]
    model = SimilarProductModel(
        rng.normal(size=(3000, 10)).astype(np.float32),
        BiMap.from_vocab(names), {n: ["a"] for n in names[::2]}).to(cuda)
    cpu = SimilarProductModel(model.item_factors, model.item_ids,
                              model.item_categories).to("cpu")
    before = tkd.launches.value
    for q in ({"items": ["i1", "i7"], "num": 10, "black_list": {"i3"}},
              {"items": ["i5"], "num": 1}):
        got = model.similar(q["items"], q["num"],
                            black_list=q.get("black_list"))
        want = cpu.similar(q["items"], q["num"],
                           black_list=q.get("black_list"))
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], atol=1e-5)
    assert tkd.launches.value == before + 2
    assert model.retrieval_stats()["kernel"]["engaged"]
    # a category query takes the masked scorer, on the card
    got = model.similar(["i1"], 5, categories={"a"})
    assert got and all(int(n[1:]) % 2 == 0 for n, _ in got)
    assert model.scorer().item_factors.device.type == "cuda"


def test_twotower_resume_on_the_card_restores_the_generator(cuda, tmp_path):
    """A run stopped after epoch 1 and resumed on the card: the restored
    tables, accumulators and generator state equal what was saved, and
    the remaining epochs walk the uninterrupted run's orders. The table
    update combines duplicate rows with float atomics, so two
    uninterrupted runs differ in rounding: the resumed tables must sit
    within 2x that spread (L2 from the two runs' mean against the L2
    between them)."""
    rng = np.random.default_rng(3)
    u, i = rng.integers(0, 400, 6000), rng.integers(0, 300, 6000)
    kw = dict(dim=16, epochs=3, batch_size=256, seed=4)
    orders = {}

    def record(trainer, key):
        draw = trainer.epoch_order

        def epoch_order(perm=None):
            order = draw(perm)
            orders.setdefault(key, []).append(order.cpu())
            return order
        trainer.epoch_order = epoch_order
        return trainer

    def tables(trainer):
        return torch.cat([trainer.tables[s].flatten().double().cpu()
                          for s in ("user", "item")])

    straight = []
    for key in ("a", "b"):
        t = record(TwoTowerTrainer((u, i, None), 400, 300,
                                   TwoTowerConfig(**kw), device=cuda), key)
        straight.append((t.run(), tables(t)))
    cfg = TwoTowerConfig(**kw, checkpoint_dir=str(tmp_path))
    first = TwoTowerTrainer((u, i, None), 400, 300, cfg, device=cuda)
    first_losses = first.run(epochs=1)
    saved = {side: (first.tables[side].cpu(), first.acc[side].cpu())
             for side in ("user", "item")}
    gen = first._perm_gen.get_state()
    resumed = record(TwoTowerTrainer((u, i, None), 400, 300, cfg,
                                     device=cuda), "resumed")
    assert resumed._epochs_done == 1
    assert resumed.tables["user"].device.type == "cuda"
    assert torch.equal(resumed._perm_gen.get_state(), gen)
    for side, (table, acc) in saved.items():
        assert torch.equal(resumed.tables[side].cpu(), table)
        assert torch.equal(resumed.acc[side].cpu(), acc)
    resumed_losses = resumed.run()
    assert len(orders["resumed"]) == 2
    for a, b in zip(orders["resumed"], orders["a"][1:]):
        assert torch.equal(a, b)
    # epoch 1's loss is the checkpointed run's, restored
    assert resumed_losses[0] == first_losses[0]
    np.testing.assert_allclose(resumed_losses, straight[0][0], rtol=1e-3)
    (_, ta), (_, tb) = straight
    spread = float((ta - tb).norm())
    assert float((tables(resumed) - (ta + tb) / 2).norm()) <= 2 * spread



# -- the session recommender ---------------------------------------------------------

def _sessionrec_trainer(device, dropout=0.0, seed=0):
    from predictionio_torch.ops import sessionrec as sr

    rng = np.random.default_rng(seed)
    n_users, n_items = 300, 500
    users = np.repeat(np.arange(n_users), 40)
    items = rng.integers(0, n_items, len(users))
    times = np.tile(np.arange(40.0), n_users)
    cfg = sr.SessionRecConfig(dim=64, heads=2, layers=2, max_len=32,
                              dropout=dropout, batch_size=64, epochs=1)
    return sr.SessionRecTrainer((users, items, times), n_users, n_items, cfg,
                                device=device)


@pytest.mark.parametrize("attn_block", [0, 8])
def test_sessionrec_forward_and_step_on_the_card_match_the_cpu(cuda,
                                                                attn_block):
    """The encoder's forward, loss and gradients on the card against the
    same carried weights on the CPU (f32, TF32 off): hidden states within
    1e-4, the loss within rtol 1e-5, the gradient norm within rtol
    1e-4."""
    import dataclasses

    from predictionio_torch.ops import sessionrec as sr

    cpu = _sessionrec_trainer("cpu")
    cfg = dataclasses.replace(cpu.cfg, attn_block=attn_block)
    params = sr.params_to_flax(cpu.encoder)
    seq = torch.from_numpy(cpu.inputs[:64])
    tgt = torch.from_numpy(cpu.targets[:64])
    out = []
    for dev in (torch.device("cpu"), cuda):
        enc = sr.SessionEncoder(cpu.n_items, cfg)
        enc.load_state_dict(sr.params_from_flax(params))
        enc.to(dev)
        h = enc(seq.to(dev))
        loss = sr.tied_loss(enc, seq.to(dev), tgt.to(dev), None)
        loss.backward()
        gnorm = torch.sqrt(sum(p.grad.double().square().sum()
                               for p in enc.parameters()))
        out.append((h.detach().cpu().numpy(), loss.item(), gnorm.item()))
    (h0, l0, g0), (h1, l1, g1) = out
    np.testing.assert_allclose(h1, h0, atol=1e-4)
    assert l1 == pytest.approx(l0, rel=1e-5)
    assert g1 == pytest.approx(g0, rel=1e-4)


def test_sessionrec_trains_on_the_card(cuda):
    trainer = _sessionrec_trainer(cuda, dropout=0.1)
    losses = trainer.run(epochs=3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert trainer.encoder.item_embed.weight.device.type == "cuda"


def _longer(state, max_len):
    """``state`` with a position table of ``max_len`` rows (the new rows
    zero), so a session can hold more than 64 seen items."""
    import copy
    import dataclasses

    params = copy.deepcopy(state.params)
    pos = params["params"]["pos_embed"]
    params["params"]["pos_embed"] = np.concatenate(
        [pos, np.zeros((max_len - len(pos), pos.shape[1]), pos.dtype)])
    return dataclasses.replace(
        state, params=params,
        cfg=dataclasses.replace(state.cfg, max_len=max_len))


def test_sessionrec_scorer_through_topk_dot_matches_the_masked_route(cuda):
    """On the card a lone query goes through ``topk_dot`` (one launch a
    call); its answers equal a full masked product's top-k, with and
    without the seen items excluded. A session of more than 64 seen
    items takes the masked route (no launch) and excludes them all."""
    from predictionio_torch.ops import sessionrec as sr
    from predictionio_torch.ops.topk import NEG_INF, ordered_topk

    trainer = _sessionrec_trainer(cuda)
    trainer.run(epochs=1)
    state = trainer.state()
    scorer = sr.SessionScorer(state, device=cuda)
    items = torch.tensor(state.params["params"]["item_embed"]["embedding"][1:],
                         device=cuda)
    for row in state.sequences[:6]:
        for exclude in (False, True):
            before = tkd.launches.value
            s, i = scorer.top_k(row[None], 16, exclude_seen=exclude)
            torch.cuda.synchronize()
            assert tkd.launches.value == before + 1
            scores = scorer.hidden(row[None]) @ items.T
            if exclude:
                seen = torch.tensor(np.unique(row[row > 0]) - 1, device=cuda)
                scores[0, seen.long()] = float(NEG_INF)
            rs, ri = ordered_topk(scores, 16)
            tol = 1e-5 * float(scores.abs().max())
            np.testing.assert_allclose(s, rs.cpu().numpy(), atol=tol)
            assert (np.asarray(i) == ri.cpu().numpy()).mean() >= 0.9
    wide = sr.SessionScorer(_longer(state, 80), device=cuda)
    row = np.zeros((1, 80), np.int32)
    row[0, :70] = np.arange(1, 71)
    before = tkd.launches.value
    s, i = wide.top_k(row, 16, exclude_seen=True)
    assert tkd.launches.value == before
    assert len(i[0]) == 16 and not set(i[0].tolist()) & set(range(70))


# -- the observability core on the card ------------------------------------------

@pytest.fixture()
def card_server(cuda, tmp_path, monkeypatch):
    """An ALS engine trained on the card and served by an EngineServer
    on the card, from a localfs store under ``tmp_path``."""
    from predictionio_torch.data.event import Event
    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    from predictionio_torch.workflow.train import run_train

    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    env = {"PIO_STORAGE_SOURCES_S_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "store")}
    for repo, name in (("METADATA", "meta"), ("EVENTDATA", "events"),
                       ("MODELDATA", "models")):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = name
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "S"
    storage = Storage.from_env(env)
    app = storage.apps().insert("obs")
    storage.events().init(app.id)
    u, i, r = _als_ratings(200, 500, 4000, seed=31)
    storage.events().insert_batch(
        [Event(event="rate", entity_type="user", entity_id=f"u{a}",
               target_entity_type="item", target_entity_id=f"i{b}",
               properties={"rating": float(c)})
         for a, b, c in zip(u, i, r)], app.id)
    engine = recommendation_engine()
    set_storage(storage)     # the data source reads the process storage
    server = None
    try:
        run_train(engine, engine.engine_params_from_variant({
            "datasource": {"params": {"app_name": "obs"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 16, "num_iterations": 3}}]}),
            engine_id="obs", ctx=DeviceContext(cuda), storage=storage)
        server = EngineServer(engine, "obs", host="127.0.0.1", port=0,
                              storage=storage, device=cuda,
                              micro_batch=False).start()
        yield server
    finally:
        set_storage(None)
        if server is not None:
            server.stop()


def test_device_memory_gauges_equal_memory_stats(cuda):
    from predictionio_torch.obs import memacct, metrics

    keep = torch.empty(1 << 22, device=cuda)    # something allocated
    n = memacct.update_device_memory_gauges()
    stats = torch.cuda.memory_stats(0)
    limit = torch.cuda.mem_get_info(0)[1]
    assert n == torch.cuda.device_count() >= 1
    gauge = metrics.REGISTRY.get("pio_device_memory_bytes")
    assert gauge.labels("0", "bytes_in_use").value == \
        stats["allocated_bytes.all.current"] >= keep.numel() * 4
    assert gauge.labels("0", "peak_bytes_in_use").value == \
        stats["allocated_bytes.all.peak"]
    assert gauge.labels("0", "bytes_limit").value == limit
    assert memacct.capacity_report()["basis"] == "memory_stats"


def test_readyz_of_a_card_deployment_names_the_card(card_server):
    import json
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{card_server.port}/readyz", timeout=60) as r:
        assert r.status == 200
        body = json.loads(r.read())
    devices = body["probes"]["devices"]
    assert devices["status"] == "ok"
    assert torch.cuda.get_device_name(0) in devices["reason"]
    assert body["probes"]["kernels"]["status"] == "ok"
    assert "topk_dot" in body["probes"]["kernels"]["reason"]


def test_profiler_counts_the_lone_queries_kernels(card_server, tmp_path):
    from predictionio_torch.obs import profiler

    card_server.query({"user": "u1", "num": 10})      # warm
    before = tkd.launches.value
    with profiler.trace_capture(str(tmp_path / "prof")) as result:
        for k in range(10):
            card_server.query({"user": f"u{k}", "num": 10})
    launched = tkd.launches.value - before
    assert launched == 10
    assert profiler.kernel_count(result["summary"], "topk_dot") == launched
    assert 0.0 <= result["summary"]["idle_share"] <= 1.0
    assert (tmp_path / "prof" / "trace.json").is_file()


def test_train_mfu_is_set_after_five_twotower_steps(cuda, monkeypatch):
    from predictionio_torch.obs import metrics

    monkeypatch.delenv("PIO_PEAK_FLOPS", raising=False)
    rng = np.random.default_rng(8)
    n_pos = 5 * 256
    trainer = TwoTowerTrainer(
        (rng.integers(0, 400, n_pos), rng.integers(0, 300, n_pos), None),
        400, 300, TwoTowerConfig(dim=32, batch_size=256, epochs=1),
        device=cuda)
    assert trainer.steps_per_epoch == 5
    trainer.run(1)
    mfu = metrics.REGISTRY.get("pio_train_mfu").labels("twotower").value
    assert 0.0 < mfu <= 1.0
    assert mfu == trainer._acct.last_mfu


_WORLD2_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from predictionio_torch.ops import als
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.ops.topk import ShardedTopKScorer
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import create_mesh

rank, port = int(sys.argv[1]), int(sys.argv[2])
# two ranks on one card: gloo (NCCL refuses them), set up by the caller
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
assert mh.initialize_from_env() is True
assert mh.rank_device().type == "cuda"
mesh = create_mesh()
rng = np.random.default_rng(0)
items = rng.normal(size=(5_001, 64)).astype(np.float32)
users = rng.normal(size=(9, 64)).astype(np.float32)
scorer = ShardedTopKScorer(items, mesh)
assert scorer.item_slab.device.type == "cuda"
full = torch.tensor(items, device="cuda")
tkd.launches.reset()
for b in range(8):
    excl = np.array([[b, 2_600 + b, -1]], np.int32)
    s, i = scorer.score(users[b:b + 1], 16, excl)
    q = torch.tensor(users[b:b + 1], device="cuda")
    rs, ri = tkd.topk_dot(q, full, torch.tensor(excl, device="cuda"), 16)
    np.testing.assert_array_equal(i, ri.cpu().numpy())
    np.testing.assert_allclose(s, rs.cpu().numpy(), rtol=1e-5, atol=1e-5)
s, i = scorer.score(users, 16)
assert tkd.launches.value == 9 + 8, tkd.launches.value
nnz = 20_000
coo = (rng.integers(0, 700, nnz), rng.integers(0, 300, nnz),
       rng.integers(1, 11, nnz).astype(np.float32) / 2)
cfg = als.ALSConfig(rank=16, iterations=2, block_size=64, solver="direct",
                    compute_dtype="float32", cg_dtype="float32")
got = als.als_train(coo, 700, 300, cfg, mesh=mesh)
want = als.als_train(coo, 700, 300, cfg)
for a, b in ((got.user_factors, want.user_factors),
             (got.item_factors, want.item_factors)):
    assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
mh.shutdown()
print("RANK OK", rank)
"""


def test_sharded_scorer_and_als_on_a_world_of_two_on_the_card(cuda):
    """Two gloo ranks on ``cuda:0``: the sharded scorer answers as
    ``topk_dot`` over the whole table does, one launch a call on each
    rank, and the sharded ALS train equals the unsharded one."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root,
           "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "PIO_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORLD2_WORKER, str(r), str(port)],
        env={**env, "PIO_PROCESS_ID": str(r)}, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK OK {r}" in out, out[-3000:]


_TT_WORLD2_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from predictionio_torch.ops import twotower as tt
from predictionio_torch.ops.kernels import embed_update as eu
from predictionio_torch.ops.kernels import flash_ce as fce
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import create_mesh

rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
assert mh.initialize_from_env() is True
rng = np.random.default_rng(3)
pos = (rng.integers(0, 3_000, 4 * 512), rng.integers(0, 2_000, 4 * 512),
       None)
perm = rng.permutation(4 * 512)
gen = torch.Generator().manual_seed(4)
state = tt.TwoTowerState(
    tables={"user": torch.randn(3_000, 32, generator=gen) / 32 ** 0.5,
            "item": torch.randn(2_000, 32, generator=gen) / 32 ** 0.5},
    acc={"user": torch.zeros(3_000), "item": torch.zeros(2_000)},
    dense={"user": [], "item": []})


def run(mesh, **cfg):
    t = tt.TwoTowerTrainer(pos, 3_000, 2_000, tt.TwoTowerConfig(
        dim=32, batch_size=512, epochs=1, learning_rate=1e-2,
        compute_dtype="float32", **cfg), device="cuda", state=state,
        mesh=mesh)
    assert t.kernel_plan["flash_ce"] and t.kernel_plan["embed_update"]
    f0, e0 = fce.launches.value, eu.launches.value
    losses = t.run(perms=[perm])
    assert fce.launches.value - f0 == 3 * 4, fce.launches.value - f0
    assert eu.launches.value - e0 == 2 * 4, eu.launches.value - e0
    return losses, {s: t._whole(s, t.tables[s]).cpu() for s in tt.SIDES}


want, tables = run(None)
for mesh, cfg in ((create_mesh({"data": 2}), {}),
                  (create_mesh({"model": 2}), {"shard_embeddings": True})):
    got, got_tables = run(mesh, **cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for s in tt.SIDES:
        torch.testing.assert_close(got_tables[s], tables[s], rtol=0,
                                   atol=1e-5)
mh.shutdown()
print("RANK OK", rank)
"""


def test_twotower_dp_and_tp_on_a_world_of_two_on_the_card(cuda):
    """Two gloo ranks on ``cuda:0``: the two-tower trainer over ``{"data":
    2}`` and over ``{"model": 2}`` with ``shard_embeddings`` launches
    ``flash_ce`` 3 times and ``embed_update`` 2 times a step on each
    rank and ends where the one-process trainer does (f32; only the
    atomics that sum a row's duplicates reorder)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root,
           "PIO_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "PIO_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TT_WORLD2_WORKER, str(r), str(port)],
        env={**env, "PIO_PROCESS_ID": str(r)}, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK OK {r}" in out, out[-3000:]


def test_rest_tier_train_and_deploy_on_the_card(cuda, tmp_path, monkeypatch):
    """The Recommendation engine trained by ``cli train`` on ``cuda:0``
    over three in-process storage servers (``REPLICAS=2``, memory
    storage behind each) and served by an ``EngineServer`` on the card
    that loads it through the tier: every lone answer equals a float64
    top-k of the stored factors (scores to 1e-5 * |q| * max|item|, ids
    except across such near-ties), one ``topk_dot`` launch or more a
    query."""
    import datetime as dt
    import json
    import os
    import urllib.request

    from predictionio_torch.data import storage as storage_mod
    from predictionio_torch.data.event import Event
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.serving.storage_server import StorageServer
    from predictionio_torch.templates.recommendation import \
        recommendation_engine
    from predictionio_torch.tools import cli
    from predictionio_torch.workflow.deploy import load_blob

    backends = [storage_mod.Storage.from_env(
        {"PIO_STORAGE_SOURCES_M_TYPE": "memory"}) for _ in range(3)]
    servers = [StorageServer(storage=b, host="127.0.0.1", port=0).start()
               for b in backends]
    env = {"PIO_STORAGE_SOURCES_C_TYPE": "rest",
           "PIO_STORAGE_SOURCES_C_HOSTS": "127.0.0.1",
           "PIO_STORAGE_SOURCES_C_PORTS": ",".join(
               str(s.port) for s in servers),
           "PIO_STORAGE_SOURCES_C_REPLICAS": "2"}
    server = None
    try:
        tier = storage_mod.Storage.from_env(env)
        app = tier.apps().insert("reco")
        tier.events().init(app.id)
        rng = np.random.default_rng(5)
        t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
        tier.events().insert_batch([Event(
            event="rate", entity_type="user",
            entity_id=f"u{int(rng.integers(200))}",
            target_entity_type="item",
            target_entity_id=f"i{int(rng.integers(120))}",
            properties={"rating": float(rng.integers(1, 6))},
            event_time=t0 + dt.timedelta(seconds=j)) for j in range(4000)],
            app.id)
        ej = tmp_path / "engine.json"
        ej.write_text(json.dumps({
            "engineId": "reco-card", "engineFactory":
            "predictionio_torch.templates.recommendation."
            "recommendation_engine",
            "datasource": {"params": {"app_name": "reco"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 16, "num_iterations": 4, "lambda_": 0.05,
                "block_size": 64}}]}))
        for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
            monkeypatch.delenv(k)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        storage_mod.set_storage(None)
        try:
            assert cli.main(["train", "--engine-json", str(ej)]) == 0
        finally:
            storage_mod.set_storage(None)
        inst = tier.engine_instances().get_latest_completed(
            "reco-card", "0", "default")
        model = load_blob(tier.models().get(inst.id).models)[0]
        U = np.asarray(model.user_factors, np.float64)
        V = np.asarray(model.item_factors, np.float64)
        names = list(model.item_ids.keys())
        tkd.launches.reset()
        server = EngineServer(recommendation_engine(), engine_id="reco-card",
                              host="127.0.0.1", port=0, storage=tier,
                              device="cuda").start()
        users = list(model.user_ids.keys())[:12]
        for user in users:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/queries.json",
                data=json.dumps({"user": user, "num": 10}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                got = json.loads(resp.read())["itemScores"]
            q = U[model.user_ids[user]]
            scores = V @ q
            order = np.lexsort((np.arange(len(V)), -scores))[:10]
            tol = 1e-5 * np.linalg.norm(q) * np.linalg.norm(V, axis=1).max()
            assert len(got) == 10
            for entry, j in zip(got, order):
                assert abs(entry["score"] - scores[j]) <= tol
                assert entry["item"] == names[j] or abs(
                    scores[model.item_ids[entry["item"]]] - scores[j]) <= tol
        assert tkd.launches.value >= len(users)
    finally:
        if server is not None:
            server.stop()
        for s in servers:
            s.stop()


# -- the operator's tools: the kernel-library cache, the profile capture --------

CACHED_LOAD = """\
import json
import torch
from predictionio_torch.obs import torchmon
from predictionio_torch.ops import kernels
from predictionio_torch.ops.kernels import embed_update as eu
torch.cuda.init()
kernels.load_library("embed_update")
gen = torch.Generator(device="cuda").manual_seed(3)
table = torch.randn((500, 64), generator=gen, device="cuda")
idx = torch.randint(0, 500, (300,), generator=gen, device="cuda")
grad = torch.randn((300, 64), generator=gen, device="cuda")
scale = torch.rand(300, generator=gen, device="cuda")
want = eu.embed_update_reference(table.clone(), idx, grad, scale)
eu.embed_update(table, idx, grad, scale)
torch.cuda.synchronize()
ok = bool(((table - want).abs() <= 1e-6 + 1e-5 * want.abs()).all())
print(json.dumps({
    "built": torchmon.KERNEL_BUILD_TOTAL.labels("embed_update",
                                                "built").value,
    "cached": torchmon.KERNEL_BUILD_TOTAL.labels("embed_update",
                                                 "cached").value,
    "dir": kernels.library_dir(), "launches": eu.launches.value, "ok": ok}))
"""


def test_a_library_built_into_a_cache_loads_cached_in_a_second_interpreter(
        cuda, tmp_path, monkeypatch):
    """``embed_update`` built into an empty ``PIO_COMPILE_CACHE_DIR`` by
    this process (``built`` 1) loads in a second interpreter with no
    build (``cached`` 1) and agrees with its plain version there."""
    import json
    import os
    import subprocess
    import sys

    from predictionio_torch.obs import torchmon
    from predictionio_torch.ops import kernels

    monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("PIO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_load_seconds", {})
    built = torchmon.KERNEL_BUILD_TOTAL.labels("embed_update", "built")
    before = built.value
    kernels.load_library("embed_update")
    assert built.value == before + 1
    kdir = tmp_path / "cache" / "kernels"
    files = sorted(os.listdir(kdir))
    assert len(files) == 2 and files[1] == files[0] + ".log"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", CACHED_LOAD], cwd=root,
                          env={**os.environ, "PYTHONPATH": root},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"built": 0, "cached": 1, "dir": str(kdir),
                   "launches": 1, "ok": True}
    assert sorted(os.listdir(kdir)) == files


def test_a_profiled_twotower_cut_names_both_kernels(cuda, tmp_path,
                                                    monkeypatch):
    """``run_train`` of the two-tower algorithm under ``PIO_PROFILE_DIR``
    on the card, 6 steps in one epoch: ``breakdown.json`` counts one step
    (one a two-tower epoch, as JAX counts) and names ``flash_ce`` with 3
    launches a step and ``embed_update`` with 2."""
    import json

    from predictionio_torch.core import (DataSource, Engine, FirstServing,
                                         IdentityPreparator)
    from predictionio_torch.core.params import EngineParams
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.models.als import PreparedRatings
    from predictionio_torch.models.twotower import (TwoTowerAlgorithm,
                                                    TwoTowerParams)
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.workflow.train import run_train

    rng = np.random.default_rng(16)
    n_ids, steps, batch = 5000, 6, 1024
    prepared = PreparedRatings(
        user_ids=BiMap.from_vocab([f"u{j}" for j in range(n_ids)]),
        item_ids=BiMap.from_vocab([f"i{j}" for j in range(n_ids)]),
        user_idx=rng.integers(0, n_ids, steps * batch),
        item_idx=rng.integers(0, n_ids, steps * batch),
        ratings=np.ones(steps * batch, np.float32))

    class Source(DataSource):
        def read_training(self, ctx):
            return prepared

    engine = Engine(Source, IdentityPreparator,
                    {"twotower": TwoTowerAlgorithm}, FirstServing)
    ep = EngineParams(
        data_source_params=("", None), preparator_params=("", None),
        algorithm_params_list=[("twotower", TwoTowerParams(
            dim=64, batch_size=batch, epochs=1))],
        serving_params=("", None))
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    fce.launches.reset()
    eu.launches.reset()
    instance = run_train(
        engine, ep, engine_id="tt-prof", ctx=DeviceContext("cuda"),
        storage=Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"}))
    assert (fce.launches.value, eu.launches.value) == (3 * steps, 2 * steps)
    got = json.loads((tmp_path / "prof" / instance.id /
                      "breakdown.json").read_text())
    assert got["steps"] == 1 and got["trace"]["device"] == "cuda"
    launches = got["trace"]["launches"]
    assert sum(n for k, n in launches.items()
               if k.startswith("flash_ce")) == 3 * steps
    assert sum(n for k, n in launches.items()
               if k.startswith("embed_update")) == 2 * steps
    # the optimizer's record_function range spans its kernels: not one more
    assert not [k for k in launches if k.startswith("Optimizer")], launches
    assert got["device_ms_per_step"] > 0


def test_a_profiler_window_keeps_every_marker_after_its_lead_in(cuda):
    """Fault 13: a session drops the device records of the first kernels
    it sees, more the older the process; the capture's lead-in takes
    that loss, so every marker of the window is recorded, the window's
    open and close markers are found on the card's clock, and the
    lead-in's kernels stay out of the summary."""
    from predictionio_torch.obs import profiler
    from predictionio_torch.tools import profile_window

    out = profile_window.lead_loss(markers=40, spacing_ms=2.0)
    assert out["recorded"] == 40, out
    assert out["lead_sec"] >= profiler.LEAD_FLOOR_SEC
    assert out["clock_offset_ms"] is not None
    assert abs(out["clock_offset_ms"]) < 1000.0


def test_a_range_inside_a_window_is_not_counted_as_a_kernel(cuda):
    """The card's record of a ``record_function`` range around kernels
    is left out of ``device_split``: only the kernels inside it count."""
    from predictionio_torch.obs import profiler
    from predictionio_torch.tools import device_time

    x = torch.ones(1 << 20, device=cuda)
    x.mul_(2.0)
    torch.cuda.synchronize()
    with profiler.windowed_profile() as w:
        with torch.profiler.record_function("pio_test::range"):
            for _ in range(3):
                x.mul_(2.0)
    assert not w["window"]["lost"], w["window"]
    ranges = [e for e in w["prof"].events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name == "pio_test::range"]
    assert ranges and all(e.is_user_annotation for e in ranges)
    split = device_time.device_split(w["prof"], window=w["window"])
    assert "pio_test::range" not in split, split
    assert sum(v["count"] for v in split.values()) == 3, split


def test_a_capture_summary_keeps_only_the_callers_kernels(cuda, tmp_path):
    """The lead-in's kernels and the two markers are left out: a window
    over 5 ``topk_dot`` calls counts 5 kernels in all."""
    from predictionio_torch.obs import profiler

    rng = np.random.default_rng(17)
    q = torch.tensor(rng.normal(size=(1, 64)).astype(np.float32),
                     device=cuda)
    items = torch.tensor(rng.normal(size=(4096, 64)).astype(np.float32),
                         device=cuda)
    excl = torch.full((1, 1), -1, dtype=torch.int32, device=cuda)
    tkd.topk_dot(q, items, excl, 16)
    torch.cuda.synchronize()
    with profiler.trace_capture(str(tmp_path / "prof")) as result:
        for _ in range(5):
            tkd.topk_dot(q, items, excl, 16)
    kernels = result["summary"]["kernels"]
    assert profiler.kernel_count(result["summary"], "topk_dot") == 5
    assert sum(v["count"] for v in kernels.values()) == 5, kernels
    window = result["summary"]["window"]
    assert window["start_us"] < window["end_us"]


PIO_RUN_TARGET = '''
import json

from predictionio_torch.data.storage import get_storage
from predictionio_torch.workflow.deploy import load_blob


def answer(argv):
    out, engine_id, num, users = argv[0], argv[1], int(argv[2]), argv[3:]
    storage = get_storage()
    instance = storage.engine_instances().get_latest_completed(
        engine_id, "0", "default")
    (model,) = load_blob(storage.models().get(instance.id).models)
    model.to("cuda")
    with open(out, "w") as f:
        json.dump({"device": str(model.device), "answers": [
            model.recommend(u, num) for u in users]}, f)
    return 3
'''


def test_pio_run_answers_lone_queries_on_the_card(cuda, tmp_path,
                                                  monkeypatch):
    """``cli run`` of a job that loads the newest COMPLETED ALS instance
    on the card through the storage ``pio run`` configured: its lone
    user answers are the float64 top-k on the host, one ``topk_dot``
    launch a query, and its exit code comes back."""
    import datetime as dt
    import json
    import pickle

    from predictionio_torch.data import storage as storage_mod
    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.tools import cli

    rng = np.random.default_rng(18)
    U = rng.normal(size=(300, 16)).astype(np.float32)
    V = rng.normal(size=(2000, 16)).astype(np.float32)
    users = [f"u{j}" for j in range(300)]
    items = [f"i{j}" for j in range(2000)]
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}
    storage = storage_mod.Storage.from_env(env)
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id="run-als", status="COMPLETED", start_time=now, end_time=now,
        engine_id="run-als", engine_version="0", engine_variant="default",
        engine_factory="predictionio_torch.templates.recommendation."
                       "recommendation_engine"))
    storage.models().insert(Model(id="run-als", models=pickle.dumps(
        [als_model_from_arrays(U, V, users, items, rank=16)])))
    (tmp_path / "pio_run_job.py").write_text(PIO_RUN_TARGET)
    monkeypatch.syspath_prepend(str(tmp_path))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    storage_mod.set_storage(None)
    picked = ["u3", "u17", "u250", "u299"]
    out = tmp_path / "answers.json"
    before = tkd.launches.value
    try:
        code = cli.main(["run", "pio_run_job.answer", str(out), "run-als",
                         "10", *picked])
    finally:
        storage_mod.set_storage(None)
    assert code == 3
    assert tkd.launches.value - before >= len(picked)
    got = json.loads(out.read_text())
    assert got["device"].startswith("cuda")
    for user, answer in zip(picked, got["answers"]):
        scores = V.astype(np.float64) @ U[users.index(user)].astype(
            np.float64)
        want = np.lexsort((np.arange(len(items)), -scores))[:10]
        tol = 1e-5 * np.linalg.norm(U[users.index(user)]) * np.linalg.norm(
            V, axis=1).max()
        for j, (item, score) in enumerate(answer):
            assert abs(score - scores[want[j]]) <= tol
            assert item == items[want[j]] or abs(
                scores[items.index(item)] - scores[want[j]]) <= tol
