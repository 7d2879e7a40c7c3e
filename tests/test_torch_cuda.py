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
