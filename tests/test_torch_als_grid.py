"""ALS grid training of the port against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages.

- ``als_grid_train``: the port's ``ALSGridTrainer`` started from the
  JAX grid's own initial draw (``_init_factors(..., grid=G)``, captured
  as it is made) against JAX ``als_grid_train``, explicit and implicit,
  with per-candidate ``regs``, ``alphas``, ``iterations`` and
  ``cg_iters``. One alternation from the same factors, with
  ``solver="direct"`` and with CG in f32: every candidate's factors to
  rtol 1e-4 (atol 1e-5 of the largest factor). Three alternations: the
  same summation-order differences grow through the few-rating groups
  (reg * n_u is a small shift there) past that element-wise bound in a
  few entries, so the end-to-end check is a relative Frobenius error
  of 1e-4, as ``test_torch_als.py`` holds the trainer. CG in f32 runs
  with budgets long enough to converge (32 and 24 steps): a 6-step CG
  is as chaotic in f32 as in bf16 (``tools/als_grid_bits.py`` reads a
  6.5e-4-7.3e-4 move of the factors after 3 alternations from a 1e-6
  nudge of the start, at MovieLens-100K shape on an H100). CG in bf16
  at the default 6 steps: each candidate within 3x the spread the JAX
  grid shows against itself when its initial user factors are nudged
  by 1e-6 (the largest of three nudges, measured here).
- The budget freeze: a candidate with fewer iterations or CG steps ends
  where a sequential port train at its own counts from the same seed
  ends. On the CPU that is the same arithmetic in the same order, so
  the test holds it to rtol 1e-5; on a card ``index_add_``'s float
  atomics and a batched ``bmm``'s blocking make grid and sequential
  agree to a tolerance only, not bit for bit (``test_torch_cuda.py``).
  The JAX package claims bit-identity on its own backend; the port does
  not.
- ``_batched_cg(active_steps=)`` against JAX's (vmapped over the
  candidates, as its grid calls it).
- ``ALSAlgorithm.grid_train`` declines what the JAX package declines,
  and a per-candidate list of the wrong length raises ValueError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_torch.data.bimap import BiMap
from predictionio_torch.models.als import (ALSAlgorithm, ALSModel, ALSParams,
                                           PreparedRatings)
from predictionio_torch.ops import als
from predictionio_torch.parallel.context import DeviceContext

torch.set_num_threads(2)


def _ratings(n_users=300, n_items=200, nnz=6000, seed=0):
    """Planted rank-4 half-star ratings over Zipf-popular items; the last
    20 users and 10 items rate nothing."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users - 20, nnz)
    i = rng.zipf(1.3, nnz) % (n_items - 10)
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
    r = 3.0 + np.einsum("nk,nk->n", U[u], V[i]) / 2.0 + rng.normal(0, .3, nnz)
    r = np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0)
    return u, i, r.astype(np.float32)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


PRECISION = {
    "direct-f32": dict(solver="direct", compute_dtype="float32",
                       cg_dtype="float32"),
    "cg-f32": dict(compute_dtype="float32", cg_dtype="float32"),
    "cg-bf16": {},     # the defaults: jacobi CG, 6 steps, bf16
}
#: the candidates: three regs (candidate 4 repeats the first and stops
#: after 2 iterations of 4 CG steps), per-candidate alphas for the
#: implicit cases. Not chip_smoke.py's lambda 0.02: on data this small a
#: few-rating group's system is near singular there, and the CG/bf16
#: factors of the JAX grid and the port's move apart further than 3x the
#: JAX grid's own nudge spread; the chip run holds lambda 0.02 by
#: held-out RMSE at MovieLens-20M width.
GRID = dict(regs=[0.05, 0.1, 0.2, 0.05], alphas=[0.5, 0.5, 0.3, 0.5],
            iterations=[3, 3, 3, 2], cg_iters=[6, 6, 6, 4])
#: CG in f32 with budgets long enough to converge
GRID_F32 = {"direct-f32": GRID,
            "cg-f32": dict(GRID, cg_iters=[32, 32, 32, 24])}


def _jax_grid(train, n_users, n_items, kw, monkeypatch, nudge=0.0, seed=0,
              grid=GRID, start=None):
    """JAX ``als_grid_train``; returns its factors and the initial
    (X, Y) it drew, its user draw nudged by ``nudge`` relative, or the
    given ``start`` instead of its draw."""
    drawn = []
    real = jax_als._init_factors

    def init(key, n_groups, n_real, rank, grid=None):
        out = real(key, n_groups, n_real, rank, grid=grid)
        if start is not None:
            out = jnp.asarray(start[len(drawn)])
        elif not drawn and nudge:
            noise = np.random.default_rng(seed).normal(size=out.shape)
            out = jnp.asarray((np.asarray(out) * (1.0 + nudge * noise)
                               ).astype(np.float32))
        drawn.append(np.array(out))
        return out

    with monkeypatch.context() as m:
        m.setattr(jax_als, "_init_factors", init)
        factors = jax_als.als_grid_train(train, n_users, n_items,
                                         jax_als.ALSConfig(**kw), **grid)
    return factors, drawn


@pytest.mark.parametrize("precision", ["direct-f32", "cg-f32"])
@pytest.mark.parametrize("implicit", [False, True])
def test_grid_alternation_matches_jax(implicit, precision, monkeypatch):
    """One alternation of every candidate from the same factors; the
    last candidate's iteration budget is 0, so it stays at its start
    in both packages."""
    n_users, n_items = 300, 200
    train = _ratings(n_users, n_items)
    kw = dict(rank=8, iterations=1, reg=0.05, implicit=implicit, alpha=0.5,
              block_size=64, seg_len=16, **PRECISION[precision])
    grid = dict(GRID_F32[precision], iterations=[1, 1, 1, 0])
    trainer = als.ALSGridTrainer(train, n_users, n_items,
                                 als.ALSConfig(**kw), device="cpu", **grid)
    rng = np.random.default_rng(7)
    X0, Y0 = (np.where(t.numpy() != 0.0,
                       rng.normal(scale=0.3, size=t.shape), 0.0)
              .astype(np.float32) for t in (trainer.X, trainer.Y))
    want, _ = _jax_grid(train, n_users, n_items, kw, monkeypatch,
                        grid=grid, start=(X0, Y0))
    trainer.X, trainer.Y = torch.tensor(X0), torch.tensor(Y0)
    got = trainer.run()
    for a, b in zip(got, want):
        for x, y in ((a.user_factors, b.user_factors),
                     (a.item_factors, b.item_factors)):
            np.testing.assert_allclose(x, y, rtol=1e-4,
                                       atol=1e-5 * np.abs(y).max())
    np.testing.assert_array_equal(got[3].user_factors, X0[3, :n_users])


@pytest.mark.parametrize("precision", sorted(PRECISION))
@pytest.mark.parametrize("implicit", [False, True])
def test_grid_matches_jax_from_its_initial_draw(implicit, precision,
                                                monkeypatch):
    n_users, n_items = 300, 200
    train = _ratings(n_users, n_items)
    kw = dict(rank=8, iterations=3, reg=0.05, implicit=implicit, alpha=0.5,
              block_size=64, seg_len=16, **PRECISION[precision])
    grid = GRID_F32.get(precision, GRID)
    want, (X0, Y0) = _jax_grid(train, n_users, n_items, kw, monkeypatch,
                               grid=grid)
    trainer = als.ALSGridTrainer(train, n_users, n_items,
                                 als.ALSConfig(**kw), device="cpu", **grid)
    user, item = trainer.sides()
    assert user.idx.shape[0] // user.step.row_block >= 2
    assert user.n_groups // user.step.group_block >= 2
    assert trainer.X.shape == X0.shape == (4, user.n_groups, 8)
    trainer.X, trainer.Y = torch.tensor(X0), torch.tensor(Y0)
    got = trainer.run()
    assert len(got) == len(want) == 4
    tol = {"user_factors": [1e-4] * 4, "item_factors": [1e-4] * 4}
    if precision == "cg-bf16":
        spread = [_jax_grid(train, n_users, n_items, kw, monkeypatch,
                            nudge=1e-6, seed=s)[0] for s in range(3)]
        tol = {k: [3 * max(_rel(getattr(f[g], k), getattr(want[g], k))
                           for f in spread) for g in range(4)]
               for k in tol}
    for g, (a, b) in enumerate(zip(got, want)):
        assert np.all(a.user_factors[-20:] == 0.0)
        assert np.all(a.item_factors[-10:] == 0.0)
        for k in tol:
            assert _rel(getattr(a, k), getattr(b, k)) <= tol[k][g], (g, k)


@pytest.mark.parametrize("precision", ["direct-f32", "cg-bf16"])
@pytest.mark.parametrize("implicit", [False, True])
def test_budget_freeze_matches_sequential_trains(implicit, precision):
    """Each candidate ends where a sequential port train with its own
    reg, alpha, iterations and CG steps ends, from the same seed: the
    grid's initial factors are the sequential trainer's draw, tiled."""
    n_users, n_items = 300, 200
    train = _ratings(n_users, n_items, seed=3)
    cfg = als.ALSConfig(rank=8, iterations=3, reg=0.05, implicit=implicit,
                        alpha=0.5, block_size=64, seg_len=16,
                        **PRECISION[precision])
    grid = als.ALSGridTrainer(train, n_users, n_items, cfg, device="cpu",
                              **GRID)
    seq0 = als.ALSTrainer(train, n_users, n_items, cfg, device="cpu")
    for g in range(4):
        assert torch.equal(grid.X[g], seq0.X) and torch.equal(grid.Y[g],
                                                              seq0.Y)
    got = grid.run()
    for g in range(4):
        seq = als.als_train(train, n_users, n_items, dataclasses.replace(
            cfg, reg=GRID["regs"][g], alpha=GRID["alphas"][g],
            iterations=GRID["iterations"][g], cg_iters=GRID["cg_iters"][g]),
            device="cpu")
        for x, y in ((got[g].user_factors, seq.user_factors),
                     (got[g].item_factors, seq.item_factors)):
            np.testing.assert_allclose(x, y, rtol=1e-5,
                                       atol=1e-6 * np.abs(y).max())
    # the frozen candidate did stop: one more alternation would move it
    longer = als.als_train(train, n_users, n_items, dataclasses.replace(
        cfg, iterations=3, cg_iters=4), device="cpu")
    assert _rel(got[3].user_factors, longer.user_factors) > 1e-3


def test_batched_cg_active_steps_matches_jax():
    """4 candidates' systems in one batch, each candidate with its own
    step budget: the port's ``active_steps`` per system against JAX's
    ``_batched_cg`` vmapped over the candidates (one budget each)."""
    rng = np.random.default_rng(2)
    G, B, K = 4, 8, 6
    M = rng.normal(size=(G, B, K, K))
    scale = 10.0 ** rng.uniform(-1, 3, size=(G, B, 1, 1))
    A = ((M @ M.transpose(0, 1, 3, 2) + K * np.eye(K)) * scale).astype(
        np.float32)
    b = rng.normal(size=(G, B, K)).astype(np.float32)
    x0 = rng.normal(size=(G, B, K)).astype(np.float32)
    budgets = np.array([5, 2, 0, 4], np.int32)
    for precond in ("jacobi", "none"):
        for dtype in ("float32", "bfloat16"):
            want = np.asarray(jax.vmap(
                lambda A_, b_, x_, k_: jax_als._batched_cg(
                    A_, b_, 5, x0=x_, matvec_dtype=jnp.dtype(dtype),
                    precond=precond, active_steps=k_))(
                jnp.asarray(A), jnp.asarray(b), jnp.asarray(x0),
                jnp.asarray(budgets)))
            got = als._batched_cg(
                torch.from_numpy(A).reshape(G * B, K, K),
                torch.from_numpy(b).reshape(G * B, K), 5,
                x0=torch.from_numpy(x0).reshape(G * B, K),
                matvec_dtype=als._dtype(dtype), precond=precond,
                active_steps=torch.from_numpy(budgets).repeat_interleave(B)
            ).numpy().reshape(G, B, K)
            assert _rel(got, want) <= (1e-5 if dtype == "float32" else 1e-2)
            # a system with budget k ends where a k-step solve ends
            for g, k in enumerate(budgets):
                alone = als._batched_cg(
                    torch.from_numpy(A[g]), torch.from_numpy(b[g]), int(k),
                    x0=torch.from_numpy(x0[g]),
                    matvec_dtype=als._dtype(dtype), precond=precond).numpy()
                np.testing.assert_array_equal(got[g], alone)


def test_per_candidate_lists_must_match_regs():
    train = _ratings(60, 40, 600)
    cfg = als.ALSConfig(rank=4, iterations=2, block_size=64)
    for key in ("alphas", "iterations", "cg_iters"):
        with pytest.raises(ValueError, match=f"`{key}` has 1 entries"):
            als.als_grid_train(train, 60, 40, cfg, regs=[0.1, 0.2],
                               device="cpu", **{key: [1]})


def test_grid_trainer_needs_the_card_unless_the_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train = _ratings(60, 40, 600)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        als.ALSGridTrainer(train, 60, 40, als.ALSConfig(rank=4), [0.1, 0.2])


# -- ALSAlgorithm.grid_train -------------------------------------------------------

def _prepared(n_users=120, n_items=80):
    u, i, r = _ratings(n_users, n_items, 2000, seed=5)
    return PreparedRatings(
        user_ids=BiMap.from_vocab([f"u{j}" for j in range(n_users)]),
        item_ids=BiMap.from_vocab([f"i{j}" for j in range(n_items)]),
        user_idx=u, item_idx=i, ratings=r)


BASE = ALSParams(rank=4, num_iterations=3, lambda_=0.1, block_size=32,
                 solver="direct", compute_dtype="float32", cg_dtype="float32")


def test_grid_train_models_equal_sequential_trains():
    ctx = DeviceContext("cpu")
    pd = _prepared()
    params = [BASE, dataclasses.replace(BASE, lambda_=0.5, num_iterations=2),
              dataclasses.replace(BASE, lambda_=0.02, cg_iters=3)]
    models = ALSAlgorithm.grid_train(ctx, pd, params)
    assert len(models) == 3 and all(isinstance(m, ALSModel) for m in models)
    for model, p in zip(models, params):
        assert model.device == torch.device("cpu")
        seq = ALSAlgorithm(p).train(ctx, pd)
        np.testing.assert_allclose(model.user_factors, seq.user_factors,
                                   rtol=1e-5,
                                   atol=1e-6 * np.abs(seq.user_factors).max())
        assert list(model.item_ids.keys()) == list(seq.item_ids.keys())
        got, want = model.recommend("u3", 5), seq.recommend("u3", 5)
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], rtol=1e-4)


@pytest.mark.parametrize("case", ["one", "rank", "seed", "capped",
                                  "binned", "other-params"])
def test_grid_train_declines_what_the_jax_package_declines(case):
    ctx = DeviceContext("cpu")
    pd = _prepared()
    other = dataclasses.replace(BASE, lambda_=0.5)
    params = [BASE, other]
    if case == "one":
        params = [BASE]
    elif case == "rank":
        params = [BASE, dataclasses.replace(other, rank=8)]
    elif case == "seed":
        params = [BASE, dataclasses.replace(other, seed=4)]
    elif case == "capped":
        params = [dataclasses.replace(p, max_ratings_per_user=5)
                  for p in params]
    elif case == "binned":
        pd = PreparedRatings(binned_request=object())
    else:
        params = [BASE, object()]
    assert ALSAlgorithm.grid_train(ctx, pd, params) is None
