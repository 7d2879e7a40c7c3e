"""The similar-product ``likealgo`` train of the port stays bounded, and
matches the JAX trainer that solves it in float32, on the CPU.

``LikeAlgorithm`` trains implicit ALS over like = +1 and dislike = -1
with the JAX package's confidence ``c = 1 + alpha * r`` (alpha 1), so a
dislike has confidence 0 and each system is ``Y^T Y`` less the disliked
rows' outer products. Where users dislike popular items those systems
are badly conditioned, and a CG matvec that reads A rounded to bf16 (the
config's ``cg_dtype``) makes them indefinite: the factors then grow
without bound over the 20 iterations. The port solves a train with a
confidence below 1 with a float32 matvec (``ops/als.py``
``matvec_dtype``); explicit trains and implicit trains over counts keep
their ``cg_dtype``.

The rows come from a seed with numpy, by the mechanism of the chip
check's data at a small size: planted rank-8 tastes over Zipf(2.2)
popular items, a like where the taste score clears 0.4 and a dislike
elsewhere. Nearly every user has a pair with the most popular item, and
about two thirds of them dislike it. Through ``LikeAlgorithm.train``
with a bf16 matvec, the largest |item factor| grew 38 to 9.5e5 times
past that of ``solver="direct"`` in 11 of seeds 0-11, and 1.5 times in
seed 1; the JAX trainer's bf16 train grew as far, or to NaN.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_torch.models._interactions import Interactions
from predictionio_torch.models.similarproduct import (LikeAlgorithm,
                                                      SimilarProductAlgorithm,
                                                      SimilarProductData,
                                                      SimilarProductParams)
from predictionio_torch.ops import als
from predictionio_torch.parallel.context import DeviceContext

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

torch.set_num_threads(2)

N_USERS, N_ITEMS, ROWS_PER_USER = 2000, 100, 4
#: how far the fixed train's largest |item factor| may sit from the
#: direct solve's (readings: 0.98-1.03 of it)
BOUND_FACTOR = 2.0


def _like_data(seed: int) -> SimilarProductData:
    """Like (+1) / dislike (-1) rows in event-time order (module
    docstring)."""
    rng = np.random.default_rng(seed)
    n = N_USERS * ROWS_PER_USER
    uu = rng.integers(0, N_USERS, size=n)
    ii = rng.zipf(2.2, size=n) % N_ITEMS
    U = rng.normal(size=(N_USERS, 8))
    V = rng.normal(size=(N_ITEMS, 8))
    z = (np.einsum("nk,nk->n", U[uu], V[ii]) / np.sqrt(8.0)
         + rng.normal(0, 0.3, n))
    users = [f"u{j}" for j in range(N_USERS)]
    items = [f"i{j}" for j in range(N_ITEMS)]
    likes = Interactions(entity_vocab=users, target_vocab=items,
                         entity_idx=uu, target_idx=ii,
                         values=np.where(z >= 0.4, 1.0, -1.0))
    return SimilarProductData(users=users, items=items, likes=likes)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_the_data_has_the_faults_mechanism():
    """Most users hold a pair with the most popular item, and most of
    those pairs are dislikes."""
    algo = LikeAlgorithm(SimilarProductParams())
    _, item_ids, (u, i, r) = algo.training_coo(_like_data(0))
    top = np.bincount(i, minlength=N_ITEMS).argmax()
    assert item_ids.inverse()[int(top)] == "i1"
    assert len(np.unique(u[i == top])) >= 0.9 * N_USERS
    assert (r[i == top] < 0).mean() >= 0.5


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_like_factors_stay_bounded_where_users_dislike_popular_items(seed):
    """``LikeAlgorithm.train`` as a user runs it (the default params:
    rank 10, 20 iterations, Jacobi CG of 6 steps, bf16 in its config)
    gives finite item factors whose largest |value| is within
    ``BOUND_FACTOR`` of the same config solved with ``solver="direct"``.
    A bf16 matvec's grew past it by orders of magnitude."""
    pd = _like_data(seed)
    algo = LikeAlgorithm(SimilarProductParams())
    model = algo.train(DeviceContext("cpu"), pd)
    user_ids, item_ids, coo = algo.training_coo(pd)
    cfg = algo.als_config(algo.params)
    assert cfg.cg_dtype == "bfloat16"
    direct = als.ALSTrainer(coo, len(user_ids), len(item_ids),
                            dataclasses.replace(cfg, solver="direct"),
                            device="cpu").run()
    assert np.isfinite(model.item_factors).all()
    want = float(np.abs(direct.item_factors).max())
    assert 0.0 < float(np.abs(model.item_factors).max()) <= (
        BOUND_FACTOR * want)


def _jax_nudge_spread(coo, n_users, n_items, cfg, X0, Y0, base) -> float:
    """How far the JAX trainer's item factors move from ``base`` when
    its initial user factors are nudged by 1e-6 relative: the largest
    relative Frobenius error over three nudges."""
    spread = 0.0
    for seed in range(3):
        ref = jax_als.ALSTrainer(coo, n_users, n_items, cfg)
        noise = np.random.default_rng(seed).normal(size=X0.shape)
        ref._X = jnp.asarray((X0 * (1.0 + 1e-6 * noise)).astype(np.float32))
        ref._Y = jnp.asarray(Y0)
        spread = max(spread, _rel(ref.run().item_factors, base))
    return spread


def test_like_algorithm_train_matches_the_jax_float32_trainer(monkeypatch):
    """The port's ``LikeAlgorithm.train`` against the JAX ``ALSTrainer``
    built with the same ``ALSConfig`` but ``cg_dtype="float32"``, over
    the same COO and from the JAX trainer's initial factors (the random
    streams differ: the port's start is replaced by JAX's). A 6-step CG
    stops short of convergence, so 20 iterations from one start drift
    apart by a few percent in either package: the JAX trainer moves
    1.3-2.4% from itself under a 1e-6 nudge of its start, and the port
    sits 1.5-2.4% from it (readings on seeds 0-2). So the port's item
    factors must be within 3x that spread (measured here) of the JAX
    trainer's, and both stay finite and bounded."""
    pd = _like_data(1)
    algo = LikeAlgorithm(SimilarProductParams())
    user_ids, item_ids, coo = algo.training_coo(pd)
    n_users, n_items = len(user_ids), len(item_ids)
    jcfg = jax_als.ALSConfig(**{**dataclasses.asdict(algo.als_config(
        algo.params)), "cg_dtype": "float32"})
    ref = jax_als.ALSTrainer(coo, n_users, n_items, jcfg)
    X0, Y0 = np.array(ref._X), np.array(ref._Y)
    starts = iter((X0, Y0))

    def jax_start(gen, n_groups, n_real, rank):
        table = next(starts)
        assert table.shape == (n_groups, rank)
        return torch.tensor(table)

    monkeypatch.setattr(als, "_init_factors", jax_start)
    model = algo.train(DeviceContext("cpu"), pd)
    want = ref.run().item_factors
    spread = _jax_nudge_spread(coo, n_users, n_items, jcfg, X0, Y0, want)
    assert np.isfinite(want).all() and np.isfinite(model.item_factors).all()
    assert _rel(model.item_factors, want) <= 3 * spread


def _side(vals):
    """One side's compressed layout over a 4 x 3 COO holding ``vals``."""
    u = np.arange(len(vals)) % 4
    i = np.arange(len(vals)) % 3
    return als.build_compressed_side(u, i, np.asarray(vals, np.float32), 4,
                                     als.ALSConfig(block_size=8), 1, None)


@pytest.mark.parametrize("vals,rng,coded", [
    ([1.0, -1.0, 1.0, -1.0, 1.0], (-1.0, 1.0), True),   # likes
    ([1.0, 2.0, 3.0, 4.0], (1.0, 4.0), True),           # counts
    ([1.0, 2.0, 3.0, 7.0], (1.0, 7.0), False),          # no ladder
    ([0.25, -1.5, 3.1, 2.0, 0.7, 9.9], (-1.5, 9.9), False),
])
def test_value_range_reads_the_real_values_of_either_layout(vals, rng,
                                                            coded):
    side = _side(vals)
    assert (side.affine is not None) == coded
    assert side.value_range() == pytest.approx(rng)


@pytest.mark.parametrize("implicit,alpha,lo,hi,alphas,want", [
    (False, 1.0, -1.0, 1.0, None, "bfloat16"),   # explicit: the config's
    (True, 1.0, 1.0, 40.0, None, "bfloat16"),    # view counts: c >= 1
    (True, 1.0, -1.0, 1.0, None, "float32"),     # likes: c = 0
    (True, 0.0, -1.0, 1.0, None, "bfloat16"),    # alpha 0: c = 1
    (True, -0.5, 1.0, 3.0, None, "float32"),     # negative alpha
    (True, 1.0, -1.0, 1.0, [0.0, 0.0], "bfloat16"),
    (True, 1.0, -1.0, 1.0, [0.0, 2.0], "float32"),  # one grid candidate
])
def test_matvec_dtype_is_float32_only_below_confidence_one(
        implicit, alpha, lo, hi, alphas, want):
    cfg = als.ALSConfig(implicit=implicit, alpha=alpha)
    assert als.matvec_dtype(cfg, lo, hi, alphas) == want


def test_the_trainers_pick_the_matvec_from_the_data():
    """A single train and a grid over like/dislike values solve in
    float32; over view counts and explicit ratings they keep the
    config's bf16, and their work model counts bf16 re-reads of A."""
    pd = _like_data(2)
    like = LikeAlgorithm(SimilarProductParams())
    _, _, likes = like.training_coo(pd)
    cfg = like.als_config(like.params)
    u, i, r = likes
    counts = (u, i, np.abs(r) + 1.0)
    for coo, implicit, want in ((likes, True, "float32"),
                                (counts, True, "bfloat16"),
                                (likes, False, "bfloat16")):
        c = dataclasses.replace(cfg, implicit=implicit, iterations=1)
        trainer = als.ALSTrainer(coo, N_USERS, N_ITEMS, c, device="cpu")
        grid = als.ALSGridTrainer(coo, N_USERS, N_ITEMS, c, [0.01, 0.1],
                                  device="cpu")
        assert (trainer.cg_dtype, grid.cg_dtype) == (want, want)
        assert trainer.sides()[0].step.cg_dtype == als._dtype(want)
        assert grid.sides()[1].step.cg_dtype == als._dtype(want)
    # the count-based similar-product train keeps its config's dtype
    assert SimilarProductAlgorithm.als_config(
        SimilarProductParams()).cg_dtype == "bfloat16"
