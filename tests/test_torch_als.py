"""ALS training of the port against the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through both packages.

- One half-step from the same ``(Y, X_prev)``: the port's
  ``make_half_step`` against JAX ``make_half_step(None, ...)``, explicit
  and implicit, compressed (uint8 codes) and uncompressed (f32 + mask),
  with two or more row blocks and group blocks on each side. With
  ``solver="direct"`` and f32 compute and CG dtypes the two agree to
  rtol 1e-4 (atol 1e-5 of the largest factor): the same arithmetic,
  summed in another order. The default CG in bf16 agrees to a relative
  Frobenius error of 1e-2: bf16 rounds the same values, but a product
  rounded differently in one CG step moves the rest. Groups with no
  ratings are exactly 0.
- The trainer, 3 iterations from the JAX trainer's initial factors:
  factors and held-out RMSE, direct/f32 to a relative Frobenius error
  of 1e-4 (RMSE to 1e-5); CG/bf16 within 3x the spread the JAX trainer
  shows against itself under a 1e-6 nudge of its start, RMSE to 1e-2
  (the test's docstring says why CG/bf16 is that sensitive). CG/bf16 is
  also held to a fixed 2e-3 one alternation at a time, each from the
  JAX trainer's current factors.
- The recommendation engine trained through the port's workflow on a
  memory store: its held-out RMSE within 0.02 of the JAX engine's on
  the same events (the two start from different random factors:
  ``jax.random`` and ``torch.Generator`` streams differ), and every
  answer equal to a float64 top-k of the port's own factors.
"""

import datetime as dt
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine)
from predictionio_tpu.workflow.deploy import (
    prepare_deploy as jax_prepare_deploy)
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.models.als import ALSModel
from predictionio_torch.ops import als
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates.recommendation import recommendation_engine
from predictionio_torch.tools import cli
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.train import run_train

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

UTC = dt.timezone.utc
RECO_FACTORY = "predictionio_torch.templates.recommendation.recommendation_engine"


def _ratings(n_users=300, n_items=200, nnz=6000, seed=0, halfstar=True):
    """Planted rank-4 ratings over Zipf-popular items: half-stars in
    0.5..5.0 (an affine ladder, so the layout is coded) or uniform reals
    (f32 + mask)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.zipf(1.3, nnz) % n_items
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
    r = 3.0 + np.einsum("nk,nk->n", U[u], V[i]) / 2.0 + rng.normal(0, .3, nnz)
    if halfstar:
        r = np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0)
    else:
        r = np.clip(r, 0.5, 5.0) + rng.uniform(0, 1e-3, nnz)
    return u, i, r.astype(np.float32)


def _wire_idx(side) -> np.ndarray:
    idx = side.idx_lo.astype(np.int32)
    if side.idx_hi is not None:
        idx |= side.idx_hi.astype(np.int32) << 16
    return idx


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


PRECISION = {
    "direct-f32": dict(solver="direct", compute_dtype="float32",
                       cg_dtype="float32"),
    "cg-bf16": {},     # the defaults: jacobi CG, 6 steps, bf16
}


# -- one half-step ---------------------------------------------------------------

@pytest.mark.parametrize("precision", sorted(PRECISION))
@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("implicit", [False, True])
def test_half_step_matches_jax(implicit, compressed, precision):
    n_users, n_items = 300, 200
    u, i, r = _ratings(n_users, n_items, halfstar=compressed)
    u = u % (n_users - 40)                # the last 40 users rate nothing
    kw = dict(rank=8, reg=0.1, implicit=implicit, alpha=0.5, block_size=64,
              seg_len=16, **PRECISION[precision])
    side = als.build_compressed_side(u, i, r, n_users, als.ALSConfig(**kw),
                                     1, None)
    assert (side.affine is not None) == compressed
    G = side.groups_per_shard
    assert G // side.group_block >= 2
    assert side.idx_lo.shape[0] // side.row_block >= 2

    rng = np.random.default_rng(1)
    Y = np.zeros((208, 8), np.float32)              # item side, padded
    Y[:n_items] = 0.3 * rng.normal(size=(n_items, 8))
    X_prev = (0.3 * rng.normal(size=(G, 8))).astype(np.float32)
    idx = _wire_idx(side)
    data = ((idx, side.val, side.seg, side.counts) if compressed
            else (idx, side.val, side.mask, side.seg, side.counts))

    want = np.asarray(jax_als.make_half_step(
        None, jax_als.ALSConfig(**kw), side.row_block, side.group_block, G,
        val_affine=side.affine)(jnp.asarray(Y), jnp.asarray(X_prev), *data))
    got = als.make_half_step(
        als.ALSConfig(**kw), side.row_block, side.group_block, G,
        val_affine=side.affine)(
        torch.from_numpy(Y), torch.from_numpy(X_prev),
        *(torch.from_numpy(a) for a in data)).numpy()

    assert got.shape == want.shape == (G, 8)
    assert np.all(got[side.counts == 0] == 0.0)
    assert np.all(np.isfinite(got))
    if precision == "direct-f32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert _rel(got, want) <= 1e-2


def test_batched_cg_matches_jax_with_and_without_jacobi():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(16, 6, 6))
    scale = 10.0 ** rng.uniform(-1, 3, size=(16, 1, 1))   # ALS-WR spread
    A = (M @ M.transpose(0, 2, 1) + 6 * np.eye(6)) * scale
    b = rng.normal(size=(16, 6))
    x0 = rng.normal(size=(16, 6))
    A, b, x0 = (a.astype(np.float32) for a in (A, b, x0))
    for precond in ("jacobi", "none"):
        for dtype in ("float32", "bfloat16"):
            want = np.asarray(jax_als._batched_cg(
                jnp.asarray(A), jnp.asarray(b), 4, x0=jnp.asarray(x0),
                matvec_dtype=jnp.dtype(dtype), precond=precond))
            got = als._batched_cg(
                torch.from_numpy(A), torch.from_numpy(b), 4,
                x0=torch.from_numpy(x0), matvec_dtype=als._dtype(dtype),
                precond=precond).numpy()
            assert _rel(got, want) <= (1e-5 if dtype == "float32" else 1e-2)


def test_unknown_cg_precond_raises():
    A = torch.eye(3).repeat(2, 1, 1)
    with pytest.raises(ValueError, match="cg_precond"):
        als._batched_cg(A, torch.ones(2, 3), 2, precond="jacobbi")
    u, i, r = _ratings(40, 30, 300)
    trainer = als.ALSTrainer((u, i, r), 40, 30, als.ALSConfig(
        rank=4, iterations=1, cg_precond="jacobbi"), device="cpu")
    with pytest.raises(ValueError, match="cg_precond"):
        trainer.run()


def test_unknown_dtype_and_solver_raise():
    with pytest.raises(ValueError, match="dtype"):
        als.make_half_step(als.ALSConfig(compute_dtype="int8"), 8, 8, 8)
    u, i, r = _ratings(40, 30, 300)
    trainer = als.ALSTrainer((u, i, r), 40, 30, als.ALSConfig(
        rank=4, iterations=1, solver="lu"), device="cpu")
    with pytest.raises(ValueError, match="solver"):
        trainer.run()


def test_cache_key_raises_naming_its_roadmap_item(tmp_path, monkeypatch):
    """The layout cache on the COO path: with no entry and no COO the
    trainer raises LayoutCacheMiss; a COO train saves the layout, and a
    trainer made from the key alone loads it and trains to the same
    factors."""
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    u, i, r = _ratings(40, 30, 300)
    cfg = als.ALSConfig(rank=4, iterations=2, solver="direct",
                        compute_dtype="float32", cg_dtype="float32")
    with pytest.raises(als.LayoutCacheMiss):
        als.ALSTrainer(None, None, None, cfg, device="cpu",
                       cache_key="fingerprint")
    cold = als.ALSTrainer((u, i, r), 40, 30, cfg, device="cpu",
                          cache_key="fingerprint")
    assert not cold.cache_hit
    warm = als.ALSTrainer(None, None, None, cfg, device="cpu",
                          cache_key="fingerprint")
    assert warm.cache_hit and (warm.n_users, warm.n_items) == (40, 30)
    a, b = cold.run(), warm.run()
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.item_factors, b.item_factors)
    again = als.als_train((u, i, r), 40, 30, cfg, device="cpu",
                          cache_key="fingerprint")
    np.testing.assert_array_equal(a.item_factors, again.item_factors)


def test_trainer_without_cuda_raises_unless_the_cpu_is_asked_for(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u, i, r = _ratings(40, 30, 300)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        als.ALSTrainer((u, i, r), 40, 30, als.ALSConfig(rank=4))
    assert als.ALSTrainer((u, i, r), 40, 30, als.ALSConfig(rank=4),
                          device="cpu").device.type == "cpu"


# -- the trainer -----------------------------------------------------------------

def _spread(train, n_users, n_items, kw, max_len, X0, Y0):
    """How far the JAX trainer moves from itself when its initial user
    factors are nudged by 1e-6 relative: the largest (user, item)
    relative errors over three nudges."""
    def run(nudge, seed):
        ref = jax_als.ALSTrainer(train, n_users, n_items,
                                 jax_als.ALSConfig(**kw),
                                 max_ratings_per_user=max_len,
                                 max_ratings_per_item=max_len)
        noise = np.random.default_rng(seed).normal(size=X0.shape)
        ref._X = jnp.asarray((X0 * (1.0 + nudge * noise)).astype(np.float32))
        ref._Y = jnp.asarray(Y0)
        return ref.run()

    base = run(0.0, 0)
    nudged = [run(1e-6, seed) for seed in range(3)]
    return (max(_rel(f.user_factors, base.user_factors) for f in nudged),
            max(_rel(f.item_factors, base.item_factors) for f in nudged))


@pytest.mark.parametrize("implicit,precision,max_len,n_items", [
    (False, "direct-f32", None, 200),
    (False, "cg-bf16", None, 200),
    (True, "cg-bf16", 25, 200),
    (False, "cg-bf16", None, 70_000),     # item ids past 2^16: idx_hi
])
def test_trainer_matches_jax_from_its_initial_factors(implicit, precision,
                                                      max_len, n_items):
    """Direct/f32: factors to a relative Frobenius error of 1e-4, RMSE to
    1e-5. CG/bf16: the 6-step CG stops short of convergence on groups
    of a few ratings at rank 8, and there a bf16 rounding that flips in
    one step moves the iterate far: the JAX trainer moves 2.3-2.6% (user
    factors) and 6.9-30% (item factors) from itself after 3 iterations
    when its initial user factors are nudged by 1e-6, and the port sits
    1.4-2.4% and 5.4-28% from it (the first two cases, measured). More CG steps do not close this: at
    16 to 48 steps the spread stays or grows. So the port's factors must
    stay within 3x that spread (the largest of three nudges, measured
    here) of the JAX trainer's, and its held-out RMSE within 1e-2 of
    theirs: five such nudges moved the JAX trainer's own RMSE by up to
    7.8e-3. The next test holds the same path to a fixed bound, one
    alternation at a time."""
    n_users = 300
    u, i, r = _ratings(n_users, 200, 7000, seed=4)
    i = (i * 337) % n_items                 # spread ids over the vocabulary
    hold = np.arange(len(r)) % 20 == 0
    train = (u[~hold], i[~hold], r[~hold])
    held = (u[hold], i[hold], r[hold])
    kw = dict(rank=8, iterations=3, reg=0.05, implicit=implicit, alpha=0.5,
              block_size=64, **PRECISION[precision])
    ref = jax_als.ALSTrainer(train, n_users, n_items,
                             jax_als.ALSConfig(**kw),
                             max_ratings_per_user=max_len,
                             max_ratings_per_item=max_len)
    trainer = als.ALSTrainer(train, n_users, n_items, als.ALSConfig(**kw),
                             device="cpu", max_ratings_per_user=max_len,
                             max_ratings_per_item=max_len)
    # the same layout went to both devices, the indexes recombined
    user, item = trainer.sides()
    assert user.idx.dtype == torch.int32
    np.testing.assert_array_equal(user.idx.numpy(), np.asarray(ref._ud[0]))
    np.testing.assert_array_equal(item.idx.numpy(), np.asarray(ref._it[0]))
    assert trainer.transfer_bytes == ref.transfer_bytes
    assert trainer.work_model() == ref.work_model()
    # start from the reference trainer's factors (jax.random and
    # torch.Generator streams differ)
    X0, Y0 = np.array(ref._X), np.array(ref._Y)
    trainer.X, trainer.Y = torch.tensor(X0), torch.tensor(Y0)
    want = ref.run()
    got = trainer.compile().run()
    if precision == "direct-f32":
        tol_u = tol_i = 1e-4
        tol_rmse = 1e-5
    else:
        spread_u, spread_i = _spread(train, n_users, n_items, kw, max_len,
                                     X0, Y0)
        tol_u, tol_i = 3 * spread_u, 3 * spread_i
        tol_rmse = 1e-2
    assert _rel(got.user_factors, want.user_factors) <= tol_u
    assert _rel(got.item_factors, want.item_factors) <= tol_i
    assert abs(als.predict_rmse(got, held)
               - jax_als.predict_rmse(want, held)) <= tol_rmse


@pytest.mark.parametrize("implicit,max_len,n_items", [
    (False, None, 200),
    (True, 25, 200),
    (False, None, 70_000),                # item ids past 2^16: idx_hi
])
def test_trainer_cg_bf16_matches_jax_one_alternation_at_a_time(
        implicit, max_len, n_items):
    """The default precision (Jacobi CG, 6 steps, bf16) held to a fixed
    bound: at each of 3 iterations the port's trainer starts from the
    JAX trainer's current factors. One ``step_n(1)`` gives user factors
    within a relative Frobenius error of 2e-3 of the JAX alternation's,
    and the item side, called on the JAX trainer's new user factors,
    gives item factors within 2e-3 of the JAX item factors (readings on
    this data: 4.4e-4 and 3.8e-4 at most). Left to run on, the two
    trajectories drift apart (the test above); from one start they do
    not. The alternation's item half-step is the item side called on its
    own user factors, bit for bit."""
    n_users = 300
    u, i, r = _ratings(n_users, 200, 7000, seed=4)
    i = (i * 337) % n_items
    train = tuple(a[np.arange(len(r)) % 20 != 0] for a in (u, i, r))
    kw = dict(rank=8, iterations=3, reg=0.05, implicit=implicit, alpha=0.5,
              block_size=64)
    ref = jax_als.ALSTrainer(train, n_users, n_items,
                             jax_als.ALSConfig(**kw),
                             max_ratings_per_user=max_len,
                             max_ratings_per_item=max_len)
    trainer = als.ALSTrainer(train, n_users, n_items, als.ALSConfig(**kw),
                             device="cpu", max_ratings_per_user=max_len,
                             max_ratings_per_item=max_len)
    _, item = trainer.sides()
    for _ in range(3):
        Y_prev = torch.tensor(np.array(ref._Y))
        trainer.X, trainer.Y = torch.tensor(np.array(ref._X)), Y_prev
        ref.step_n(1)
        trainer.step_n(1)
        X_ref, Y_ref = np.array(ref._X), np.array(ref._Y)
        assert _rel(trainer.X.numpy(), X_ref) <= 2e-3
        assert torch.equal(trainer.Y, item(trainer.X, Y_prev))
        assert _rel(item(torch.tensor(X_ref), Y_prev).numpy(), Y_ref) <= 2e-3


def test_trainer_learns_and_keeps_unrated_rows_zero():
    u, i, r = _ratings(200, 150, 5000, seed=6)
    i = i % 140                             # items 140..149 rated by none
    hold = np.arange(len(r)) % 20 == 0
    cfg = als.ALSConfig(rank=6, iterations=8, reg=0.05, block_size=64)
    trainer = als.ALSTrainer((u[~hold], i[~hold], r[~hold]), 200, 150, cfg,
                             device="cpu")
    before = als.predict_rmse(trainer.factors(), (u[hold], i[hold], r[hold]))
    factors = trainer.compile().run()
    after = als.predict_rmse(factors, (u[hold], i[hold], r[hold]))
    assert after < 0.6 < before
    unrated = np.setdiff1d(np.arange(150), i[~hold])
    assert len(unrated) and np.all(factors.item_factors[unrated] == 0.0)
    assert factors.user_factors.shape == (200, 6)


# -- the engine ------------------------------------------------------------------

def _events(event_cls, n_users=120, n_items=80, nnz=3000, seed=8):
    """Rate events from planted ratings; every 20th held out, as
    (user id, item id, rating)."""
    u, i, r = _ratings(n_users, n_items, nnz, seed=seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    events, held = [], []
    for j, (uu, ii, rr) in enumerate(zip(u, i, r)):
        if j % 20 == 0:
            held.append((f"u{uu}", f"i{ii}", float(rr)))
            continue
        events.append(event_cls(
            event="rate", entity_type="user", entity_id=f"u{uu}",
            target_entity_type="item", target_entity_id=f"i{ii}",
            properties={"rating": float(rr)},
            event_time=t0 + dt.timedelta(seconds=j)))
    return events, held


ALS_PARAMS = {"rank": 8, "num_iterations": 10, "lambda_": 0.05,
              "block_size": 64}


def _variant(factory):
    return {"engineFactory": factory,
            "datasource": {"name": "", "params": {"app_name": "reco"}},
            "algorithms": [{"name": "als", "params": ALS_PARAMS}]}


def _held_rmse(model, held) -> float:
    pred = [float(model.user_factors[model.user_ids[uu]]
                  @ model.item_factors[model.item_ids[ii]])
            if uu in model.user_ids and ii in model.item_ids else 0.0
            for uu, ii, _ in held]
    return float(np.sqrt(np.mean((np.array(pred)
                                  - np.array([r for *_, r in held])) ** 2)))


def _check_against_float64_topk(deployment, model: ALSModel, queries):
    """Each answer: the float64 top-k of the model's own factors, under
    (score descending, item id ascending); ids may differ only where two
    scores are within the tolerance of the float32 product."""
    U = model.user_factors.astype(np.float64)
    V = model.item_factors.astype(np.float64)
    names = list(model.item_ids.keys())
    for q in queries:
        got = deployment.query(q)["itemScores"]
        if "user" in q:
            qvec = U[model.user_ids[q["user"]]]
            allowed = np.ones(len(V), bool)
            allowed[[model.item_ids[b] for b in q.get("blacklist", ())]] = (
                False)
        else:
            qvec = V[model.item_ids[q["item"]]]
            allowed = np.ones(len(V), bool)
            allowed[model.item_ids[q["item"]]] = False
        scores = V @ qvec
        cand = np.flatnonzero(allowed)
        order = cand[np.lexsort((cand, -scores[cand]))][:q["num"]]
        tol = 1e-5 * np.linalg.norm(qvec) * np.linalg.norm(V, axis=1).max()
        assert len(got) == len(order), q
        for slot, (entry, j) in enumerate(zip(got, order)):
            assert abs(entry["score"] - scores[j]) <= tol, (q, slot)
            assert (entry["item"] == names[j]
                    or abs(scores[model.item_ids[entry["item"]]]
                           - scores[j]) <= tol), (q, slot)


def test_engine_trains_on_the_port_like_the_jax_engine():
    events, held = _events(Event)
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    app = storage.apps().insert("reco")
    storage.events().init(app.id)
    storage.events().insert_batch(events, app.id)
    engine = recommendation_engine()
    ctx = DeviceContext("cpu")
    set_storage(storage)
    try:
        instance = run_train(engine, engine.engine_params_from_variant(
            _variant(RECO_FACTORY)), engine_id="reco", ctx=ctx,
            storage=storage)
        assert instance.status == "COMPLETED"
        deployment = prepare_deploy(engine, instance, ctx, storage)
    finally:
        set_storage(None)

    jax_events, _ = _events(JaxEvent)
    jax_storage = JaxStorage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    jax_app = jax_storage.apps().insert("reco")
    jax_storage.events().init(jax_app.id)
    jax_storage.events().insert_batch(jax_events, jax_app.id)
    jax_engine = jax_recommendation_engine()
    factory = "predictionio_tpu.templates.recommendation.recommendation_engine"
    jax_set_storage(jax_storage)
    try:
        jax_instance = jax_run_train(
            jax_engine, jax_engine.engine_params_from_variant(
                _variant(factory)), engine_id="reco",
            engine_factory=factory, storage=jax_storage, ctx=MeshContext())
        jax_model = jax_prepare_deploy(jax_engine, jax_instance,
                                       MeshContext(), jax_storage).models[0]
    finally:
        jax_set_storage(None)

    model = deployment.models[0]
    assert isinstance(model, ALSModel)
    assert list(model.user_ids.keys()) == list(jax_model.user_ids.keys())
    assert list(model.item_ids.keys()) == list(jax_model.item_ids.keys())
    rmse, rmse_jax = _held_rmse(model, held), _held_rmse(jax_model, held)
    assert rmse < 1.0
    assert abs(rmse - rmse_jax) <= 0.02, (rmse, rmse_jax)

    rng = np.random.default_rng(9)
    users = [f"u{j}" for j in rng.choice(120, 12, replace=False)
             if f"u{j}" in model.user_ids]
    items = [f"i{j}" for j in rng.choice(80, 6, replace=False)
             if f"i{j}" in model.item_ids]
    queries = [{"user": uu, "num": 10} for uu in users]
    queries += [{"item": ii, "num": 5} for ii in items]
    queries.append({"user": users[0], "num": 7, "blacklist": items[:3]})
    _check_against_float64_topk(deployment, model, queries)
    assert deployment.query({"user": "nobody", "num": 3}) == {
        "itemScores": []}


def test_cli_trains_and_deploys_the_recommendation_engine(tmp_path,
                                                          monkeypatch):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "store")}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    storage = Storage.from_env(env)
    app = storage.apps().insert("reco")
    storage.events().init(app.id)
    events, held = _events(Event, nnz=1500, seed=10)
    storage.events().insert_batch(events, app.id)
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({**_variant(RECO_FACTORY),
                                       "engineId": "reco-cli"}))
    set_storage(None)
    try:
        assert cli.main(["train", "--engine-json", str(engine_json),
                         "--device", "cpu"]) == 0
    finally:
        set_storage(None)
    storage = Storage.from_env(env)
    instance = storage.engine_instances().get_latest_completed(
        "reco-cli", "0", "default")
    assert instance is not None and instance.status == "COMPLETED"
    assert json.loads(instance.algorithms_params)[0]["params"]["rank"] == 8
    deployment = prepare_deploy(recommendation_engine(), instance,
                                DeviceContext("cpu"), storage)
    model = deployment.models[0]
    assert _held_rmse(model, held) < 1.2
    user = next(iter(model.user_ids.keys()))
    _check_against_float64_topk(deployment, model, [{"user": user,
                                                     "num": 5}])
