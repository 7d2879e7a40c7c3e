"""The port's top-k (predictionio_torch.ops) against the JAX package's.

Inputs are made from seeds with numpy and go through both packages:

  - ``topk_dot_reference`` (the CUDA kernel's plain version, which the
    wrapper runs for CPU tensors) against the Pallas ``topk_dot`` in
    interpret mode, on the kernel cases of tests/test_index.py plus
    exact ties and a whole tile excluded. Scores to rtol = atol = 1e-5
    (f32 on both sides, sums in another order); indices equal, except
    across exact ties, where the returned id's true score must match;
  - the port's ``TopKScorer`` against the JAX one on both routes over the
    edge cases of tests/test_topk_edges.py;
  - 66,000 items, so a winner id above 2^16 must survive.

The kernel itself runs only on a CUDA card: tests/test_torch_cuda.py
(``cuda`` marker) and ``chip_smoke.py`` hold it against the plain
version there.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas.topk_dot import topk_dot as jax_topk_dot
from predictionio_tpu.ops.topk import TopKScorer as JaxScorer
from predictionio_tpu.ops.topk import cosine_normalize as jax_cosine_normalize
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.ops.topk import (TopKScorer, cosine_normalize,
                                         ordered_topk)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(q, items, excl, k):
    s, i = tkd.topk_dot(torch.tensor(q), torch.tensor(items),
                        torch.tensor(excl, dtype=torch.int32), k)
    return s.numpy(), i.numpy()


def _assert_same_topk(q, items, s, i, js, ji):
    """Same scores; same ids except across exact ties, where the port's
    id must carry the slot's score."""
    np.testing.assert_allclose(s, js, **TOL)
    for b in range(len(q)):
        np.testing.assert_allclose(items[i[b]] @ q[b], s[b], **TOL)
        assert len(set(i[b].tolist())) == len(i[b])
    differ = i != ji
    if differ.any():
        true = np.take_along_axis(np.atleast_2d(q) @ items.T, i, axis=1)
        np.testing.assert_allclose(true[differ], js[differ], **TOL)


@pytest.mark.parametrize("I,D,B,k,E", [
    (1024, 16, 4, 8, 1),      # exact tile multiple (of the TPU tile)
    (1300, 16, 4, 8, 4),      # ragged last tile
    (700, 8, 1, 16, 2),
    (513, 32, 8, 8, 8),       # one full tile + a 1-row tail
])
def test_reference_matches_pallas(I, D, B, k, E):
    rng = np.random.default_rng(I + D)
    q = rng.normal(size=(B, D)).astype(np.float32)
    items = rng.normal(size=(I, D)).astype(np.float32)
    excl = np.full((B, E), -1, np.int32)
    excl[:, 0] = rng.integers(0, I, size=B)
    js, ji = jax_topk_dot(q, items, excl, k, interpret=True)
    s, i = _port(q, items, excl, k)
    _assert_same_topk(q, items, s, i, np.asarray(js), np.asarray(ji))
    assert np.array_equal(i, np.asarray(ji))   # no ties in random data


def test_reference_ties_resolve_to_lowest_id():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(600, 8)).astype(np.float32)
    items = np.vstack([base, base[:200]])   # 200 exact-tie pairs
    q = rng.normal(size=(3, 8)).astype(np.float32)
    excl = np.full((3, 1), -1, np.int32)
    js, ji = jax_topk_dot(q, items, excl, 16, interpret=True)
    s, i = _port(q, items, excl, 16)
    _assert_same_topk(q, items, s, i, np.asarray(js), np.asarray(ji))
    # the one total order: a tied pair comes lower id first
    for b in range(3):
        for j in range(15):
            if s[b, j] == s[b, j + 1]:
                assert i[b, j] < i[b, j + 1]


def test_reference_whole_tile_excluded():
    rng = np.random.default_rng(2)
    items = rng.normal(size=(1024, 8)).astype(np.float32)
    q = rng.normal(size=(1, 8)).astype(np.float32)
    top = np.argsort(-(items @ q[0]), kind="stable")[:16]
    excl = top[None, :].astype(np.int32)      # ban the true top-16
    js, ji = jax_topk_dot(q, items, excl, 8, interpret=True)
    s, i = _port(q, items, excl, 8)
    _assert_same_topk(q, items, s, i, np.asarray(js), np.asarray(ji))
    assert not set(i[0].tolist()) & set(top.tolist())


def test_winner_beyond_uint16():
    """66,000 items: the winning id must survive as an int32."""
    I, D = 66_000, 8
    rng = np.random.default_rng(0)
    items = 0.01 * rng.normal(size=(I, D)).astype(np.float32)
    q = rng.normal(size=(2, D)).astype(np.float32)
    winner = 65_777
    items[winner] = 100.0 * q[0] / np.linalg.norm(q[0])
    excl = np.full((2, 1), -1, np.int32)
    s, i = _port(q, items, excl, 8)
    js, ji = JaxScorer(items, placement="device").score(q, 8)
    assert int(i[0, 0]) == winner == int(ji[0, 0])
    _assert_same_topk(q, items, s, i, js, ji)


@pytest.mark.parametrize("bad", [
    dict(k=0), dict(k=200), dict(B=129), dict(E=65),
    dict(dtype=torch.float64), dict(excl_dtype=torch.int64),
])
def test_wrapper_rejects_shapes_outside_the_caps(bad):
    B, E = bad.get("B", 2), bad.get("E", 1)
    q = torch.zeros((B, 4), dtype=bad.get("dtype", torch.float32))
    items = torch.zeros((150, 4), dtype=torch.float32)
    excl = torch.full((B, E), -1, dtype=bad.get("excl_dtype", torch.int32))
    with pytest.raises((ValueError, TypeError)):
        tkd.topk_dot(q, items, excl, bad.get("k", 8))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = tkd.launches.value
    rng = np.random.default_rng(3)
    s, i = _port(rng.normal(size=(2, 4)).astype(np.float32),
                 rng.normal(size=(50, 4)).astype(np.float32),
                 np.full((2, 1), -1, np.int32), 8)
    assert s.shape == i.shape == (2, 8) and i.dtype == np.int32
    assert tkd.launches.value == before


@pytest.mark.parametrize("I,k", [(513, 8), (26_744, 16), (66_000, 128),
                                 (1, 1), (300, 5)])
def test_tile_plan_covers_the_table(I, k):
    k2, chunk, per_tile, n_tiles = tkd.plan_tiles(I, k)
    assert k2 >= k and k2 & (k2 - 1) == 0 and k2 + chunk == tkd.SLOTS
    assert n_tiles * k2 <= max(tkd.MAX_CANDIDATES, k2)
    n_chunks = -(-I // chunk)
    assert (n_tiles - 1) * per_tile < n_chunks <= n_tiles * per_tile


def test_ordered_topk_is_one_total_order():
    s = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, -2.0, -1e30, -1e30]])
    vals, idx = ordered_topk(s, 8)
    assert idx[0].tolist() == [1, 2, 0, 3, 4, 5, 6, 7]
    assert vals[0, 0] == 3.0 and vals[0, -1] == -1e30


# -- TopKScorer: both routes, the edge cases of tests/test_topk_edges.py ----

RNG = np.random.default_rng(7)
FACTORS = RNG.normal(size=(7, 4)).astype(np.float32)
USER = RNG.normal(size=(4,)).astype(np.float32)
USERS = RNG.normal(size=(5, 4)).astype(np.float32)


def _both(placement, factors=FACTORS, **kw):
    return (TopKScorer(factors, placement=placement, device="cpu", **kw),
            JaxScorer(factors, placement=placement, **kw))


def _same(port_out, jax_out):
    (s, i), (js, ji) = port_out, jax_out
    assert s.shape == np.asarray(js).shape and i.shape == np.asarray(ji).shape
    np.testing.assert_allclose(s, js, **TOL)
    assert np.array_equal(i, ji)


EDGE_CASES = {
    "k_beyond_n": lambda sc: sc.score(USER, 50),
    "k_zero": lambda sc: sc.score(USER, 0),
    "empty_batch": lambda sc: sc.score(np.zeros((0, 4), np.float32), 5),
    "batch_with_exclusions": lambda sc: sc.score(
        USERS, 4, np.array([[1, 4], [-1, -1], [0, 2], [6, -1], [3, 3]],
                           np.int32)),
    "out_of_range_excludes": lambda sc: sc.score(
        USER, 3, np.array([99, -5, -1], np.int32)),
    "excluded_fill_slots": lambda sc: sc.score(
        USER, 7, np.array([0, 1, 2], np.int32)),
    "masked": lambda sc: sc.score_masked(USER, 3, np.arange(7) == 2),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("placement", ["host", "device"])
def test_scorer_edges_match_jax(placement, case):
    port, jax_sc = _both(placement)
    _same(EDGE_CASES[case](port), EDGE_CASES[case](jax_sc))


@pytest.mark.parametrize("placement", ["host", "device"])
def test_scorer_long_exclude_drops_oldest_first(placement):
    port, jax_sc = _both(placement, max_exclude=2)
    excl = np.array([0, 1, 2, 3], np.int32)
    _same(port.score(USER, 7, excl), jax_sc.score(USER, 7, excl))


@pytest.mark.parametrize("placement", ["host", "device"])
@pytest.mark.parametrize("n", [0, 1])
def test_scorer_tiny_tables_match_jax(placement, n):
    port, jax_sc = _both(placement, factors=FACTORS[:n])
    _same(port.score(USER, 5), jax_sc.score(USER, 5))
    _same(port.score(USER, 5, np.array([0, 3], np.int32)),
          jax_sc.score(USER, 5, np.array([0, 3], np.int32)))


@pytest.mark.parametrize("placement", ["host", "device"])
def test_scorer_ties_rank_lowest_index_first(placement):
    dominant = (USER / np.linalg.norm(USER)).astype(np.float32)
    table = 0.01 * FACTORS
    table = np.vstack([table[:2], 5.0 * dominant[None, :], table[2:],
                       5.0 * dominant[None, :]])   # rows 2 and 8 tie on top
    port, jax_sc = _both(placement, factors=table)
    s, i = port.score(USER, 4)
    assert i[0, 0] == 2 and i[0, 1] == 8
    _same((s, i), jax_sc.score(USER, 4))


@pytest.mark.parametrize("env", ["host", "auto", "device"])
def test_scorer_on_a_card_never_takes_the_host_route(monkeypatch, env):
    """The placement choice exists on the CPU only. The scorer builds
    its device copy lazily, so this runs without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("PIO_SERVE_PLACEMENT", env)
    for placement in (None, "auto", "device"):
        scorer = TopKScorer(FACTORS, placement=placement, device="cuda:0")
        assert scorer.placement == "device"
        assert scorer._route(1) == "device"
    with pytest.raises(ValueError, match="device='cpu'"):
        TopKScorer(FACTORS, placement="host", device="cuda:0")
    assert TopKScorer(FACTORS, device="cpu").placement == env


def test_cosine_normalize_matches_jax():
    m = RNG.normal(size=(6, 5)).astype(np.float32)
    m[2] = 0.0                                    # a zero row stays zero
    np.testing.assert_allclose(cosine_normalize(m), jax_cosine_normalize(m),
                               **TOL)
