import json
import os

import numpy as np
import pytest
import torch

from benchmark.lib import generators
from benchmark.tests.conftest import ROOT

SIZES = {"n_users": 500, "n_items": 300}
VALUES = {"levels": [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0],
          "counts": [1, 3, 1, 7, 4, 21, 11, 28, 8, 14]}
RATINGS = {"name": "t", "generator": "ratings", "n_ratings": 12000,
           "holdout_every": 20, "users": {"min": 5, "median": 15, "max": 250},
           "items": {"top": 450, "median": 15, "min": 1},
           "values": VALUES, "planted_rank": 8, "noise": 0.5}
SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, -5]


def ml20m():
    return json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                       "ml20m-ratings.json")))


@pytest.mark.parametrize("seed", SEEDS)
def test_ratings_repeat_per_seed(seed):
    a = generators.ratings(SIZES, RATINGS, seed)
    b = generators.ratings(SIZES, RATINGS, seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    u, i, r = a
    assert len(u) == len(i) == len(r) == 12000
    assert u.max() < 500 and i.max() < 300 and u.min() >= 0
    assert set(np.unique(r * 2)) <= set(range(1, 11))
    assert r.dtype == np.float32 and u.dtype == np.int64


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_pairs_are_distinct_and_keep_each_users_count(seed):
    u, i, _ = generators.ratings(SIZES, RATINGS, seed)
    assert len(np.unique(u * 300 + i)) == len(u)
    counts = np.sort(np.bincount(u, minlength=500))
    want = generators.user_counts(500, 12000, RATINGS["users"])
    np.testing.assert_array_equal(counts, want)


def test_seeds_change_rows_not_sizes():
    a = generators.ratings(SIZES, RATINGS, 1)
    b = generators.ratings(SIZES, RATINGS, 2)
    assert not np.array_equal(a[0], b[0])
    assert len(a[0]) == len(b[0])
    assert np.array_equal(np.sort(np.bincount(a[0], minlength=500)),
                          np.sort(np.bincount(b[0], minlength=500)))
    assert abs(a[2].mean() - b[2].mean()) < 0.1


def test_values_follow_the_histogram():
    _, _, r = generators.ratings(SIZES, RATINGS, 4)
    levels, got = np.unique(r, return_counts=True)
    want = np.asarray(VALUES["counts"], float) / sum(VALUES["counts"])
    assert list(levels) == VALUES["levels"]
    np.testing.assert_allclose(got / len(r), want, atol=0.01)


def test_user_counts_hold_the_published_anchors():
    mix = ml20m()
    nu = generators.user_counts(138_493, mix["n_ratings"], mix["users"])
    assert nu.sum() == 20_000_263
    assert nu.min() == 20 and nu.max() == 9254
    assert np.median(nu) == 68
    assert np.all(np.diff(nu) >= 0)


def test_item_targets_hold_the_published_anchors():
    mix = ml20m()
    t = generators.item_targets(26_744, mix["n_ratings"], mix["items"])
    assert t.sum() == 20_000_263
    assert t[0] == 67_310 and t.min() >= 1
    assert np.median(t) == 18
    assert np.all(np.diff(t) <= 0)


def test_fitted_weights_give_each_item_its_target():
    mix = ml20m()
    nu = generators.user_counts(138_493, mix["n_ratings"], mix["users"])
    t = generators.item_targets(26_744, mix["n_ratings"], mix["items"])
    ns, users = np.unique(nu, return_counts=True)
    w = generators.fit_weights(t, ns, users)
    k, c, _ = generators._capped_plan(w, ns)
    # a user's sure items and expected sampled items make its count
    tail = np.cumsum(w[::-1])[::-1]
    np.testing.assert_allclose(k + c * tail[k], ns, rtol=1e-9)
    assert np.all(c * w[k] <= 1.0 + 1e-12)


def test_integerize_keeps_the_total_and_the_floor():
    out = generators.integerize(np.array([0.2, 5.5, 3.3, 1.0]), 12, 1)
    assert out.sum() == 12 and out.min() >= 1
    with pytest.raises(ValueError):
        generators.integerize(np.ones(5), 3, 1)


def test_streams_differ_and_fit_63_bits():
    seen = {generators.stream_seed(5, tag) for tag in range(10)}
    assert len(seen) == 10
    assert all(0 <= s < 2**63 for s in seen)


def test_tables_repeat():
    t1 = generators.normal_tables({"user": (50, 8), "item": (40, 8)}, 3, 6,
                                  "cpu")
    t2 = generators.normal_tables({"user": (50, 8), "item": (40, 8)}, 3, 6,
                                  "cpu")
    assert torch.equal(t1["user"], t2["user"])
    assert abs(float(t1["user"].var()) - 1 / 8) < 0.05
