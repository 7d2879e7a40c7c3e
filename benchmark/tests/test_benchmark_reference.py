"""The reference at small sizes on the CPU: it agrees with plain dense
arithmetic, accepts the port, and rejects lower precision and perturbed
outputs."""

import numpy as np
import pytest
import torch

from benchmark.lib import cells
from benchmark.reference import als as ref_als
from benchmark.reference.rounding import lower, rounder
from benchmark.runners import als
from benchmark.tests.conftest import ROOT

#: tolerances at these sizes, set from the readings quoted beside them
#: (CPU runs of the port against its reference and of the float8
#: control, four seeds): sound loss_gap 3.7e-6-1.1e-4 and row_err
#: 0.038-0.045; the control 0.046-0.054 and 0.55-0.59
ALS_LIMITS = {"loss_gap": 1e-3, "row_err": 0.2}


def small(name):
    """The cell at 1,500 users x 600 items and 40,000 ratings, the
    traffic's anchors scaled to fit."""
    c = cells.load(ROOT, name)
    c.config["model"].update(n_users=1500, n_items=600)
    c.mix.update(n_ratings=40000, users={"min": 5, "median": 15, "max": 300},
                 items={"top": 900, "median": 30, "min": 1})
    return c


def passes(readings, limits):
    return all(readings[k] <= v for k, v in limits.items())


def test_als_normal_equations_match_dense():
    g = torch.Generator().manual_seed(0)
    n_u, n_i, K = 7, 5, 3
    u = torch.tensor([0, 0, 1, 3, 3, 3, 6, 6])
    i = torch.tensor([1, 1, 2, 0, 4, 2, 3, 1])   # a duplicate pair
    r = torch.tensor([1.0, 2.0, 3.5, 4.0, 0.5, 5.0, 2.5, 3.0])
    R = ref_als.Ratings(u.numpy(), i.numpy(), r.numpy(), n_u, n_i, "cpu")
    Y = torch.randn((n_i, K), generator=g)
    A, b = ref_als.normal_equations(R.by_user, Y, 0.1, lambda t: t)
    for user in range(n_u):
        rows = (u == user).nonzero().flatten()
        Yg = Y[i[rows]]
        want = Yg.T @ Yg + 0.1 * max(len(rows), 1) * torch.eye(K)
        torch.testing.assert_close(A[user], want)
        torch.testing.assert_close(b[user], Yg.T @ r[rows])


def test_als_cg_converges_to_the_solve():
    g = torch.Generator().manual_seed(1)
    M = torch.randn((4, 6, 6), generator=g)
    A = M @ M.transpose(1, 2) + 6 * torch.eye(6)
    b = torch.randn((4, 6), generator=g)
    x = ref_als.cg(A, b, torch.zeros(4, 6), 30, lambda t: t)
    torch.testing.assert_close(x, torch.linalg.solve(A, b), rtol=1e-4,
                               atol=1e-5)


@pytest.fixture(scope="module")
def als_run():
    c = small("als-ml20m.train")
    s = als.Setup(c.config["model"], c.mix, 2**31 + 17, "cpu")
    t, f = s.training()
    R = s.ratings()
    base = ref_als.train(R, s.X0, s.Y0, c.config["model"])
    return c, s, f, R, base


def test_als_reference_accepts_the_port(als_run):
    c, s, f, R, base = als_run
    assert passes(s.judge(f, R, base), ALS_LIMITS)


def test_als_reference_rejects_lower_precision(als_run):
    c, s, f, R, base = als_run
    m = c.config["model"]
    got = ref_als.train(R, s.X0, s.Y0, m, lower(m["compute_dtype"]))
    assert not passes(ref_als.check(R, s.X0, s.Y0, *got, m, base),
                      ALS_LIMITS)


@pytest.mark.parametrize("how", ["scale", "row", "start"])
def test_als_reference_rejects_perturbed_factors(als_run, how):
    c, s, f, R, base = als_run
    X = torch.as_tensor(f.user_factors).clone()
    Y = torch.as_tensor(f.item_factors).clone()
    if how == "scale":
        X *= 1.05
    elif how == "row":
        j = int(torch.argsort(-Y.abs().sum(1))[len(Y) // 4])
        Y[j] = -Y[j]
    else:
        X, Y = s.X0.clone(), s.Y0.clone()
    assert not passes(ref_als.check(R, s.X0, s.Y0, X, Y, c.config["model"],
                                    base), ALS_LIMITS)


def test_float8_rounding_is_coarser_than_bfloat16():
    x = torch.linspace(-1, 1, 1001)[None, :]
    e16 = (rounder("bfloat16")(x) - x).abs().max()
    e8 = (rounder("float8")(x) - x).abs().max()
    assert 0 < e16 < e8 < 0.05
    assert np.isclose(float(rounder("float32")(x).sum()), float(x.sum()))
