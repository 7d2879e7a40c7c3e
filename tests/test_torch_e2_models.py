"""The port's e2 models (``predictionio_torch/models/naive_bayes.py``,
``models/markov.py``) against the JAX package's, on the CPU.

- Categorical naive Bayes on the reference's fruit points and on a
  seeded random set: priors, likelihoods (seen entries only), the dense
  table, ``log_score`` (the -inf default, an unknown label, a custom
  default), ``score_batch`` and ``predict``/``predict_batch`` equal to
  the JAX model's (scores within 1e-6, labels equal), and the
  reference's numbers (CategoricalNaiveBayesTest.scala) within 1e-4.
- Markov chain on the reference fixtures and a seeded random tally:
  the padded top-N tables equal the JAX ones exactly, ``predict``
  within 1e-6 of the JAX model's and of a float64 product; empty rows,
  duplicate tallies and out-of-range states behave as in JAX.
"""

import math

import numpy as np
import pytest
import torch

from predictionio_tpu.models import markov as jax_markov
from predictionio_tpu.models import naive_bayes as jax_nb
from predictionio_torch.models import markov, naive_bayes

torch.set_num_threads(2)

TOL = 1e-4
BANANA, ORANGE, OTHER = "Banana", "Orange", "Other Fruit"
LONG, NOT_LONG = "Long", "Not Long"
SWEET, NOT_SWEET = "Sweet", "Not Sweet"
YELLOW, NOT_YELLOW = "Yellow", "Not Yellow"

FRUIT = [
    (BANANA, [LONG, SWEET, YELLOW]), (BANANA, [LONG, SWEET, YELLOW]),
    (BANANA, [LONG, SWEET, YELLOW]), (BANANA, [LONG, SWEET, YELLOW]),
    (BANANA, [NOT_LONG, NOT_SWEET, NOT_YELLOW]),
    (ORANGE, [NOT_LONG, SWEET, NOT_YELLOW]),
    (ORANGE, [NOT_LONG, NOT_SWEET, NOT_YELLOW]),
    (OTHER, [LONG, SWEET, NOT_YELLOW]), (OTHER, [NOT_LONG, SWEET, NOT_YELLOW]),
    (OTHER, [LONG, SWEET, YELLOW]),
    (OTHER, [NOT_LONG, NOT_SWEET, NOT_YELLOW]),
]


def _random_points(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"L{int(rng.integers(4))}",
             [f"v{int(rng.integers(k))}" for k in (3, 5, 2, 7)])
            for _ in range(n)]


def _pair(rows, **kw):
    port = naive_bayes.train([naive_bayes.LabeledPoint(l, f) for l, f in rows],
                             device="cpu", **kw)
    ref = jax_nb.train([jax_nb.LabeledPoint(l, f) for l, f in rows], **kw)
    return port, ref


@pytest.mark.parametrize("rows", [FRUIT, _random_points()],
                         ids=["fruit", "random"])
def test_naive_bayes_matches_jax(rows):
    port, ref = _pair(rows)
    assert port.priors == pytest.approx(ref.priors, abs=1e-6)
    assert port.likelihoods.keys() == ref.likelihoods.keys()
    for lbl, slots in port.likelihoods.items():
        for got, want in zip(slots, ref.likelihoods[lbl]):
            assert got == pytest.approx(want, abs=1e-6)
    np.testing.assert_array_equal(port._likelihoods,
                                  np.asarray(ref._likelihoods))
    queries = [f for _l, f in rows] + [[f[0], "unseen"] + f[2:]
                                       for _l, f in rows[:3]]
    np.testing.assert_allclose(port.score_batch(queries),
                               ref.score_batch(queries), atol=1e-6)
    assert port.predict_batch(queries) == ref.predict_batch(queries)
    assert [port.predict(q) for q in queries[:4]] == [
        ref.predict(q) for q in queries[:4]]
    for label, feats in rows[:5] + [("nope", rows[0][1])]:
        a = port.log_score(naive_bayes.LabeledPoint(label, feats))
        b = ref.log_score(jax_nb.LabeledPoint(label, feats))
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, abs=1e-5)


def test_naive_bayes_reference_numbers():
    m, _ = _pair(FRUIT)
    assert m.priors[BANANA] == pytest.approx(-0.7885, abs=TOL)
    assert m.priors[ORANGE] == pytest.approx(-1.7047, abs=TOL)
    lik = m.likelihoods
    assert lik[BANANA][0][LONG] == pytest.approx(math.log(4 / 5), abs=TOL)
    assert LONG not in lik[ORANGE][0] and YELLOW not in lik[ORANGE][2]
    point = naive_bayes.LabeledPoint
    assert m.log_score(point(BANANA, [LONG, NOT_SWEET, NOT_YELLOW])) == \
        pytest.approx(-4.2304, abs=TOL)
    assert m.log_score(point(BANANA, [LONG, NOT_SWEET, "x"])) == float("-inf")
    assert m.log_score(point("x", [LONG, NOT_SWEET, YELLOW])) is None
    fn = lambda ls: (min(ls) - math.log(2)) if ls else float("-inf")
    assert m.log_score(point(BANANA, [LONG, NOT_SWEET, "x"]),
                       default_likelihood=fn) == pytest.approx(-4.9236,
                                                               abs=TOL)
    baked, ref = _pair(FRUIT, default_likelihood=fn)
    q = point(BANANA, [LONG, NOT_SWEET, "x"])
    assert baked.log_score(q) == pytest.approx(-4.9236, abs=TOL)
    assert baked.log_score(q) == pytest.approx(
        ref.log_score(jax_nb.LabeledPoint(BANANA, [LONG, NOT_SWEET, "x"])),
        abs=1e-6)
    assert m.predict([LONG, SWEET, YELLOW]) == BANANA
    with pytest.raises(ValueError):
        m.encode_features([[LONG, SWEET]])
    with pytest.raises(ValueError):
        naive_bayes.train([point("a", ["x"]), point("b", ["x", "y"])],
                          device="cpu")


TWO_BY_TWO = ([0, 0, 1, 1], [0, 1, 0, 1], [3, 7, 10, 10])
FIVE_BY_FIVE = (
    [0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4],
    [1, 2, 0, 1, 2, 3, 4, 1, 2, 4, 0, 3, 4, 1, 3, 4],
    [12, 8, 3, 3, 9, 2, 8, 10, 8, 10, 2, 3, 4, 7, 8, 10],
)


def _random_tally(seed=0, n_states=40, n=600):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_states, n), rng.integers(0, n_states, n),
            rng.integers(1, 20, n).astype(np.float64)), n_states


@pytest.mark.parametrize("case", ["two", "five", "random"])
@pytest.mark.parametrize("top_n", [1, 2, 5])
def test_markov_matches_jax(case, top_n):
    entries, n_states = {"two": (TWO_BY_TWO, 2), "five": (FIVE_BY_FIVE, 5),
                         "random": _random_tally()}[case]
    port = markov.train(entries, n_states, top_n, device="cpu")
    ref = jax_markov.train(entries, n_states, top_n)
    np.testing.assert_array_equal(port.indices, ref.indices)
    np.testing.assert_array_equal(port.probs, ref.probs)
    rng = np.random.default_rng(top_n)
    cur = rng.dirichlet(np.ones(n_states)).astype(np.float32)
    got = port.predict(cur)
    np.testing.assert_allclose(got, ref.predict(cur), atol=1e-6)
    dense = np.zeros((n_states, n_states))
    np.add.at(dense, (np.repeat(np.arange(n_states), top_n),
                      port.indices.reshape(-1)),
              port.probs.reshape(-1).astype(np.float64))
    np.testing.assert_allclose(got, cur.astype(np.float64) @ dense,
                               atol=1e-6)
    assert [port.transition_row(s) for s in range(n_states)] == [
        ref.transition_row(s) for s in range(n_states)]


def test_markov_edge_cases_match_jax():
    m = markov.train(([0], [1], [5.0]), n_states=3, top_n=2, device="cpu")
    assert m.transition_row(2) == []
    assert m.predict([0.0, 0.0, 1.0]) == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError):
        m.predict([1.0, 0.0])
    dup = ([0, 0, 0], [1, 1, 2], [3.0, 4.0, 5.0])
    assert markov.train(dup, 3, 1, device="cpu").transition_row(0) == [
        (1, pytest.approx(7 / 12))]
    for bad in (([0], [5], [1.0]), ([-1], [0], [1.0])):
        with pytest.raises(ValueError):
            markov.train(bad, n_states=2, top_n=1, device="cpu")
        with pytest.raises(ValueError):
            jax_markov.train(bad, n_states=2, top_n=1)
    with pytest.raises(ValueError):
        markov.train(dup, 3, 0, device="cpu")
    empty = markov.train(([], [], []), n_states=2, top_n=2, device="cpu")
    assert empty.predict([1.0, 0.0]) == [0.0, 0.0]
