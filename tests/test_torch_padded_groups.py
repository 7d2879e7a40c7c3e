"""The per-group padded layout (``ops/ragged.py`` ``build_padded_groups``)
against the JAX package's, bit for bit, on both of its routes.

The port fills the layout with numpy alone. The same seeded COO ratings
go through it and through the JAX package's builder on its numpy route
(below its ``_NATIVE_MIN_NNZ``, and everywhere under
``PIO_NATIVE_RAGGED=0``) and on its native route (``rb_fill_padded``):
``idx``, ``val``, ``mask`` and ``counts`` must be equal arrays of equal
dtype, with and without a ``max_len`` cap (which keeps each group's
latest entries), with a padded group axis and other ``len_multiple``s.
A group id out of range raises ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_tpu.ops import ragged as jax_ragged
from predictionio_torch.ops import ragged

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

FIELDS = ("idx", "val", "mask", "counts")


def coo(nnz, n_groups, seed=0, n_items=5000):
    rng = np.random.default_rng(seed)
    # Zipf-ish group sizes, so some groups are far longer than the cap
    groups = np.minimum(rng.zipf(1.3, nnz) - 1, n_groups - 1)
    return (groups.astype(np.int64), rng.integers(0, n_items, nnz),
            rng.standard_normal(nnz).astype(np.float32))


def assert_bit_equal(port, jax):
    for name in FIELDS:
        got, want = getattr(port, name), getattr(jax, name)
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), name
    assert port.n_groups == jax.n_groups
    assert port.max_len == jax.max_len


#: the JAX package's route at each size
ROUTES = {"numpy": 5_000, "native": 260_000}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("max_len,group_multiple,len_multiple", [
    (None, 1, 8), (16, 1, 8), (5, 7, 8), (40, 64, 1), (3, 4, 16)])
def test_padded_groups_are_jaxs_bits(monkeypatch, route, max_len,
                                     group_multiple, len_multiple):
    monkeypatch.delenv("PIO_NATIVE_RAGGED", raising=False)
    nnz = ROUTES[route]
    assert (nnz >= jax_ragged._NATIVE_MIN_NNZ) == (route == "native")
    g, i, v = coo(nnz, 301, seed=nnz + (max_len or 0))
    kwargs = dict(max_len=max_len, group_multiple=group_multiple,
                  len_multiple=len_multiple)
    port = ragged.build_padded_groups(g, i, v, 301, **kwargs)
    jax = jax_ragged.build_padded_groups(g, i, v, 301, **kwargs)
    assert_bit_equal(port, jax)
    assert port.idx.shape[0] % group_multiple == 0
    assert port.max_len % len_multiple == 0


def test_both_routes_agree_and_the_env_forces_numpy(monkeypatch):
    """At a size where the JAX package fills natively, the port's numpy
    fill gives its bits, and those of its numpy route under
    ``PIO_NATIVE_RAGGED=0``; the variable changes nothing in the port."""
    monkeypatch.delenv("PIO_NATIVE_RAGGED", raising=False)
    g, i, v = coo(ROUTES["native"], 257, seed=3)
    port = ragged.build_padded_groups(g, i, v, 257, max_len=12)
    assert_bit_equal(port, jax_ragged.build_padded_groups(
        g, i, v, 257, max_len=12))
    monkeypatch.setenv("PIO_NATIVE_RAGGED", "0")
    assert jax_ragged._native_lib() is None
    assert_bit_equal(port, jax_ragged.build_padded_groups(
        g, i, v, 257, max_len=12))
    assert_bit_equal(port, ragged.build_padded_groups(
        g, i, v, 257, max_len=12))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_truncation_keeps_each_groups_latest_entries(monkeypatch, route):
    monkeypatch.delenv("PIO_NATIVE_RAGGED", raising=False)
    nnz = ROUTES[route]
    g, i, v = coo(nnz, 50, seed=11)
    # item ids in arrival order, so "latest" is visible in the ids
    i = np.arange(nnz, dtype=np.int64) % (1 << 30)
    out = ragged.build_padded_groups(g, i, v, 50, max_len=8)
    for group in (0, 1, 49):
        arrived = i[g == group]
        kept = out.counts[group]
        assert kept == min(len(arrived), out.max_len)
        assert np.array_equal(out.idx[group, :kept], arrived[-kept:])
        assert out.mask[group, kept:].sum() == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("bad", [-1, 64])
def test_a_bad_group_id_raises_like_jax(monkeypatch, route, bad):
    monkeypatch.delenv("PIO_NATIVE_RAGGED", raising=False)
    nnz = ROUTES[route]
    g, i, v = coo(nnz, 64, seed=5)
    g[nnz // 2] = bad
    for module in (jax_ragged, ragged):
        with pytest.raises(ValueError):
            module.build_padded_groups(g, i, v, 64)


def test_empty_and_unequal_inputs_like_jax():
    empty = np.zeros(0, np.int64)
    assert_bit_equal(
        ragged.build_padded_groups(empty, empty, empty, 5, group_multiple=4),
        jax_ragged.build_padded_groups(empty, empty, empty, 5,
                                       group_multiple=4))
    for module in (jax_ragged, ragged):
        with pytest.raises(ValueError, match="equal length"):
            module.build_padded_groups(np.zeros(3), np.zeros(2),
                                       np.zeros(3), 4)
