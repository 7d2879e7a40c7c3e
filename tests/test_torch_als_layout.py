"""The ALS host layout of the port against the JAX package's.

The same seeded COO ratings go through both packages'
``build_segmented_groups`` and ``build_compressed_side`` (the JAX side
takes its numpy route: every input here is below its native cutover).
Tolerance: none. Every array must be bit-identical and every field
equal: ``idx``, ``val``, ``mask``, ``seg``, ``counts`` and the blocks of
the segmented layout; ``idx_lo``, ``idx_hi``, codes or val and mask,
``seg``, ``counts``, ``affine`` and the blocks of the compressed one.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import ragged as jax_ragged
from predictionio_torch.ops import als
from predictionio_torch.ops import ragged

torch.set_num_threads(2)


def _coo(n_groups, n_opposing, nnz, seed, values="halfstar"):
    """Seeded COO: Zipf-skewed opposing ids (a few long groups), values
    as named: ``halfstar`` (an affine ladder 0.5..5.0), ``real`` (no
    ladder), ``nan`` (half-stars with a few NaN), ``one`` (one value)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, nnz)
    o = (rng.zipf(1.3, nnz) * 7919) % n_opposing
    if values == "halfstar":
        v = rng.integers(1, 11, nnz) * 0.5
    elif values == "real":
        v = rng.normal(3.0, 1.0, nnz)
    elif values == "nan":
        v = rng.integers(1, 11, nnz) * 0.5
        v[rng.random(nnz) < 0.01] = np.nan
    else:
        v = np.full(nnz, 4.0)
    return g, o, v.astype(np.float32)


def _assert_same_fields(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray) or b is None:
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, name
            # equal_nan: NaN values must sit in the same slots
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, (name, a, b)


SEGMENTED_FIELDS = ("idx", "val", "mask", "seg", "counts", "n_groups",
                    "n_shards", "rows_per_shard", "groups_per_shard",
                    "row_block", "group_block")
COMPRESSED_FIELDS = ("idx_lo", "idx_hi", "val", "mask", "seg", "counts",
                     "affine", "row_block", "group_block",
                     "groups_per_shard", "n_shards")


@pytest.mark.parametrize("seg_len,max_len,n_shards,block_size", [
    ("auto", None, 1, 4096),
    (8, None, 1, 32),          # groups span several rows; several blocks
    (16, 12, 1, 64),           # capped groups keep their latest entries
    ("auto", 40, 2, 64),       # two shards, local segment ids
])
def test_segmented_groups_are_bit_identical(seg_len, max_len, n_shards,
                                            block_size):
    g, o, v = _coo(150, 90, 4000, seed=3)
    kw = dict(seg_len=seg_len, max_len=max_len, n_shards=n_shards,
              block_size=block_size, row_cost_slots=13.65)
    got = ragged.build_segmented_groups(g, o, v, 150, **kw)
    want = jax_ragged.build_segmented_groups(g, o, v, 150, **kw)
    _assert_same_fields(got, want, SEGMENTED_FIELDS)


def test_auto_seg_len_matches():
    counts = np.random.default_rng(0).zipf(1.5, 3000).clip(max=2000)
    for slots in (8.0, 13.65, 54.6):
        assert ragged.auto_seg_len(counts, slots) == (
            jax_ragged.auto_seg_len(counts, slots))
    assert ragged.auto_seg_len(np.zeros(4, np.int64)) == 16


@pytest.mark.parametrize("values,n_opposing,seg_len,max_len,block_size", [
    ("halfstar", 90, "auto", None, 64),     # coded: uint8 + affine
    ("halfstar", 90, 8, 20, 32),            # coded, capped, many blocks
    ("real", 90, "auto", None, 64),         # no ladder: f32 + mask
    ("nan", 90, 16, None, 64),              # NaN forces f32 + mask
    ("one", 90, "auto", None, 64),          # one value: affine b = 0
    ("halfstar", 70_000, "auto", None, 64),  # vocab > 65,535: idx_hi
    ("real", 70_000, 8, 30, 32),            # idx_hi with f32 + mask
])
def test_compressed_sides_are_bit_identical(values, n_opposing, seg_len,
                                            max_len, block_size):
    g, o, v = _coo(150, n_opposing, 4000, seed=5, values=values)
    kw = dict(rank=16, seg_len=seg_len, block_size=block_size)
    got = als.build_compressed_side(g, o, v, 150, als.ALSConfig(**kw), 1,
                                    max_len)
    want = jax_als.build_compressed_side(g, o, v, 150,
                                         jax_als.ALSConfig(**kw), 1, max_len)
    _assert_same_fields(got, want, COMPRESSED_FIELDS)
    assert (got.idx_hi is not None) == (n_opposing > 65_535)
    assert (got.affine is None) == (values in ("real", "nan"))
    assert got.slot_bytes == want.slot_bytes
    assert got.transfer_bytes == want.transfer_bytes


def test_compress_side_matches_on_a_segmented_layout():
    g, o, v = _coo(60, 200, 900, seed=9)
    sg = jax_ragged.build_segmented_groups(g, o, v, 60, seg_len=8)
    _assert_same_fields(als.compress_side(sg), jax_als.compress_side(sg, 0),
                        COMPRESSED_FIELDS)


def test_index_wire_format_rejects_a_25_bit_vocabulary():
    idx = np.array([[0, 1 << 24]], np.int32)
    with pytest.raises(ValueError, match="24-bit"):
        als._split_idx(idx)
    lo, hi = als._split_idx(np.array([[70_000, 3]], np.int32))
    assert (lo.astype(np.int32) | hi.astype(np.int32) << 16).tolist() == [
        [70_000, 3]]


def test_row_cost_slots_match():
    for rank in (4, 32, 64, 128):
        assert als.als_row_cost_slots(rank) == jax_als.als_row_cost_slots(rank)
