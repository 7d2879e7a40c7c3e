"""The port's fused scan+bin and native binning, on the CPU.

- ``bin_columnar`` of the port against the JAX package's, each over its
  own log of the same seeded events: bit-identical ``idx_lo``/``idx_hi``/
  ``val``/``mask``/``seg``/``counts``, the same affine codes, block
  sizes, vocabularies, holdout and row count.
- The same call against the port's own numpy route over the same COO
  (``find_columnar``, the template's value rule, then
  ``build_segmented_groups`` and ``compress_side``): bit-identical too.
  Cases: tombstones and compaction, empty groups, a vocabulary past
  2^16, values that form no affine ladder, an unknown filter.
- ``rb_bin_compressed`` (``build_compressed_segmented``) and
  ``rb_fill_segmented`` against the numpy route over seeded ragged COO,
  a bad group index that raises, NaN values that stay uncoded.
- Holdout views keep their own native owner; ``read_prepared`` is
  memoized.
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.data.backends.eventlog import (
    EventLogEventStore as JaxStore)
from predictionio_tpu.data.storage import EventColumns as JaxColumns
from predictionio_tpu.ops import ragged as jax_ragged
from predictionio_torch.data.backends.eventlog import EventLogEventStore
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import EventColumns
from predictionio_torch.ops import ragged
from predictionio_torch.ops.als import compress_side
from predictionio_torch.templates.recommendation import BinnedReadRequest

UTC = dt.timezone.utc


def _columns(cls, n=60_000, users=800, items=300, seed=0, buy_frac=0.2):
    rng = np.random.default_rng(seed)
    names = np.where(rng.random(n) < buy_frac, 1, 0).astype(np.int32)
    vals = (0.5 + 0.5 * rng.integers(0, 10, n)).astype(np.float64)
    vals[names == 1] = np.nan       # buy rows carry no rating property
    return cls(entity_codes=rng.integers(0, users, n).astype(np.int32),
               target_codes=rng.integers(0, items, n).astype(np.int32),
               name_codes=names, values=vals,
               times_us=np.arange(n, dtype=np.int64) * 1000,
               entity_vocab=[f"u{i}" for i in range(users)],
               target_vocab=[f"i{i}" for i in range(items)],
               names=["rate", "buy"])


@pytest.fixture
def stores(tmp_path):
    port = EventLogEventStore(str(tmp_path / "port"))
    ref = JaxStore(str(tmp_path / "jax"))
    port.init(1)
    ref.init(1)
    yield port, ref
    port.close()
    ref.close()


def _ingest(stores, cols_fn, **kw):
    """The same columns into both stores."""
    for store, cls in zip(stores, (EventColumns, JaxColumns)):
        store.insert_columnar(cols_fn(cls, **kw), 1, entity_type="user",
                              target_entity_type="item",
                              value_property="rating")


def _bin(store, **kw):
    kw.setdefault("value_property", "rating")
    kw.setdefault("overrides", {"buy": 4.0})
    kw.setdefault("entity_type", "user")
    kw.setdefault("event_names", ["rate", "buy"])
    kw.setdefault("target_entity_type", "item")
    return store.bin_columnar(1, **kw)


def _numpy_route(store, skip_mod=0, skip_rem=0, buy_rating=4.0, **knobs):
    """The port's numpy route over the same rows: columnar read, target
    drop, the template's value rule, holdout, then
    build_segmented_groups and compress_side per side."""
    cs = store.find_columnar(1, value_property="rating", time_ordered=False,
                             entity_type="user", event_names=["rate", "buy"],
                             target_entity_type="item")
    keep = cs.target_codes >= 0
    u = cs.entity_codes[keep].astype(np.int64)
    i = cs.target_codes[keep].astype(np.int64)
    v = np.nan_to_num(cs.values[keep], nan=0.0).astype(np.float32)
    if "buy" in cs.names:
        v = np.where(cs.name_codes[keep] == cs.names.index("buy"),
                     np.float32(buy_rating), v)
    hold = (np.arange(len(u)) % skip_mod == skip_rem if skip_mod
            else np.zeros(len(u), bool))
    tr = (u[~hold], i[~hold], v[~hold])
    ho = (u[hold], i[hold], v[hold])
    user = compress_side(ragged.build_segmented_groups(
        tr[0], tr[1], tr[2], len(cs.entity_vocab), **knobs))
    item = compress_side(ragged.build_segmented_groups(
        tr[1], tr[0], tr[2], len(cs.target_vocab), **knobs))
    return cs, tr, ho, user, item


def _assert_side_equal(want, got):
    np.testing.assert_array_equal(want.idx_lo, got.idx_lo)
    assert want.idx_lo.dtype == got.idx_lo.dtype == np.uint16
    assert (want.idx_hi is None) == (got.idx_hi is None)
    if want.idx_hi is not None:
        np.testing.assert_array_equal(want.idx_hi, got.idx_hi)
    assert want.affine == got.affine
    np.testing.assert_array_equal(want.val, got.val)
    assert want.val.dtype == got.val.dtype
    assert (want.mask is None) == (got.mask is None)
    if want.mask is not None:
        np.testing.assert_array_equal(want.mask, got.mask)
    np.testing.assert_array_equal(want.seg, got.seg)
    np.testing.assert_array_equal(want.counts, got.counts)
    assert (want.row_block, want.group_block, want.groups_per_shard,
            want.n_shards) == (got.row_block, got.group_block,
                               got.groups_per_shard, got.n_shards)


def _assert_binned_equal(want, got):
    """A port BinnedInteractions against the JAX package's, bit for bit."""
    for side in ("user_side", "item_side"):
        w, g = getattr(want, side), getattr(got, side)
        _assert_side_equal(w, g)
        assert (w.n_groups, w.kept_entries) == (g.n_groups, g.kept_entries)
        assert w.kept_value_sum == g.kept_value_sum
    assert want.entity_vocab == got.entity_vocab
    assert want.target_vocab == got.target_vocab
    assert want.n_rows == got.n_rows
    assert (want.holdout is None) == (got.holdout is None)
    if want.holdout is not None:
        for w, g in zip(want.holdout, got.holdout):
            np.testing.assert_array_equal(w, g)
            assert w.dtype == g.dtype


def _check_both(stores, **kw):
    """bin_columnar of the port against the JAX store's and against the
    port's numpy route; returns the port's result and the route's."""
    port, ref = stores
    got = _bin(port, **kw)
    _assert_binned_equal(_bin(ref, **kw), got)
    route = _numpy_route(port, **kw)
    cs, tr, ho, user, item = route
    _assert_side_equal(user, got.user_side)
    _assert_side_equal(item, got.item_side)
    assert got.entity_vocab == cs.entity_vocab
    assert got.target_vocab == cs.target_vocab
    assert got.n_rows == len(tr[0])
    if len(ho[0]):
        for w, g in zip(ho, got.holdout):
            np.testing.assert_array_equal(w, g)
    return got, route


def test_bin_columnar_matches_jax_and_the_numpy_route(stores):
    _ingest(stores, _columns)
    got, (cs, tr, _, _, _) = _check_both(stores, skip_mod=20, skip_rem=0,
                                         block_size=512)
    assert got.user_side.affine == (0.5, 0.5)
    assert got.n_rows + len(got.holdout[0]) == 60_000
    # the kept-value sum backs a global-mean baseline
    assert got.user_side.kept_value_sum == pytest.approx(
        float(np.sum(tr[2], dtype=np.float64)), rel=1e-9)
    assert got.scan_sec >= 0.0 and got.bin_sec >= 0.0
    assert stores[0].bin_columnar_calls == 1


def test_bin_columnar_over_tombstones_and_after_compaction(stores):
    _ingest(stores, _columns, n=30_000, seed=3)
    evs = [dict(event="rate", entity_type="user", entity_id=f"u{k % 50}",
                target_entity_type="item", target_entity_id=f"i{k % 30}",
                properties={"rating": 2.5},
                event_time=dt.datetime(2026, 3, 1, tzinfo=UTC),
                event_id=f"{k:032x}") for k in range(500)]
    from predictionio_tpu.data.event import Event as JaxEvent

    port, ref = stores
    port.insert_batch([Event(**e) for e in evs], 1)
    ref.insert_batch([JaxEvent(**e) for e in evs], 1)
    for e in evs[::3]:
        assert port.delete(e["event_id"], 1) and ref.delete(e["event_id"], 1)
    _check_both(stores, block_size=256)
    port.compact(1)
    ref.compact(1)
    _check_both(stores, block_size=256)


def test_bin_columnar_with_empty_groups(stores):
    """A user whose only event is held out leaves an empty group: its
    count is 0 in the layout, as in the numpy route's."""
    def cols(cls):
        rng = np.random.default_rng(2)
        n = 4001
        ent = np.concatenate([[0], 1 + np.arange(n - 1) % 37]).astype(np.int32)
        return cls(entity_codes=ent,
                   target_codes=(np.arange(n) % 11).astype(np.int32),
                   name_codes=np.zeros(n, np.int32),
                   values=(0.5 + 0.5 * rng.integers(0, 9, n)).astype(
                       np.float64),
                   times_us=np.arange(n, dtype=np.int64),
                   entity_vocab=["u_only"] + [f"u{k}" for k in range(37)],
                   target_vocab=[f"i{k}" for k in range(11)],
                   names=["rate"])

    _ingest(stores, cols)
    got, _ = _check_both(stores, skip_mod=20, skip_rem=0, block_size=64)
    assert got.entity_vocab[0] == "u_only"
    assert got.user_side.counts[0] == 0


def test_bin_columnar_past_a_16_bit_vocabulary(stores):
    """70,000 items: the user side's indexes grow the idx_hi stream."""
    def cols(cls):
        n_items, n = 70_000, 72_000
        rng = np.random.default_rng(5)
        items = np.concatenate([np.arange(n_items, dtype=np.int32),
                                rng.integers(0, n_items, n - n_items)
                                .astype(np.int32)])
        return cls(entity_codes=rng.integers(0, 500, n).astype(np.int32),
                   target_codes=items, name_codes=np.zeros(n, np.int32),
                   values=(0.5 + 0.5 * rng.integers(0, 10, n)).astype(
                       np.float64),
                   times_us=np.arange(n, dtype=np.int64),
                   entity_vocab=[f"u{i}" for i in range(500)],
                   target_vocab=[f"i{i}" for i in range(n_items)],
                   names=["rate"])

    _ingest(stores, cols)
    got, _ = _check_both(stores, block_size=512)
    assert got.user_side.idx_hi is not None      # items are > 2^16
    assert got.item_side.idx_hi is None          # users are not


def test_bin_columnar_keeps_values_off_a_ladder_in_float32(stores):
    def cols(cls):
        n, users, items = 5000, 60, 40
        rng = np.random.default_rng(9)
        return cls(entity_codes=rng.integers(0, users, n).astype(np.int32),
                   target_codes=rng.integers(0, items, n).astype(np.int32),
                   name_codes=np.zeros(n, np.int32),
                   values=rng.normal(3.0, 1.0, n),
                   times_us=np.arange(n, dtype=np.int64),
                   entity_vocab=[f"u{i}" for i in range(users)],
                   target_vocab=[f"i{i}" for i in range(items)],
                   names=["rate"])

    _ingest(stores, cols)
    got, _ = _check_both(stores, block_size=64)
    assert got.user_side.affine is None
    assert got.user_side.mask is not None
    assert got.user_side.val.dtype == np.float32


def test_bin_columnar_rejects_an_unknown_filter(stores):
    _ingest(stores, _columns, n=1000)
    with pytest.raises(TypeError):
        _bin(stores[0], limit=5)
    with pytest.raises(ValueError, match="seg_len"):
        _bin(stores[0], seg_len="short")


# -- native binning from COO -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_len,n_shards", [(None, 1), (64, 1), (None, 4)])
def test_rb_bin_compressed_matches_the_numpy_route(monkeypatch, seed,
                                                   max_len, n_shards):
    """Ragged-shape fuzz: group skew, truncation, shards, both value
    regimes (an affine ladder, normal reals), and a tail of empty
    groups; the JAX package's native builder gives the same bits."""
    monkeypatch.setattr(ragged, "_NATIVE_MIN_NNZ", 0)
    monkeypatch.setattr(jax_ragged, "_NATIVE_MIN_NNZ", 0)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5_000, 40_000))
    n_groups = int(rng.integers(50, 3_000))
    n_items = int(rng.integers(20, 2_000))
    g = rng.integers(0, n_groups, n).astype(np.int64)
    i = (rng.zipf(1.3, n) % n_items).astype(np.int64)
    if seed % 2:
        v = (1.0 + 0.5 * rng.integers(0, 9, n)).astype(np.float32)
    else:
        v = rng.normal(size=n).astype(np.float32)
    g = np.minimum(g, max(1, n_groups - 10))
    bs = int(rng.choice([64, 512, 4096]))
    knobs = dict(max_len=max_len, n_shards=n_shards, block_size=bs)
    got = ragged.build_compressed_segmented(g, i, v, n_groups, **knobs)
    monkeypatch.setenv("PIO_NATIVE_RAGGED", "0")    # the numpy route
    assert ragged.build_compressed_segmented(g, i, v, n_groups) is None
    sg = ragged.build_segmented_groups(g, i, v, n_groups, **knobs)
    _assert_side_equal(compress_side(sg), got)
    assert got.kept_entries == int(sg.counts.sum())
    monkeypatch.delenv("PIO_NATIVE_RAGGED")
    _assert_side_equal(jax_ragged.build_compressed_segmented(
        g, i, v, n_groups, **knobs), got)


@pytest.mark.parametrize("max_len,n_shards", [(None, 1), (64, 4)])
def test_rb_fill_segmented_matches_the_numpy_route(monkeypatch, max_len,
                                                   n_shards):
    rng = np.random.default_rng(7)
    n, n_groups = 250_000, 3_000
    g = rng.integers(0, n_groups, n).astype(np.int64)
    i = (rng.zipf(1.3, n) % 800).astype(np.int64)
    v = rng.normal(size=n).astype(np.float32)
    knobs = dict(max_len=max_len, n_shards=n_shards)
    got = ragged.build_segmented_groups(g, i, v, n_groups, **knobs)
    monkeypatch.setenv("PIO_NATIVE_RAGGED", "0")
    want = ragged.build_segmented_groups(g, i, v, n_groups, **knobs)
    for name in ("idx", "val", "mask", "seg", "counts"):
        np.testing.assert_array_equal(getattr(want, name),
                                      getattr(got, name))


def test_native_binning_rejects_a_bad_group_index(monkeypatch):
    monkeypatch.setattr(ragged, "_NATIVE_MIN_NNZ", 0)
    g = np.array([0, 99], np.int64)
    with pytest.raises(ValueError, match="out of range"):
        ragged.build_compressed_segmented(g, np.zeros(2, np.int64),
                                          np.ones(2, np.float32), 10)
    with pytest.raises(ValueError):     # the group counts do not fit
        ragged.build_segmented_groups(g, np.zeros(2, np.int64),
                                      np.ones(2, np.float32), 10)


def test_nan_values_stay_uncoded(monkeypatch):
    """A NaN among the values forces the f32 + mask layout, as in the
    numpy route (np.unique keeps the NaN and the ladder check fails)."""
    monkeypatch.setattr(ragged, "_NATIVE_MIN_NNZ", 0)
    g = np.arange(64, dtype=np.int64) % 8
    i = np.arange(64, dtype=np.int64) % 16
    v = np.where(np.arange(64) % 2 == 0, 2.0, 1.0).astype(np.float32)
    v[0] = np.nan
    got = ragged.build_compressed_segmented(g, i, v, 8, block_size=64)
    assert got.affine is None and got.mask is not None
    _assert_side_equal(compress_side(ragged.build_segmented_groups(
        g, i, v, 8, block_size=64)), got)


# -- buffer lifetime and the template's read ---------------------------------------

def test_holdout_views_do_not_pin_the_side_buffers(stores):
    def owner_of(arr):
        a = arr
        while a is not None and not hasattr(a, "_owner"):
            a = a.base
        return a._owner

    _ingest(stores, _columns, n=5000, users=60, items=30)
    out = _bin(stores[0], skip_mod=20, skip_rem=0, block_size=64)
    side_owner = owner_of(out.user_side.idx_lo)
    assert owner_of(out.holdout[0]) is not side_owner
    assert owner_of(out.item_side.seg) is side_owner
    assert owner_of(out.holdout[2]) is owner_of(out.holdout[0])


def test_read_prepared_is_memoized_per_request():
    req = BinnedReadRequest(
        app_name="x", channel_name=None, entity_type="user",
        event_names=["rate"], target_entity_type="item",
        value_property="rating", overrides={})
    sentinel = object()
    req._prepared = sentinel        # an earlier consumer's read
    assert req.read_prepared() is sentinel
