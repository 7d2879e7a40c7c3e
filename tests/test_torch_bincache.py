"""The port's layout cache against the JAX package's, on the CPU.

- An entry round-trips: the same arrays (dtype, shape, bytes) and meta
  come back as read-only views over the file's mapping.
- A save is atomic (temp file + rename): a prune keeps the newest
  ``PIO_BIN_CACHE_KEEP`` entries, leaves a fresh temp (a save in flight)
  and sweeps a stale one; a torn entry loads as a miss.
- A loaded entry stays valid when the file is pruned while in use.
- ``layout_cache_key`` derives the JAX package's key from the same
  fingerprint and knobs, and the formats agree both ways: an entry the
  JAX engine saved on its binned lane is a hit for the port's
  ``ALSAlgorithm``, which makes no scan and trains exactly the factors
  of a cold bin of the same events (``solver="direct"``, f32); an entry
  the port saved loads in the JAX package.
"""

import datetime as dt
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.models.als import ALSAlgorithm as JaxALSAlgorithm
from predictionio_tpu.models.als import ALSParams as JaxALSParams
from predictionio_tpu.models.als import PreparedRatings as JaxPrepared
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import bincache as jax_bincache
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_tpu.templates.recommendation import (
    BinnedReadRequest as JaxRequest)
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                           PreparedRatings)
from predictionio_torch.ops import als, bincache
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates.recommendation import BinnedReadRequest

torch.set_num_threads(2)

UTC = dt.timezone.utc


def _coo(n=30_000, users=300, items=120, seed=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, users, n), rng.integers(0, items, n),
            (1.0 + 0.5 * rng.integers(0, 9, n)).astype(np.float32))


CFG = dict(rank=8, iterations=2, block_size=256, solver="direct",
           compute_dtype="float32", cg_dtype="float32")


def test_an_entry_round_trips_as_read_only_views(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    rng = np.random.default_rng(0)
    arrays = {"a": rng.integers(0, 255, (37, 5)).astype(np.uint8),
              "b": rng.normal(size=(11,)).astype(np.float32),
              "c": np.arange(7, dtype=np.int32)[::2],     # not contiguous
              "empty": np.zeros((0,), np.uint16)}
    meta = {"n": 3, "affine": [0.5, 0.5], "none": None}
    bincache.save("k", arrays, meta)
    got, got_meta = bincache.load("k")
    assert got_meta == meta
    for name, a in arrays.items():
        np.testing.assert_array_equal(got[name], a)
        assert got[name].dtype == a.dtype and got[name].shape == a.shape
        assert not got[name].flags.writeable
    assert bincache.load("missing") is None
    # the JAX package reads the same file
    jax_arrays, jax_meta = jax_bincache.load("k")
    assert jax_meta == meta
    for name, a in arrays.items():
        np.testing.assert_array_equal(jax_arrays[name], a)


def test_save_is_atomic_and_prune_skips_fresh_temps(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    monkeypatch.setenv("PIO_BIN_CACHE_KEEP", "2")
    a = {"x": np.arange(100, dtype=np.int32)}
    for k in ("k1", "k2", "k3"):
        bincache.save(k, a, {"k": k})
        os.utime(os.path.join(bincache.cache_dir(), f"{k}.bin"),
                 (1e9 + int(k[1]), 1e9 + int(k[1])))
    bincache._prune(2)
    names = sorted(os.listdir(bincache.cache_dir()))
    assert names == ["k2.bin", "k3.bin"]       # the least recently used went
    fresh = os.path.join(bincache.cache_dir(), "inflight.bin.tmp")
    stale = os.path.join(bincache.cache_dir(), "dead.bin.tmp")
    for path in (fresh, stale):
        with open(path, "wb") as f:
            f.write(b"x")
    os.utime(stale, (4000.0, 4000.0))
    bincache._prune(2)
    assert os.path.exists(fresh)
    assert not os.path.exists(stale)
    # a torn entry (a truncated file put in place by force) is a miss
    bincache.save("torn", a, {})
    path = os.path.join(bincache.cache_dir(), "torn.bin")
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    assert bincache.load("torn") is None
    with open(path, "wb") as f:
        f.write(b"not a cache entry at all")
    assert bincache.load("torn") is None


def test_a_loaded_entry_survives_a_prune_while_in_use(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    u, i, v = _coo()
    cfg = als.ALSConfig(**CFG)
    user = als.build_compressed_side(u, i, v, 300, cfg, 1, None)
    item = als.build_compressed_side(i, u, v, 120, cfg, 1, None)
    als.save_layout("warm", user, item, 300, 120, len(v))
    cached = als.load_layout("warm")
    assert cached is not None and cached.vocabs is None
    os.remove(os.path.join(bincache.cache_dir(), "warm.bin"))
    assert als.load_layout("warm") is None
    trainer = als.ALSTrainer.from_cache(cached, cfg, device="cpu")
    assert trainer.cache_hit and trainer.load_sec == cached.load_sec
    got = trainer.run()
    want = als.ALSTrainer((u, i, v), 300, 120, cfg, device="cpu").run()
    np.testing.assert_array_equal(want.user_factors, got.user_factors)
    np.testing.assert_array_equal(want.item_factors, got.item_factors)


@pytest.mark.parametrize("knobs", [
    {}, {"seg_len": 32, "block_size": 512, "rank": 16},
    {"max_u": 50, "max_i": None}])
def test_layout_cache_key_is_the_jax_key(knobs):
    caps = (knobs.pop("max_u", None), knobs.pop("max_i", None))
    got = als.layout_cache_key("L1-g0-b9-n9-t0|reco", als.ALSConfig(**knobs),
                               1, *caps)
    want = jax_als.layout_cache_key("L1-g0-b9-n9-t0|reco",
                                    jax_als.ALSConfig(**knobs), 1, *caps)
    assert got == want
    assert got != als.layout_cache_key("L1-g0-b9-n9-t0|reco",
                                       als.ALSConfig(**knobs), 2, *caps)


def _events(cls, n_users=60, n_items=30, n=2500, seed=11):
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    return [cls(event="rate", entity_type="user",
                entity_id=f"u{rng.integers(0, n_users)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.integers(0, n_items)}",
                properties={"rating": float(rng.integers(1, 11)) / 2},
                event_time=t0 + dt.timedelta(seconds=j)) for j in range(n)]


def _el_env(path):
    return {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(path)}


def _request(cls):
    return cls(app_name="reco", channel_name=None, entity_type="user",
               event_names=["rate", "buy"], target_entity_type="item",
               value_property="rating", overrides={"buy": 4.0})


def test_an_entry_the_jax_engine_saved_trains_the_port(tmp_path,
                                                       monkeypatch):
    """One fingerprint string keys both packages' entries (the stores'
    own fingerprints hash their log paths, which differ here)."""
    fingerprint = "shared-fingerprint|reco|rate|buy|4.0|True"
    params = dict(rank=8, num_iterations=3, lambda_=0.05, block_size=64,
                  solver="direct", compute_dtype="float32",
                  cg_dtype="float32")
    jax_storage = JaxStorage.from_env(_el_env(tmp_path / "jax"))
    jax_storage.apps().insert("reco")
    jax_storage.events().init(1)
    jax_storage.events().insert_batch(_events(JaxEvent), 1)
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc-jax"))
    jax_set_storage(jax_storage)
    try:
        JaxALSAlgorithm(JaxALSParams(**params)).train(
            MeshContext(), JaxPrepared(binned_request=_request(JaxRequest),
                                       fingerprint=fingerprint))
    finally:
        jax_set_storage(None)
        jax_storage.events().close()
    assert len(list((tmp_path / "bc-jax").glob("*.bin"))) == 1

    storage = Storage.from_env(_el_env(tmp_path / "port"))
    storage.apps().insert("reco")
    storage.events().init(1)
    storage.events().insert_batch(_events(Event), 1)
    set_storage(storage)
    try:
        def train(cache_dir):
            monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(cache_dir))
            algo = ALSAlgorithm(ALSParams(**params))
            model = algo.train(DeviceContext("cpu"), PreparedRatings(
                binned_request=_request(BinnedReadRequest),
                fingerprint=fingerprint))
            return algo.last_train, model

        warm_info, warm = train(tmp_path / "bc-jax")
        assert warm_info["cache_hit"] and warm_info["lane"] == "binned"
        assert storage.events().bin_columnar_calls == 0
        cold_info, cold = train(tmp_path / "bc-port")
        assert not cold_info["cache_hit"]
        assert storage.events().bin_columnar_calls == 1
    finally:
        set_storage(None)
        storage.events().close()
    assert list(warm.user_ids.keys()) == list(cold.user_ids.keys())
    assert list(warm.item_ids.keys()) == list(cold.item_ids.keys())
    np.testing.assert_array_equal(warm.user_factors, cold.user_factors)
    np.testing.assert_array_equal(warm.item_factors, cold.item_factors)

    # the port's entry (with its vocabularies) loads in the JAX package
    key = als.layout_cache_key(fingerprint, als.ALSConfig(
        rank=8, block_size=64), 1)
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc-port"))
    arrays, meta = jax_bincache.load(key)
    port = als.load_layout(key)
    for prefix, side in (("u_", port.user_side), ("i_", port.item_side)):
        theirs = jax_als.SideLayout.from_arrays(arrays, prefix, meta)
        np.testing.assert_array_equal(theirs.idx_lo, side.idx_lo)
        np.testing.assert_array_equal(theirs.val, side.val)
        np.testing.assert_array_equal(theirs.seg, side.seg)
        np.testing.assert_array_equal(theirs.counts, side.counts)
        assert theirs.affine == side.affine
    assert port.vocabs == (list(cold.user_ids.keys()),
                           list(cold.item_ids.keys()))
