"""The ALS trainer's put, its completion stamps and its gather roof
probe, on the CPU, against the one-shot put and the JAX trainer.

- ``ChunkedPut`` gives tensors equal to a one-shot copy for arrays
  smaller than, equal to and several times the chunk, with a ragged last
  chunk, rows larger than a chunk, every wire dtype and both ranks.
- A trainer put in chunks (``PIO_BIN_CHUNK_MB``) holds device tensors
  bit-identical to the one-shot put's (``PIO_TRANSFER_DOUBLE_BUFFER=0``)
  and trains the same factors bit for bit, over coded and uncoded
  layouts, indexes past 2^16 and a layout cache entry's read-only
  mapping.
- ``wait_device_timed`` returns one ordered stamp a side, as the JAX
  trainer's does, and notes the transfer stage once;
  ``measure_gather_roof`` returns the JAX probe's keys, and the same
  ``slots_per_iteration``, over the same COO and config.

Both packages read ``PIO_BIN_CHUNK_MB`` and ``PIO_TRANSFER_DOUBLE_BUFFER``:
they are set with ``monkeypatch`` only, under ``shared_env_unchanged``.
"""

import math

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_torch.obs import perfacct
from predictionio_torch.ops import als

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.mark.parametrize("shape,dtype,chunk_bytes,chunks", [
    ((10, 4), np.float32, 160, 0),        # equal to a chunk: one-shot
    ((10, 4), np.float32, 1000, 0),       # smaller
    ((40, 5), np.uint8, 50, 4),           # four chunks exactly
    ((37, 3), np.int16, 60, 4),           # ragged last chunk (10 rows each)
    ((9,), np.int32, 8, 5),               # 1-D: two rows a chunk
    ((6, 100), np.uint8, 30, 6),          # a row larger than a chunk
    ((1, 64), np.float32, 16, 0),         # one row: one-shot
])
def test_chunked_put_equals_the_one_shot_copy(shape, dtype, chunk_bytes,
                                              chunks):
    rng = np.random.default_rng(0)
    a = (rng.integers(-100, 100, size=shape).astype(dtype)
         if np.dtype(dtype).kind in "iu" else
         rng.normal(size=shape).astype(dtype))
    stager = als.ChunkedPut(CPU, chunk_bytes)
    got = stager.put(a)
    want = torch.from_numpy(a)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert stager.chunks == chunks
    assert stager.done() is None


def test_chunked_put_reuses_its_two_staging_buffers():
    stager = als.ChunkedPut(CPU, 100)
    a = np.arange(1000, dtype=np.uint8)
    b = np.arange(700, dtype=np.int32).reshape(350, 2)
    assert torch.equal(stager.put(a), torch.from_numpy(a))
    bufs = [t.data_ptr() for t in stager._bufs]
    assert torch.equal(stager.put(b), torch.from_numpy(b))
    assert [t.data_ptr() for t in stager._bufs] == bufs
    assert stager.chunks == 10 + 30      # 12 rows of 8 bytes a chunk


@pytest.mark.parametrize("chunk_mb", ["0", "-1"])
def test_a_chunk_of_zero_bytes_is_the_one_shot_put(monkeypatch, chunk_mb):
    monkeypatch.setenv("PIO_BIN_CHUNK_MB", chunk_mb)
    assert als.put_chunk_bytes() == 0


def test_the_put_reads_the_jax_packages_names_and_default(monkeypatch):
    monkeypatch.delenv("PIO_BIN_CHUNK_MB", raising=False)
    monkeypatch.delenv("PIO_TRANSFER_DOUBLE_BUFFER", raising=False)
    assert als.put_chunk_bytes() == int(jax_als._DEFAULT_CHUNK_MB * 1e6)
    monkeypatch.setenv("PIO_BIN_CHUNK_MB", "0.5")
    assert als.put_chunk_bytes() == 500_000
    monkeypatch.setenv("PIO_TRANSFER_DOUBLE_BUFFER", "0")
    assert als.put_chunk_bytes() == 0


def _ratings(n_users=300, n_items=200, nnz=6000, seed=0, halfstar=True):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.zipf(1.3, nnz) % n_items
    r = 3.0 + rng.normal(0, 1.0, nnz)
    if halfstar:
        r = np.clip(np.round(r * 2.0) / 2.0, 0.5, 5.0)
    else:
        r = np.clip(r, 0.5, 5.0) + rng.uniform(0, 1e-3, nnz)
    return u, i, r.astype(np.float32)


def _device_arrays(trainer):
    return [t for side in trainer.sides()
            for t in (side.idx, side.val, side.mask, side.seg, side.counts)
            if t is not None]


def _train(monkeypatch, coo, n_users, n_items, cfg, chunk_mb):
    """A trainer put with ``chunk_mb`` (None: the one-shot put) and run;
    -> (trainer, factors)."""
    if chunk_mb is None:
        monkeypatch.setenv("PIO_TRANSFER_DOUBLE_BUFFER", "0")
        monkeypatch.delenv("PIO_BIN_CHUNK_MB", raising=False)
    else:
        monkeypatch.delenv("PIO_TRANSFER_DOUBLE_BUFFER", raising=False)
        monkeypatch.setenv("PIO_BIN_CHUNK_MB", chunk_mb)
    trainer = als.ALSTrainer(coo, n_users, n_items, cfg, device="cpu")
    return trainer, trainer.run()


@pytest.mark.parametrize("halfstar,n_items", [
    (True, 200),             # coded uint8 values, lo-uint16 indexes
    (False, 200),            # f32 values + mask
    (True, 70_000),          # indexes past 2^16: idx_hi
])
def test_chunked_trainer_put_is_bit_identical_to_the_one_shot_put(
        monkeypatch, halfstar, n_items):
    u, i, r = _ratings(halfstar=halfstar)
    i = (i * 337) % n_items
    cfg = als.ALSConfig(rank=8, iterations=2, block_size=64)
    one, f_one = _train(monkeypatch, (u, i, r), 300, n_items, cfg, None)
    assert one.put_chunks == 0
    # 0.002 MB: every array of more than 2,000 bytes in chunks, the
    # last one ragged; 0.02 MB: the index streams in chunks, the rest
    # in one piece
    for chunk_mb in ("0.002", "0.02"):
        got, f_got = _train(monkeypatch, (u, i, r), 300, n_items, cfg,
                            chunk_mb)
        assert got.put_chunks > 0
        assert got.transfer_bytes == one.transfer_bytes
        for a, b in zip(_device_arrays(got), _device_arrays(one)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(f_got.user_factors, f_one.user_factors)
        np.testing.assert_array_equal(f_got.item_factors, f_one.item_factors)


def test_chunked_put_of_a_cache_entrys_mapping(monkeypatch, tmp_path):
    """The warm lane's source, a layout cache entry's read-only mapping,
    goes through the staging buffers to the same tensors."""
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    u, i, r = _ratings(seed=3)
    cfg = als.ALSConfig(rank=8, iterations=1, block_size=64)
    key = als.layout_cache_key("fp-transfer", cfg, 1)
    monkeypatch.setenv("PIO_TRANSFER_DOUBLE_BUFFER", "0")
    one = als.ALSTrainer((u, i, r), 300, 200, cfg, device="cpu",
                         cache_key="fp-transfer")
    cached = als.load_layout(key)
    assert cached is not None
    assert not cached.user_side.idx_lo.flags.writeable
    monkeypatch.delenv("PIO_TRANSFER_DOUBLE_BUFFER")
    monkeypatch.setenv("PIO_BIN_CHUNK_MB", "0.001")
    warm = als.ALSTrainer.from_cache(cached, cfg, device="cpu")
    assert warm.cache_hit and warm.put_chunks > 0
    for a, b in zip(_device_arrays(warm), _device_arrays(one)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(warm.run().item_factors,
                                  one.run().item_factors)


def test_wait_device_timed_gives_one_ordered_stamp_a_side_like_jax(
        monkeypatch):
    monkeypatch.setenv("PIO_BIN_CHUNK_MB", "0.002")
    u, i, r = _ratings(seed=5)
    cfg = als.ALSConfig(rank=8, iterations=1, block_size=64)
    perfacct.LEDGER.start_run("test-wait-device-timed")
    trainer = als.ALSTrainer((u, i, r), 300, 200, cfg, device="cpu")
    stages = perfacct.LEDGER.snapshot()["runs"][-1]["stages"]
    stamps = trainer.wait_device_timed()
    ref = jax_als.ALSTrainer((u, i, r), 300, 200, jax_als.ALSConfig(
        rank=8, iterations=1, block_size=64))
    assert len(stamps) == len(ref.wait_device_timed()) == 2
    assert trainer.put_start <= stamps[0] <= stamps[1]
    # one (end of issue, bytes) entry a side, as JAX's _put_log
    assert [b for _, b in trainer._put_log] == [b for _, b in ref._put_log]
    assert trainer._put_log[0][0] <= trainer._put_log[1][0] <= stamps[1]
    # the stage was noted once, at set-up, within the put's seconds
    assert stages["transfer"] == round(trainer.transfer_sec, 4)
    assert 0.0 <= trainer.transfer_sec <= trainer.put_sec
    assert perfacct.LEDGER.snapshot()["runs"][-1]["stages"][
        "transfer"] == stages["transfer"]
    assert trainer._stager is None   # the staging buffers are let go


@pytest.mark.parametrize("halfstar", [True, False])
def test_gather_roof_has_the_jax_probes_keys_and_slots(halfstar):
    u, i, r = _ratings(seed=7, halfstar=halfstar)
    cfg = dict(rank=8, iterations=1, block_size=64)
    trainer = als.ALSTrainer((u, i, r), 300, 200, als.ALSConfig(**cfg),
                             device="cpu")
    ref = jax_als.ALSTrainer((u, i, r), 300, 200, jax_als.ALSConfig(**cfg))
    got = trainer.measure_gather_roof(reps=2)
    want = ref.measure_gather_roof(reps=2)
    assert set(got) == set(want)
    assert got["slots_per_iteration"] == want["slots_per_iteration"]
    user, item = trainer.sides()
    assert got["slots_per_iteration"] == (user.idx.numel()
                                          + item.idx.numel())
    assert got["roof_kernel_sec"] > 0.0
    assert math.isclose(got["roof_slots_per_sec"],
                        user.idx.numel() / got["roof_kernel_sec"])


def test_gather_roof_raises_on_a_non_finite_table():
    u, i, r = _ratings(seed=8)
    trainer = als.ALSTrainer((u, i, r), 300, 200,
                             als.ALSConfig(rank=8, block_size=64),
                             device="cpu")
    trainer.Y[0, 0] = float("nan")
    trainer.Y[1:] = trainer.Y[0]
    with pytest.raises(RuntimeError, match="not finite"):
        trainer.measure_gather_roof()
