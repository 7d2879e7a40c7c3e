"""Mid-training checkpoint/resume (``core/checkpoint.py``) of the port,
on the CPU, mirroring the JAX package's ``tests/test_checkpoint.py``.

- The checkpointer: atomic writes, two kept, a torn newest file falling
  back to the one before, a fingerprint mismatch starting fresh, and a
  ``torch.distributed`` world of more than one process refused.
- Two-tower resume: a run stopped after epoch 1 (or 2) and resumed from
  its checkpoint gives tables, Adagrad accumulators, dense weights,
  AdamW state and losses EQUAL, bit for bit, to an uninterrupted run's
  (the epoch-order generator's state travels with the checkpoint); a
  changed config or changed data starts fresh; a checkpoint written on
  a card does not restore on the CPU.
- ``train_fingerprint`` gives the JAX function's digest for the same
  parts (a torch tensor hashes as its numpy array), and a checkpoint
  directory the JAX trainer wrote is skipped as another run, read
  without importing anything of the JAX package.
"""

import dataclasses
import json
import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from predictionio_tpu.core.checkpoint import (
    train_fingerprint as jax_train_fingerprint)
from predictionio_tpu.ops.twotower import TwoTowerConfig as JaxConfig
from predictionio_tpu.ops.twotower import TwoTowerTrainer as JaxTrainer
from predictionio_torch.core import checkpoint
from predictionio_torch.core.checkpoint import (TrainCheckpointer,
                                                train_fingerprint)
from predictionio_torch.ops.twotower import TwoTowerConfig, TwoTowerTrainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checkpointer_atomicity_and_retention(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), every=2, keep=2)
    assert ck.restore() is None
    assert ck.maybe_save(1, {"a": 1}) is False      # not due
    assert ck.maybe_save(2, {"a": 2}) is True
    assert ck.maybe_save(4, {"a": 4}) is True
    assert ck.maybe_save(6, {"a": 6}) is True       # evicts epoch 2
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt_4.pkl", "ckpt_6.pkl"]
    assert ck.restore() == (6, {"a": 6})


def test_torn_newest_checkpoint_falls_back_to_the_previous(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), fingerprint="fp")
    ck.maybe_save(1, {"t": torch.arange(3.0)})
    ck.maybe_save(2, {"t": torch.arange(4.0)})
    (tmp_path / "ckpt_2.pkl").write_bytes(b"torn")
    epoch, state = ck.restore()
    assert epoch == 1
    # tensors come back as host numpy arrays, by value
    assert isinstance(state["t"], np.ndarray)
    np.testing.assert_array_equal(state["t"], np.arange(3.0, dtype=np.float32))
    # no .tmp file is left behind by a completed write
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_fingerprint_mismatch_starts_fresh_with_a_warning(tmp_path, caplog):
    TrainCheckpointer(str(tmp_path), fingerprint="a").maybe_save(1, {"x": 1})
    with caplog.at_level(logging.WARNING, logger=checkpoint.__name__):
        assert TrainCheckpointer(str(tmp_path), fingerprint="b").restore() \
            is None
    assert "different run" in caplog.text


def test_a_distributed_world_raises_naming_its_roadmap_item(tmp_path,
                                                            monkeypatch):
    ck = TrainCheckpointer(str(tmp_path))
    monkeypatch.setattr(checkpoint.multihost, "process_count", lambda: 2)
    for call in (lambda: ck.maybe_save(1, {}), ck.restore):
        with pytest.raises(NotImplementedError, match=r"queue 1 item 12\)"):
            call()


def _toy_data(n=400, n_users=30, n_items=12, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_users, n), rng.integers(0, n_items, n)


CONFIGS = {
    # the default tail (normalization only) and the bf16 products
    "plain": dict(dim=8, epochs=4, batch_size=64, seed=5),
    # a tail MLP under AdamW, f32
    "mlp": dict(dim=8, hidden=(16,), epochs=4, batch_size=64, seed=5,
                compute_dtype="float32"),
    # the loss kernel's plain version (batch >= 128: eligible)
    "kernel": dict(dim=8, epochs=3, batch_size=128, seed=7,
                   flash_ce_kernel="on"),
}


def _assert_same_state(a: TwoTowerTrainer, b: TwoTowerTrainer) -> None:
    for side in ("user", "item"):
        assert torch.equal(a.tables[side], b.tables[side]), side
        assert torch.equal(a.acc[side], b.acc[side]), side
        for la, lb in zip(a.dense[side], b.dense[side]):
            for k in la:
                assert torch.equal(la[k], lb[k]), (side, k)
    if a._opt is not None:
        sa, sb = a._opt.state_dict()["state"], b._opt.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for k in sa:
            for name in sa[k]:
                assert torch.equal(sa[k][name], sb[k][name]), (k, name)
    assert torch.equal(a._perm_gen.get_state(), b._perm_gen.get_state())


@pytest.mark.parametrize("stop_after", [1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_twotower_resume_equals_an_uninterrupted_run(tmp_path, config,
                                                     stop_after):
    u, i = _toy_data()
    kw = CONFIGS[config]
    straight = TwoTowerTrainer((u, i, None), 30, 12, TwoTowerConfig(**kw),
                               device="cpu")
    losses_straight = straight.run()

    cfg = TwoTowerConfig(**kw, checkpoint_dir=str(tmp_path / "tt"))
    first = TwoTowerTrainer((u, i, None), 30, 12, cfg, device="cpu")
    first.run(epochs=stop_after)            # the "crash"
    assert len(first.checkpoint_seconds) == stop_after
    resumed = TwoTowerTrainer((u, i, None), 30, 12, cfg, device="cpu")
    assert resumed._epochs_done == stop_after
    # what was restored is what the first run saved
    _assert_same_state(resumed, first)
    losses_resumed = resumed.run()
    assert losses_resumed == losses_straight
    _assert_same_state(resumed, straight)
    np.testing.assert_array_equal(resumed.embeddings().item_vecs,
                                  straight.embeddings().item_vecs)
    assert sorted(os.listdir(tmp_path / "tt")) == [
        f"ckpt_{e}.pkl" for e in (kw["epochs"] - 1, kw["epochs"])]


def test_fingerprint_guards_stale_and_wrong_shape(tmp_path):
    """A checkpoint of other data or another config is ignored: no stale
    model, no wrong-shape table."""
    u, i = _toy_data()
    ckdir = str(tmp_path / "fp")
    cfg = TwoTowerConfig(dim=8, epochs=2, batch_size=64, seed=5,
                         checkpoint_dir=ckdir)
    t1 = TwoTowerTrainer((u, i, None), 30, 12, cfg, device="cpu")
    t1.run()
    assert t1._epochs_done == 2
    # same data and config: resuming to completion is the right result
    assert TwoTowerTrainer((u, i, None), 30, 12, cfg,
                           device="cpu")._epochs_done == 2
    # new data: fresh
    u2, i2 = _toy_data(seed=99)
    assert TwoTowerTrainer((u2, i2, None), 30, 12, cfg,
                           device="cpu")._epochs_done == 0
    # a grown catalog never adopts the 12-item table
    grown = TwoTowerTrainer((u, i, None), 30, 20, cfg, device="cpu")
    assert grown._epochs_done == 0
    assert grown.tables["item"].shape[0] == 20
    assert grown.run()
    # a changed config: fresh
    assert TwoTowerTrainer((u, i, None), 30, 12,
                           dataclasses.replace(cfg, temperature=0.1),
                           device="cpu")._epochs_done == 0


def test_a_card_checkpoint_does_not_restore_on_the_cpu(tmp_path):
    """The epoch-order generator's state belongs to its device type: a
    checkpoint a trainer on a card wrote raises on the CPU rather than
    resume on other orders."""
    u, i = _toy_data()
    cfg = TwoTowerConfig(dim=8, epochs=2, batch_size=64, seed=5,
                         checkpoint_dir=str(tmp_path))
    TwoTowerTrainer((u, i, None), 30, 12, cfg, device="cpu").run(epochs=1)
    path = tmp_path / "ckpt_1.pkl"
    doc = pickle.loads(path.read_bytes())
    assert doc["state"]["perm_gen_device"] == "cpu"
    doc["state"]["perm_gen_device"] = "cuda"
    path.write_bytes(pickle.dumps(doc))
    with pytest.raises(ValueError, match="written by a trainer on cuda"):
        TwoTowerTrainer((u, i, None), 30, 12, cfg, device="cpu")


@dataclasses.dataclass(frozen=True)
class _Cfg:
    rank: int = 4
    name: str = "x"


PARTS = {
    "int": (7, 7),
    "str": ("predictionio_torch", "predictionio_torch"),
    "float": (0.07, 0.07),
    "none": (None, None),
    "tuple": ((1, "a", 2.5), (1, "a", 2.5)),
    "dataclass": (_Cfg(), _Cfg()),
    "int64 array": (np.arange(10, dtype=np.int64),) * 2,
    "float32 2-d array": (np.ones((3, 4), np.float32) / 3,) * 2,
    "non-contiguous array": (np.arange(20, dtype=np.int32)[::3],) * 2,
    "tensor": (torch.arange(10, dtype=torch.int64),
               np.arange(10, dtype=np.int64)),
    "float tensor": (torch.tensor(np.linspace(0, 1, 7, dtype=np.float32)),
                     np.linspace(0, 1, 7, dtype=np.float32)),
}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_train_fingerprint_equals_jax(part):
    ours, theirs = PARTS[part]
    assert train_fingerprint(ours, 3) == jax_train_fingerprint(theirs, 3)


def test_twotower_config_fingerprints_as_in_jax():
    """The port's config prints as the JAX package's: one digest, until
    the port's trainer adds its own part."""
    kw = dict(dim=8, epochs=2, batch_size=64, seed=5)
    assert (train_fingerprint(TwoTowerConfig(**kw))
            == jax_train_fingerprint(JaxConfig(**kw)))


def test_a_jax_checkpoint_directory_is_skipped_as_another_run(tmp_path,
                                                              caplog):
    u, i = _toy_data()
    ckdir = str(tmp_path / "jax")
    kw = dict(dim=8, epochs=2, batch_size=64, seed=5, checkpoint_dir=ckdir)
    JaxTrainer((u, i, None), 30, 12, JaxConfig(**kw)).run(epochs=1)
    assert os.listdir(ckdir) == ["ckpt_1.pkl"]
    with caplog.at_level(logging.WARNING, logger=checkpoint.__name__):
        port = TwoTowerTrainer((u, i, None), 30, 12, TwoTowerConfig(**kw),
                               device="cpu")
    assert port._epochs_done == 0
    assert "different run" in caplog.text
    # read with the JAX package and optax out of reach: the file's
    # foreign classes load as placeholders, the fingerprint differs
    code = (
        "import sys, json\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax',\n"
        "                                  'flax', 'predictionio_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from predictionio_torch.core.checkpoint import TrainCheckpointer\n"
        f"ck = TrainCheckpointer({ckdir!r}, fingerprint='port')\n"
        "print(json.dumps({'restored': ck.restore() is not None}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "restored": False}
    assert "different run" in proc.stderr
