"""``pio train``'s profile capture on the port (``PIO_PROFILE_DIR``,
``workflow/train.py``, ``obs/profiler.py``) against the JAX package's,
on the CPU.

- ``per_step`` equals JAX's on the same parsed dicts, the ``None``
  cases (no steps, no device time) included.
- ``_log_step_breakdown`` logs JAX's messages with JAX's ``extra`` keys
  and writes the same ``breakdown.json``, each package's breakdown
  source patched to give the same dict (JAX's parse runs in a
  subprocess: ``subprocess.run`` is patched to answer its JSON line).
- ``run_train`` under ``PIO_PROFILE_DIR`` writes ``trace.json`` and
  ``breakdown.json`` under ``<dir>/<instance id>`` with JAX's keys: the
  two-tower train per step (the CPU operators' time, ``device: cpu``),
  ALS, which counts no step, as the total; the model equals the
  unprofiled run's bit for bit.
- The steps a capture divides by equal JAX's count for the same session
  and two-tower trains: the session trainer's steps, the two-tower
  trainer's epochs.
- A train under an open capture window (``ProfilerBusy``) and a train
  whose breakdown fails both complete, unprofiled or unparsed.

No JAX train runs under ``PIO_PROFILE_DIR`` here (JAX's own
``tests/test_workflow.py`` covers that train).
"""

import dataclasses
import json
import logging
import os
import pickle
import subprocess

import numpy as np
import pytest
import torch

from predictionio_tpu.obs import jaxmon
from predictionio_tpu.obs import profiler as jax_profiler
from predictionio_tpu.ops import sessionrec as jax_sr
from predictionio_tpu.ops.twotower import TwoTowerConfig as JaxConfig
from predictionio_tpu.ops.twotower import TwoTowerTrainer as JaxTrainer
from predictionio_tpu.workflow import train as jax_train
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.obs import profiler, torchmon
from predictionio_torch.ops import sessionrec as sr
from predictionio_torch.ops import twotower as tt
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates.recommendation import recommendation_engine
from predictionio_torch.templates.twotower import twotower_engine
from predictionio_torch.workflow import train as port_train
from predictionio_torch.workflow.train import run_train

from tests.test_torch_sessionrec import (JAX_CFG, _cyclic_events, _np_tree,
                                         _port_cfg, jitted_flax_init)
from tests.test_torch_twotower import _positives, _seed_block_events
from tests.torch_env_guard import shared_env_unchanged  # noqa: F401
from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

TT_VARIANT = {
    "engineFactory": "predictionio_torch.templates.twotower.twotower_engine",
    "datasource": {"name": "", "params": {"app_name": "pc-app"}},
    "algorithms": [{"name": "twotower", "params": {
        "dim": 8, "epochs": 3, "batch_size": 64, "learning_rate": 1e-2,
        "min_rating": 3.0}}],
}
ALS_VARIANT = {
    "engineFactory": ("predictionio_torch.templates.recommendation."
                      "recommendation_engine"),
    "datasource": {"name": "", "params": {"app_name": "pc-app"}},
    "algorithms": [{"name": "als", "params": {"rank": 4,
                                              "num_iterations": 2}}],
}
#: JAX's breakdown record, per step (``per_step`` + ``trace``)
JAX_STEP_KEYS = {"steps", "device_ms_per_step", "by_category_ms_per_step",
                 "trace"}


@pytest.fixture()
def store():
    """A memory store holding the two-block events, the process's
    storage for the test (the data source reads it)."""
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    _seed_block_events(storage, Event, "pc-app")
    set_storage(storage)
    yield storage
    set_storage(None)


def _train(storage, variant, engine_id="pc"):
    engine = (twotower_engine() if "twotower" in variant["engineFactory"]
              else recommendation_engine())
    instance = run_train(engine, engine.engine_params_from_variant(variant),
                         engine_id=engine_id, ctx=DeviceContext("cpu"),
                         storage=storage)
    assert instance.status == "COMPLETED"
    model = pickle.loads(storage.models().get(instance.id).models)[0]
    return instance, model


PARSED = {"device_time_sec": 0.0123,
          "by_category": {"flash_ce_kernel_bf16": {"time_frac": 0.631},
                          "embed_update_kernel": {"time_frac": 0.05},
                          "Memset (Device)": {"time_frac": 0.319}}}


@pytest.mark.parametrize("parsed,steps", [
    (PARSED, 6), (PARSED, 1), (PARSED, 0), (PARSED, -2),
    ({**PARSED, "device_time_sec": 0.0}, 6),
    ({"device_time_sec": 1.23456789}, 7),
    ({"device_time_sec": 2.5, "by_category": None}, 3),
    ({"device_time_sec": 0.0004,
      "by_category": {"a": {"time_frac": 0.333}}}, 3),
    ({}, 4),
], ids=["six", "one", "no-steps", "negative", "no-device-time",
        "no-categories", "null-categories", "rounding", "empty"])
def test_per_step_equals_jax(parsed, steps):
    assert profiler.per_step(parsed, steps) == jax_profiler.per_step(
        parsed, steps)


@pytest.mark.parametrize("steps,breakdown", [
    (6, {"steps": 6, "device_ms_per_step": 2.05,
         "by_category_ms_per_step": {"flash_ce_kernel_bf16": 1.2935},
         "trace": {"device_time_sec": 0.0123}}),
    (0, {"device_time_sec": 0.75,
         "by_category": {"aten::mm": {"time_frac": 0.6}}}),
    (3, {"error": "no per-step breakdown"}),
], ids=["per-step", "total", "error"])
def test_log_step_breakdown_logs_and_writes_like_jax(
        monkeypatch, tmp_path, caplog, steps, breakdown):
    """The same breakdown through both packages' ``_log_step_breakdown``:
    the same log record (message and ``pio`` extra) and the same
    ``breakdown.json`` (none for an error)."""
    line = json.dumps(breakdown) + "\n"
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: (
        subprocess.CompletedProcess(cmd, 0, stdout=line, stderr="")))
    monkeypatch.setattr(profiler, "step_breakdown",
                        lambda capture, n: json.loads(line))
    monkeypatch.setattr(profiler, "parse_capture",
                        lambda capture: json.loads(line))
    out = str(tmp_path)
    written = {}
    records = {}
    for name, call in (("jax", lambda: jax_train._log_step_breakdown(
            out, steps)), ("port", lambda: port_train._log_step_breakdown(
                out, steps, {"summary": {}}))):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            call()
        records[name] = [(r.levelname, r.getMessage(),
                          getattr(r, "pio", None)) for r in caplog.records
                         if r.name.endswith("workflow.train")]
        path = tmp_path / "breakdown.json"
        written[name] = path.read_text() if path.exists() else None
        if path.exists():
            path.unlink()
    assert records["port"] == records["jax"]
    assert len(records["port"]) == 1
    assert written["port"] == written["jax"]
    assert (written["port"] is None) == ("error" in breakdown)


def test_run_train_writes_breakdown_json_with_jaxs_keys(
        monkeypatch, tmp_path, store, caplog):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    with caplog.at_level(logging.INFO,
                         logger="predictionio_torch.workflow.train"):
        instance, _ = _train(store, TT_VARIANT)
    out = tmp_path / "prof" / instance.id
    assert (out / "trace.json").exists()
    got = json.loads((out / "breakdown.json").read_text())
    want_keys = set(jax_profiler.per_step(PARSED, 3)) | {"trace"}
    assert set(got) == want_keys == JAX_STEP_KEYS
    assert got["steps"] == 3                       # one a two-tower epoch
    assert got["trace"]["device"] == "cpu"
    assert got["trace"]["device_time_sec"] > 0
    assert 0 < len(got["trace"]["by_category"]) <= 8
    # sort_keys writes the categories by name; their shares add up
    fracs = [v["time_frac"] for v in got["trace"]["by_category"].values()]
    assert 0 < sum(fracs) <= 1.0 + 8 * 5e-4
    assert all(v["launches"] >= 1
               for v in got["trace"]["by_category"].values())
    assert set(got["trace"]["by_category"]) <= set(got["trace"]["launches"])
    assert set(got["by_category_ms_per_step"]) == set(
        got["trace"]["by_category"])
    assert got == {**profiler.per_step(got["trace"], 3),
                   "trace": got["trace"]}
    assert ("train device time: %.3f ms/step over %d step(s)"
            % (got["device_ms_per_step"], 3)) in caplog.text


def test_als_counts_no_step_and_logs_the_total(monkeypatch, tmp_path, store,
                                               caplog):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    with caplog.at_level(logging.INFO,
                         logger="predictionio_torch.workflow.train"):
        instance, _ = _train(store, ALS_VARIANT)
    got = json.loads((tmp_path / "prof" / instance.id /
                      "breakdown.json").read_text())
    # JAX's steps == 0 branch: the parsed trace itself, its total logged
    assert {"device_time_sec", "by_category"} <= set(got)
    assert "steps" not in got and got["device"] == "cpu"
    assert ("train device time: %.3f s total (no per-step timings "
            "observed)" % got["device_time_sec"]) in caplog.text


@pytest.mark.parametrize("variant", [TT_VARIANT, ALS_VARIANT],
                         ids=["twotower", "als"])
def test_the_profiled_model_equals_the_unprofiled_one(monkeypatch, tmp_path,
                                                      store, variant):
    _, plain = _train(store, variant, "plain")
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    instance, profiled = _train(store, variant, "profiled")
    assert (tmp_path / "prof" / instance.id / "breakdown.json").exists()
    assert np.array_equal(profiled.user_factors, plain.user_factors)
    assert np.array_equal(profiled.item_factors, plain.item_factors)


def test_session_steps_equal_jaxs_count():
    """JAX's capture divides by its ``pio_train_step_seconds``
    observations: one a session step. The port counts the same steps."""
    users, items, times = _cyclic_events(n_users=50, n_items=12, hist=12,
                                         seed=1)
    cfg = dataclasses.replace(JAX_CFG, epochs=2)
    with jitted_flax_init():
        jt = jax_sr.SessionRecTrainer((users, items, times), 50, 12, cfg)
    port = sr.SessionRecTrainer((users, items, times), 50, 12,
                                _port_cfg(cfg), device="cpu",
                                params=_np_tree(jt._params))
    jax_before = jaxmon.TRAIN_STEP_SECONDS.labels().count
    jt.run()
    jax_steps = jaxmon.TRAIN_STEP_SECONDS.labels().count - jax_before
    port_before = torchmon.train_steps()
    port.run()
    assert torchmon.train_steps() - port_before == jax_steps == 6


def test_twotower_steps_equal_jaxs_count():
    """The JAX two-tower trainer observes one dispatch an epoch; the port
    counts one step an epoch."""
    u, i, n_users, n_items = _positives()
    base = dict(dim=8, epochs=3, batch_size=128, seed=7, learning_rate=1e-2,
                compute_dtype="float32")
    ref = JaxTrainer((u, i, None), n_users, n_items, JaxConfig(**base))
    port = tt.TwoTowerTrainer((u, i, None), n_users, n_items,
                              tt.TwoTowerConfig(**base), device="cpu")
    jax_before = jaxmon.TRAIN_STEP_SECONDS.labels().count
    ref.run()
    jax_steps = jaxmon.TRAIN_STEP_SECONDS.labels().count - jax_before
    port_before = torchmon.train_steps()
    port.run()
    assert torchmon.train_steps() - port_before == jax_steps == 3
    assert port.steps_per_epoch == 5


def test_a_busy_profiler_leaves_the_train_unprofiled(monkeypatch, tmp_path,
                                                     store, caplog):
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    with caplog.at_level(logging.INFO,
                         logger="predictionio_torch.workflow.train"):
        with profiler.trace_capture(str(tmp_path / "window")):
            instance, _ = _train(store, TT_VARIANT)
    assert not (tmp_path / "prof" / instance.id).exists()
    assert "train runs unprofiled" in caplog.text
    assert "already running" in caplog.text
    assert (tmp_path / "window" / "trace.json").exists()


def test_a_failed_breakdown_never_fails_the_train(monkeypatch, tmp_path,
                                                  store, caplog):
    def boom(capture, steps):
        raise RuntimeError("parse failed")

    monkeypatch.setattr(profiler, "step_breakdown", boom)
    monkeypatch.setenv("PIO_PROFILE_DIR", str(tmp_path / "prof"))
    with caplog.at_level(logging.INFO,
                         logger="predictionio_torch.workflow.train"):
        instance, _ = _train(store, TT_VARIANT)
    out = tmp_path / "prof" / instance.id
    assert (out / "trace.json").exists()
    assert not (out / "breakdown.json").exists()
    assert "device-time breakdown unavailable: parse failed" in caplog.text


def test_the_window_probe_reads_the_process_age_and_needs_a_card():
    """``tools/profile_window.py`` measures a capture's lost lead on the
    card only; its process age is this process's."""
    from predictionio_torch.tools import profile_window

    age = profile_window.process_age_sec()
    assert 0.0 < age < 24 * 3600.0
    assert profile_window.process_age_sec() >= age
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            profile_window.lead_loss(markers=2, spacing_ms=1.0)
