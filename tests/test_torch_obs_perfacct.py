"""The port's performance accounting against the JAX package's.

The cost basis is analytic in the port: the two-tower step's FLOPs must
equal the JAX ``twotower_matmul_flops`` and ALS's ``work_model`` the JAX
trainer's, exactly, for the same shapes and data. The session
recommender's formula is held against torch's own FLOP counter over one
training step. MFU from an injected step time equals JAX's for the same
peak (``PIO_PEAK_FLOPS`` in both). The peaks: an H100 takes the rates
``tools/device_time.py`` names, the env overrides them, and any other
device sets no MFU gauge. The data-path ledger and tail attribution are
copies and give the same snapshots and reports.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from predictionio_tpu.obs import perfacct as jax_perfacct
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops.twotower import TwoTowerConfig as JaxTTConfig
from predictionio_tpu.ops.twotower import _tail_widths as jax_tail_widths
from predictionio_torch.obs import metrics, perfacct
from predictionio_torch.ops import als
from predictionio_torch.ops import sessionrec as sr
from predictionio_torch.ops.twotower import (TwoTowerConfig, TwoTowerTrainer,
                                             tail_widths)
from predictionio_torch.tools import device_time

torch.set_num_threads(1)


def _ratings(n_users, n_items, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32),
            (rng.integers(1, 11, n) / 2).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(dim=32), dict(dim=64, embed_dim=96),
                                dict(dim=16, hidden=(24, 40))])
def test_twotower_flops_equal_jax(kw):
    cfg, jax_cfg = TwoTowerConfig(**kw), JaxTTConfig(**kw)
    assert tail_widths(cfg) == jax_tail_widths(jax_cfg)
    for batch in (8, 256, 8192):
        assert perfacct.twotower_matmul_flops(
            batch, cfg.dim, tail_widths(cfg)) == \
            jax_perfacct.twotower_matmul_flops(
                batch, jax_cfg.dim, jax_tail_widths(jax_cfg))
    u, i, _ = _ratings(20, 30, 100)
    trainer = TwoTowerTrainer((u, i, None), 20, 30,
                              TwoTowerConfig(batch_size=16, **kw),
                              device="cpu")
    assert trainer.matmul_flops_per_step() == \
        jax_perfacct.twotower_matmul_flops(16, jax_cfg.dim,
                                           jax_tail_widths(jax_cfg))


@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_als_work_model_equals_jax(solver):
    u, i, r = _ratings(60, 45, 700, seed=3)
    kw = dict(rank=8, iterations=1, solver=solver)
    port = als.ALSTrainer((u, i, r), 60, 45, als.ALSConfig(**kw),
                          device="cpu")
    jax = jax_als.ALSTrainer((u, i, r), 60, 45, jax_als.ALSConfig(**kw))
    assert port.work_model() == jax.work_model()


def test_sessionrec_flops_count_one_step():
    cfg = sr.SessionRecConfig(dim=16, heads=2, layers=2, max_len=8,
                              dropout=0.0, batch_size=4)
    n_items = 25
    enc = sr.SessionEncoder(n_items, cfg)
    seq = torch.randint(1, n_items + 1, (4, cfg.max_len))
    counter = FlopCounterMode(display=False)
    with counter:
        sr.tied_loss(enc, seq, seq, None).backward()
    assert counter.get_total_flops() == perfacct.sessionrec_step_flops(
        4, cfg.max_len, n_items + 1, cfg.dim, cfg.layers, cfg.heads,
        cfg.ffn_mult)


def test_mfu_equals_jax_for_one_peak(monkeypatch):
    monkeypatch.setenv("PIO_PEAK_FLOPS", "4.5e14")
    monkeypatch.setenv("PIO_PEAK_HBM_BYTES", "2.0e12")
    flops = jax_perfacct.twotower_matmul_flops(4096, 128, [128, 128])
    for seconds in (0.0017, 0.25, 3.0):
        assert perfacct.mfu(flops, seconds) == jax_perfacct.mfu(flops,
                                                                seconds)
    port = perfacct.StepAccountant("t-mfu", flops, 3.0e9, device="cpu")
    jax = jax_perfacct.StepAccountant("t-mfu", flops, 3.0e9)
    assert port.observe(0.004, steps=3) == jax.observe(0.004, steps=3)
    gauge = metrics.REGISTRY.get("pio_train_mfu").labels("t-mfu")
    assert gauge.value == port.last_mfu > 0
    assert metrics.REGISTRY.get("pio_roofline_position").labels(
        "t-mfu").value == pytest.approx((flops / 3.0e9) / (4.5e14 / 2.0e12))


def test_h100_peaks_and_their_overrides(monkeypatch):
    monkeypatch.delenv("PIO_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PIO_PEAK_HBM_BYTES", raising=False)
    monkeypatch.setattr(perfacct, "device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert perfacct.peak_flops() == device_time.BF16_FLOPS == 989e12
    assert perfacct.peak_hbm_bytes() == device_time.HBM_BYTES_PER_S
    monkeypatch.setenv("PIO_PEAK_FLOPS", "5e14")
    monkeypatch.setenv("PIO_PEAK_HBM_BYTES", "oops")     # unparseable
    assert perfacct.peak_flops() == 5e14
    assert perfacct.peak_hbm_bytes() == device_time.HBM_BYTES_PER_S


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", None])
def test_unknown_device_sets_no_mfu(monkeypatch, caplog, name):
    monkeypatch.delenv("PIO_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("PIO_PEAK_HBM_BYTES", raising=False)
    monkeypatch.setattr(perfacct, "device_name", lambda device=None: name)
    monkeypatch.setattr(perfacct, "_unknown_logged", set())
    model = f"t-unknown-{name}"
    with caplog.at_level("INFO", logger=perfacct.__name__):
        acct = perfacct.StepAccountant(model, 1e12, 1e9)
    assert acct.observe(0.01) is None and acct.last_mfu is None
    assert perfacct.peak_flops() is None and perfacct.mfu(1e12, 1.0) is None
    mfu_models = {v[0] for v, _ in
                  metrics.REGISTRY.get("pio_train_mfu").children()}
    assert model not in mfu_models
    assert metrics.REGISTRY.get("pio_step_flops").labels(model).value == 1e12
    assert any("stay unset" in r.getMessage() for r in caplog.records)


def test_ledger_and_tail_report_equal_jax():
    port, jax = perfacct.DataPathLedger(), jax_perfacct.DataPathLedger()
    for ledger in (port, jax):
        ledger.note_stage("read", 0.5)
        ledger.note_ingest(ts=100.0)
        ledger.note_train_read(ts=101.0)
        ledger.note_stage("read", 0.25)
        ledger.note_stage("fit", 1.5)
        ledger.note_ingest(ts=103.0)
        ledger.note_publish(ts=104.0)
    snap = port.snapshot(now=110.0)
    want = jax.snapshot(now=110.0)
    for s in (snap, want):
        for run in s["runs"]:
            run.pop("start_unix")
    assert snap == want and snap["staleness_seconds"] == 10.0
    rng = np.random.default_rng(4)
    records = [{"duration_ms": float(d),
                "stages": {"queue": float(d) * 0.3, "dispatch": float(d) * 0.6,
                           "unattributed": float(d) * 0.1}}
               for d in rng.exponential(5.0, 64)]
    assert perfacct.tail_report(records, q=0.9) == \
        jax_perfacct.tail_report(records, q=0.9)
