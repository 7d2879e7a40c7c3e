"""The port's device-memory ledger against the JAX package's.

The same register/release sequence, drawn from one numpy seed, gives
both ledgers the same per-model, per-component totals. Owners are held
by weak reference: a port trainer that is deleted leaves the ledger at
the next read after ``gc.collect()``, with no sleep and no thread (the
JAX ALS trainer's transfer watcher is what makes its counterpart test
wait). A CPU process reports no device statistics and starts no CUDA.
"""

import gc

import numpy as np
import torch

from predictionio_tpu.obs import memacct as jax_memacct
from predictionio_torch.models.als import als_model_from_arrays
from predictionio_torch.obs import memacct, metrics
from predictionio_torch.ops import als
from predictionio_torch.ops.twotower import TwoTowerConfig, TwoTowerTrainer

torch.set_num_threads(1)


class Owner:
    """A weak-referenceable owner."""


def test_register_release_totals_equal_jax():
    rng = np.random.default_rng(7)
    port, jax = memacct.MemLedger(), jax_memacct.MemLedger()
    owners = [Owner() for _ in range(6)]
    models = ["als", "twotower", "index:ivf"]
    components = ["factors", "id_maps", "index", "params"]
    for _ in range(60):
        owner = owners[rng.integers(len(owners))]
        if rng.random() < 0.2:
            assert port.release(owner) == jax.release(owner)
            continue
        args = (models[rng.integers(3)], components[rng.integers(4)],
                int(rng.integers(1, 1 << 20)))
        port.register(owner, *args)
        jax.register(owner, *args)
        assert port.model_bytes() == jax.model_bytes()
    assert port.model_totals() == jax.model_totals()
    assert port.total_bytes() == jax.total_bytes() > 0
    del owners[:3]
    gc.collect()
    assert port.model_bytes() == jax.model_bytes()


def _ledger_total(model: str) -> int:
    return memacct.LEDGER.model_totals().get(model, 0)


def test_deleted_trainers_release_their_bytes():
    rng = np.random.default_rng(2)
    u = rng.integers(0, 30, 200)
    i = rng.integers(0, 40, 200)
    r = (rng.integers(1, 11, 200) / 2).astype(np.float32)
    gc.collect()
    before = {m: _ledger_total(m) for m in ("twotower", "als")}
    tt = TwoTowerTrainer((u, i, None), 30, 40,
                         TwoTowerConfig(dim=8, batch_size=32), device="cpu")
    al = als.ALSTrainer((u, i, r), 30, 40, als.ALSConfig(rank=4),
                        device="cpu")
    grown = {m: _ledger_total(m) - before[m] for m in before}
    assert grown["twotower"] == (tt._param_bytes + tt._opt_bytes
                                 + tt._data_bytes) > 0
    assert grown["als"] == al.transfer_bytes > 0
    del tt, al
    gc.collect()
    assert {m: _ledger_total(m) for m in before} == before


def test_model_is_priced_at_load_and_patch():
    model = als_model_from_arrays(np.ones((5, 4), np.float32),
                                  np.ones((7, 4), np.float32),
                                  [f"u{k}" for k in range(5)],
                                  [f"i{k}" for k in range(7)])
    entries = {fp.component: fp.nbytes for fp in memacct.LEDGER.footprints()
               if fp.model == "als" and fp.nbytes in (12 * 16, 12 * 24)}
    assert entries == {"factors": 12 * 16, "id_maps": 12 * 24}
    model.upsert_rows(user_rows=[("u9", np.zeros(4, np.float32))])
    assert any(fp.component == "factors" and fp.nbytes == 13 * 16
               for fp in memacct.LEDGER.footprints())
    assert memacct.release_model(model) == 2


def test_cpu_process_reports_no_device_and_starts_no_cuda(monkeypatch):
    monkeypatch.delenv("PIO_PEAK_HBM_BYTES", raising=False)
    assert memacct.update_device_memory_gauges() == 0
    report = memacct.report()
    assert set(report) == set(jax_memacct.report())
    assert report["basis"] == "env" and report["capacity_bytes"] is None
    assert report["headroom_bytes"] is None and report["devices"] == []
    assert not torch.cuda.is_initialized()
    monkeypatch.setenv("PIO_PEAK_HBM_BYTES", str(1 << 40))
    report = memacct.capacity_report()
    assert report["headroom_bytes"] == (1 << 40) - memacct.LEDGER.total_bytes()
    assert metrics.REGISTRY.get("pio_device_headroom_bytes").value == \
        report["headroom_bytes"]


def test_train_peaks_and_preflight_match_jax(monkeypatch):
    monkeypatch.setenv("PIO_PEAK_HBM_BYTES", str(1 << 40))
    for mod in (memacct, jax_memacct):
        mod.note_train_peak("t-peak", 12345, source="analytic")
    assert memacct.train_peaks()["t-peak"] == \
        jax_memacct.train_peaks()["t-peak"]

    class Models:
        def size(self, instance_id):
            return {"small": 100, "huge": 1 << 45}[instance_id]

    class Store:
        def models(self):
            return Models()

    for instance, result in (("small", "allowed"), ("huge", "refused")):
        got = {}
        for mod in (memacct, jax_memacct):
            try:
                got[mod] = mod.preflight_check(instance, Store())["result"]
            except mod.PreflightRefused as e:
                got[mod] = e.decision["result"]
        assert got[memacct] == got[jax_memacct] == result
