"""The port's health probes against the JAX package's.

The storage probe gives the same result in both packages for a store
that is up and for one that is down (one repository failing its health
check), and both engine servers map storage loss to DEGRADED. The
device probe answers ``cpu`` where no deployment registered a card, and
FAILED (never DEGRADED) for a registered card CUDA cannot reach; the
kernel-library probe fails for a kernel that was asked for and is not
loaded. The probe registry runs the same way in both.
"""

import pytest

from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.obs import health as jax_health
from predictionio_torch.data.storage import Storage
from predictionio_torch.obs import health
from predictionio_torch.ops import kernels


def _env(tmp_path):
    return {
        "PIO_STORAGE_SOURCES_S_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_S_PATH": str(tmp_path / "store"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "events",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "S",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "models",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "S",
    }


def _result(probe):
    r = probe()
    return r.status, r.reason.split(" in ")[0]   # drop the latency tail


@pytest.mark.parametrize("down", [None, "EVENTDATA", "raise"])
def test_storage_probe_equals_jax(tmp_path, monkeypatch, down):
    port, jax = Storage.from_env(_env(tmp_path)), JaxStorage.from_env(
        _env(tmp_path))
    if down is not None:
        for st in (port, jax):
            if down == "raise":
                def boom():
                    raise ConnectionError("backend gone")
                monkeypatch.setattr(st.client_for("MODELDATA"),
                                    "health_check", boom)
            else:
                monkeypatch.setattr(st.client_for(down), "health_check",
                                    lambda: False)
    got = _result(lambda: health.storage_probe(port))
    assert got == _result(lambda: jax_health.storage_probe(jax))
    # one source serves the three repositories: down, it fails them all
    assert got == (("ok", "3 repositories") if down is None else
                   ("failed", "unreachable: EVENTDATA, METADATA, MODELDATA"))


def test_registry_aggregates_like_jax():
    probes = {"a": lambda: health.ok("fine"),
              "b": lambda: health.degraded("slow"),
              "c": lambda: 1 / 0}
    jax_probes = {"a": lambda: jax_health.ok("fine"),
                  "b": lambda: jax_health.degraded("slow"),
                  "c": lambda: 1 / 0}
    port_reg, jax_reg = health.HealthRegistry(), jax_health.HealthRegistry()
    for reg, ps in ((port_reg, probes), (jax_reg, jax_probes)):
        for name, fn in ps.items():
            reg.register(name, fn)
    (overall, detail), (j_overall, j_detail) = port_reg.run(), jax_reg.run()
    assert overall == j_overall == "failed"
    strip = lambda d: {k: {f: v[f] for f in ("status", "reason")}  # noqa: E731
                       for k, v in d.items()}
    assert strip(detail) == strip(j_detail)
    assert detail["c"]["reason"] == "ZeroDivisionError: division by zero"


def test_devices_probe_cpu_and_a_card_it_cannot_reach(monkeypatch):
    monkeypatch.setattr(health, "_DEVICES", {})
    assert health._devices_probe().as_dict() == {"status": "ok",
                                                 "reason": "cpu"}
    health.register_device("cpu")          # a CPU deployment registers none
    assert health._devices_probe().reason == "cpu"
    health.register_device("cuda:0")
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = health._devices_probe()
    assert result.status == "failed" and "cuda:0" in result.reason
    health.unregister_device("cuda:0")
    assert health._devices_probe().reason == "cpu"


def test_kernels_probe(monkeypatch):
    monkeypatch.setattr(kernels, "_requested", set())
    monkeypatch.setattr(kernels, "_libs", {})
    assert health._kernels_probe().as_dict() == {
        "status": "ok", "reason": "no kernel requested"}
    kernels._requested.add("topk_dot")
    result = health._kernels_probe()
    assert result.status == "failed" and "topk_dot" in result.reason
    kernels._libs["topk_dot"] = object()
    assert health._kernels_probe().as_dict() == {
        "status": "ok", "reason": "loaded: topk_dot"}


def test_default_probes_replace_compile_cache_with_kernels(monkeypatch):
    monkeypatch.setattr(health, "_defaults_installed", False)
    reg = health.HealthRegistry()
    monkeypatch.setattr(health, "REGISTRY", reg)
    health.install_default_probes()
    jax_names = {"devices", "compile_cache", "flight_errors", "disk",
                 "device_memory"}
    assert set(reg.names()) == jax_names - {"compile_cache"} | {"kernels"}


def test_shared_monitor_thread_is_joined():
    wd = health.Watchdog("t-join", min_seconds=60.0, min_history=1)
    wd.record(0.001)
    with wd.watch():
        thread = health._MONITOR._thread
        assert thread is not None and thread.is_alive()
    assert health.stop_monitor(timeout=10)
    assert not thread.is_alive()
