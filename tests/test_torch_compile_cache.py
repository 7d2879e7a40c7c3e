"""The port's kernel-library cache (``parallel/compile_cache.py``,
``ops/kernels/__init__.py``) against the JAX package's compile cache, on
the CPU.

- Where the libraries go: under ``$PIO_COMPILE_CACHE_DIR/kernels`` (the
  directory JAX's ``cache_dir_default()`` names, when the variable
  points there), else, with the variable unset, with
  ``PIO_COMPILE_CACHE=0`` or with a directory that cannot be created,
  the package's ``_build/`` (the last counted as ``cache_unavailable``).
- The key: the library's name changes with the source, the flags and
  ``nvcc --version``, and with none of them it stays put.
- No ``nvcc`` runs on the CPU: every wrapper given CPU tensors takes
  its plain version.
- A build and a load across processes, with a stand-in ``nvcc`` that
  compiles a plain C++ source with ``g++``: this process builds into an
  empty cache (``built`` 1), a second interpreter loads the library
  with no build (``cached`` 1).
- The ``compile_cache`` readiness probe gives JAX's status and reason
  for the same hit and miss counts, each package on a private registry.

JAX's ``enable_persistent_cache()`` is never called here: it would
point ``jax.config`` at this test's temporary directory for the rest of
the worker.
"""

import json
import os
import stat
import subprocess
import sys
import textwrap

import pytest
import torch

from predictionio_tpu.obs import health as jax_health
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.parallel import compile_cache as jax_cc
from predictionio_torch.obs import health, metrics, torchmon
from predictionio_torch.ops import kernels
from predictionio_torch.ops.kernels import embed_update as eu
from predictionio_torch.ops.kernels import flash_ce as fce
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.parallel import compile_cache as cc

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


@pytest.fixture()
def cache_env(monkeypatch, tmp_path):
    """An empty cache under ``tmp_path``, the JAX default home there."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "home"))
    monkeypatch.delenv("PIO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", jax_cc.cache_dir_default())
    return tmp_path


@pytest.mark.parametrize("basedir", [True, False], ids=["fs-basedir", "home"])
def test_cache_dir_default_is_jaxs(monkeypatch, tmp_path, basedir):
    monkeypatch.setenv("HOME", str(tmp_path / "user"))
    if basedir:
        monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    else:
        monkeypatch.delenv("PIO_FS_BASEDIR", raising=False)
    assert cc.cache_dir_default() == jax_cc.cache_dir_default()


def test_libraries_go_under_the_cache_dir_plus_kernels(cache_env):
    want = os.path.join(jax_cc.cache_dir_default(), "kernels")
    assert kernels.library_dir() == want
    assert cc.enable_persistent_cache() == want
    assert os.path.isdir(want)
    assert want.startswith(str(cache_env))


@pytest.mark.parametrize("how", ["unset", "disabled", "empty"])
def test_without_a_cache_the_libraries_stay_in_build(monkeypatch, tmp_path,
                                                     how):
    monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("PIO_COMPILE_CACHE", raising=False)
    if how == "unset":
        monkeypatch.delenv("PIO_COMPILE_CACHE_DIR")
    elif how == "disabled":
        monkeypatch.setenv("PIO_COMPILE_CACHE", "0")
    else:
        monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", "")
    assert kernels.library_dir() == cc.BUILD_DIR
    assert cc.enable_persistent_cache() is None
    assert not (tmp_path / "cache").exists()
    assert cc.BUILD_DIR == os.path.join(ROOT, "predictionio_torch", "ops",
                                        "kernels", "_build")


def test_an_unusable_cache_falls_back_to_build_and_is_counted(
        monkeypatch, tmp_path, caplog):
    blocker = tmp_path / "a-file"
    blocker.write_text("not a directory")
    monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", str(blocker / "cache"))
    monkeypatch.delenv("PIO_COMPILE_CACHE", raising=False)
    child = torchmon.KERNEL_BUILD_TOTAL.labels("cachetest",
                                               "cache_unavailable")
    before = child.value
    try:
        with caplog.at_level("WARNING",
                             logger="predictionio_torch.parallel"):
            assert kernels.library_dir("cachetest") == cc.BUILD_DIR
            assert cc.enable_persistent_cache() is None
        assert child.value == before + 1
        assert "kernel-library cache unavailable" in caplog.text
    finally:
        torchmon.KERNEL_BUILD_TOTAL.remove("cachetest", "cache_unavailable")


@pytest.fixture()
def fake_source(monkeypatch, tmp_path):
    """A kernel source ``k.cu`` in a private ``csrc/``, and a fixed
    ``nvcc --version``."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("extern \"C\" int k_answer() { return 1; }\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "nvcc_version", lambda: "release 1.0")
    monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    return csrc


@pytest.mark.parametrize("change", ["source", "flags", "nvcc"])
def test_the_key_changes_with_source_flags_and_nvcc(monkeypatch, fake_source,
                                                   change):
    first = kernels._library_path("k")
    assert kernels._library_path("k") == first
    assert os.path.dirname(first) == kernels.library_dir()
    if change == "source":
        (fake_source / "k.cu").write_text(
            "extern \"C\" int k_answer() { return 2; }\n")
    elif change == "flags":
        monkeypatch.setattr(kernels, "NVCC_FLAGS",
                            [*kernels.NVCC_FLAGS, "-lineinfo"])
    else:
        monkeypatch.setattr(kernels, "nvcc_version", lambda: "release 2.0")
    second = kernels._library_path("k")
    assert second != first
    assert os.path.basename(second).startswith("libk-")


def test_nvcc_version_is_asked_once_a_process(monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="release 9.9\n")

    monkeypatch.setattr(kernels, "nvcc_path", lambda: "/opt/fake/nvcc")
    monkeypatch.setattr(kernels, "_nvcc_versions", {})
    monkeypatch.setattr(kernels.subprocess, "run", run)
    assert kernels.nvcc_version() == "release 9.9\n"
    assert kernels.nvcc_version() == "release 9.9\n"
    assert calls == [["/opt/fake/nvcc", "--version"]]


def test_nvcc_never_runs_on_the_cpu(monkeypatch):
    """Every wrapper given CPU tensors takes its plain version: no
    library is asked for, no nvcc is looked up or started."""

    def refuse(*a, **kw):
        raise AssertionError("nvcc ran on the CPU")

    monkeypatch.setattr(kernels, "nvcc_path", refuse)
    monkeypatch.setattr(kernels.subprocess, "Popen", refuse)
    monkeypatch.setattr(kernels.subprocess, "run", refuse)
    before = kernels.requested_kernels()
    gen = torch.Generator().manual_seed(0)
    items = torch.randn(40, 8, generator=gen)
    q = torch.randn(2, 8, generator=gen)
    scores, idx = tkd.topk_dot(q, items, torch.full((2, 1), -1,
                                                    dtype=torch.int32), 5)
    assert scores.shape == (2, 5) and idx.shape == (2, 5)
    u = torch.nn.functional.normalize(torch.randn(16, 8, generator=gen),
                                      dim=1).requires_grad_()
    v = torch.nn.functional.normalize(torch.randn(16, 8, generator=gen),
                                      dim=1).requires_grad_()
    ids = torch.arange(16)
    loss = fce.flash_ce(u, v, ids, ids, torch.ones(16), 0.07, torch.float32)
    loss.backward()
    assert torch.isfinite(loss) and u.grad is not None
    table = torch.zeros(10, 4)
    eu.embed_update(table, torch.tensor([1, 1, 3]), torch.ones(3, 4),
                    torch.ones(3))
    assert float(table[1, 0]) == -2.0 and float(table[3, 0]) == -1.0
    assert kernels.requested_kernels() == before


FAKE_NVCC = """\
#!{python}
# stands in for nvcc: answers --version, and builds a plain C++ source
# with g++ where nvcc would build CUDA, printing a ptxas-style report
import os, subprocess, sys
args = sys.argv[1:]
if args == ["--version"]:
    print("fake nvcc, release 1.0")
    sys.exit(0)
out, src = args[args.index("-o") + 1], args[-1]
with open(os.path.join(os.path.dirname(__file__), "builds.txt"), "a") as f:
    f.write(src + "\\n")
subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", src, "-o", out],
               check=True)
print("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'")
print("ptxas info    : Used 12 registers")
print("      0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
"""

SECOND_PROCESS = """\
import json, sys
from predictionio_torch.obs import torchmon
from predictionio_torch.ops import kernels
kernels.CSRC_DIR = sys.argv[1]
lib = kernels.load_library("k")
lib.k_answer.restype = __import__("ctypes").c_int
built = torchmon.KERNEL_BUILD_TOTAL.labels("k", "built").value
cached = torchmon.KERNEL_BUILD_TOTAL.labels("k", "cached").value
print(json.dumps({{"answer": lib.k_answer(), "built": built,
                  "cached": cached, "dir": kernels.library_dir(),
                  "loaded": kernels.loaded_kernels(),
                  "load_seconds": kernels.load_seconds()["k"]}}))
"""


def test_a_second_process_loads_the_cached_library_without_a_build(
        monkeypatch, tmp_path):
    """This process builds ``k`` into an empty cache with the stand-in
    nvcc; a second interpreter over the same cache loads it cached."""
    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    nvcc = cuda_home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("extern \"C\" int k_answer() { return 7; }\n")
    cache = tmp_path / "cache"
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    monkeypatch.setenv("PIO_COMPILE_CACHE_DIR", str(cache))
    monkeypatch.delenv("PIO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_requested", set())
    monkeypatch.setattr(kernels, "_load_seconds", {})
    monkeypatch.setattr(kernels, "_nvcc_versions", {})
    built = torchmon.KERNEL_BUILD_TOTAL.labels("k", "built")
    try:
        lib = kernels.load_library("k")
        assert lib.k_answer() == 7
        assert built.value == 1
        path = kernels._library_path("k")
        assert os.path.dirname(path) == str(cache / "kernels")
        assert os.path.exists(path) and os.path.exists(path + ".log")
        assert kernels.ptxas_report("k") == {"_Z1kv": {
            "registers": 12, "spill_stores": 0, "spill_loads": 0}}
        assert not [f for f in os.listdir(cache / "kernels")
                    if f.endswith(".tmp")]
        assert (cuda_home / "bin" / "builds.txt").read_text().count(
            "k.cu") == 1
        env = {**os.environ, "PYTHONPATH": ROOT}
        proc = subprocess.run(
            [sys.executable, "-c", SECOND_PROCESS.format(), str(csrc)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got["answer"] == 7
        assert got["built"] == 0 and got["cached"] == 1
        assert got["dir"] == str(cache / "kernels")
        assert got["loaded"] == ["k"] and got["load_seconds"] >= 0.0
        # the second process ran no build
        assert (cuda_home / "bin" / "builds.txt").read_text().count(
            "k.cu") == 1
    finally:
        torchmon.KERNEL_BUILD_TOTAL.remove("k", "built")


@pytest.mark.parametrize("hits,misses,env", [
    (0, 0, {}),
    (3, 5, {}),
    (10, 30, {}),
    (30, 10, {}),
    (16, 16, {}),
    (4, 4, {"PIO_CACHE_MIN_LOOKUPS": "8", "PIO_CACHE_HIT_FLOOR": "0.6"}),
    (6, 2, {"PIO_CACHE_MIN_LOOKUPS": "8", "PIO_CACHE_HIT_FLOOR": "0.6"}),
], ids=["none", "below-lookup-floor", "under-hit-floor", "above-hit-floor",
        "at-hit-floor", "env-under", "env-above"])
def test_compile_cache_probe_answers_like_jax(monkeypatch, hits, misses,
                                              env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax_reg, port_reg = jax_metrics.Registry(), metrics.Registry()
    monkeypatch.setattr(jax_metrics, "REGISTRY", jax_reg)
    monkeypatch.setattr(metrics, "REGISTRY", port_reg)
    jax_family = jax_reg.counter("pio_jax_compile_cache_total", "h",
                                 ("result",))
    port_family = port_reg.counter("pio_kernel_build_total", "h",
                                   ("kernel", "result"))
    if hits or misses:
        jax_family.labels("hit").inc(hits)
        jax_family.labels("miss").inc(misses)
        # spread over the kernels: the port's probe sums them
        port_family.labels("topk_dot", "cached").inc(hits - hits // 2)
        port_family.labels("flash_ce", "cached").inc(hits // 2)
        port_family.labels("topk_dot", "built").inc(misses)
        port_family.labels("embed_update", "cache_unavailable").inc(3)
    want = jax_health._compile_cache_probe()
    got = health._compile_cache_probe()
    assert (got.status, got.reason) == (want.status, want.reason)
