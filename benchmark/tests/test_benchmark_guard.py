import json
import os
import subprocess
import sys

import pytest

from benchmark.lib import env
from benchmark.tests.conftest import ROOT


def test_top_level_names_compare_whole():
    assert env.forbidden_loaded(["predictionio_torch",
                                 "predictionio_torch.ops.als"]) == []
    assert env.forbidden_loaded(["jax.numpy"]) == ["jax"]
    assert env.forbidden_loaded(["jaxlib"]) == ["jaxlib"]
    assert env.forbidden_loaded(["flax.linen"]) == ["flax"]
    assert env.forbidden_loaded(["predictionio_tpu.ops"]) == [
        "predictionio_tpu"]
    # a name that only begins like a forbidden one is another module
    assert env.forbidden_loaded(["jaxtyping", "predictionio_tpux",
                                 "flaxen"]) == []


def test_harness_and_program_load_nothing_forbidden():
    """Everything a run imports, in a fresh interpreter (this test
    process may hold JAX from elsewhere)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.lib import env, cells, trace, generators, work\n"
        "from benchmark import run, calibrate\n"
        "from benchmark.runners import als\n"
        "from benchmark.reference import als as ra\n"
        "import predictionio_torch.ops.als\n"
        "for fault in als.FAULTS.values():\n"
        "    with fault():\n"
        "        pass\n"
        "import json; print(json.dumps(env.forbidden_loaded()))\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, **env.cache_env(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cache_directories_are_fixed_and_inside():
    a = env.cache_env(ROOT)
    assert a == env.cache_env(ROOT)
    for key in ("PIO_COMPILE_CACHE_DIR", "PIO_NATIVE_BUILD_DIR",
                "TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        assert a[key].startswith(os.path.join(ROOT, "benchmark", ".cache"))
    assert str(os.getpid()) not in json.dumps(a)


#: ``run.main`` on a machine made to look as if it had a card, with a
#: runner that does no work and a per-layer reader that imports
#: ``MODULE`` (a stand-in package of that name, first on the path)
FAKE_RUN = """
import importlib, os, sys, types
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(fake)r)
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.init = lambda: None
torch.cuda.reset_peak_memory_stats = lambda: None
torch.cuda.get_device_name = lambda i=0: "stand-in"
from benchmark import run
from benchmark.lib import cells
from benchmark.lib.outcome import Outcome

class Trace:
    busy_s, window_s = 0.5, 1.0
    def device_ops(self): return []
    def idle_gaps(self): return []

def go(cell, seed, seconds, trace, device):
    return Outcome(attempted=1, failed=0, e2e={}, readings={},
                   memory_peak_bytes=1, context={}, trace=Trace())

cells.runner = lambda config: types.SimpleNamespace(run=go)

def reader(root, name):
    def read(ctx):
        if %(module)r:
            importlib.import_module(%(module)r)
        return 1.0
    return read

cells.reader = reader
sys.exit(run.main(["--workload", "als-ml20m.train", "--seed", "1",
                   "--seconds", "1", "--trace", "1"]))
"""


@pytest.mark.parametrize("module", ["", "jax", "flax", "predictionio_tpu"])
def test_a_reader_that_loads_jax_stops_the_result(tmp_path, module):
    if module:
        (tmp_path / module).mkdir()
        (tmp_path / module / "__init__.py").write_text("")
    code = FAKE_RUN % {"root": ROOT, "fake": str(tmp_path),
                       "module": module}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, **env.cache_env(ROOT)})
    if not module:
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
        return
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert module in out.stderr
