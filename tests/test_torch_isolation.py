"""The port never imports JAX or the JAX package.

``predictionio_torch`` (and ``chip_smoke.py``, which runs where there is
no JAX) may import torch, numpy and the standard library only. Checked
two ways: importing every module of the port in a fresh interpreter (this
test process already holds JAX: tests/conftest.py imports it) leaves
``jax``, ``flax``, ``optax`` and ``predictionio_tpu`` out of
``sys.modules``; and no source file names them in an import statement.
"""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "predictionio_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "predictionio_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_port_module_pulls_in_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import predictionio_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'predictionio_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'modules': len(names), 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["modules"] >= 20
    assert result["bad"] == []


def test_no_source_imports_jax():
    sources = _port_sources()
    assert len(sources) >= 20
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} imports "
                    f"{name}" for name in names
                    if name.split(".")[0] in FORBIDDEN]
    assert bad == []


#: the data lane's and the front door's modules, which the walk above
#: must reach
DATA_LANE = ("predictionio_torch.native",
             "predictionio_torch.data.backends.eventlog",
             "predictionio_torch.ops.bincache",
             "predictionio_torch.ops.ragged",
             "predictionio_torch.data.store",
             "predictionio_torch.serving.stats",
             "predictionio_torch.serving.webhooks",
             "predictionio_torch.serving.webhooks.mailchimp",
             "predictionio_torch.serving.webhooks.segmentio",
             "predictionio_torch.serving.event_server",
             "predictionio_torch.tools.commands",
             "predictionio_torch.tools.eventdata",
             "predictionio_torch.tools.admin",
             "predictionio_torch.tools.cli")


#: the evaluation half's modules (``pio eval``, grid tuning)
EVALUATION = ("predictionio_torch.core.controller",
              "predictionio_torch.core.engine",
              "predictionio_torch.core.persistent_model",
              "predictionio_torch.core.cross_validation",
              "predictionio_torch.core.evaluation",
              "predictionio_torch.core.fast_eval",
              "predictionio_torch.data.metadata",
              "predictionio_torch.data.storage",
              "predictionio_torch.data.backends.memory",
              "predictionio_torch.data.backends.localfs",
              "predictionio_torch.ops.als",
              "predictionio_torch.models.als",
              "predictionio_torch.templates.recommendation",
              "predictionio_torch.workflow.train",
              "predictionio_torch.workflow.evaluate",
              "predictionio_torch.workflow.fake",
              "predictionio_torch.tools.cli")


def _walk_and_import(want) -> dict:
    """In a fresh interpreter: which of ``want`` the package walk misses,
    and which forbidden modules importing ``want`` loaded."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import predictionio_torch as pkg\n"
        "names = {m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'predictionio_torch.')}\n"
        f"want = {tuple(want)!r}\n"
        "for n in want: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'missing': sorted(set(want) - names), "
        "'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_data_lane_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(DATA_LANE) == {"missing": [], "bad": []}


def test_the_evaluation_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(EVALUATION) == {"missing": [], "bad": []}
