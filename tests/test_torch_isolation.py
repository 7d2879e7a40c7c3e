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
