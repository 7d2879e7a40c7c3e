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


#: the streaming freshness lane's modules (``pio stream``, fold-in)
STREAM = ("predictionio_torch.workflow.stream",
          "predictionio_torch.index.recall",
          "predictionio_torch.serving.engine_server",
          "predictionio_torch.serving.http",
          "predictionio_torch.ops.twotower")


#: the model families (sessionrec, classification, regression, vanilla,
#: the e2 models)
MODEL_FAMILIES = ("predictionio_torch.ops.attention",
                  "predictionio_torch.ops.sessionrec",
                  "predictionio_torch.models",
                  "predictionio_torch.models.sessionrec",
                  "predictionio_torch.models.classification",
                  "predictionio_torch.models.regression",
                  "predictionio_torch.models.naive_bayes",
                  "predictionio_torch.models.markov",
                  "predictionio_torch.templates.sessionrec",
                  "predictionio_torch.templates.classification",
                  "predictionio_torch.templates.regression",
                  "predictionio_torch.templates.vanilla",
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


def test_the_stream_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(STREAM) == {"missing": [], "bad": []}


def test_the_model_family_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(MODEL_FAMILIES) == {"missing": [], "bad": []}


#: the observability core and the IVF index
OBSERVABILITY = ("predictionio_torch.obs",
                 "predictionio_torch.obs.metrics",
                 "predictionio_torch.obs.trace",
                 "predictionio_torch.obs.logging",
                 "predictionio_torch.obs.flight",
                 "predictionio_torch.obs.journal",
                 "predictionio_torch.obs.perfacct",
                 "predictionio_torch.obs.memacct",
                 "predictionio_torch.obs.health",
                 "predictionio_torch.obs.torchmon",
                 "predictionio_torch.obs.profiler",
                 "predictionio_torch.obs.dataobs",
                 "predictionio_torch.obs.contprof",
                 "predictionio_torch.obs.anomaly",
                 "predictionio_torch.obs.collect",
                 "predictionio_torch.obs.push",
                 "predictionio_torch.index",
                 "predictionio_torch.index.exact",
                 "predictionio_torch.index.ivf",
                 "predictionio_torch.serving.http",
                 "predictionio_torch.serving.event_server",
                 "predictionio_torch.tools.device_time")


def test_the_observability_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(OBSERVABILITY) == {"missing": [], "bad": []}


def test_importing_the_observability_core_starts_nothing():
    """The obs package and the event server import no torch and start
    no thread: the journal writer and the watchdog monitor start on
    first use, and no log or signal handler is installed at import."""
    code = (
        "import json, logging, signal, sys, threading\n"
        "before = (list(logging.getLogger().handlers),\n"
        "          signal.getsignal(signal.SIGTERM))\n"
        "import predictionio_torch.obs, predictionio_torch.serving.event_server\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'threads': threading.active_count(),\n"
        "                  'same_handlers': before == (\n"
        "                      list(logging.getLogger().handlers),\n"
        "                      signal.getsignal(signal.SIGTERM))}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "torch": False, "threads": 1, "same_handlers": True}


#: the deployed engine's operator contract: resilience, SLOs, quality,
#: timelines, the fleet and its router, replay, and the modules they
#: changed
OPERATOR = ("predictionio_torch.resilience",
            "predictionio_torch.resilience.policy",
            "predictionio_torch.resilience.chaos",
            "predictionio_torch.resilience.admission",
            "predictionio_torch.resilience.alerts",
            "predictionio_torch.obs.slo",
            "predictionio_torch.obs.quality",
            "predictionio_torch.obs.timeline",
            "predictionio_torch.obs.journal",
            "predictionio_torch.serving.fleet",
            "predictionio_torch.serving.router",
            "predictionio_torch.serving.engine_server",
            "predictionio_torch.serving.http",
            "predictionio_torch.workflow.replay",
            "predictionio_torch.workflow.train",
            "predictionio_torch.data.storage",
            "predictionio_torch.tools.cli")


def test_the_operator_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(OPERATOR) == {"missing": [], "bad": []}


def test_importing_the_operator_modules_starts_nothing():
    """The resilience layer, the SLO monitor, the fleet and the router
    import no torch and start no thread at import: the alert sink, the
    supervisor's monitor and the router's workers start on use."""
    code = (
        "import json, sys, threading\n"
        "import predictionio_torch.resilience, predictionio_torch.obs.slo\n"
        "import predictionio_torch.serving.fleet\n"
        "import predictionio_torch.serving.router\n"
        "import predictionio_torch.workflow.replay\n"
        "print(json.dumps({'torch': 'torch' in sys.modules,\n"
        "                  'threads': threading.active_count()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "torch": False, "threads": 1}


#: the multi-process path: the world and mesh, the sharded reads, the
#: sharded ALS half-step and top-k, and the single-writer train
MULTI_PROCESS = ("predictionio_torch.parallel",
                 "predictionio_torch.parallel.context",
                 "predictionio_torch.parallel.mesh",
                 "predictionio_torch.parallel.multihost",
                 "predictionio_torch.data.storage",
                 "predictionio_torch.data.store",
                 "predictionio_torch.data.backends.memory",
                 "predictionio_torch.data.backends.localfs",
                 "predictionio_torch.data.backends.eventlog",
                 "predictionio_torch.templates._columnar",
                 "predictionio_torch.templates.recommendation",
                 "predictionio_torch.ops.als",
                 "predictionio_torch.ops.topk",
                 "predictionio_torch.ops.kernels.topk_dot",
                 "predictionio_torch.models.als",
                 "predictionio_torch.workflow.train",
                 "predictionio_torch.workflow.deploy",
                 "predictionio_torch.tools.cli")


def test_the_multi_process_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(MULTI_PROCESS) == {"missing": [], "bad": []}


#: multi-process training beyond ALS: the two-tower and session
#: recommender trainers over a mesh, ring attention, the checkpointer
#: across processes, the exit hook's runtime and the flops formula
MULTI_PROCESS_TRAINING = ("predictionio_torch.parallel.multihost",
                          "predictionio_torch.parallel.mesh",
                          "predictionio_torch.ops.twotower",
                          "predictionio_torch.ops.attention",
                          "predictionio_torch.ops.sessionrec",
                          "predictionio_torch.ops.kernels.flash_ce",
                          "predictionio_torch.ops.kernels.embed_update",
                          "predictionio_torch.core.checkpoint",
                          "predictionio_torch.obs.perfacct",
                          "predictionio_torch.models.twotower",
                          "predictionio_torch.models.sessionrec",
                          "predictionio_torch.templates.twotower",
                          "predictionio_torch.workflow.train")


def test_the_multi_process_training_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(MULTI_PROCESS_TRAINING) == {"missing": [],
                                                        "bad": []}


#: the storage tier: the sqlite and rest backends, the storage server,
#: batch views, and the commands and console that repair replicas
STORAGE_TIER = ("predictionio_torch.data.backends.sqlite",
                "predictionio_torch.data.backends.rest",
                "predictionio_torch.serving.storage_server",
                "predictionio_torch.data.view",
                "predictionio_torch.data.bimap",
                "predictionio_torch.data.store",
                "predictionio_torch.tools.commands",
                "predictionio_torch.tools.cli")


def test_the_storage_tier_modules_are_walked_and_import_no_jax():
    assert _walk_and_import(STORAGE_TIER) == {"missing": [], "bad": []}
