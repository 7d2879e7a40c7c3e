"""Engine variants and the engine-project path of the port, on the CPU.

Mirrors the JAX package's ``tests/test_workflow.py::
test_engine_variant_loading``, ``tests/test_tools.py::
test_app_and_template_commands`` / ``test_build_train_via_cli`` (with
``recommendation`` in place of ``vanilla``) and ``TestTemplateScaffold``,
and covers:

- ``EngineManifest`` through each port backend's repo (memory, localfs,
  eventlog), a manifest the JAX package wrote to a localfs store read
  back by the port, and ``pio build`` registering one on each backend;
- the reference's Quick Start on the port for the recommendation,
  similar-product and e-commerce templates: ``template get``, ``build``,
  ``train`` and ``deploy`` (a server process of its own) answering
  ``POST /queries.json``;
- a project the JAX package's ``template get recommendation`` scaffolded
  — its engine module imports ``predictionio_tpu`` — built, trained and
  deployed by the port in processes where importing ``jax``,
  ``optax``, ``flax`` or ``predictionio_tpu`` raises, with none of them
  in ``sys.modules`` at exit;
- the project module's path-keyed name shared with the JAX package, so
  a model class defined there unpickles in either package;
- the classification, regression, vanilla and sessionrec scaffolds
  trained and answering, and a variant's ``"slo"`` block raising with
  its ROADMAP.md item.
"""

import datetime as dt
import json
import os
import pickle
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from predictionio_tpu.data.metadata import EngineManifest as JaxManifest
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.tools.cli import main as jax_cli_main
from predictionio_tpu.workflow import variant as jax_variant
from predictionio_torch.core import (Algorithm, DataSource, Engine,
                                     Preparator, Serving)
from predictionio_torch.core.params import Params
from predictionio_torch.data.event import Event
from predictionio_torch.data.metadata import EngineManifest
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.tools import cli
from predictionio_torch.workflow import variant
from predictionio_torch.workflow.variant import EngineVariant

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTC = dt.timezone.utc
ctx = DeviceContext("cpu")


# -- a tiny engine, resolved by dotted path ---------------------------------------

@dataclass
class IdParams(Params):
    id: int = 0


class DataSource0(DataSource):
    def __init__(self, params: IdParams):
        super().__init__(params)

    def read_training(self, ctx):
        return {"ds": self.params.id}


class Preparator0(Preparator):
    def __init__(self, params: IdParams):
        super().__init__(params)

    def prepare(self, ctx, td):
        return {**td, "prep": self.params.id}


class Model0:
    def __init__(self, algo_id, pd):
        self.algo_id, self.pd = algo_id, pd


class Algo0(Algorithm):
    def __init__(self, params: IdParams):
        super().__init__(params)

    def train(self, ctx, pd):
        return Model0(self.params.id, pd)

    def predict(self, model, query):
        return {"algo": model.algo_id, "q": query}


class Serving0(Serving):
    def serve(self, query, predictions):
        return predictions[0]


def sample_factory():
    return Engine(data_source_classes={"ds": DataSource0},
                  preparator_classes={"prep": Preparator0},
                  algorithm_classes={"algo": Algo0},
                  serving_classes={"serve": Serving0})


def test_engine_variant_loading(tmp_path):
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({
        "id": "v1", "engineFactory": "tests.test_torch_variant.sample_factory",
        "datasource": {"name": "ds", "params": {"id": 5}},
        "algorithms": [{"name": "algo", "params": {"id": 6}}],
        "preparator": {"name": "prep", "params": {}},
        "serving": {"name": "serve", "params": {}},
        "runtimeConf": {"mesh.data": "8"}}))
    v = EngineVariant.load(str(path))
    assert v.id == "v1" and v.base_dir == str(tmp_path)
    engine = v.create_engine()
    ep = v.engine_params(engine)
    assert ep.data_source_params[1].id == 5
    assert v.runtime_conf() == {"mesh.data": "8"}
    assert v.slo_conf() is None
    result = engine.train(ctx, ep)
    assert result.models[0].algo_id == 6
    assert result.models[0].pd == {"ds": 5, "prep": 0}


def test_variant_fields_checked_as_in_jax():
    with pytest.raises(ValueError, match="engineFactory"):
        EngineVariant.from_dict({"id": "x"})
    v = EngineVariant.from_dict({"engineFactory": "a.b",
                                 "sparkConf": {"k": "v"},
                                 "slo": {"p99_ms": 50}})
    assert v.id == "default" and v.runtime_conf() == {"k": "v"}
    assert v.slo_conf() == {"p99_ms": 50}
    with pytest.raises(ValueError, match="JSON object"):
        EngineVariant.from_dict({"engineFactory": "a.b",
                                 "slo": [1]}).slo_conf()
    # a JAX-package factory path resolves under the port
    jv = EngineVariant.from_dict({"engineFactory": (
        "predictionio_tpu.templates.similarproduct.similar_product_engine")})
    assert set(jv.create_engine().algorithm_classes) == {"als", "likealgo"}


# -- the project module --------------------------------------------------------------

PROJECT_SRC = '''\
"""A project's engine module, as the JAX package scaffolds one."""
import predictionio_tpu.core.params
from predictionio_tpu.core import Engine, FirstServing  # a comment: predictionio_tpu
from predictionio_tpu.templates.recommendation import (
    RecoDataSource, RecoPreparator)

NOTE = "predictionio_tpu stays in strings"


class MyModel:
    def __init__(self, value):
        self.value = value


def params_module():
    return predictionio_tpu.core.params.__name__


def my_engine():
    return Engine(RecoDataSource, RecoPreparator, {}, FirstServing)
'''


def test_project_imports_are_rewritten_and_the_key_matches_jax(tmp_path):
    path = tmp_path / "my_engine.py"
    path.write_text(PROJECT_SRC)
    module = variant._load_project_module(str(path))
    try:
        assert module.__name__.startswith("_pio_project_")
        assert module.params_module() == "predictionio_torch.core.params"
        assert module.NOTE == "predictionio_tpu stays in strings"
        assert module.RecoDataSource.__module__ == (
            "predictionio_torch.templates.recommendation")
        # loaded again unchanged: the same module object
        assert variant._load_project_module(str(path)) is module
        blob = pickle.dumps(module.MyModel(7))
        # the JAX loader keys the same file the same way
        del sys.modules[module.__name__]
        jax_module = jax_variant._load_project_module(str(path))
        assert jax_module.__name__ == module.__name__
        back = pickle.loads(blob)
        assert type(back) is jax_module.MyModel and back.value == 7
        # and a model pickled by the JAX package's load unpickles here
        jax_blob = pickle.dumps(jax_module.MyModel(8))
        del sys.modules[module.__name__]
        module = variant._load_project_module(str(path))
        back = pickle.loads(jax_blob)
        assert type(back) is module.MyModel and back.value == 8
    finally:
        sys.modules.pop(module.__name__, None)


def test_variant_loads_the_project_module_beside_its_engine_json(tmp_path):
    (tmp_path / "my_engine.py").write_text(PROJECT_SRC)
    (tmp_path / "engine.json").write_text(json.dumps(
        {"engineFactory": "my_engine.my_engine"}))
    v = EngineVariant.load(str(tmp_path / "engine.json"))
    engine = v.create_engine()
    ds = engine.data_source_classes[""]
    assert ds.__module__ == "predictionio_torch.templates.recommendation"
    sys.modules.pop(next(k for k, m in list(sys.modules.items())
                         if getattr(m, "__file__", None)
                         == str(tmp_path / "my_engine.py")))


# -- storage: EngineManifest on every backend ----------------------------------------

def _backend_env(kind, tmp_path):
    if kind == "memory":
        return {"PIO_STORAGE_SOURCES_M_TYPE": "memory"}
    if kind == "localfs":
        return {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                "PIO_STORAGE_SOURCES_FS_PATH": str(tmp_path / "fs")}
    return {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path / "el")}


@pytest.mark.parametrize("kind", ["memory", "localfs", "eventlog"])
def test_manifest_round_trip(tmp_path, kind):
    repo = Storage.from_env(_backend_env(kind, tmp_path)).engine_manifests()
    assert repo.get("e", "1") is None and repo.get_all() == []
    m1 = EngineManifest(id="e", version="1", name="default",
                        description="d", files=["engine.json"],
                        engine_factory="a.b")
    m2 = EngineManifest(id="e", version="2", name="v2")
    repo.insert(m1)
    repo.insert(m2)
    assert repo.get("e", "1") == m1 and repo.get("e", "2") == m2
    m1.description = "changed"
    repo.update(m1)
    assert repo.get("e", "1").description == "changed"
    assert sorted(m.version for m in repo.get_all()) == ["1", "2"]
    repo.delete("e", "1")
    assert repo.get("e", "1") is None and repo.get_all() == [m2]
    if kind != "memory":
        # a new process reads what this one wrote
        again = Storage.from_env(_backend_env(kind, tmp_path))
        assert again.engine_manifests().get_all() == [m2]


def test_a_jax_written_manifest_reads_back_on_the_port(tmp_path):
    env = _backend_env("localfs", tmp_path)
    jax_repo = JaxStorage.from_env(env).engine_manifests()
    jax_repo.insert(JaxManifest(id="e", version="3", name="default",
                                description=None, files=["x.json"],
                                engine_factory="pkg.f"))
    repo = Storage.from_env(env).engine_manifests()
    assert repo.get("e", "3") == EngineManifest(
        id="e", version="3", name="default", description=None,
        files=["x.json"], engine_factory="pkg.f")
    repo.insert(EngineManifest(id="e", version="4", name="n"))
    assert JaxStorage.from_env(env).engine_manifests().get(
        "e", "4").name == "n"


@pytest.mark.parametrize("kind", ["memory", "localfs", "eventlog"])
def test_build_registers_the_manifest_on_every_backend(tmp_path, monkeypatch,
                                                       capsys, kind):
    env = _backend_env(kind, tmp_path)
    storage = Storage.from_env(env)
    set_storage(storage)
    try:
        tdir = tmp_path / "proj"
        assert cli.main(["template", "get", "recommendation",
                         str(tdir)]) == 0
        ej = str(tdir / "engine.json")
        assert cli.main(["build", "--engine-json", ej,
                         "--engine-version", "7"]) == 0
        assert cli.main(["build", "--engine-json", ej,
                         "--engine-version", "7"]) == 0   # an update
        out = capsys.readouterr().out
        assert ("Registered engine recommendation_engine."
                "recommendation_engine 7") in out
        (m,) = storage.engine_manifests().get_all()
        assert (m.id, m.version, m.name, m.files) == (
            "recommendation_engine.recommendation_engine", "7", "default",
            [ej])
    finally:
        set_storage(None)


# -- the CLI ---------------------------------------------------------------------------

@pytest.fixture()
def memory_store():
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    set_storage(storage)
    yield storage
    set_storage(None)


def test_app_and_template_commands(memory_store, tmp_path, capsys):
    assert cli.main(["app", "new", "cliapp"]) == 0
    assert "Access Key:" in capsys.readouterr().out
    assert cli.main(["app", "list"]) == 0
    assert cli.main(["status"]) == 0
    assert cli.main(["app", "new", "cliapp"]) == 1
    assert "already exists" in capsys.readouterr().err
    assert cli.main(["template", "list"]) == 0
    listed = capsys.readouterr().out
    for name in ("recommendation", "similarproduct",
                 "ecommercerecommendation", "classification", "vanilla",
                 "regression", "twotower", "twotower-hybrid", "sessionrec"):
        assert name in listed
    tdir = str(tmp_path / "eng")
    assert cli.main(["template", "get", "recommendation", tdir]) == 0
    v = json.load(open(f"{tdir}/engine.json"))
    assert v["engineFactory"].endswith("recommendation_engine")
    assert os.path.exists(f"{tdir}/recommendation_engine.py")
    assert os.path.exists(f"{tdir}/README.md")


def _family_project(name, storage, tmp_path):
    """Events (or a data file) for template ``name`` and the engine.json
    blocks that train it small, with a query and a check of its answer."""
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    if name in ("classification", "sessionrec"):
        app = storage.apps().insert("fam")
        storage.events().init(app.id)
    if name == "classification":
        rows = [(f"u{n}", float(n % 2), [8.0, 1.0, 1.0] if n % 2 == 0
                 else [1.0, 1.0, 8.0]) for n in range(21)]
        storage.events().insert_batch([
            Event(event="$set", entity_type="user", entity_id=u,
                  properties={"plan": lbl, **{f"attr{j}": v
                                              for j, v in enumerate(f)}},
                  event_time=t0) for u, lbl, f in rows], app.id)
        return ({"app_name": "fam"},
                [{"name": "naive", "params": {}},
                 {"name": "logistic", "params": {"iterations": 50}}],
                {"features": [1.0, 1.0, 8.0]},
                lambda answer: answer == {"label": 1.0})
    if name == "sessionrec":
        storage.events().insert_batch([
            Event(event="view", entity_type="user", entity_id=f"u{u}",
                  target_entity_type="item", target_entity_id=f"i{(u + t) % 6}",
                  event_time=t0 + dt.timedelta(seconds=t))
            for u in range(12) for t in range(6)], app.id)
        return ({"app_name": "fam"},
                [{"name": "sessionrec", "params": {
                    "dim": 8, "heads": 2, "layers": 1, "max_len": 6,
                    "epochs": 2, "batch_size": 8}}],
                {"user": "u0", "num": 3},
                lambda answer: len(answer["itemScores"]) == 3)
    if name == "regression":
        rng = np.random.default_rng(0)
        x = rng.normal(size=(60, 3))
        path = tmp_path / "lr_data.txt"
        path.write_text("".join(
            f"{r @ [2.0, -1.0, 0.5]} {r[0]} {r[1]} {r[2]}\n" for r in x))
        return ({"filepath": str(path)},
                [{"name": "sgd", "params": {"iterations": 300,
                                            "step_size": 0.2}},
                 {"name": "ridge", "params": {}}],
                {"features": [1.0, 1.0, 1.0]},
                lambda answer: abs(answer - 1.5) < 0.1)
    return ({}, [{"name": "algo", "params": {"mult": 3}}], {"q": 2.0},
            lambda answer: answer == {"p": 6.0})


@pytest.mark.parametrize("name", ["classification", "regression", "vanilla",
                                  "sessionrec"])
def test_unported_templates_raise_naming_their_roadmap_item(
        memory_store, tmp_path, capsys, name):
    """Formerly "not ported" (ROADMAP.md items 8 and 11): each template's
    scaffold now builds, trains on the CPU and answers through the
    port's deploy path."""
    from predictionio_torch.workflow.deploy import prepare_deploy

    assert cli.main(["template", "list"]) == 0
    assert "not ported" not in capsys.readouterr().out
    tdir = tmp_path / "t"
    assert cli.main(["template", "get", name, str(tdir)]) == 0
    ds, algos, query, check = _family_project(name, memory_store, tmp_path)
    ej = tdir / "engine.json"
    v = json.loads(ej.read_text())
    v["datasource"] = {"params": ds}
    v["algorithms"] = algos
    ej.write_text(json.dumps(v))
    assert cli.main(["build", "--engine-json", str(ej)]) == 0
    assert cli.main(["train", "--engine-json", str(ej),
                     "--device", "cpu"]) == 0
    assert "COMPLETED" in capsys.readouterr().out
    engine, _ = cli.engine_from_json(str(ej))
    instance = memory_store.engine_instances().get_latest_completed(
        v["engineFactory"], "0", "default")
    deployment = prepare_deploy(engine, instance, ctx, memory_store)
    assert check(deployment.query(query)), deployment.query(query)


def test_deploy_of_a_variant_with_an_slo_block_raises(memory_store, tmp_path,
                                                     monkeypatch, capsys):
    """A variant with an ``"slo"`` block once raised (SLOs were not
    ported); now ``cli deploy`` serves it, its ``shed`` thresholds reach
    the admission controller and its objectives ``/admin/slo``."""
    from predictionio_torch.serving import http as port_http
    from predictionio_torch.serving.engine_server import EngineServer

    app = memory_store.apps().insert("reco")
    memory_store.events().init(app.id)
    memory_store.events().insert_batch(_rate_events(), app.id)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({
        "engineFactory": "predictionio_torch.templates.recommendation."
                         "recommendation_engine",
        "datasource": {"params": {"app_name": "reco"}},
        "algorithms": [{"name": "als", "params": {"rank": 4,
                                                  "num_iterations": 2}}],
        "slo": {"latency_ms": 50, "latency_objective": 0.995,
                "availability_objective": 0.99,
                "shed": {"queue_depth": 7, "inflight": 5, "burn": 9.0}}}))
    assert cli.main(["train", "--engine-json", str(path),
                     "--device", "cpu"]) == 0
    seen = {}

    def serve_once(server):
        # in place of serving until SIGTERM: read the deployed server
        server.start()
        try:
            seen["limits"] = server.admission.snapshot()["limits"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/admin/slo",
                    timeout=30) as resp:
                seen["slo"] = {e["name"]: e for e in json.load(resp)["slos"]}
        finally:
            server.stop()

    monkeypatch.setattr(EngineServer, "serve_forever", serve_once)
    monkeypatch.setattr(port_http, "install_drain_handler",
                        lambda *servers, **kw: None)
    assert cli.main(["deploy", "--engine-json", str(path), "--ip",
                     "127.0.0.1", "--port", "0", "--device", "cpu"]) == 0
    assert "deployed on 127.0.0.1" in capsys.readouterr().out
    assert seen["limits"] == {"queue_depth": 7, "inflight": 5, "burn": 9.0}
    latency = seen["slo"]["serving-latency"]
    assert latency["threshold_ms"] == 50.0
    assert latency["objective"] == 0.995
    assert seen["slo"]["http-availability"]["objective"] == 0.99


def _rate_events(n=1200, n_users=40, n_items=30, seed=0):
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    return [Event(event="rate", entity_type="user",
                  entity_id=f"u{rng.integers(n_users)}",
                  target_entity_type="item",
                  target_entity_id=f"i{rng.zipf(1.3) % n_items}",
                  properties={"rating": float(rng.integers(1, 6))},
                  event_time=t0 + dt.timedelta(seconds=j))
            for j in range(n)]


def test_build_train_via_cli(memory_store, tmp_path, capsys):
    app = memory_store.apps().insert("reco")
    memory_store.events().init(app.id)
    memory_store.events().insert_batch(_rate_events(), app.id)
    tdir = tmp_path / "eng"
    assert cli.main(["template", "get", "recommendation", str(tdir)]) == 0
    ej = tdir / "engine.json"
    v = json.loads(ej.read_text())
    v["datasource"] = {"params": {"app_name": "reco"}}
    v["algorithms"] = [{"name": "als", "params": {"rank": 4,
                                                  "num_iterations": 2}}]
    ej.write_text(json.dumps(v))
    assert cli.main(["build", "--engine-json", str(ej)]) == 0
    assert cli.main(["train", "--engine-json", str(ej),
                     "--device", "cpu"]) == 0
    assert "COMPLETED" in capsys.readouterr().out
    assert len(memory_store.engine_manifests().get_all()) == 1
    instances = memory_store.engine_instances().get_all()
    assert instances and instances[0].status == "COMPLETED"
    assert instances[0].engine_factory == (
        "recommendation_engine.recommendation_engine")


def test_scaffolded_source_is_editable_and_projects_do_not_collide(
        memory_store, tmp_path, capsys):
    app = memory_store.apps().insert("scaffold")
    memory_store.events().init(app.id)
    memory_store.events().insert_batch(
        [Event(event="buy", entity_type="user", entity_id=f"u{k % 6}",
               target_entity_type="item", target_entity_id=f"i{k % 4}")
         for k in range(40)], app.id)
    tdir = tmp_path / "myreco"
    assert cli.main(["template", "get", "recommendation", str(tdir)]) == 0
    src_path = tdir / "recommendation_engine.py"
    src = src_path.read_text()
    assert "buy_rating: float = 4.0" in src
    src_path.write_text(src.replace("buy_rating: float = 4.0",
                                    "buy_rating: float = 2.5"))
    ej = tdir / "engine.json"
    v = json.loads(ej.read_text())
    v["datasource"] = {"params": {"app_name": "scaffold"}}
    v["algorithms"] = [{"name": "als", "params": {
        "rank": 4, "num_iterations": 2, "block_size": 8}}]
    ej.write_text(json.dumps(v))
    assert cli.main(["train", "--engine-json", str(ej),
                     "--device", "cpu"]) == 0
    assert "COMPLETED" in capsys.readouterr().out
    mod = next(m for k, m in sys.modules.items()
               if k.startswith("_pio_project_")
               and getattr(m, "__file__", None) == str(src_path))
    assert mod.RecoDataSourceParams().buy_rating == 2.5
    tdir2 = tmp_path / "other"
    assert cli.main(["template", "get", "recommendation", str(tdir2)]) == 0
    engine2 = EngineVariant.load(str(tdir2 / "engine.json")).create_engine()
    ds_cls = next(iter(engine2.data_source_classes.values()))
    assert ds_cls.__module__ != mod.__name__
    assert sys.modules[ds_cls.__module__].RecoDataSourceParams() \
        .buy_rating == 4.0


# -- the Quick Start, end to end -------------------------------------------------------

def _put_quickstart_events(storage, template):
    """Seeded events each template trains on."""
    app = storage.apps().insert("qs")
    storage.events().init(app.id)
    rng = np.random.default_rng(1)
    t0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
    if template == "recommendation":
        storage.events().insert_batch(_rate_events(), app.id)
        return
    events = [Event(event="$set", entity_type="user", entity_id=f"u{u}")
              for u in range(40)]
    events += [Event(event="$set", entity_type="item", entity_id=f"i{i}",
                     properties={"categories": [f"c{i % 3}"]})
               for i in range(30)]
    for j in range(1500):
        u, i = f"u{rng.integers(40)}", f"i{rng.zipf(1.3) % 30}"
        name = ("view" if template == "similarproduct" else "rate")
        props = ({} if name == "view"
                 else {"rating": float(rng.integers(1, 6))})
        events.append(Event(event=name, entity_type="user", entity_id=u,
                            target_entity_type="item", target_entity_id=i,
                            properties=props,
                            event_time=t0 + dt.timedelta(seconds=j)))
        if template == "similarproduct" and j % 4 == 0:
            events.append(Event(
                event="like" if j % 8 else "dislike", entity_type="user",
                entity_id=u, target_entity_type="item", target_entity_id=i,
                event_time=t0 + dt.timedelta(seconds=j)))
    storage.events().insert_batch(events, app.id)


QUICKSTART = {
    "recommendation": (
        {"datasource": {"params": {"app_name": "qs"}},
         "algorithms": [{"name": "als", "params": {"rank": 4,
                                                   "num_iterations": 3}}]},
        [{"user": "u1", "num": 4}, {"item": "i2", "num": 3}]),
    "similarproduct": (
        {"datasource": {"params": {"app_name": "qs"}},
         "algorithms": [{"name": "als", "params": {"rank": 4,
                                                   "num_iterations": 3}},
                        {"name": "likealgo",
                         "params": {"rank": 4, "num_iterations": 3}}]},
        [{"items": ["i1"], "num": 4},
         {"items": ["i1", "i2"], "num": 3, "categories": ["c1"]}]),
    "ecommercerecommendation": (
        {"datasource": {"params": {"app_name": "qs"}},
         "algorithms": [{"name": "als", "params": {
             "app_name": "qs", "rank": 4, "num_iterations": 3}}]},
        [{"user": "u1", "num": 4},
         {"user": "u2", "num": 3, "blackList": ["i1"]}]),
}

BLOCKED_CLI = (
    "import atexit, json, sys\n"
    "FORBIDDEN = ('jax', 'jaxlib', 'optax', 'flax', 'predictionio_tpu')\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in FORBIDDEN:\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "atexit.register(lambda: print('MODULES ' + json.dumps(sorted(\n"
    "    m for m in sys.modules if m.split('.')[0] in FORBIDDEN)),\n"
    "    flush=True))\n"
    "from predictionio_torch.tools import cli\n"
    "sys.exit(cli.main(sys.argv[1:]))\n")


def _run_blocked(args, env, **kw):
    """A port CLI command in a process where importing the JAX package,
    jax, optax or flax raises."""
    return subprocess.run([sys.executable, "-c", BLOCKED_CLI, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300, **kw)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _deploy_and_query(ej, env, queries):
    """``cli deploy`` in a blocked process of its own; the queries'
    answers; ``cli undeploy``; the server's exit code and the forbidden
    modules it held at exit."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_CLI, "deploy", "--engine-json",
         str(ej), "--ip", "127.0.0.1", "--port", str(port), "--device",
         "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                       timeout=5).read()
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(f"deploy: {proc.stdout.read()}")
                time.sleep(0.2)
        answers = [_post(port, q) for q in queries]
        stop = _run_blocked(["undeploy", "--port", str(port)], env)
        assert stop.returncode == 0, stop.stderr
        code = proc.wait(timeout=60)
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    modules = json.loads(out.split("MODULES ")[-1].splitlines()[0])
    return answers, code, modules


@pytest.mark.parametrize("template", sorted(QUICKSTART))
def test_quick_start_template_get_build_train_deploy(tmp_path, template):
    env_store = _backend_env("localfs", tmp_path)
    storage = Storage.from_env(env_store)
    _put_quickstart_events(storage, template)
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("PIO_STORAGE_")},
           **env_store, "PYTHONPATH": ROOT}
    tdir = tmp_path / "proj"
    out = _run_blocked(["template", "get", template, str(tdir)], env)
    assert out.returncode == 0, out.stderr
    ej = tdir / "engine.json"
    ej.write_text(json.dumps({**json.loads(ej.read_text()),
                              **QUICKSTART[template][0]}))
    for args in (["build", "--engine-json", str(ej)],
                 ["train", "--engine-json", str(ej), "--device", "cpu"]):
        out = _run_blocked(args, env)
        assert out.returncode == 0, out.stderr
        assert "MODULES []" in out.stdout
    storage = Storage.from_env(env_store)
    (manifest,) = storage.engine_manifests().get_all()
    assert manifest.engine_factory.startswith(
        template.replace("-", "_") + "_engine.")
    answers, code, modules = _deploy_and_query(ej, env,
                                               QUICKSTART[template][1])
    assert code == 0 and modules == []
    assert all(a["itemScores"] for a in answers), answers


def test_a_jax_scaffolded_project_runs_on_the_port_without_jax(tmp_path):
    """The JAX console's ``template get recommendation`` copies the JAX
    template's source, which imports ``predictionio_tpu``; the port
    builds, trains and deploys it with the JAX package out of reach."""
    tdir = tmp_path / "jaxproj"
    assert jax_cli_main(["template", "get", "recommendation",
                         str(tdir)]) == 0
    src = (tdir / "recommendation_engine.py").read_text()
    assert "from predictionio_tpu.parallel.mesh import MeshContext" in src
    env_store = _backend_env("localfs", tmp_path)
    _put_quickstart_events(Storage.from_env(env_store), "recommendation")
    env = {**{k: v for k, v in os.environ.items()
              if not k.startswith("PIO_STORAGE_")},
           **env_store, "PYTHONPATH": ROOT}
    ej = tdir / "engine.json"
    ej.write_text(json.dumps({**json.loads(ej.read_text()),
                              **QUICKSTART["recommendation"][0]}))
    for args in (["build", "--engine-json", str(ej)],
                 ["train", "--engine-json", str(ej), "--device", "cpu"]):
        out = _run_blocked(args, env)
        assert out.returncode == 0, out.stderr
        assert "MODULES []" in out.stdout
    instance = Storage.from_env(env_store).engine_instances() \
        .get_latest_completed("recommendation_engine.recommendation_engine",
                              "0", "default")
    assert instance is not None
    answers, code, modules = _deploy_and_query(
        ej, env, QUICKSTART["recommendation"][1])
    assert code == 0 and modules == []
    assert all(a["itemScores"] for a in answers)
