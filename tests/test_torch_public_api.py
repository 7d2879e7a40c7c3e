"""The port's public API against the JAX package's, on the CPU:
``DataMap``'s methods (the ``tests/test_datamap.py`` cases through both
packages), ``SimpleEngine``, and the package exports of ``data``,
``core`` and ``obs``.

Each case runs the same inputs through both packages' classes and
compares what they return (values, raised exception types, hashes and
JSON text); ``SimpleEngine`` trains and evaluates the sample engine's
one-of-each components exactly as the JAX one does.
"""

from __future__ import annotations

import datetime as dt
import importlib

import pytest

from predictionio_tpu.core import SimpleEngine as JaxSimpleEngine
from predictionio_tpu.data import datamap as jax_datamap
from predictionio_tpu.parallel.mesh import MeshContext
from predictionio_torch.core import SimpleEngine
from predictionio_torch.data import datamap
from predictionio_torch.parallel.context import DeviceContext

from tests import sample_engine as jax_sample
from tests import torch_sample_engine as port_sample
from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

UTC = dt.timezone.utc
PACKAGES = {"jax": jax_datamap, "port": datamap}


def both(case):
    """``case(module)`` through each package: (outcome, value), where a
    raised exception's outcome is its class name."""
    out = {}
    for name, module in PACKAGES.items():
        try:
            out[name] = ("ok", case(module))
        except Exception as e:  # noqa: BLE001 — the raised type is compared
            out[name] = ("raised", type(e).__name__)
    return out["jax"], out["port"]


CASES = {
    "typed_get": lambda m: [
        m.DataMap({"a": 1, "b": "x", "c": 2.5, "d": True, "arr": [1, 2],
                   "obj": {"k": 1}}).get(k, t)
        for k, t in (("a", int), ("b", str), ("c", float), ("a", float),
                     ("d", bool), ("arr", list), ("obj", dict))],
    "get_missing_raises": lambda m: m.DataMap({"a": 1}).get("nope"),
    "get_default": lambda m: m.DataMap({"a": 1}).get("nope", 5),
    "get_opt": lambda m: [m.DataMap({"a": 1}).get_opt("a", int),
                          m.DataMap({"a": 1}).get_opt("missing"),
                          m.DataMap({"a": 1}).get_opt("missing", default=7)],
    "get_or_else": lambda m: [m.DataMap({"a": 1}).get_or_else("missing", "x"),
                              m.DataMap({"a": 1}).get_or_else("a", "x")],
    "type_mismatch": lambda m: m.DataMap({"a": "str"}).get("a", int),
    "bool_is_not_int": lambda m: m.DataMap({"a": True}).get("a", int),
    "merge_right_biased": lambda m: m.DataMap({"x": 1, "y": 2}).merge(
        m.DataMap({"y": 3, "z": 4})).to_dict(),
    "merge_a_mapping": lambda m: m.DataMap({"x": 1}).merge(
        {"x": [2], "w": None}).to_dict(),
    "remove_and_keyset": lambda m: [
        sorted(m.DataMap({"x": 1, "y": 2, "z": 3}).remove(["y"]).keyset()),
        sorted(m.DataMap({"x": 1, "y": 2, "z": 3}).keyset())],
    "to_json": lambda m: m.DataMap({"b": [1, "two"], "a": 1,
                                    "c": {"n": None}}).to_json(),
    "json_roundtrip": lambda m: m.DataMap.from_json(
        m.DataMap({"a": 1, "b": [1, "two"], "c": {"n": None}}).to_json()
    ) == m.DataMap({"a": 1, "b": [1, "two"], "c": {"n": None}}),
    "from_json": lambda m: m.DataMap.from_json('{"q": [1, {"r": 2.5}]}')
    .to_dict(),
    "hash_consistent_with_eq": lambda m: [
        hash(m.DataMap({"a": 1, "l": [1, {"k": 2}]}))
        == hash(m.DataMap({"l": [1.0, {"k": 2}], "a": 1.0})),
        len({m.DataMap({"a": 1}), m.DataMap({"a": 1}),
             m.DataMap({"a": 2})})],
    "hash_value": lambda m: hash(m.DataMap({"a": 1, "b": ("t",)})),
    "property_map_times": lambda m: [
        (pm.get("a", int), pm.first_updated, pm.last_updated)
        for pm in [m.PropertyMap({"a": 1},
                                 first_updated=dt.datetime(2026, 1, 1,
                                                           tzinfo=UTC),
                                 last_updated=dt.datetime(2026, 1, 2,
                                                          tzinfo=UTC))]],
    "property_map_hash_and_merge": lambda m: [
        hash(m.PropertyMap({"a": 1}, dt.datetime(2026, 1, 1, tzinfo=UTC),
                           dt.datetime(2026, 1, 2, tzinfo=UTC)))
        == hash(m.DataMap({"a": 1})),
        type(m.PropertyMap({"a": 1}, dt.datetime(2026, 1, 1, tzinfo=UTC),
                           dt.datetime(2026, 1, 2, tzinfo=UTC)).merge(
            {"b": 2})).__name__],
    "error_is_a_key_error": lambda m: issubclass(m.DataMapError, KeyError),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_datamap_answers_like_jax(name):
    jax_answer, port_answer = both(CASES[name])
    assert port_answer == jax_answer


def test_the_reference_cases_hold_on_the_port():
    """``tests/test_datamap.py``'s assertions, on the port's classes."""
    d = datamap.DataMap({"a": 1})
    assert d.get_or_else("missing", "x") == "x"
    assert datamap.DataMap({"x": 1, "y": 2}).merge(
        datamap.DataMap({"y": 3, "z": 4})).to_dict() == {"x": 1, "y": 3,
                                                         "z": 4}
    full = datamap.DataMap({"x": 1, "y": 2, "z": 3})
    assert full.remove(["y"]).keyset() == {"x", "z"}
    assert full.keyset() == {"x", "y", "z"}
    d = datamap.DataMap({"a": 1, "b": [1, "two"], "c": {"n": None}})
    assert datamap.DataMap.from_json(d.to_json()) == d


# -- SimpleEngine ----------------------------------------------------------------

def _simple(engine_cls, sample):
    return engine_cls(sample.DataSource0, sample.Preparator0, sample.Algo0,
                      sample.Serving0)


def _one_of_each(params_cls, sample):
    return params_cls(
        data_source_params=("", sample.IdParams(id=1)),
        preparator_params=("", sample.IdParams(id=2)),
        algorithm_params_list=[("", sample.IdParams(id=3))],
        serving_params=("", sample.IdParams(id=9)))


def test_simple_engine_trains_and_evaluates_like_jax():
    from predictionio_tpu.core import EngineParams as JaxEngineParams
    from predictionio_torch.core import EngineParams

    port_engine = _simple(SimpleEngine, port_sample)
    jax_engine = _simple(JaxSimpleEngine, jax_sample)
    for engine in (port_engine, jax_engine):
        assert set(engine.data_source_classes) == {""}
        assert set(engine.algorithm_classes) == {""}
    port_params = _one_of_each(EngineParams, port_sample)
    jax_params = _one_of_each(JaxEngineParams, jax_sample)
    (port_model,) = port_engine.train(DeviceContext("cpu"),
                                      port_params).models
    (jax_model,) = jax_engine.train(MeshContext(), jax_params).models
    assert str(port_model) == str(jax_model)
    assert (str(port_engine.eval(DeviceContext("cpu"), port_params))
            == str(jax_engine.eval(MeshContext(), jax_params)))


def test_simple_engine_reads_a_variant_like_jax():
    variant = {"datasource": {"params": {"id": 4}},
               "algorithms": [{"name": "", "params": {"id": 6}}]}
    port = _simple(SimpleEngine, port_sample).engine_params_from_variant(variant)
    jax = _simple(JaxSimpleEngine, jax_sample).engine_params_from_variant(variant)
    assert str(port) == str(jax)


# -- package exports -------------------------------------------------------------

@pytest.mark.parametrize("package", ["data", "core", "obs"])
def test_package_exports_are_jaxs(package):
    jax_pkg = importlib.import_module(f"predictionio_tpu.{package}")
    port_pkg = importlib.import_module(f"predictionio_torch.{package}")
    renamed = {"jaxmon": "torchmon"}
    want = {renamed.get(n, n) for n in jax_pkg.__all__}
    assert want <= set(port_pkg.__all__)
    for name in want:
        assert getattr(port_pkg, name) is not None, name
    if package == "obs":
        assert port_pkg.quality.__name__ == "predictionio_torch.obs.quality"
        assert port_pkg.slo.MONITOR is not None
        assert port_pkg.timeline.TIMELINE is not None
