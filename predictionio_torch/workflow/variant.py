"""Engine variant (engine.json) loading.

Counterpart of ``predictionio_tpu/workflow/variant.py``. Behavior
contract from the reference (CreateWorkflow.scala:152-177 +
Engine.scala:328-384): an engine variant JSON names the engine factory
and fills each DASE slot with ``{name, params}`` blocks:

    {
      "id": "default",
      "description": "...",
      "engineFactory": "myengine.RecommendationEngine",
      "datasource": {"name": "", "params": {...}},
      "preparator": {"name": "", "params": {...}},
      "algorithms": [{"name": "als", "params": {...}}],
      "serving": {"name": "", "params": {...}}
    }

The reference's ``sparkConf`` passthrough is ``runtimeConf``; an
``"slo"`` block is read by ``slo_conf()``.

A factory module that sits beside the engine.json (a project that ``pio
template get`` scaffolded) loads from its file under a path-keyed module
name, as in the JAX package, so a model class it defines unpickles in a
later deploy process. Such a module may have been scaffolded by the JAX
package and import ``predictionio_tpu``: the loader parses it and
rewrites every import of ``predictionio_tpu`` or a module under it to
the same module under ``predictionio_torch`` (``core.engine.port_module``)
before it compiles the tree, so the project runs on the port and nothing
of the JAX package is imported. Strings and comments are left as they
are.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from predictionio_torch.core.engine import (JAX_PACKAGE, PORT_PACKAGE,
                                            Engine, factory_from_object,
                                            port_module,
                                            resolve_engine_factory)
from predictionio_torch.core.params import EngineParams


class _PortImports(ast.NodeTransformer):
    """``predictionio_tpu[.x]`` -> ``predictionio_torch[.x]`` in import
    statements. ``import predictionio_tpu.x`` also binds the name
    ``predictionio_tpu`` (to the port's package), so attribute paths
    through it keep working."""

    def visit_Import(self, node: ast.Import):
        bind_root = False
        for alias in node.names:
            ported = port_module(alias.name)
            if ported != alias.name and alias.asname is None:
                bind_root = True
            alias.name = ported
        if not bind_root:
            return node
        root = ast.Assign(targets=[ast.Name(JAX_PACKAGE, ast.Store())],
                          value=ast.Name(PORT_PACKAGE, ast.Load()))
        return [node, ast.copy_location(root, node)]

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.level == 0 and node.module:
            node.module = port_module(node.module)
        return node


def port_project_source(source: str, path: str = "<project>"):
    """A project module's source -> its code object with every import of
    the JAX package rewritten to the port's."""
    tree = _PortImports().visit(ast.parse(source, filename=path))
    return compile(ast.fix_missing_locations(tree), path, "exec")


def _load_project_module(path: str):
    """Load a project-local engine module by file path.

    The sys.modules key is derived from the absolute path, so it is (a)
    unique per project — no cross-project shadowing, (b) deterministic
    across processes and the same as the JAX package's — classes pickled
    out of the module (custom models) unpickle in a later deploy process
    once create_engine has loaded the module again."""
    import importlib.util

    path = os.path.abspath(path)
    key = "_pio_project_" + hashlib.md5(path.encode()).hexdigest()[:12]
    mtime = os.path.getmtime(path)
    cached = sys.modules.get(key)
    if (cached is not None
            and getattr(cached, "__file__", None) == path
            and getattr(cached, "__pio_mtime__", None) == mtime):
        return cached
    with open(path) as f:
        code = port_project_source(f.read(), path)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    module.__pio_mtime__ = mtime
    sys.modules[key] = module
    try:
        exec(code, module.__dict__)
    except BaseException:
        sys.modules.pop(key, None)
        raise
    return module


@dataclass
class EngineVariant:
    id: str
    engine_factory: str
    description: str = ""
    raw: Dict[str, Any] = field(default_factory=dict)
    #: directory of the engine.json; scaffolded engine modules (`pio
    #: template get`) resolve from here — the analogue of the reference
    #: building the project dir onto the classpath (Console.scala:772
    #: `pio build` before train/deploy)
    base_dir: Optional[str] = None

    @staticmethod
    def from_dict(d: Dict[str, Any],
                  base_dir: Optional[str] = None) -> "EngineVariant":
        if "engineFactory" not in d:
            raise ValueError("engine variant requires 'engineFactory'")
        return EngineVariant(id=d.get("id", "default"),
                             engine_factory=d["engineFactory"],
                             description=d.get("description", ""),
                             raw=dict(d), base_dir=base_dir)

    @staticmethod
    def load(path: str) -> "EngineVariant":
        with open(path) as f:
            return EngineVariant.from_dict(
                json.load(f), base_dir=os.path.dirname(os.path.abspath(path)))

    def create_engine(self) -> Engine:
        # a factory module next to the engine.json loads from its file
        # under a path-keyed module name: two projects both named
        # `recommendation_engine` never shadow each other, and sys.path
        # is never changed
        if self.base_dir:
            mod_name, _, attr = self.engine_factory.rpartition(".")
            candidate = (os.path.join(self.base_dir, *mod_name.split("."))
                         + ".py" if mod_name else None)
            if candidate and os.path.isfile(candidate):
                module = _load_project_module(candidate)
                return factory_from_object(getattr(module, attr),
                                           self.engine_factory)()
        return resolve_engine_factory(self.engine_factory)()

    def engine_params(self, engine: Optional[Engine] = None) -> EngineParams:
        engine = engine or self.create_engine()
        return engine.engine_params_from_variant(self.raw)

    def runtime_conf(self) -> Dict[str, str]:
        return dict(self.raw.get("runtimeConf")
                    or self.raw.get("sparkConf") or {})

    def slo_conf(self) -> Optional[Dict[str, Any]]:
        """The variant's declarative ``"slo"`` block (objectives and
        shedding thresholds, read by `pio deploy`), or None when the
        variant declares none."""
        block = self.raw.get("slo")
        if block is None:
            return None
        if not isinstance(block, dict):
            raise ValueError('engine variant "slo" must be a JSON object')
        return dict(block)
