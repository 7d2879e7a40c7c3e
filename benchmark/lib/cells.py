"""What a cell is made of, found by name from ``BENCHMARK.json``:

- its configuration, ``benchmark/configs/<config>.json`` (the file the
  entry names), whose ``runner`` names ``benchmark/runners/<runner>.py``;
- its traffic mix, ``benchmark/traffic/<traffic>.json``;
- the limits of its correctness numbers, ``benchmark/limits/<cell>.json``;
- one reader a per-layer metric, ``benchmark/metrics/<metric>.py``.

A later change adds a configuration, a cell or a metric by adding these
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, e2e_names: Optional[set] = None) -> bool:
    """A metric is the cell's where its ``workloads`` list it or, with
    no such key, where the cell reports the metric it moves (per-layer)
    or always (end to end)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None or "moves" not in metric:
        return True
    return metric["moves"] in e2e_names


def load(root: str, name: str) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(work)})")
    w = work[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, entry["file"]))
    mix = _load_json(os.path.join(root, "benchmark", "traffic",
                                  f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(root, "benchmark", "limits",
                                     f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), workload=w, config=config,
                mix=mix, limits=limits, end_to_end=e2e, per_layer=per_layer)


def runner(config: dict):
    """The module ``benchmark/runners/<config['runner']>.py``."""
    return importlib.import_module(f"benchmark.runners.{config['runner']}")


def reader(root: str, metric: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(readings: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each number compared beside its limit, in the limits file's
    order; a number the run did not give reads as None and fails."""
    out = {}
    for key, spec in limits["checks"].items():
        value = readings.get(key)
        ok = value is not None and value == value and value <= spec["limit"]
        out[key] = {"value": value, "limit": spec["limit"], "ok": ok}
    return out
