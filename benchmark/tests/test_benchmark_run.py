"""``run.py`` and ``BENCHMARK.json`` against the benchmark's contract."""

import json
import os
import re
import subprocess
import sys

from benchmark.lib import cells
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "als-ml20m.train",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert not out.stdout.strip()


def test_unknown_workload_exits_nonzero():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nope",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_json_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert b["command"][1] == "benchmark/run.py"
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] == []
        names.add(c["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert w["config"] in names and len(w["why"]) <= 200
        cell = cells.load(ROOT, w["name"])      # every file it names
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        runner = cells.runner(cell.config)
        assert callable(runner.run) and callable(runner.readings)
        assert runner.FAULTS
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert len(json.dumps(b)) < 64 * 1024


def test_command_names_no_file_outside_paths():
    b = bench()
    for word in b["command"]:
        assert not word.startswith("/") and ".." not in word
    assert b["command"][1].startswith(b["paths"][0] + "/")

