"""``pio bench-compare`` on the port (``tools/benchcmp.py``, ``cli
bench-compare``) against the JAX package's, on the CPU.

The same bench files (the checked-in trajectory under
``tests/data/bench``, and rounds edited from it: a config change, a
round without metrics, rounds with ``key.*`` blocks, a missing file)
through both packages give the same printed rows and the same exit
codes, through ``benchcmp.run`` and through ``cli bench-compare``;
``load_metrics``, ``compare``'s deltas and the direction rules agree
metric for metric. And the port's command tree is JAX's, every
command of it. The root logger's
handlers and level are put back after each test.
"""

import dataclasses
import io
import json
import logging
import os
from pathlib import Path

import pytest

from predictionio_tpu.tools import benchcmp as jax_benchcmp
from predictionio_tpu.tools import cli as jax_cli
from predictionio_torch.tools import benchcmp
from predictionio_torch.tools import cli

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

FIXTURES = sorted(str(p) for p in (Path(__file__).parent / "data" / "bench")
                  .glob("BENCH_r*.json"))
#: the JAX console's commands the port leaves to a later slice: none
NOT_PORTED: set = set()


@pytest.fixture(autouse=True)
def root_logging_restored():
    """Either package's ``cli.main`` installs its console handler on the
    root logger, writing to the stream of the moment (capsys's, closed
    after the test), and sets the root level: both go back after each
    test, so the later tests of the worker do not log into a closed
    stream (a slow path: every record then prints a traceback)."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for handler in list(root.handlers):
        if handler not in handlers:
            root.removeHandler(handler)
    for handler in handlers:
        if handler not in root.handlers:
            root.addHandler(handler)
    root.setLevel(level)


def _round(tmp_path, name, parsed):
    path = tmp_path / name
    path.write_text(json.dumps({"n": 1, "cmd": "python bench.py", "rc": 0,
                                "parsed": parsed}))
    return str(path)


def _trajectories(tmp_path):
    doc = json.loads(Path(FIXTURES[1]).read_text())
    doc["parsed"]["detail"]["rank"] = 128
    changed = tmp_path / "BENCH_r99.json"
    changed.write_text(json.dumps(doc))
    empty = _round(tmp_path, "BENCH_r98.json", {})
    keyed = [_round(tmp_path, f"BENCH_r9{j}.json", {
        "metric": "m", "value": 1.0,
        "key": {"journal_append_us": us, "anomaly_scan_ms": ms,
                "quality_recall_vs_retrain": recall, "n_users": 10,
                "twotower_mfu": mfu, "serve_p99_ms": 0.0}})
        for j, (us, ms, recall, mfu) in enumerate(
            ((10.0, 2.0, 0.99, 0.3), (14.0, 1.9, 0.9, 0.31)))]
    return {
        "within": FIXTURES[:2], "regression": FIXTURES,
        "improved": [FIXTURES[2], FIXTURES[1]],
        "config-changed": [FIXTURES[0], str(changed)],
        "one-file": FIXTURES[:1],
        "skips-empty": [FIXTURES[0], empty, FIXTURES[1]],
        "keyed": keyed, "no-common": [FIXTURES[0], keyed[0]],
        "missing-file": [FIXTURES[0], str(tmp_path / "BENCH_r00.json")],
    }


CASES = ["within", "regression", "improved", "config-changed", "one-file",
         "skips-empty", "keyed", "no-common", "missing-file"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("against,tolerance", [("prev", 10.0),
                                               ("first", 2.5)])
def test_run_prints_the_same_rows_and_exits_alike(tmp_path, case, against,
                                                  tolerance):
    files = _trajectories(tmp_path)[case]
    outs, rcs = {}, {}
    for name, module in (("jax", jax_benchcmp), ("port", benchcmp)):
        buf = io.StringIO()
        rcs[name] = module.run(files, tolerance_pct=tolerance,
                               against=against, out=buf)
        outs[name] = buf.getvalue()
    assert rcs["port"] == rcs["jax"]
    assert outs["port"] == outs["jax"]
    assert outs["port"].startswith("bench-compare:")


@pytest.mark.parametrize("case", ["within", "regression", "config-changed",
                                  "keyed"])
def test_metrics_and_deltas_agree(tmp_path, case):
    files = _trajectories(tmp_path)[case]
    base, new = (benchcmp.load_metrics(f) for f in files[-2:])
    assert (base, new) == tuple(jax_benchcmp.load_metrics(f)
                                for f in files[-2:])
    got = [dataclasses.asdict(d) for d in benchcmp.compare(base, new, 10.0)]
    want = [dataclasses.asdict(d)
            for d in jax_benchcmp.compare(base, new, 10.0)]
    assert got == want and got
    for metric in new:
        assert benchcmp.lower_is_better(metric) == (
            jax_benchcmp.lower_is_better(metric))
        assert benchcmp.is_config_key(metric) == (
            jax_benchcmp.is_config_key(metric))


@pytest.mark.parametrize("argv", [
    ["--tolerance", "10", *FIXTURES[1:]],
    ["--tolerance", "10", *FIXTURES[:2]],
    ["--against", "first", *FIXTURES],
    ["--dir", os.path.dirname(FIXTURES[0])],
    ["--dir", os.path.dirname(os.path.abspath(__file__))],
], ids=["regression", "within", "first", "dir", "dir-without-rounds"])
def test_cli_bench_compare_answers_like_jax(capsys, argv):
    rc_jax = jax_cli.main(["bench-compare", *argv])
    out_jax = capsys.readouterr().out
    rc_port = cli.main(["bench-compare", *argv])
    out_port = capsys.readouterr().out
    assert rc_port == rc_jax
    assert out_port == out_jax
    assert "bench-compare:" in out_port


def test_default_files_are_jaxs():
    directory = os.path.dirname(FIXTURES[0])
    assert benchcmp.default_files(directory) == jax_benchcmp.default_files(
        directory) == FIXTURES


def _commands(parser):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return set(sub.choices)


def test_the_port_command_tree_lacks_only_the_unported_commands():
    port, jax = _commands(cli.build_parser()), _commands(
        jax_cli.build_parser())
    assert "bench-compare" in port
    assert port <= jax
    assert jax - port == NOT_PORTED
