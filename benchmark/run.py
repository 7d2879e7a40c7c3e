"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.
This file only dispatches: the cell's configuration, traffic mix,
limits and per-layer metrics are files found by name (``lib/cells.py``),
and the configuration names the runner that sets up and measures it.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number the
check compared beside its limit, which also end standard error. A run
without the cards it needs, or that loaded a module of JAX or of the
JAX package, exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import env  # noqa: E402  (stdlib only)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def power_limit() -> str:
    """``nvidia-smi``'s power limit of card 0, or ``unknown``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    env.set_cache_env(ROOT)
    from benchmark.lib import cells

    try:
        cell = cells.load(ROOT, args.workload)
    except (KeyError, OSError, ValueError) as e:
        return fail(f"cannot load cell {args.workload!r}: {e}")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA card (torch.cuda.is_available() is false); "
                    "the benchmark does not run on the CPU")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"cell {cell.name} needs {cell.chips} CUDA cards, "
                    f"this machine has {torch.cuda.device_count()}")
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    result, log = execute(cell, args.seed, args.seconds, bool(args.trace))
    return emit(result, log)


def emit(result: dict, log: dict) -> int:
    """Print the run's log and checks to standard error and its result
    line to standard output, unless a module of JAX or of the JAX
    package is loaded by now (the runner, the program and every metric
    reader have run): then name it and print no result."""
    found = env.forbidden_loaded()
    if found:
        return fail(f"modules of JAX or of the JAX package were loaded: "
                    f"{found}")
    sys.stdout.flush()
    print(f"window: {json.dumps(log)}", file=sys.stderr)
    for k, c in result["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(cell, seed: int, seconds: float, trace: bool,
            device="cuda") -> tuple:
    """Run ``cell`` once on ``device``: its result line and the runner's
    log (the CPU serves the tests alone)."""
    import torch

    from benchmark.lib import cells

    outcome = cells.runner(cell.config).run(cell, seed, seconds, trace,
                                            device)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(ROOT, m["name"])(outcome.context)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = cells.judge(outcome.readings, cell.limits)
    correct = all(c["ok"] for c in checks.values()) and outcome.failed == 0
    on_card = torch.device(device).type == "cuda"
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": {
                  "platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(0) if on_card
                           else "cpu"),
                  "count": cell.chips,
                  "memory_peak_bytes": outcome.memory_peak_bytes,
                  "power_limit": power_limit() if on_card else "none"}}
    if trace:
        tr = outcome.trace
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result, outcome.log or {}


if __name__ == "__main__":
    sys.exit(main())
