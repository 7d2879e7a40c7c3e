"""Lone-query latency of two or more trees of this repo, on one card.

    python -m predictionio_torch.tools.lone_query_ab TREE [TREE ...]
        [--rounds 2] [--iters 1000]

A tree is a checkout of this repo: the working tree (``.``), or a ``git
archive`` of another commit unpacked in a directory that ``.gitignore``
lists. Each round runs every tree in turn, odd rounds in reverse order
(A, B, B, A for two trees and two rounds), each in a fresh process with
the tree first on ``sys.path``, so that each tree is timed by its own
code:

- ``wrapper_ms``: host wall time per call over ``--iters`` back-to-back
  calls of the tree's ``topk_dot`` at the serve shape (B=1, I=26,744,
  D=64, k=16, E=1), synchronised once at the end: the host's time to
  issue one call, where that is longer than the kernel's.
- ``serve``, ``catalog``: the tree's ``topk_dot`` at the serve shape
  and at a 1M x 128 catalog (B=1, k=16, E=1), device time per call from
  ``torch.profiler`` warm and with L2 flushed (``warm_ms``,
  ``cold_ms``) and the kernels per call, measured for every tree by
  this tool's own ``device_time.py``.
- ``lone_ms_p50``, ``lone_ms_max``: the tree's
  ``chip_smoke.serve_phase()``, ML-20M-shaped ALS factors deployed by
  its ``EngineServer`` and asked lone queries over HTTP, every answer
  checked against a float64 host top-k.

Prints one JSON object, its rows in run order. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = """
import importlib.util, json, sys, time
import torch

spec = importlib.util.spec_from_file_location("device_time", sys.argv[2])
device_time = importlib.util.module_from_spec(spec)
spec.loader.exec_module(device_time)
import chip_smoke
from predictionio_torch.ops.kernels import topk_dot as tkd

torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(5)
out = {"module": tkd.__file__}
for name, I, D in (("serve", 26_744, 64), ("catalog", 1_000_000, 128)):
    items = torch.randn((I, D), generator=gen, device="cuda")
    q = torch.randn((1, D), generator=gen, device="cuda")
    excl = torch.full((1, 1), -1, dtype=torch.int32, device="cuda")
    fn = lambda: tkd.topk_dot(q, items, excl, 16)
    if name == "serve":
        # host time first: launches run slower after profiling
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        iters = int(sys.argv[1])
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out["wrapper_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    warm = device_time.profile_call(fn)
    cold = device_time.profile_call(fn, 50, cold=True)
    out[name] = {"warm_ms": warm["ms"], "cold_ms": cold["ms"],
                 "kernels_per_call": warm["kernels_per_call"]}
    del items
serve = chip_smoke.serve_phase()
out.update({key: serve[key] for key in (
    "lone_ms_p50", "lone_ms_max", "launches")})
print(json.dumps(out))
"""


def run_tree(tree: str, iters: int) -> dict:
    root = os.path.abspath(tree)
    env = {**os.environ, "PYTHONPATH": root}
    timer = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "device_time.py")
    out = subprocess.run([sys.executable, "-c", _CHILD, str(iters), timer],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{tree} exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return {"tree": tree, **json.loads(out.stdout.strip().splitlines()[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=1000)
    args = ap.parse_args(argv)
    rows = []
    for r in range(args.rounds):
        for tree in (args.trees if r % 2 == 0 else args.trees[::-1]):
            rows.append(run_tree(tree, args.iters))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[:1]
    print(json.dumps({"card": card, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
