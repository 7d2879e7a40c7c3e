"""The readings a cell's limits are set from, on the chip at the cell's
own size, several seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--what sound,control,unchanged,half,row]

For each seed it makes the cell's set-up once and reads the check's
numbers of

- ``sound``: the program as a run drives it;
- ``control``: the reference put in the program's place, computed in
  the precision below the configuration's (``reference/rounding.lower``);
- each fault of the runner's ``FAULTS`` planted in the program.

The configuration's runner (``runners/<runner>.py``) reads them: its
``readings(cell, seed, what, device)`` yields ``(what, numbers)``.

One JSON line a reading, then a summary line: the largest sound reading
of each number (the lower reading), and the least reading of the
control and of each fault (the upper readings). No measured run does
any of this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import env  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="")
    args = ap.parse_args(argv)
    env.set_cache_env(ROOT)
    import torch

    from benchmark.lib import cells

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(ROOT, args.workload)
    runner = cells.runner(cell.config)
    what = (args.what.split(",") if args.what
            else ["sound", "control", *runner.FAULTS])
    summary: dict = {}
    for seed in (int(x) for x in args.seeds.split(",")):
        for kind, out in runner.readings(cell, seed, what, "cuda"):
            print(json.dumps({"cell": cell.name, "seed": seed, "what": kind,
                              **out}), flush=True)
            for key in cell.limits["checks"]:
                if key in out:
                    summary.setdefault(kind, {}).setdefault(key, []).append(
                        out[key])
    print(json.dumps({"cell": cell.name, "summary": {
        kind: {key: (max(v) if kind == "sound" else min(v))
               for key, v in nums.items()}
        for kind, nums in summary.items()}}), flush=True)
    found = env.forbidden_loaded()
    if found:
        print(f"calibrate: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
