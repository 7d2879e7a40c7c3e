"""Time the ``topk_dot`` kernel on the card, one block count at a time.

    python -m predictionio_torch.tools.topk_dot_timing [--shapes serve,catalog]
        [--blocks 0,66,132,264,396,528,792,1056] [--iters 100]

Builds ``csrc/topk_dot.cu``, prints ``ptxas``'s registers and spills of
its kernels, then, at each shape, times the kernel for each block count
of its grid (0: the planner's own choice): device time per call from
``torch.profiler`` over ``--iters`` back-to-back calls with the table
warm in L2 (``warm_ms``) and with L2 flushed before each call
(``cold_ms``), and the device kernels and memsets traced per call. The
plain version (``topk_dot_reference``) and one library call
(``torch.matmul`` + ``torch.topk``) are timed beside it, and
``bound_ms`` is the table read once at 3.35 TB/s. Shapes:

  serve    B=1, I=26,744, D=64, k=16, E=1   (an ALS lone query, ML-20M)
  catalog  B=1, I=1,000,000, D=128, k=16, E=1 (a two-tower lone query)

Every block count's answer must equal the planner's bit for bit (each
item's dot is summed in the same order whatever the grid) and agree
with the plain version (scores to 1e-5 * |q| * max|item|). Prints one
JSON object and exits 1 when an answer disagrees. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Tuple

import torch

from predictionio_torch.ops import kernels
from predictionio_torch.ops.kernels import topk_dot as tkd
from predictionio_torch.tools.device_time import (F32_FLOPS,
                                                  HBM_BYTES_PER_S,
                                                  profile_call)

SHAPES = {"serve": (1, 26_744, 64, 16, 1),
          "catalog": (1, 1_000_000, 128, 16, 1)}


def bound(B: int, I: int, D: int, k: int, E: int) -> Tuple[float, str]:
    """``(ms, by)``: the larger of the bytes (q, table, exclusions read
    once, the answer written once) over HBM's rate and the 2*B*I*D f32
    operations over the f32 rate, and which of the two it is."""
    bytes_ms = ((B * D + I * D + B * E) * 4 + B * k * 8) / HBM_BYTES_PER_S
    ops_ms = 2.0 * B * I * D / F32_FLOPS
    if bytes_ms >= ops_ms:
        return bytes_ms * 1e3, "bytes"
    return ops_ms * 1e3, "operations"


def time_shape(name: str, blocks, iters: int) -> dict:
    B, I, D, k, E = SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(5)
    items = torch.randn((I, D), generator=gen, device="cuda")
    q = torch.randn((B, D), generator=gen, device="cuda")
    excl = torch.full((B, E), -1, dtype=torch.int32, device="cuda")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    rs, ri = tkd.topk_dot_reference(q, items, excl, k)
    tol = float(1e-5 * q.norm() * items.norm(dim=1).max())
    first = None
    rows = []
    for n in blocks:
        grid = tkd.plan_blocks(I, k, B, sm_count, n or None)
        fn = lambda: tkd._launch(q, items, excl, k, grid)  # noqa: E731
        s, i = fn()
        torch.cuda.synchronize()
        first = first or (s, i)
        # ids as the plain version's, except at its own near-ties: there
        # the kernel's item must score within tol of the slot
        got = (q @ items.T).gather(1, i.long())
        agrees = (torch.equal(s, first[0]) and torch.equal(i, first[1])
                  and float((s - rs).abs().max()) <= tol
                  and bool(((i == ri) | ((got - rs).abs() <= tol)).all()))
        warm, cold = (profile_call(fn, iters, c) for c in (False, True))
        rows.append({"blocks": n or "plan", "grid_blocks": grid[1],
                     "warm_ms": warm["ms"], "cold_ms": cold["ms"],
                     "kernels_per_call": warm["kernels_per_call"],
                     "memsets_per_call": warm["memsets_per_call"],
                     "agrees": agrees})
    plain = lambda: tkd.topk_dot_reference(q, items, excl, k)  # noqa: E731
    library = lambda: torch.topk(q @ items.T, k, dim=1)  # noqa: E731
    return {
        "shape": f"B={B},I={I},D={D},k={k},E={E}",
        "plan": tkd.plan_blocks(I, k, B, sm_count),
        "bound_ms": bound(B, I, D, k, E)[0],
        "plain_warm_ms": profile_call(plain, iters)["ms"],
        "library_warm_ms": profile_call(library, iters)["ms"],
        "library_cold_ms": profile_call(library, iters, cold=True)["ms"],
        "blocks": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="serve,catalog")
    ap.add_argument("--blocks", default="0,66,132,264,396,528,792,1056")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("topk_dot_timing: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all(["topk_dot"])
    blocks = [int(x) for x in args.blocks.split(",")]
    shapes = {name: time_shape(name, blocks, args.iters)
              for name in args.shapes.split(",")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[:1]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card,
        "ptxas": kernels.ptxas_report("topk_dot"),
        "shapes": shapes}))
    return 0 if all(r["agrees"] for s in shapes.values()
                    for r in s["blocks"]) else 1


if __name__ == "__main__":
    sys.exit(main())
