"""Where a grid candidate's arithmetic could part from its sequential train.

    python -m predictionio_torch.tools.als_grid_bits [--device cpu]

On MovieLens-100K-shaped ratings (943 users, 1,682 items, 66,667
uniform 1-5 ratings: one fold of ``chip_smoke.py``'s ``pio eval``), rank
64, f32, ``lambda_`` 0.1: one half-step of each side, a single train's
(``ops.als.HalfStep``) against a grid of ``--candidates`` copies of the
same inputs (``GridHalfStep``), stage by stage (the summed Gramians
``A`` and rhs ``b``, then the solve from the same ``A``, ``b``); then
``torch.bmm`` as a matrix-vector product, and as a GEMM with a second
column, at each side's group block B against G x B systems. Last, the
chaos the equality guards against: one candidate's factors after 3
alternations of 6-step f32 CG, and after the same from a start nudged
by 1e-6 (relative Frobenius change). Prints one JSON line with the
device's name. Runs on the card by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from predictionio_torch.ops import als
from predictionio_torch.parallel.context import resolve_device


def _same(a: torch.Tensor, b: torch.Tensor) -> dict:
    return {"equal": bool(torch.equal(a, b)),
            "max_abs_diff": float((a - b).abs().max())}


def _ratings(seed: int = 23):
    rng = np.random.default_rng(seed)
    n = 100_000
    u, i = rng.integers(0, 943, n), rng.integers(0, 1682, n)
    r = rng.integers(1, 6, n).astype(np.float32)
    keep = np.arange(n) % 3 != 0
    return u[keep], i[keep], r[keep]


def half_steps(device: torch.device, G: int) -> dict:
    """Single vs grid, stage by stage, on each side of the fold."""
    u, i, r = _ratings()
    cfg = als.ALSConfig(rank=64, reg=0.1, compute_dtype="float32",
                        cg_dtype="float32")
    rng = np.random.default_rng(1)
    out = {}
    for name, g_idx, o_idx, n, n_opp in (("user", u, i, 943, 1682),
                                         ("item", i, u, 1682, 943)):
        side = als._build_side(g_idx, o_idx, r, n, cfg, 1, None)
        t = [torch.from_numpy(a).to(device)
             for a in (side.idx, side.val, side.mask, side.seg, side.counts)]
        idx, val, mask, seg, counts = t
        Y = torch.zeros((n_opp + 64, 64), device=device)
        Y[:n_opp] = torch.from_numpy(
            (0.1 * rng.normal(size=(n_opp, 64))).astype(np.float32))
        X = torch.from_numpy((0.1 * rng.normal(
            size=(side.groups_per_shard, 64))).astype(np.float32)).to(device)
        single = als.HalfStep(cfg, side.row_block, side.group_block,
                              side.groups_per_shard)
        grid = als.GridHalfStep(cfg, side.row_block, side.group_block,
                                side.groups_per_shard,
                                torch.full((G,), cfg.reg, device=device),
                                torch.ones(G, device=device), None)
        Ar, br = single.partials(Y, idx, val, mask)
        A, b = single.segment_sum(Ar, br, seg)
        AG, bG = grid.partial_sums(Y.expand(G, -1, -1).contiguous(), idx,
                                   val, mask, seg)
        x = single.solve(A, b, X, counts, Y)
        xG = grid.solve(A.expand(G, -1, -1, -1).contiguous(),
                        b.expand(G, -1, -1).contiguous(),
                        X.expand(G, -1, -1).contiguous(), counts,
                        Y.expand(G, -1, -1).contiguous())
        B = side.group_block
        M = torch.randn(G * B, 64, 64, device=device)
        v = torch.randn(G * B, 64, device=device)
        two = torch.nn.functional.pad(v.unsqueeze(-1), (0, 1))
        out[name] = {
            "rows": list(side.idx.shape), "group_block": B,
            "A": _same(A, AG[G - 1]), "b": _same(b, bG[G - 1]),
            "solve": _same(x, xG[G - 1]),
            "bmm_matvec_B_vs_GB": _same(
                torch.bmm(M[:B], v[:B].unsqueeze(-1)),
                torch.bmm(M, v.unsqueeze(-1))[:B]),
            "bmm_two_columns_B_vs_GB": _same(
                torch.bmm(M[:B], two[:B]), torch.bmm(M, two)[:B])}
    return out


def nudge_spread(device: torch.device) -> dict:
    """One candidate of the sweep (``lambda_`` 0.01, 3 alternations of
    6-step f32 CG) from its start and from the start nudged by 1e-6."""
    u, i, r = _ratings()
    cfg = als.ALSConfig(rank=64, iterations=3, reg=0.01, seed=3,
                        compute_dtype="float32", cg_dtype="float32")
    base = als.ALSTrainer((u, i, r), 943, 1682, cfg, device=device).run()
    nudged = als.ALSTrainer((u, i, r), 943, 1682, cfg, device=device)
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn(tuple(nudged.X.shape), generator=gen)
    nudged.X = nudged.X * (1.0 + 1e-6 * noise.to(device))
    got = nudged.run()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    return {"user": rel(got.user_factors, base.user_factors),
            "item": rel(got.item_factors, base.item_factors),
            "config": dataclasses.asdict(cfg)}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--candidates", type=int, default=6)
    args = parser.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "candidates": args.candidates,
        "half_steps": half_steps(device, args.candidates),
        "nudge_1e-6_relative_change": nudge_spread(device)}))


if __name__ == "__main__":
    main()
