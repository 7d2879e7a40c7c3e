"""Time the ``flash_ce`` kernels on the card, one split at a time.

    python -m predictionio_torch.tools.flash_ce_timing [--batch 8192]
        [--dim 128] [--splits 1,2,3,4,6,8] [--iters 50]

Builds ``csrc/flash_ce.cu``, prints ``ptxas``'s registers and spills
of each of its kernels, then, at one bf16 batch shape, times the
forward kernel and the backward kernel (du, and dv with the roles
swapped) for each split S of the loop over the other side: CUDA-event
time per launch over ``--iters`` back-to-back launches, the kernel
alone (outputs preallocated, partials not summed). Each split's
results are held against the first split's, as f32 sums taken in
another order: the forward LSEs to 1e-6 of their largest entry, the
diagonal exactly, the gradients (from the first split's LSEs, so that
every split rounds the same coefficients) to 1e-4 of their largest
entry; each largest error is printed. Prints one JSON object and exits
1 when a split disagrees. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from predictionio_torch.ops import kernels
from predictionio_torch.ops.kernels import flash_ce as fce
from predictionio_torch.tools.device_time import call_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--splits", default="1,2,3,4,6,8")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ce_timing: needs a CUDA card", file=sys.stderr)
        return 2
    kernels.build_all(["flash_ce"])
    B, D, cdt, temp = args.batch, args.dim, torch.bfloat16, 0.07
    gen = torch.Generator(device="cuda").manual_seed(7)
    u, v = (torch.nn.functional.normalize(
        torch.randn((B, D), generator=gen, device="cuda"), dim=1)
        for _ in range(2))
    ui = torch.randint(0, B // 3, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    ii = torch.randint(0, B // 4, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    w = torch.ones(B, device="cuda")
    ub, vb = fce._kernel_inputs(u, v, cdt)
    scale = torch.full((1,), 1.0 / (2.0 * B * temp), device="cuda")
    n_tiles = -(-B // fce.TILE)
    ref = None
    rows = []
    for S in (int(x) for x in args.splits.split(",")):
        if S > n_tiles:
            continue
        lse_ui, lse_iu, diag = fce.forward_kernel(ub, vb, ui, ii, w, temp,
                                                  cdt, S)
        lses = (lse_ui, lse_iu) if ref is None else ref[:2]
        du = fce.grad_kernel(ub, vb, ui, ii, w, *lses, scale, temp, cdt, D,
                             S)
        dv = fce.grad_kernel(vb, ub, ii, ui, w, *lses[::-1], scale, temp,
                             cdt, D, S)
        torch.cuda.synchronize()
        if ref is None:
            ref = (lse_ui, lse_iu, diag, du, dv)
        err = {name: float((a - r).abs().max() / r.abs().max())
               for name, a, r in zip(("lse_ui", "lse_iu", "diag", "du", "dv"),
                                     (lse_ui, lse_iu, diag, du, dv), ref)}
        agrees = (max(err["lse_ui"], err["lse_iu"]) <= 1e-6
                  and err["diag"] == 0.0
                  and max(err["du"], err["dv"]) <= 1e-4)
        sum_ui = torch.empty((S, B), device="cuda")
        iu_parts = torch.empty((n_tiles, B), device="cuda")
        out = torch.empty((S, B, D), device="cuda")
        diag_out = torch.empty_like(diag)
        fwd_ms = call_ms(lambda: fce._launch(
            fce._MODE_FWD, ub, vb, ui, ii, w, temp, cdt, S, sum_ui=sum_ui,
            diag=diag_out, iu_parts=iu_parts), args.iters, warmup=5)
        grad_ms = call_ms(lambda: fce._launch(
            fce._MODE_GRAD, ub, vb, ui, ii, w, temp, cdt, S, lse_ui=lse_ui,
            lse_iu=lse_iu, scale=scale, out=out), args.iters, warmup=5)
        rows.append({"split": S, "blocks": n_tiles * S, "fwd_ms": fwd_ms,
                     "grad_ms": grad_ms, "loss_ms": fwd_ms + 2 * grad_ms,
                     "max_err_vs_first_split": err,
                     "agrees_with_first_split": agrees})
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "shape": f"B={B},D={D},cdt=bfloat16",
        "ptxas": kernels.ptxas_report("flash_ce"),
        "splits": rows}))
    return 0 if all(r["agrees_with_first_split"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
