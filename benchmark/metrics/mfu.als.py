"""Percent of the chip's bf16 peak a whole ALS training reaches: the
alternations' FLOPs (``lib/work.als_flops_per_alternation``) over the
traced window's wall seconds, which hold whole trainings (put, start,
alternations, fetch)."""

from benchmark.lib import peaks, work


def read(ctx):
    if ctx.get("family") != "als" or not ctx["window_s"] > 0:
        return None
    flops = work.als_flops_per_alternation(
        ctx["n_ratings"], ctx["n_users"], ctx["n_items"], ctx["rank"],
        ctx["cg_iters"]) * ctx["alternations"]
    return 100.0 * flops / ctx["window_s"] / peaks.BF16_FLOPS
