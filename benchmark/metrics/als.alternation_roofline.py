"""Percent of its roofline an ALS alternation runs at: the least time it
needs (``lib/work.als_bound_s``: its FLOPs at the bf16 peak or its bytes
at the HBM rate, whichever is longer) over its kernels' device time in
the traced window (the put's and the fetch's copies left out)."""

from benchmark.lib import work


def read(ctx):
    if ctx.get("family") != "als" or not ctx["kernel_s"] > 0:
        return None
    bound = work.als_bound_s(ctx["n_ratings"], ctx["n_users"],
                             ctx["n_items"], ctx["rank"], ctx["cg_iters"])
    return 100.0 * bound * ctx["alternations"] / ctx["kernel_s"]
