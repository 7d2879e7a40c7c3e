"""Percent of the traced ALS window in which no operation ran on the
card."""


def read(ctx):
    if ctx.get("family") != "als" or not ctx["window_s"] > 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx["busy_s"] / ctx["window_s"])
