"""Host seconds binning both sides of the ratings in set-up
(``build_compressed_side``, timed by the benchmark's clock)."""


def read(ctx):
    if ctx.get("family") != "als":
        return None
    return ctx["bin_s"] or None
