"""Device ms an alternation of ALS's stage 1, the gather and the partial
Gramians, both sides, each profiled alone on the window's own layout and
factors (``runners/als.stage_profile``)."""


def read(ctx):
    if ctx.get("family") != "als":
        return None
    return ctx["stages_ms"].get("gather_gramian") or None
