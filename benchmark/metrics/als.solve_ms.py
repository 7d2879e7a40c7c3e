"""Device ms an alternation of ALS's stage 3, regularize and CG solve,
both sides, profiled as ``als.gather_gramian_ms`` is."""


def read(ctx):
    if ctx.get("family") != "als":
        return None
    return ctx["stages_ms"].get("solve") or None
