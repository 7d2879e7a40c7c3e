"""Where an ALS alternation's time goes on the card.

    from predictionio_torch.tools.als_timing import (grid_profile,
                                                     stage_profile)
    stage_profile(trainer, wall_ms_per_alternation)
    grid_profile(grid_trainer, wall_ms_per_alternation)

For a trained ``ops.als.ALSTrainer`` on a CUDA device: device time per
alternation by stage and side (stage 1, the gather and partial
Gramians; stage 2, the segment-sum; stage 3, regularize and solve), each
stage from ``torch.profiler`` on the trainer's own layout and current
factors (``device_time.profile_call``); then one whole alternation under
the profiler, which gives its device time and its device kernels (one
launch each). The idle share is one less the device time over the
caller's wall time per alternation. ``grid_profile`` does the same for
an ``ops.als.ALSGridTrainer``: one grid alternation (G candidates at
once) under the profiler, split into the two half-steps.
``chip_smoke.py`` prints the results beside the card's name and power
limit. Needs a CUDA card.
"""

from __future__ import annotations

from predictionio_torch.tools.device_time import (HBM_BYTES_PER_S,
                                                  profile_call)


def stage_profile(trainer, wall_ms: float, iters: int = 3) -> dict:
    X, Y = trainer.X, trainer.Y
    user, item = trainer.sides()
    stages = {}
    for name, side, opposing, own in (("user", user, Y, X),
                                      ("item", item, X, Y)):
        step = side.step
        Yc = opposing.to(step.cdt)
        partials = profile_call(
            lambda: step.partials(Yc, side.idx, side.val, side.mask), iters)
        Ar, br = step.partials(Yc, side.idx, side.val, side.mask)
        segment_sum = profile_call(lambda: step.segment_sum(Ar, br, side.seg),
                                   iters)
        A, b = step.segment_sum(Ar, br, side.seg)
        del Ar, br
        solve = profile_call(lambda: step.solve(A, b, own, side.counts, Yc),
                             iters)
        del A, b
        stages[name] = {"gather_gramian_ms": partials["ms"],
                        "segment_sum_ms": segment_sum["ms"],
                        "solve_ms": solve["ms"],
                        "kernels": {"gather_gramian":
                                    partials["kernels_per_call"],
                                    "segment_sum":
                                    segment_sum["kernels_per_call"],
                                    "solve": solve["kernels_per_call"]}}
    whole = profile_call(lambda: item(user(Y, X), Y), iters)
    bytes_per_iter = trainer.work_model()["hbm_bytes_per_iter"]
    return {
        "device_ms_per_alternation": whole["ms"],
        "wall_ms_per_alternation": wall_ms,
        "device_idle_share": 1.0 - whole["ms"] / wall_ms,
        "launches_per_alternation": whole["kernels_per_call"]
        + whole["memsets_per_call"],
        "stages_ms": stages,
        "by_stage_ms": {
            stage: sum(s[f"{stage}_ms"] for s in stages.values())
            for stage in ("gather_gramian", "segment_sum", "solve")},
        "work_model_bytes_per_alternation": bytes_per_iter,
        "work_model_hbm_share": bytes_per_iter / (whole["ms"] / 1e3)
        / HBM_BYTES_PER_S,
        "top_kernels_ms": dict(sorted(whole["split"].items(),
                                      key=lambda kv: -kv[1])[:8]),
    }


def grid_profile(trainer, wall_ms: float, iters: int = 3) -> dict:
    """Device time, launches and idle share of one grid alternation of
    an ``ALSGridTrainer``, and of each half-step; ``wall_ms`` is the
    caller's wall time per grid alternation."""
    X, Y = trainer.X, trainer.Y
    user, item = trainer.sides()
    whole = profile_call(lambda: item(user(Y, X), Y), iters)
    halves = {name: profile_call(lambda: side(opposing, own), iters)
              for name, side, opposing, own in (("user", user, Y, X),
                                                ("item", item, X, Y))}
    return {
        "candidates": trainer.G,
        "device_ms_per_alternation": whole["ms"],
        "wall_ms_per_alternation": wall_ms,
        "device_idle_share": 1.0 - whole["ms"] / wall_ms,
        "launches_per_alternation": whole["kernels_per_call"]
        + whole["memsets_per_call"],
        "half_step_ms": {k: v["ms"] for k, v in halves.items()},
        "top_kernels_ms": dict(sorted(whole["split"].items(),
                                      key=lambda kv: -kv[1])[:8]),
    }
