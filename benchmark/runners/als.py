"""ALS cells: ``predictionio_torch.ops.als`` trained as ``pio train``
trains it on every retrain.

Set-up makes the ratings from the seed, holds out every
``holdout_every``-th, bins both sides on the host
(``build_compressed_side``), makes the initial factors on the device and
runs one whole training to warm every shape. The window repeats whole
trainings: ``ALSTrainer.from_sides`` (the put), the initial factors
copied in, ``run()`` (the alternations) and the factors fetched to the
host. It ends with its last whole training, so a stall anywhere shows.

The check judges the last training's factors against
``reference/als.py``: its own training from the same ratings and the
same initial factors, and the exact solve of the last half-step.

``readings`` and ``FAULTS`` serve ``calibrate.py`` alone (the readings
a cell's limits are set from) and the tests; no measured run uses them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import numpy as np
import torch

from benchmark.lib import generators, trace as tracing
from benchmark.lib.outcome import Outcome
from benchmark.reference import als as ref
from benchmark.reference.rounding import lower

#: whole trainings the traced window holds at most
TRACE_TRAININGS = 2
#: calls of each stage under the stage profile
STAGE_CALLS = 3


def als_config(model: dict, seed: int):
    from predictionio_torch.ops.als import ALSConfig

    return ALSConfig(
        rank=int(model["rank"]), iterations=int(model["iterations"]),
        reg=float(model["reg"]), block_size=int(model["block_size"]),
        seed=generators.stream_seed(seed, 4) % (1 << 31),
        solver=model["solver"], cg_iters=int(model["cg_iters"]),
        cg_dtype=model["cg_dtype"], cg_precond=model["cg_precond"],
        compute_dtype=model["compute_dtype"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Setup:
    """One seed's ratings, binned sides and initial factors."""

    def __init__(self, model: dict, mix: dict, seed: int, device):
        from predictionio_torch.ops.als import build_compressed_side

        self.model, self.device = model, torch.device(device)
        self.n_users, self.n_items = int(model["n_users"]), int(
            model["n_items"])
        uu, ii, vals = generators.ratings(model, mix, seed, self.device)
        keep = ~generators.holdout_mask(len(vals), mix)
        self.train = (uu[keep], ii[keep], vals[keep])
        self.cfg = als_config(model, seed)
        t0 = time.perf_counter()
        self.user_side = build_compressed_side(
            self.train[0], self.train[1], self.train[2], self.n_users,
            self.cfg, 1, None)
        self.item_side = build_compressed_side(
            self.train[1], self.train[0], self.train[2], self.n_items,
            self.cfg, 1, None)
        #: host seconds binning both sides
        self.bin_s = time.perf_counter() - t0
        rank = int(model["rank"])
        f = generators.normal_tables({"user": (self.n_users, rank),
                                      "item": (self.n_items, rank)},
                                     seed, 5, self.device)
        self.X0, self.Y0 = f["user"], f["item"]

    @property
    def n_train(self) -> int:
        return len(self.train[2])

    def training(self):
        """The window's call: a trainer from the binned sides (the put),
        the seeded start, the alternations and the fetch. Returns the
        trainer and its host factors."""
        from predictionio_torch.ops.als import ALSTrainer

        t = ALSTrainer.from_sides(self.user_side, self.item_side,
                                  self.n_users, self.n_items, self.n_train,
                                  self.cfg, device=self.device)
        t.X[:self.n_users].copy_(self.X0)
        t.Y[:self.n_items].copy_(self.Y0)
        return t, t.run()

    def ratings(self) -> ref.Ratings:
        return ref.Ratings(*self.train, self.n_users, self.n_items,
                           self.device)

    def judge(self, factors, ratings=None, reference=None) -> dict:
        """The check's numbers for host factors (``ALSFactors``)."""
        ratings = ratings or self.ratings()
        X = torch.as_tensor(factors.user_factors, device=self.device)
        Y = torch.as_tensor(factors.item_factors, device=self.device)
        return ref.check(ratings, self.X0, self.Y0, X, Y, self.model,
                         reference)


def stage_profile(trainer, calls: int = STAGE_CALLS) -> dict:
    """Device ms an alternation of stage 1 (gather + partial Gramians)
    and stage 3 (regularize + CG solve), both sides, each stage alone on
    the trainer's layout and current factors, from one profiler session
    (``tools/als_timing.stage_profile``'s method)."""
    user, item = trainer.sides()
    with tracing.session() as tr:
        for name, side, opposing, own in (("user", user, trainer.Y,
                                           trainer.X),
                                          ("item", item, trainer.X,
                                           trainer.Y)):
            step = side.step
            Yc = opposing.to(step.cdt)
            tr.mark(f"{name}.partials")
            for _ in range(calls):
                step.partials(Yc, side.idx, side.val, side.mask)
            tr.mark(f"{name}.prepare")
            Ar, br = step.partials(Yc, side.idx, side.val, side.mask)
            A, b = step.segment_sum(Ar, br, side.seg)
            del Ar, br
            tr.mark(f"{name}.solve")
            for _ in range(calls):
                step.solve(A, b, own, side.counts, Yc)
            tr.mark(f"{name}.done")
            del A, b
    return {stage: 1e3 * sum(tr.phase_s(f"{side}.{phase}")
                             for side in ("user", "item")) / calls
            for stage, phase in (("gather_gramian", "partials"),
                                 ("solve", "solve"))}


def run(cell, seed: int, seconds: float, trace: bool,
        device="cuda") -> Outcome:
    model, mix = cell.config["model"], cell.mix
    s = Setup(model, mix, seed, device)
    t, factors = s.training()          # warm-up: every shape, once
    del t
    sync(device)
    setup_s = tracing.process_age_sec()
    n = 0
    context = session = None
    t0 = time.perf_counter()
    units = []
    if not trace:
        while True:
            t, factors = s.training()
            units.append((time.perf_counter(), t.put_sec))
            del t
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
    else:
        with tracing.session() as session:
            while True:
                with torch.profiler.record_function("bench::training"):
                    t, factors = s.training()
                n += 1
                if (n >= TRACE_TRAININGS
                        or time.perf_counter() - session.t0 >= seconds):
                    break
        window = session.window_s
        kernels = tracing.merged([(b, e) for b, e, name in session.ops
                                  if not name.startswith("Memcpy")])
        context = {
            "family": "als", "window_s": window, "busy_s": session.busy_s,
            "trainings": n, "alternations": n * int(model["iterations"]),
            "kernel_s": sum(e - b for b, e in kernels) / 1e6,
            "n_ratings": s.n_train, "n_users": s.n_users,
            "n_items": s.n_items, "rank": int(model["rank"]),
            "cg_iters": int(model["cg_iters"]), "bin_s": s.bin_s,
            "stages_ms": stage_profile(t)}
        del t
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    failed = int(not (np.isfinite(factors.user_factors).all()
                      and np.isfinite(factors.item_factors).all()))
    sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings = s.judge(factors)
    ends = [t0] + [u[0] for u in units]
    log = {"units_s": [b - a for a, b in zip(ends, ends[1:])],
           "put_s": [u[1] for u in units], "bin_s": s.bin_s}
    return Outcome(
        attempted=n, failed=failed,
        e2e={"train_ratings_per_s":
             n * s.n_train * int(model["iterations"]) / window,
             "setup_s": setup_s},
        readings=readings, memory_peak_bytes=int(peak), context=context,
        trace=session, log=log)


# -- calibration: the control and faults planted under the timed path ------


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = obj.__dict__[name]
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged():
    """A step that returns its state unchanged: each half-step hands
    back the factors it was given."""
    from predictionio_torch.ops import als as prog

    return _patched(prog.HalfStep, "__call__",
                    lambda self, Y, X_prev, *rest: X_prev)


def _half():
    """Half of the batch left out: the partial Gramians and right-hand
    sides of the second half of each block's rows are zeroed."""
    from predictionio_torch.ops import als as prog

    partials = prog.HalfStep.partials

    def half(self, Yc, idx, val, mask):
        Ar, br = partials(self, Yc, idx, val, mask)
        Ar[Ar.shape[0] // 2:] = 0.0
        br[br.shape[0] // 2:] = 0.0
        return Ar, br
    return _patched(prog.HalfStep, "partials", half)


def _row():
    """An answer altered where it is produced: one item's factor row
    negated in the factors a training hands back."""
    from predictionio_torch.ops import als as prog

    factors = prog.ALSTrainer.factors

    def altered(self):
        f = factors(self)
        j = int(np.argsort(-np.abs(f.item_factors).sum(1))[
            len(f.item_factors) // 4])
        f.item_factors[j] = -f.item_factors[j]
        return f
    return _patched(prog.ALSTrainer, "factors", altered)


#: faults planted in the program, each a context manager for its block
FAULTS = {"unchanged": _unchanged, "half": _half, "row": _row}


def readings(cell, seed: int, what, device):
    """The check's numbers of each of ``what`` (``sound``, ``control``
    or a fault of ``FAULTS``) on one seed's set-up, with their seconds."""
    model = cell.config["model"]
    s = Setup(model, cell.mix, seed, device)
    R = s.ratings()
    t0 = time.perf_counter()
    base = ref.train(R, s.X0, s.Y0, model)
    sync(device)
    yield "reference_train_s", {"seconds": time.perf_counter() - t0}
    for kind in what:
        t0 = time.perf_counter()
        if kind == "control":
            got = ref.train(R, s.X0, s.Y0, model,
                            lower(model["compute_dtype"]))
            out = ref.check(R, s.X0, s.Y0, *got, model, base)
        elif kind == "sound":
            t, f = s.training()
            del t
            t1 = time.perf_counter()
            out = s.judge(f, R, base)
            out["judge_s"] = time.perf_counter() - t1
        else:
            with FAULTS[kind]():
                t, f = s.training()
            del t
            out = s.judge(f, R, base)
        out["seconds"] = time.perf_counter() - t0
        yield kind, out
