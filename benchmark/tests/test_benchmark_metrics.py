from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import cells, peaks, trace, work
from benchmark.tests.conftest import ROOT

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA, annotation=False, thread=1):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


class FakeProf:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def session(events, marks=(trace.OPEN, "phase.a", trace.CLOSE),
            window_s=1.0):
    s = trace.Session()
    s.marks = list(marks)
    s.window_s = window_s
    s.read(FakeProf(events))
    return s


CANNED = [
    ev(trace.OPEN, 0, 10, annotation=True),
    ev("void flash_ce_kernel_bf16<128>(Params)", 20, 120),
    ev("Memset (Device)", 130, 135),
    ev("phase.a", 200, 210, annotation=True),
    ev("embed_update_kernel(float*)", 300, 340),
    ev("Memcpy HtoD (Pageable -> Device)", 350, 400),
    ev(trace.CLOSE, 1000, 1005, annotation=True),
    ev("outside", 2000, 2100),
    ev("bench::epoch", 5, 990, device=CPU, annotation=True),
    ev("aten::mm", 150, 250, device=CPU),
]


def test_session_bounds_phases_and_busy():
    s = session(CANNED)
    assert [op[2] for op in s.ops] == [
        "flash_ce_kernel_bf16<128>", "Memset",
        "embed_update_kernel", "Memcpy HtoD"]
    assert s.busy_s == pytest.approx((100 + 5 + 40 + 50) / 1e6)
    assert s.phase_s(trace.OPEN) == pytest.approx(105 / 1e6)
    assert s.phase_s("phase.a") == pytest.approx(90 / 1e6)
    assert s.device_ops(2)[0][0] == "flash_ce_kernel_bf16<128>"
    gaps = dict(s.idle_gaps())
    # gaps 10-20, 120-130, 135-300 (host in aten::mm at 217), 340-350,
    # 400-1000
    assert sum(gaps.values()) == pytest.approx((10 + 10 + 165 + 10 + 600)
                                               / 1e6)
    assert gaps["aten::mm"] == pytest.approx(165 / 1e6)


def test_session_without_its_marks_has_no_window():
    with pytest.raises(RuntimeError, match="lost"):
        session([e for e in CANNED if e.name != trace.CLOSE])


def test_kernel_name_shortens():
    assert trace.kernel_name(
        "void (anonymous namespace)::f<1>(float const*, int)") == "f<1>"


ALS_CTX = {"family": "als", "window_s": 2.0, "busy_s": 1.5, "trainings": 1,
           "alternations": 10, "kernel_s": 1.2, "n_ratings": 19_000_000,
           "n_users": 138_493, "n_items": 26_744, "rank": 64,
           "cg_iters": 6, "bin_s": 2.9,
           "stages_ms": {"gather_gramian": 60.0, "solve": 28.0}}


def read(name, ctx):
    return cells.reader(ROOT, name)(ctx)


def test_als_work_counts_the_algorithm():
    f = work.als_flops_per_alternation(19_000_000, 138_493, 26_744, 64, 6)
    assert f == pytest.approx(2 * 19e6 * (2 * 4096 + 128)
                              + 7 * 2 * 4096 * (138_493 + 26_744))
    assert 3.2e11 < f < 3.3e11
    b = work.als_bytes_per_alternation(19_000_000, 138_493, 26_744, 64)
    assert b == pytest.approx(2 * 19e6 * 4 + 2 * 165_237 * 64 * 4)
    assert work.als_bound_s(19_000_000, 138_493, 26_744, 64, 6) == \
        pytest.approx(f / peaks.BF16_FLOPS)


def test_als_readers():
    bound = work.als_bound_s(19_000_000, 138_493, 26_744, 64, 6)
    assert read("als.alternation_roofline", ALS_CTX) == pytest.approx(
        100 * bound * 10 / 1.2)
    assert read("mfu.als", ALS_CTX) == pytest.approx(
        100 * work.als_flops_per_alternation(19_000_000, 138_493, 26_744,
                                             64, 6) * 10 / 2.0 / 989e12)
    assert read("device_idle_share.als", ALS_CTX) == pytest.approx(25.0)
    assert read("als.gather_gramian_ms", ALS_CTX) == 60.0
    assert read("als.solve_ms", ALS_CTX) == 28.0
    assert read("als.bin_s", ALS_CTX) == 2.9
    other = {"family": "other", "window_s": 3.0}
    for name in ("als.alternation_roofline", "mfu.als",
                 "device_idle_share.als", "als.solve_ms"):
        assert read(name, other) is None


def test_readers_return_nothing_rather_than_zero():
    assert read("als.alternation_roofline", dict(ALS_CTX, kernel_s=0.0)) \
        is None
    assert read("mfu.als", dict(ALS_CTX, window_s=0.0)) is None
    assert read("als.solve_ms", dict(ALS_CTX, stages_ms={})) is None


def test_every_per_layer_metric_has_a_reader():
    import json
    import os

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        assert callable(cells.reader(ROOT, m["name"]))
