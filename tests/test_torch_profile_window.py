"""A profiler window opened late in a long-lived process keeps its first
device record (``predictionio_torch/obs/profiler.py``).

A ``torch.profiler`` session started in a process that has run a while
drops the device records of the first kernels it sees, more the older
the process (up to 7 at 100 s, 19 at 250 s, 40 at 500 s on an H100
host, ``tools/profile_window.py``). The port launches tiny kernels through a
lead-in that grows with the age, then opens the caller's window with a
marker and keeps the device records between it and the close marker;
a window that lost a marker says so and counts nothing. Here a fake
profiler applies that drop rule, so the CPU runs the whole window path;
the card-only probe is in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import contextlib
import types

import pytest
import torch

from predictionio_torch.obs import profiler
from predictionio_torch.tools import device_time

from tests.torch_env_guard import shared_env_unchanged  # noqa: F401

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA

#: the most records a session dropped at each process age on an H100
#: host (``tools/profile_window.py``, 100 markers 5 ms apart, no lead-in;
#: the last, a window in ``chip_smoke.py``'s own process)
MEASURED_LOSS = {10.8: 0, 18.33: 0, 100.0: 7, 250.0: 19, 500.0: 40,
                 899.78: 42, 1800.02: 0}


def _dropped(age):
    """The fake session's loss: at least the measured one, linear in the
    process's age."""
    return int(round(0.08 * age))


@pytest.mark.parametrize("age", sorted(MEASURED_LOSS))
def test_the_lead_in_outlasts_every_measured_loss(age):
    """At each measured age the lead-in launches more tiny kernels than
    the records a session dropped there, with room to spare."""
    kernels = profiler.lead_in_sec(age) / profiler.LEAD_SPACING_SEC
    assert kernels > 3 * MEASURED_LOSS[age] + 10
    assert _dropped(age) >= MEASURED_LOSS[age]


def test_the_lead_in_grows_with_the_process_age():
    assert profiler.lead_in_sec(0.0) == profiler.LEAD_FLOOR_SEC
    assert profiler.lead_in_sec(-5.0) == profiler.LEAD_FLOOR_SEC
    assert profiler.lead_in_sec(3600.0) == pytest.approx(
        profiler.LEAD_FLOOR_SEC + 3600.0 * profiler.LEAD_PER_SEC_OF_AGE)
    assert profiler.lead_in_sec(1e6) == profiler.LEAD_MAX_SEC
    age = profiler.process_age_sec()
    assert 0.0 < age < 24 * 3600.0
    assert profiler.lead_in_sec() >= profiler.lead_in_sec(age)


# -- a fake profiler that drops a session's first records --------------------

class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def sleep(self, seconds):
        self.now += seconds


def _event(name, device, start_s, end_s, thread=1, annotation=False):
    start_us, end_us = start_s * 1e6, end_s * 1e6
    return types.SimpleNamespace(
        name=name, key=name, device_type=device, thread=thread,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(
            start=start_us, end=end_us,
            elapsed_us=lambda: end_us - start_us))


class FakeProfile:
    """CPU ranges and kernels on one clock; a kernel launched inside a
    marker range also gives the range's record on the card. On stop it
    drops the card's records of the first ``dropped`` kernels."""

    def __init__(self, clock, dropped):
        self.clock = clock
        self.dropped = dropped
        self.cpu = []
        self.card = []     # [(kernel record, its range's card record)]
        self.range = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.kept = [r for pair in self.card[self.dropped:] for r in pair
                     if r is not None]
        return False

    def launch(self, name, thread=1):
        """A kernel launched now, running 1 ms."""
        start = self.clock.now + 5e-6
        kernel = _event(name, CUDA, start, start + 1e-3, thread)
        annotation = (_event(self.range, CUDA, start, start + 1e-3, thread,
                             annotation=True)
                      if self.range else None)
        self.card.append((kernel, annotation))
        self.clock.now += 1e-3

    def events(self):
        return self.cpu + self.kept


@contextlib.contextmanager
def _fake_card(monkeypatch, clock, dropped):
    """``windowed_profile`` on the fake profiler and clock, as on a card."""
    made = []

    def make_profile(activities=None):
        made.append(FakeProfile(clock, dropped))
        return made[-1]

    def mark(name):
        prof = made[-1]
        start = clock.now
        prof.range = name
        prof.launch("vectorized_elementwise_kernel<FillFunctor>")
        prof.range = None
        prof.cpu.append(_event(name, CPU, start, clock.now,
                               annotation=True))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", make_profile)
    monkeypatch.setattr(profiler, "_mark", mark)
    monkeypatch.setattr(profiler, "_lead_kernel",
                        lambda: made[-1].launch("spin_kernel"))
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: clock.now)
    yield made


@pytest.mark.parametrize("age", [10.8, 500.0, 3600.0])
def test_a_late_window_keeps_its_first_record(monkeypatch, age):
    """At the process age the session drops its first records: the
    lead-in's kernels take the loss, the caller's first kernel is kept,
    and neither the lead-in nor the markers reach the summary."""
    clock = FakeClock()
    monkeypatch.setattr(profiler, "process_age_sec", lambda: age)
    with _fake_card(monkeypatch, clock, _dropped(age)) as made:
        with profiler.windowed_profile(sleep=clock.sleep) as w:
            prof = made[-1]
            prof.launch("first_kernel")
            clock.sleep(0.010)
            prof.launch("topk_dot_kernel<8,4>", thread=2)
    assert w["lead_sec"] == profiler.lead_in_sec(age)
    window = w["window"]
    assert window["start_us"] is not None and window["end_us"] is not None
    assert window["clock_offset_ms"] == pytest.approx(5e-3)
    assert w["seconds"] == pytest.approx(0.012, abs=1e-9)
    split = device_time.device_split(w["prof"], window=window)
    assert split == {
        "first_kernel": {"count": 1, "ms": pytest.approx(1.0)},
        "topk_dot_kernel<8,4>": {"count": 1, "ms": pytest.approx(1.0)}}
    summary = profiler.summarize(w["prof"], w["seconds"], window)
    assert summary["device_ms"] == pytest.approx(2.0)
    assert summary["idle_share"] == pytest.approx(1.0 - 2.0 / 12.0)
    assert summary["window"] == window


def test_without_the_lead_in_the_first_records_are_lost(monkeypatch):
    """The failure the lead-in repairs: at 500 s of age a window opened
    at once loses its marker and its first 39 kernels, and says so: it
    has no bounds, so its summary holds no device time and
    ``device_split`` will not count between its markers."""
    clock = FakeClock()
    monkeypatch.setattr(profiler, "lead_in_sec", lambda age=None: 0.0)
    monkeypatch.setattr(profiler, "_lead_in", lambda seconds, sleep: None)
    with _fake_card(monkeypatch, clock, _dropped(500.0)) as made:
        with profiler.windowed_profile(sleep=clock.sleep) as w:
            for _ in range(50):
                made[-1].launch("caller_kernel")
    assert w["window"]["start_us"] is None and w["window"]["lost"]
    assert device_time.device_split(w["prof"])["caller_kernel"][
        "count"] == 50 - 39
    with pytest.raises(ValueError, match="lost a marker"):
        device_time.device_split(w["prof"], window=w["window"])
    summary = profiler.summarize(w["prof"], w["seconds"], w["window"])
    assert summary["window_lost"] is True
    assert summary["kernels"] == {}
    assert summary["device_ms"] is None and summary["idle_share"] is None
    assert "error" in profiler.parse_capture({"summary": summary})


def test_a_cpu_capture_takes_no_lead_in(monkeypatch, tmp_path):
    """Without a card no device record can be lost: the window opens at
    once and keeps its CPU summary."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("PIO_PROFILE_FORCE", "1")
    slept = []
    with profiler.windowed_profile(sleep=slept.append) as w:
        torch.ones(4).sum()
    assert slept == [] and w["lead_sec"] == 0.0 and w["window"] is None
    with profiler.trace_capture(str(tmp_path)) as result:
        torch.ones(4).sum()
    assert result["lead_sec"] == 0.0
    assert result["summary"]["device"] == "cpu"
    assert "window" not in result["summary"]


#: lead-ins a window could take: the port's tiny kernels, a wait as
#: long that launches nothing, and none
LEAD_INS = {"kernels": profiler._lead_in,
            "sleep": lambda seconds, sleep: sleep(seconds),
            "none": lambda seconds, sleep: None}


@pytest.mark.parametrize("lead,first_kept", [("kernels", True),
                                             ("sleep", False),
                                             ("none", False)])
def test_only_a_lead_in_of_kernels_takes_the_loss(monkeypatch, lead,
                                                  first_kept):
    """A lead-in that only waits, or none, leaves the session's first
    records to be the caller's, which it drops: the window then loses
    its open marker and its summary says so."""
    clock = FakeClock()
    monkeypatch.setattr(profiler, "process_age_sec", lambda: 500.0)
    monkeypatch.setattr(profiler, "_lead_in", LEAD_INS[lead])
    with _fake_card(monkeypatch, clock, _dropped(500.0)) as made:
        with profiler.windowed_profile(sleep=clock.sleep) as w:
            made[-1].launch("first_kernel")
    assert w["lead_sec"] == profiler.lead_in_sec(500.0)
    assert w["window"]["lost"] is not first_kept
    summary = profiler.summarize(w["prof"], w["seconds"], w["window"])
    assert ("first_kernel" in summary["kernels"]) == first_kept
    assert summary.get("window_lost", False) is not first_kept


def test_a_range_inside_the_window_is_not_a_kernel(monkeypatch):
    """The card's record of a ``record_function`` range (an optimizer's
    step, say) spans the kernels inside it: only the kernels count, so
    the window's device time is theirs once."""
    clock = FakeClock()
    monkeypatch.setattr(profiler, "process_age_sec", lambda: 100.0)
    with _fake_card(monkeypatch, clock, _dropped(100.0)) as made:
        with profiler.windowed_profile(sleep=clock.sleep) as w:
            prof = made[-1]
            prof.range = "Optimizer.step#AdamW.step"
            prof.launch("multi_tensor_apply_kernel")
            prof.launch("multi_tensor_apply_kernel")
            prof.range = None
            prof.launch("embed_update_kernel")
    split = device_time.device_split(w["prof"], window=w["window"])
    assert split == {
        "multi_tensor_apply_kernel": {"count": 2, "ms": pytest.approx(2.0)},
        "embed_update_kernel": {"count": 1, "ms": pytest.approx(1.0)}}
    summary = profiler.summarize(w["prof"], w["seconds"], w["window"])
    assert summary["device_ms"] == pytest.approx(3.0)


def test_profile_call_records_a_lost_window_again(monkeypatch):
    """A window that lost a marker is never read: ``profile_call``
    records it again, and raises when every window lost one."""
    clock = FakeClock()
    monkeypatch.setattr(profiler, "_lead_in", LEAD_INS["none"])
    monkeypatch.setattr(profiler, "process_age_sec", lambda: 500.0)
    with _fake_card(monkeypatch, clock, _dropped(500.0)) as made:
        def call():
            if made:
                made[-1].launch("caller_kernel")
        with pytest.raises(RuntimeError, match="no device time"):
            device_time.profile_call(call, iters=10)
    assert len(made) == device_time.PROFILE_WINDOWS
    clock = FakeClock()
    monkeypatch.setattr(profiler, "_lead_in", LEAD_INS["kernels"])
    with _fake_card(monkeypatch, clock, _dropped(500.0)) as made:
        got = device_time.profile_call(call, iters=10)
    assert got["windows"] == 1 and got["kernels"] == ["caller_kernel"]
    assert got["ms"] == pytest.approx(1.0)
