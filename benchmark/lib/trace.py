"""The device trace of a window, from ``torch.profiler`` called here.

A ``session()`` opens the profiler, launches a lead-in of tiny kernels
and then marks the window's start: a ``torch.profiler`` session in an
old process drops the device records of the first kernels it sees, and
the lead-in (0.02 s plus 1 ms a second of the process's age, a kernel a
millisecond) takes that loss instead of the window. This is the method
of ``predictionio_torch/obs/profiler.py``'s ``windowed_profile``,
copied, so that the yardstick does not move with the program.

``mark(name)`` puts a marker kernel inside a ``record_function`` range
of that name; the card's record of the range gives the boundary on the
card's clock. The device operations between two marks belong to the
phase the first one opened. A session whose marks the card did not
record raises: a window without bounds has no device time.

What a session yields, once closed:

- ``ops``: every kernel, memset and copy in the window, as ``(start_us,
  end_us, short_name)``, and ``phase_ops`` the same by phase;
- ``window_s``: the window's length on the host clock, from the open
  mark to the end of the last device work; ``busy_s``: the union of the
  ops' intervals on the card;
- ``device_ops()`` and ``idle_gaps()``: the ``breakdown`` lists.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import time
import warnings
from typing import Dict, List, Tuple

LEAD_PER_SEC_OF_AGE = 1e-3
LEAD_FLOOR_SEC = 0.02
LEAD_MAX_SEC = 10.0
LEAD_SPACING_SEC = 1e-3
OPEN = "bench::open"
CLOSE = "bench::close"


def process_age_sec() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def lead_in_sec() -> float:
    return min(LEAD_MAX_SEC, LEAD_FLOOR_SEC
               + LEAD_PER_SEC_OF_AGE * max(0.0, process_age_sec()))


def kernel_name(signature: str) -> str:
    """``void (anonymous namespace)::f<1>(float const*, ...)`` -> ``f<1>``."""
    name = signature.replace("(anonymous namespace)::", "").replace(
        "void ", "")
    return name.split("(", 1)[0].strip()[:120]


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Session:
    def __init__(self):
        self.marks: List[str] = []
        self.window_s = 0.0
        self.lead_s = 0.0
        #: host clock at the open mark
        self.t0 = 0.0
        self.ops: List[Tuple[float, float, str]] = []
        self.phase_ops: Dict[str, List[Tuple[float, float, str]]] = {}
        self.start_us = self.end_us = 0.0
        self._host: List[Tuple[float, float, str, int]] = []

    def mark(self, name: str) -> None:
        import torch

        if name in self.marks:
            raise ValueError(f"mark {name!r} twice in one session")
        with torch.profiler.record_function(name):
            torch.ones(1, device="cuda")
        self.marks.append(name)

    # -- reading -----------------------------------------------------------

    def read(self, prof) -> None:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        names = set(self.marks)
        card: Dict[str, Tuple[float, float]] = {}
        ops: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str, int]] = []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == cuda:
                if e.name in names:
                    card[e.name] = (tr.start, tr.end)
                elif not e.is_user_annotation:
                    ops.append((tr.start, tr.end, kernel_name(e.name)))
            else:
                host.append((tr.start, tr.end, e.name, getattr(e, "thread",
                                                               0)))
        lost = [m for m in self.marks if m not in card]
        if lost:
            raise RuntimeError(f"the profiler lost the card's record of "
                               f"{lost} (lead-in {self.lead_s:.3f} s): the "
                               "window has no bounds")
        bounds = sorted((card[m][1], m) for m in self.marks)
        self.start_us = card[OPEN][1]
        self.end_us = card[CLOSE][0]
        inside = sorted(op for op in ops
                        if self.start_us <= op[0] < self.end_us)
        self.ops = inside
        starts = [b[0] for b in bounds]
        for op in inside:
            k = bisect.bisect_right(starts, op[0]) - 1
            self.phase_ops.setdefault(bounds[k][1], []).append(op)
        self._host = sorted(h for h in host
                            if h[1] >= self.start_us and h[0] < self.end_us
                            and h[2] not in names)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(s, e) for s, e, _ in self.ops])
                   ) / 1e6

    def phase_s(self, phase: str) -> float:
        """Device seconds of the ops of ``phase``."""
        return sum(e - s for s, e, _ in self.phase_ops.get(phase, ())) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        """The ``top`` device operations by summed seconds."""
        total: Dict[str, float] = {}
        for s, e, n in self.ops:
            total[n] = total.get(n, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The window's idle time on the card, summed by what the host
        was doing at each gap's middle: the innermost host event open
        there (a benchmark phase's range or an operator), ``host`` where
        none was."""
        busy = merged([(s, e) for s, e, _ in self.ops])
        edges = [self.start_us] + [x for iv in busy for x in iv] + [
            self.end_us]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        total: Dict[str, float] = {}
        for (s, e), name in zip(gaps, self._host_at([(s + e) / 2
                                                     for s, e in gaps])):
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def _host_at(self, times: List[float]) -> List[str]:
        """The innermost host event open at each of ``times``: among
        the events of every thread that cover it, the one that started
        last."""
        order = sorted(range(len(times)), key=lambda k: times[k])
        out = ["host"] * len(times)
        events = self._host
        i = 0
        open_: List[Tuple[float, float, str, int]] = []
        for k in order:
            t = times[k]
            while i < len(events) and events[i][0] <= t:
                open_.append(events[i])
                i += 1
            open_ = [ev for ev in open_ if ev[1] >= t]
            if open_:
                out[k] = max(open_, key=lambda ev: ev[0])[2][:120]
        return out


@contextlib.contextmanager
def session():
    """``with session() as tr:`` — the block runs under the profiler,
    after the lead-in and the open mark; ``tr`` is read on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    tr = Session()
    # torch says once a process that a session keeps one cycle's events
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.lead_s = lead_in_sec()
        end = time.perf_counter() + tr.lead_s
        while True:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            if time.perf_counter() >= end:
                break
            time.sleep(LEAD_SPACING_SEC)
        tr.mark(OPEN)
        tr.t0 = t0 = time.perf_counter()
        try:
            yield tr
        finally:
            torch.cuda.synchronize()
            tr.window_s = time.perf_counter() - t0
            tr.mark(CLOSE)
            torch.cuda.synchronize()
    tr.read(prof)
