"""Timing helpers for the port's kernels on an H100.

Device time per call from ``torch.profiler``, CUDA-event time per call,
and the card's rates that bound a kernel's work. ``chip_smoke.py`` and
the timing tools under ``predictionio_torch/tools/`` share them. Every
function needs a CUDA card.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
L2_FLUSH_BYTES = 256 << 20       # five times the 50 MB L2
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
# H100 SXM exponentials: 132 SMs x 16 special-function results per clock
# (CUDA C++ Programming Guide, arithmetic throughput, cc 9.0) x 1.98 GHz
SFU_PER_S = 132 * 16 * 1.98e9


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """CUDA-event time per call over back-to-back calls: the device time
    or the host's time to issue the call, whichever is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 50) -> float:
    """Median CUDA-event time of one call issued right after a write of
    ``L2_FLUSH_BYTES``, so the call finds nothing of its inputs in L2."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def kernel_name(signature: str) -> str:
    """``void (anonymous namespace)::f<1>(float const*, ...)`` -> ``f<1>``."""
    name = signature.replace("(anonymous namespace)::", "").replace(
        "void ", "")
    return name.split("(", 1)[0].strip()


def profile_call(fn, iters: int = 100, cold: bool = False) -> dict:
    """Device time per call of ``fn`` from ``torch.profiler`` over
    ``iters`` calls: ``ms``, the summed self time of every CUDA kernel and
    memset; ``split``, that time by kernel (short names); the kernels and
    the memsets traced per call, and the kernels' names. ``cold``: each
    call follows a ``bitwise_not_`` over ``L2_FLUSH_BYTES``, so it finds
    nothing of its inputs in L2; the flush's own kernel is left out."""
    from torch.profiler import ProfilerActivity, profile

    flush = (torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device="cuda") if cold else None)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    traced = device_split(prof, skip="bitwise_not")
    split = {name: v["ms"] / iters for name, v in traced.items()}
    if sum(split.values()) <= 0:
        raise RuntimeError("torch.profiler traced no device time")
    memsets = sum(v["count"] for name, v in traced.items()
                  if "memset" in name.lower())
    launched = sum(v["count"] for v in traced.values())
    return {"ms": sum(split.values()), "split": split,
            "kernels_per_call": (launched - memsets) / iters,
            "memsets_per_call": memsets / iters,
            "kernels": sorted(name for name in split
                              if "memset" not in name.lower())}


def device_split(prof, skip: str = "") -> dict:
    """Device work a finished ``torch.profiler.profile`` traced, by
    short kernel name: ``{name: {"count": launches, "ms": summed self
    device time}}``; events whose name contains ``skip`` (when given)
    are left out. The one reader of a trace's device events, shared by
    the timing helpers here and ``obs/profiler.py``'s capture summary."""
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if skip and skip in e.key:
            continue
        entry = out.setdefault(kernel_name(e.key), {"count": 0, "ms": 0.0})
        entry["count"] += e.count
        entry["ms"] += e.self_device_time_total / 1e3
    return out
