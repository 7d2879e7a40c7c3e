"""How much of a ``torch.profiler`` window's start loses its device records.

``torch.profiler`` keeps a device record only when its timestamp falls
inside the window, and the device timestamps come from another clock
than the window's bounds. Where the two drift apart over a process's
life, the first part of every window loses its kernels: a capture
opened late in a long-lived process (``POST /admin/profile`` on a
server up for hours, ``PIO_PROFILE_DIR`` in a process that trained
before) then under-counts, or records nothing if the window is short.

:func:`lead_loss` measures it at this process's age: one window through
``obs/profiler.trace_capture`` in which a marker kernel
(``torch.cuda._sleep``'s ``spin_kernel``, which nothing else launches)
is launched and waited for every ``spacing_ms``; the markers the
window lost, times the spacing, is the lost lead.

    python -m predictionio_torch.tools.profile_window --ages 5,120,300

probes at each process age (seconds since the process started) and
prints one JSON line each. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def process_age_sec() -> float:
    """Seconds since this process started (``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def lead_loss(markers: int = 100, spacing_ms: float = 5.0) -> dict:
    """One capture window with ``markers`` marker kernels ``spacing_ms``
    apart from its start: how many it recorded, and the lost lead (the
    markers lost, times the spacing)."""
    import torch

    from predictionio_torch.obs import profiler

    if not torch.cuda.is_available():
        raise RuntimeError("profile_window needs a CUDA card")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    age = process_age_sec()
    with tempfile.TemporaryDirectory(prefix="pio_profile_window_") as out:
        with profiler.trace_capture(out) as result:
            t0 = time.perf_counter()
            for j in range(markers):
                while time.perf_counter() - t0 < j * spacing_ms / 1e3:
                    time.sleep(spacing_ms / 1e4)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
    recorded = sum(v["count"] for name, v in result["summary"][
        "kernels"].items() if "spin_kernel" in name)
    return {"process_age_sec": age, "markers": markers,
            "spacing_ms": spacing_ms, "recorded": recorded,
            "lost_lead_ms": (markers - recorded) * spacing_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ages", default="5",
                        help="process ages (s) to probe at, comma-separated")
    parser.add_argument("--markers", type=int, default=100)
    parser.add_argument("--spacing-ms", type=float, default=5.0)
    args = parser.parse_args(argv)
    for age in sorted(float(a) for a in args.ages.split(",")):
        wait = age - process_age_sec()
        if wait > 0:
            time.sleep(wait)
        print(json.dumps(lead_loss(args.markers, args.spacing_ms)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
