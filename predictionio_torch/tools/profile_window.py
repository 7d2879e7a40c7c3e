"""How many of a ``torch.profiler`` window's first device records are lost.

A ``torch.profiler`` session started in a process that has run a while
drops the device records of the first kernels it sees, more the older
the process. A capture opened late in a long-lived process (``POST
/admin/profile`` on a server up for hours, ``PIO_PROFILE_DIR`` in a
process that trained before) would under-count, or record nothing if
the window is short. ``obs/profiler.py`` therefore launches tiny
kernels through a lead-in that grows with the process's age before it
opens the caller's window.

:func:`lead_loss` measures what a window still loses at this process's
age: one window through ``obs/profiler.trace_capture`` in which a
marker kernel (``torch.cuda._sleep``'s ``spin_kernel``, which nothing
else launches inside the window) is launched and waited for every
``spacing_ms``; the markers the window lost, times the spacing, is the
lost lead. Each line also gives the lead-in the window took
(``lead_sec``), the open marker's launch latency between the host's
clock and the card's (``clock_offset_ms``) and whether the window lost
a marker of its bounds (``window_lost``).

    python -m predictionio_torch.tools.profile_window --ages 5,100,250,500
        [--lead kernels|none]

probes at each process age (seconds since the process started) and
prints one JSON line each; ``--lead none`` measures what a plain
``torch.profiler`` session, with no lead-in, loses instead. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from predictionio_torch.obs.profiler import process_age_sec


def _markers(markers: int, spacing_ms: float) -> None:
    """``markers`` marker kernels ``spacing_ms`` apart, each waited for."""
    import torch

    t0 = time.perf_counter()
    for j in range(markers):
        while time.perf_counter() - t0 < j * spacing_ms / 1e3:
            time.sleep(spacing_ms / 1e4)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def lead_loss(markers: int = 100, spacing_ms: float = 5.0,
              lead: str = "kernels") -> dict:
    """One window with ``markers`` marker kernels ``spacing_ms`` apart
    from its start: how many it recorded, and the lost lead (the markers
    lost, times the spacing). ``lead="kernels"`` opens the window
    through ``obs.profiler.trace_capture`` (its lead-in and markers);
    ``"none"`` opens a plain ``torch.profiler`` session, as the capture
    did before it had a lead-in, and counts every marker it kept."""
    import torch

    from predictionio_torch.obs import profiler
    from predictionio_torch.tools import device_time

    if lead not in ("kernels", "none"):
        raise ValueError(f"lead must be 'kernels' or 'none', not {lead!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_window needs a CUDA card")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    age = process_age_sec()
    if lead == "none":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _markers(markers, spacing_ms)
        kernels, lead_sec, window = device_time.device_split(prof), 0.0, {}
    else:
        with tempfile.TemporaryDirectory(
                prefix="pio_profile_window_") as out:
            with profiler.trace_capture(out) as result:
                _markers(markers, spacing_ms)
        kernels, lead_sec = result["summary"]["kernels"], result["lead_sec"]
        window = result["summary"]["window"]
    recorded = sum(v["count"] for name, v in kernels.items()
                   if "spin_kernel" in name)
    return {"process_age_sec": age, "markers": markers,
            "spacing_ms": spacing_ms, "recorded": recorded,
            "lost_lead_ms": (markers - recorded) * spacing_ms,
            "lead": lead, "lead_sec": lead_sec,
            "window_lost": window.get("lost", False),
            "clock_offset_ms": window.get("clock_offset_ms")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ages", default="5",
                        help="process ages (s) to probe at, comma-separated")
    parser.add_argument("--markers", type=int, default=100)
    parser.add_argument("--spacing-ms", type=float, default=5.0)
    parser.add_argument("--lead", default="kernels",
                        choices=["kernels", "none"],
                        help="the capture's lead-in of tiny kernels (the "
                             "default), or a plain session with none")
    args = parser.parse_args(argv)
    for age in sorted(float(a) for a in args.ages.split(",")):
        wait = age - process_age_sec()
        if wait > 0:
            time.sleep(wait)
        print(json.dumps(lead_loss(args.markers, args.spacing_ms,
                                   args.lead)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
