"""obs: the telemetry and diagnostics core of the port.

Counterpart of ``predictionio_tpu/obs/__init__.py``, one registry:

  obs.metrics   — Counter/Gauge/Histogram with labels in a process-global
                  Registry, Prometheus text exposition (``GET /metrics``
                  on every server, serving/http.py)
  obs.trace     — trace ids + spans with ``X-PIO-Trace-Id`` propagation,
                  the span ring (``GET /admin/spans``, ``/admin/trace``)
  obs.torchmon  — PyTorch runtime bridge: kernel builds, transfer bytes,
                  train-step timing, device memory gauges (jaxmon's part)
  obs.flight    — the flight recorder: completed request records, metric
                  snapshots, slow-request log, error dumps
                  (``GET /admin/flight``)
  obs.profiler  — on-demand torch.profiler windows on the card
                  (``POST /admin/profile``) and their device-time summary
  obs.logging   — structured JSON log lines carrying the trace id
  obs.health    — the probes behind ``GET /readyz`` and the stall
                  watchdogs
  obs.journal   — the ops journal (``GET /admin/journal``)
  obs.perfacct  — MFU/roofline gauges on the card's peaks, the data-path
                  ledger and staleness clock, tail attribution
  obs.memacct   — the device-memory ledger, train peaks and preflight
                  (``GET /admin/memory``)
  obs.slo       — declarative SLOs and multi-window burn-rate alerts
                  (``GET /admin/slo``)
  obs.timeline  — bounded metric-timeline rings (``GET /admin/timeline``)
  obs.quality   — answer diffs, canary verdicts and drift reports
                  (``GET/POST /admin/quality``)

  obs.push      — the ``PIO_PUSH_URL`` OpenMetrics pusher with backoff
  obs.contprof  — the continuous host profiler: always-on stack
                  sampling by thread role, request and endpoint
                  (``GET /admin/prof``)
  obs.dataobs   — data-plane sketches over the event stream: rates,
                  heavy hitters and skew, cardinality, quantiles,
                  schema drift, query coverage (``GET /admin/data``)
  obs.anomaly   — the regression sentinel over the timelines, each
                  change-point attributed to a journal event
                  (``GET /admin/anomaly``)
  obs.collect   — the federation: stitched traces and the fleet's
                  merged metrics, tail, profile, journal, anomalies and
                  data (``GET /admin/trace``, ``/admin/fleet/*``)

Importing this package imports no torch and starts no thread: the
journal's writer, the watchdog monitor, the profiler's sampler, the
data plane's worker and the pusher start on first use.
"""

from predictionio_torch.obs import (flight, health, journal, memacct,
                                    metrics, perfacct, profiler, push,
                                    torchmon, trace)
from predictionio_torch.obs import logging as obs_logging
from predictionio_torch.obs.metrics import (
    CONTENT_TYPE,
    REGISTRY,
    counter,
    gauge,
    histogram,
)
from predictionio_torch.obs.trace import TRACE_HEADER, span

__all__ = [
    "CONTENT_TYPE",
    "REGISTRY",
    "TRACE_HEADER",
    "counter",
    "flight",
    "gauge",
    "health",
    "histogram",
    "journal",
    "memacct",
    "metrics",
    "obs_logging",
    "perfacct",
    "profiler",
    "push",
    "span",
    "torchmon",
    "trace",
]
