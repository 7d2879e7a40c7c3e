"""Shared HTTP plumbing: JSON handler, bind retries, thread lifecycle,
the operator routes, the admin bearer gate and the SIGTERM drain.

Copy of ``predictionio_tpu/serving/http.py`` for what the port has.
Every server inherits, from the ``_instrument`` wrapper:

  GET  /healthz          liveness (cheap, no probes)
  GET  /readyz           readiness (health probes; 503 on any FAILED)
  GET  /metrics          Prometheus text, or OpenMetrics with exemplars
                         under ``Accept: application/openmetrics-text``
  GET  /admin/flight     flight-recorder dump         } bearer-token
  POST /admin/profile    torch.profiler window and    } guarded when
                         its device-time summary      } PIO_ADMIN_TOKEN
  GET  /admin/spans      this process's span ring     } is set
  GET  /admin/trace      the stitched trace of one id }
                         across the federation members}
                         (obs/collect.py)             }
  GET  /admin/journal    ops journal ring             }
  GET  /admin/memory     device-memory accounting     }
  GET  /admin/slo        SLO burn-rate evaluation     }
  GET/POST /admin/chaos  fault-injection rule set     }
  GET  /admin/resilience breaker/admission/chaos      }
  GET  /admin/timeline   metric timelines + the       }
                         data-path ledger             }
  GET  /admin/tail       tail-latency attribution     }
  GET  /admin/prof       continuous host profiler     }
                         flame (obs/contprof.py)      }
  GET  /admin/anomaly    regression sentinel report   }
  GET  /admin/data       data-plane report            }
                         (obs/dataobs.py)             }
  GET/POST /admin/quality model-quality report        }
  GET/POST /admin/fleet  replica fleet snapshot and   }
                         control (404 without a fleet)}
  GET  /admin/fleet/{metrics,tail,prof,journal,       }
                    anomaly,data}                     }
                         the members' answers merged  }
                         (404 without a fleet or      }
                         PIO_OBS_MEMBERS)             }

and the request telemetry: a trace context per request (an accepted
or minted ``X-PIO-Trace-Id``, echoed on the response), a flight record,
``pio_http_requests_total``, ``pio_http_request_duration_seconds`` and
the ``pio_http_requests_in_flight`` gauge. The gauge is labelled by
server class, as in the JAX package; the drain and the 503 gate of a
stopped server keep a count per server instance, since one process
may run two servers of a class (an engine server per deployment).

Every admin route of the JAX server answers here. A server's
``start()`` starts the environment's process services, as a JAX
server's does: the metrics pusher (``PIO_PUSH_URL``), the SLO alert
webhook sink (``PIO_ALERT_WEBHOOK_URL``), the SLO objectives
(``PIO_SLO_FILE``) and the chaos rules (``PIO_CHAOS``); and it holds
the continuous host profiler (obs/contprof.py) from ``start()`` to
``stop()``, whose samples of a handler thread carry its request's trace
id and route.
"""

from __future__ import annotations

import functools
import hmac
import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qs, urlparse

from predictionio_torch.obs import (anomaly, collect, contprof, dataobs,
                                    flight, health, journal, memacct,
                                    metrics, perfacct, profiler, push, slo,
                                    timeline, trace)
from predictionio_torch.resilience import alerts, chaos
from predictionio_torch.resilience import policy as respolicy

log = logging.getLogger(__name__)

_REQUESTS_TOTAL = metrics.counter(
    "pio_http_requests_total",
    "HTTP requests answered, by server, method, route and status",
    ("server", "method", "route", "status"),
)
_REQUEST_SECONDS = metrics.histogram(
    "pio_http_request_duration_seconds",
    "HTTP request handling wall time (request parsed -> response written)",
    ("server", "method", "route"),
)
_IN_FLIGHT = metrics.gauge(
    "pio_http_requests_in_flight",
    "Requests currently being handled, by server",
    ("server",),
)

#: path segments that are data ids (event/model/scan ids, uuid hexes):
#: collapsed to ":id" so metric label cardinality stays bounded
_ID_SEGMENT = re.compile(r"^[0-9a-fA-F-]{16,}$")

#: hard cap on distinct route labels per process: beyond this, new
#: paths (scanners probing random 404s) collapse to ":other"
_MAX_ROUTES = 64
_routes_seen: set = set()


def metrics_route(path: str) -> str:
    """A bounded-cardinality route label for a request path."""
    out = []
    for seg in path.split("/"):
        if not seg:
            continue
        stem, dot, ext = seg.rpartition(".")
        base = stem if dot else seg
        if _ID_SEGMENT.match(base) or len(base) > 48:
            seg = ":id" + (dot + ext if dot else "")
        out.append(seg)
    route = "/" + "/".join(out)
    if route in _routes_seen:
        return route
    if len(_routes_seen) < _MAX_ROUTES:  # benign race: cap is approximate
        _routes_seen.add(route)
        return route
    return ":other"


def _admin_authorized(handler) -> bool:
    """Bearer-token gate for the ``/admin/*`` routes and the routes that
    change a server (``POST /model/patch``): with ``PIO_ADMIN_TOKEN``
    unset everything stays open (the trusted-network default); once
    set, requests must carry ``Authorization: Bearer <token>``
    (constant-time compare)."""
    token = os.environ.get("PIO_ADMIN_TOKEN")
    if not token:
        return True
    supplied = handler.headers.get("Authorization") or ""
    return hmac.compare_digest(supplied, f"Bearer {token}")


def _server_storage(server_ref) -> Any:
    """The serving object's storage, wherever the server keeps it (the
    event server nests it inside its core)."""
    storage = getattr(server_ref, "storage", None)
    if storage is None:
        storage = getattr(getattr(server_ref, "core", None), "storage", None)
    return storage


def _serve_readyz(handler) -> None:
    """``GET /readyz``: run the process health probes plus THIS
    server's storage probe; 200 while nothing FAILED, 503 with the same
    per-probe detail otherwise. A server may override its storage probe
    with a ``storage_readyz_probe`` method (the engine server does:
    storage loss is DEGRADED while a model is loaded)."""
    health.install_default_probes()
    override = getattr(handler.server_ref, "storage_readyz_probe", None)
    if override is not None:
        extra = {"storage": override}
    else:
        storage = _server_storage(handler.server_ref)
        extra = {"storage": lambda: health.storage_probe(storage)}
    overall, detail = health.REGISTRY.run(extra=extra)
    status = 503 if overall == health.FAILED else 200
    handler._send(status, {"status": overall, "probes": detail})


def _serve_metrics(handler, query: str) -> None:
    """``GET /metrics``: Prometheus text by default; the OpenMetrics
    document under ``Accept: application/openmetrics-text`` or
    ``?format=openmetrics``. Device-memory gauges are refreshed first
    (where CUDA is initialised), so a scrape reads the allocator now."""
    memacct.update_device_memory_gauges()
    accept = handler.headers.get("Accept") or ""
    fmt = (parse_qs(query).get("format") or [""])[0]
    if "application/openmetrics-text" in accept or fmt == "openmetrics":
        handler._send(200, metrics.REGISTRY.render_openmetrics(),
                      content_type=metrics.OPENMETRICS_CONTENT_TYPE)
    else:
        handler._send(200, metrics.REGISTRY.render(),
                      content_type=metrics.CONTENT_TYPE)


def _serve_admin_flight(handler, query: str) -> None:
    """``GET /admin/flight``: the flight-recorder dump as JSON.
    ``?n=N`` limits to the last N records, ``?slow=1`` keeps only
    slow/errored ones. Captured query payloads are included only when an
    admin token is configured (and so was presented)."""
    params = parse_qs(query)
    try:
        n = int(params["n"][0]) if "n" in params else None
    except ValueError:
        handler._send(400, {"message": "n must be an integer"})
        return
    slow_only = (params.get("slow") or ["0"])[0].lower() in ("1", "true")
    include_payloads = bool(os.environ.get("PIO_ADMIN_TOKEN"))
    handler._send(200, flight.RECORDER.dump(
        n, slow_only=slow_only, include_payloads=include_payloads))


def _serve_admin_profile(handler, query: str) -> None:
    """``POST /admin/profile?seconds=N``: record a torch.profiler window
    of THIS process and answer the trace's path and its device-time
    summary (kernel launch counts and times, the idle share); 501
    without a card, 409 while a capture is running. The handler thread
    sleeps through the window: the capture is of the OTHER threads."""
    params = parse_qs(query)
    try:
        seconds = float((params.get("seconds") or ["3"])[0])
    except ValueError:
        handler._send(400, {"message": "seconds must be a number"})
        return
    seconds = profiler.clamp_seconds(seconds)
    try:
        result = profiler.capture(seconds)
    except profiler.ProfilerUnavailable as e:
        handler._send(501, {"message": str(e),
                            "backend": profiler.backend()})
        return
    except profiler.ProfilerBusy as e:
        handler._send(409, {"message": str(e)})
        return
    handler._send(200, {"artifact": result["artifact"], "seconds": seconds,
                        "backend": profiler.backend(),
                        "summary": result["summary"]})


def _serve_admin_spans(handler, query: str) -> None:
    """``GET /admin/spans?trace=<id>&n=N``: THIS process's span ring,
    with the ring capacity and the eviction counter."""
    params = parse_qs(query)
    trace_id = (params.get("trace") or [None])[0]
    if trace_id is not None and not trace.valid_trace_id(trace_id):
        handler._send(400, {"message": "trace must be id-shaped"})
        return
    try:
        n = int(params["n"][0]) if "n" in params else None
    except ValueError:
        handler._send(400, {"message": "n must be an integer"})
        return
    server = handler.server_version.split("/", 1)[0]
    handler._send(200, trace.span_page(server, trace_id, n))


def _serve_admin_trace(handler, query: str) -> None:
    """``GET /admin/trace?id=<trace>``: the cross-process stitched
    trace: this server fans out to its federation members (its fleet's
    replicas, the active supervisors of this process, and the
    ``PIO_OBS_MEMBERS`` extras), dedupes and assembles one annotated
    tree (obs/collect.py)."""
    params = parse_qs(query)
    trace_id = (params.get("id") or params.get("trace") or [None])[0]
    if not trace_id or not trace.valid_trace_id(trace_id):
        handler._send(400, {"message": "need an id-shaped ?id=<trace>"})
        return
    members = collect.default_members(handler.server_ref)
    handler._send(200, collect.stitch_trace(trace_id, members))


def _serve_admin_tail(handler, query: str) -> None:
    """``GET /admin/tail?q=``: tail-latency attribution over the flight
    recorder's stage timings: for requests above ``q`` (default 0.95),
    which stage dominates against the median request."""
    params = parse_qs(query)
    try:
        q = float((params.get("q") or ["0.95"])[0])
        report = perfacct.tail_report(q=q)
    except ValueError as e:
        handler._send(400, {"message": str(e)})
        return
    handler._send(200, report)


def _fleet_federation_members(handler):
    """The members of the fleet-scoped federations: the supervised
    fleet's replicas plus the ``PIO_OBS_MEMBERS`` extras, first
    occurrence of a name or address winning (a replica scraped twice
    would be summed twice); None (404) with neither."""
    fleet = getattr(handler.server_ref, "fleet", None)
    members = collect.fleet_members(fleet) + collect.env_members()
    seen: set = set()
    deduped = []
    for m in members:
        if m.name in seen or m.url in seen:
            continue
        seen.update((m.name, m.url))
        deduped.append(m)
    return deduped or None


def _serve_fleet_metrics(handler, query: str, members) -> None:
    """``GET /admin/fleet/metrics``: the members' /metrics merged
    (counters sum, histograms bucket-wise, gauges keep a ``member``
    label) with the fleet SLO burn; ``?format=prom`` answers the merged
    document as Prometheus text."""
    report = collect.federate_metrics(members)
    merged = report.pop("_merged")
    fmt = (parse_qs(query).get("format") or [""])[0]
    if fmt in ("prom", "prometheus", "text"):
        handler._send(200, collect.render_merged(merged),
                      content_type=metrics.CONTENT_TYPE)
        return
    handler._send(200, report)


def _serve_fleet_tail(handler, query: str, members) -> None:
    """``GET /admin/fleet/tail?q=&n=``: tail attribution over every
    member's flight recorder, with the per-member tail split."""
    params = parse_qs(query)
    try:
        q = float((params.get("q") or ["0.95"])[0])
        n = int(params["n"][0]) if "n" in params else None
        report = collect.federate_tail(members, q=q, n=n)
    except ValueError as e:
        handler._send(400, {"message": str(e)})
        return
    handler._send(200, report)


def _parse_prof_slices(query: str):
    """``?slow=1``, ``?endpoint=`` and ``?format=`` of the profile
    routes."""
    params = parse_qs(query)
    slow = (params.get("slow") or ["0"])[0].lower() in ("1", "true")
    endpoint = (params.get("endpoint") or [None])[0]
    fmt = (params.get("format") or [""])[0]
    return slow, endpoint, fmt


def _serve_admin_prof(handler, query: str) -> None:
    """``GET /admin/prof``: the continuous host profiler's flame
    (obs/contprof.py); ``?format=collapsed`` answers folded ``stack
    count`` lines, ``?endpoint=`` one route's slice, ``?slow=1`` the
    above-``PIO_SLOW_MS`` cohort with its trace ids."""
    slow, endpoint, fmt = _parse_prof_slices(query)
    payload = contprof.snapshot(endpoint=endpoint, slow=slow)
    if fmt == "collapsed":
        handler._send(200, contprof.collapsed_text(payload),
                      content_type="text/plain; charset=UTF-8")
        return
    handler._send(200, payload)


def _serve_fleet_prof(handler, query: str, members) -> None:
    """``GET /admin/fleet/prof``: the members' profiles with their
    folded stacks summed; the slices of ``/admin/prof``."""
    slow, endpoint, fmt = _parse_prof_slices(query)
    report = collect.federate_prof(members, endpoint=endpoint, slow=slow)
    if fmt == "collapsed":
        handler._send(200, contprof.collapsed_text(report["merged"]),
                      content_type="text/plain; charset=UTF-8")
        return
    handler._send(200, report)


def _journal_slices(handler, query: str):
    """``(n, kind, since)`` of the journal routes; None after a 400."""
    params = parse_qs(query)
    try:
        n = int((params.get("n") or ["200"])[0])
        since = float(params["since"][0]) if "since" in params else None
    except ValueError as e:
        handler._send(400, {"message": f"bad n/since: {e}"})
        return None
    return n, (params.get("kind") or [None])[0], since


def _serve_admin_journal(handler, query: str) -> None:
    """``GET /admin/journal?n=&kind=&since=``: this process's ops
    journal ring, newest last; ``kind`` filters one event kind exactly,
    ``since`` is a unix-seconds floor, ``n`` caps the page (200)."""
    slices = _journal_slices(handler, query)
    if slices is not None:
        n, kind, since = slices
        handler._send(200, journal.JOURNAL.page(n=n, kind=kind,
                                                since=since))


def _serve_fleet_journal(handler, query: str, members) -> None:
    """``GET /admin/fleet/journal``: the members' journals merged into
    one member-annotated, time-ordered stream (the slices of
    ``/admin/journal``)."""
    slices = _journal_slices(handler, query)
    if slices is not None:
        n, kind, since = slices
        handler._send(200, collect.federate_journal(members, n=n, kind=kind,
                                                    since=since))


def _serve_admin_data(handler, query: str) -> None:
    """``GET /admin/data?top=``: the data plane's report
    (obs/dataobs.py): ingest rates, entity heavy hitters and skew,
    cardinalities, quantiles, schema drift and the unknown-entity
    coverage ratio; ``top`` sizes the heavy-hitter table."""
    try:
        top = int((parse_qs(query).get("top") or ["20"])[0])
    except ValueError as e:
        handler._send(400, {"message": f"bad top: {e}"})
        return
    handler._send(200, dataobs.DATAOBS.report(top_n=top))


def _serve_admin_quality(handler) -> None:
    """``GET /admin/quality``: the model-quality report (obs/quality.py
    STATE): the latest drift probe and replay comparison, the canary's
    progress and verdict. ``POST /admin/quality`` with ``{"replay":
    {...}}`` and/or ``{"drift": {...}}`` registers a report computed
    elsewhere (``pio replay`` pushes its result here)."""
    from predictionio_torch.obs import quality

    if handler.command == "GET":
        handler._send(200, quality.STATE.report())
        return
    if handler.command != "POST":
        handler._send(405, {"message": "GET or POST"})
        return
    try:
        payload = handler._read_json()
    except json.JSONDecodeError as e:
        handler._send(400, {"message": f"invalid JSON: {e}"})
        return
    registered = []
    if isinstance(payload, dict):
        if isinstance(payload.get("replay"), dict):
            quality.STATE.set_replay(payload["replay"])
            registered.append("replay")
        if isinstance(payload.get("drift"), dict):
            quality.STATE.set_drift(payload["drift"])
            registered.append("drift")
    if not registered:
        handler._send(400, {"message": 'body needs a "replay" and/or '
                                       '"drift" object'})
        return
    handler._send(200, {"message": "registered: " + ", ".join(registered)})


def _serve_admin_chaos(handler) -> None:
    """``GET /admin/chaos``: the active fault-injection rule set.
    ``POST /admin/chaos``: ``{"spec": "..."}`` replaces it, ``{"add":
    "..."}`` appends, ``{"clear": true | "site"}`` drops
    (resilience/chaos.py spec grammar)."""
    if handler.command == "GET":
        handler._send(200, chaos.describe())
        return
    if handler.command != "POST":
        handler._send(405, {"message": "GET or POST"})
        return
    try:
        payload = handler._read_json()
        result = chaos.apply_admin(payload)
    except (json.JSONDecodeError, ValueError) as e:
        handler._send(400, {"message": str(e)})
        return
    handler._send(200, result)


def _serve_admin_timeline(handler) -> None:
    """``GET /admin/timeline``: the metric-timeline rings
    (obs/timeline.py) plus the data-path ledger and staleness clock
    (obs/perfacct.py). The read ticks the sampler (rate-limited by the
    cadence), so watching a server builds its history."""
    timeline.TIMELINE.sample()
    payload = timeline.TIMELINE.series()
    payload["datapath"] = perfacct.LEDGER.snapshot()
    handler._send(200, payload)


def _serve_admin_fleet(handler) -> None:
    """``GET /admin/fleet``: the replica fleet's snapshot (states,
    versions, restart counts, swap and canary progress). ``POST
    /admin/fleet``: ``{"reload": true}`` starts a rolling hot-swap,
    ``{"drain"|"readmit": "<replica>"}`` moves a replica out of or back
    into rotation, ``{"canary": "start"|"promote"|"rollback"}`` drives
    the canary lane. 404 on a server that supervises no fleet."""
    fleet = getattr(handler.server_ref, "fleet", None)
    if fleet is None:
        handler._send(404, {"message": "no fleet supervised by this "
                                       "server"})
        return
    if handler.command == "GET":
        handler._send(200, fleet.snapshot())
        return
    if handler.command != "POST":
        handler._send(405, {"message": "GET or POST"})
        return
    try:
        result = fleet.apply_admin(handler._read_json())
    except (json.JSONDecodeError, ValueError) as e:
        handler._send(400, {"message": str(e)})
        return
    if "started" in result:
        # as the router's GET /reload: 202 for a swap started now, 409
        # when one is running already
        handler._send(202 if result["started"] else 409, result)
        return
    handler._send(200, result)


def _serve_admin_resilience(handler) -> None:
    """``GET /admin/resilience``: the circuit breakers, this server's
    admission controller (None where it has none) and the active chaos
    rules: the degraded-mode diagnosis on one page."""
    admission = getattr(handler.server_ref, "admission", None)
    handler._send(200, {
        "circuits": respolicy.breakers_snapshot(),
        "admission": (admission.snapshot()
                      if admission is not None else None),
        "chaos": chaos.describe(),
    })


def _serve_admin(handler, path: str, query: str) -> bool:
    """The ``/admin/*`` routes; False when ``path`` is none of them."""
    command = handler.command
    if command == "GET" and path == "/admin/flight":
        _serve_admin_flight(handler, query)
    elif command == "POST" and path == "/admin/profile":
        _serve_admin_profile(handler, query)
    elif command == "GET" and path == "/admin/spans":
        _serve_admin_spans(handler, query)
    elif command == "GET" and path == "/admin/trace":
        _serve_admin_trace(handler, query)
    elif command == "GET" and path == "/admin/journal":
        _serve_admin_journal(handler, query)
    elif command == "GET" and path == "/admin/memory":
        handler._send(200, memacct.report())
    elif command == "GET" and path == "/admin/slo":
        handler._send(200, slo.MONITOR.report())
    elif path == "/admin/chaos":
        _serve_admin_chaos(handler)
    elif command == "GET" and path == "/admin/resilience":
        _serve_admin_resilience(handler)
    elif command == "GET" and path == "/admin/timeline":
        _serve_admin_timeline(handler)
    elif path == "/admin/quality":
        _serve_admin_quality(handler)
    elif command == "GET" and path == "/admin/tail":
        _serve_admin_tail(handler, query)
    elif command == "GET" and path == "/admin/prof":
        _serve_admin_prof(handler, query)
    elif command == "GET" and path == "/admin/anomaly":
        # the read scans, so an idle server still verdicts while someone
        # is watching
        handler._send(200, anomaly.SENTINEL.scan())
    elif command == "GET" and path == "/admin/data":
        _serve_admin_data(handler, query)
    elif path == "/admin/fleet":
        _serve_admin_fleet(handler)
    elif command == "GET" and path in _FLEET_FEDERATIONS:
        members = _fleet_federation_members(handler)
        if members is None:
            handler._send(404, {"message": "no fleet supervised by this "
                                           "server and no PIO_OBS_MEMBERS "
                                           "configured"})
        else:
            _FLEET_FEDERATIONS[path](handler, query, members)
    else:
        return False
    return True


#: ``GET /admin/fleet/<name>``: each takes (handler, query, members)
_FLEET_FEDERATIONS = {
    "/admin/fleet/metrics": _serve_fleet_metrics,
    "/admin/fleet/tail": _serve_fleet_tail,
    "/admin/fleet/prof": _serve_fleet_prof,
    "/admin/fleet/journal": _serve_fleet_journal,
    "/admin/fleet/anomaly": lambda handler, query, members: handler._send(
        200, collect.federate_anomaly(members)),
    "/admin/fleet/data": lambda handler, query, members: handler._send(
        200, collect.federate_data(members)),
}


def _instrument(fn):
    """Wrap a ``do_METHOD`` handler: serve the shared routes before any
    per-server routing or auth, then run the handler under the request's
    trace context with a flight record, the request metrics and this
    server's in-flight count (what the drain waits for). Applied once
    to every handler class through ``__init_subclass__``."""
    if getattr(fn, "_pio_instrumented", False):
        return fn

    @functools.wraps(fn)
    def wrapper(self):
        parsed = urlparse(self.path)
        path = parsed.path
        server_label = self.server_version.split("/", 1)[0]
        if self.command == "GET" and path == "/healthz":
            # liveness: no probes, no locks beyond _send
            self._send(200, {"status": "alive"})
            return
        if self.command == "GET" and path == "/readyz":
            _serve_readyz(self)
            return
        if self.command == "GET" and path == "/metrics":
            _serve_metrics(self, parsed.query)
            return
        if path.startswith("/admin/"):
            if not _admin_authorized(self):
                self._send(401, {"message": "missing or invalid bearer "
                                            "token (PIO_ADMIN_TOKEN)"},
                           extra_headers={"WWW-Authenticate": "Bearer"})
                return
            if _serve_admin(self, path, parsed.query):
                return
        server = self.server_ref
        if not server._enter():
            # stopped: what it holds (an event log, a batcher) may be
            # closed already
            self.close_connection = True
            self._send(503, {"message": "server is stopping"})
            return
        # the inbound id is untrusted: anything not id-shaped is
        # re-minted, never echoed into headers or span logs
        raw_id = self.headers.get(trace.TRACE_HEADER, "")
        accepted = trace.valid_trace_id(raw_id)
        trace_id = raw_id if accepted else trace.new_trace_id()
        raw_parent = self.headers.get(trace.PARENT_HEADER, "")
        parent_span = raw_parent if (
            accepted and trace.valid_span_id(raw_parent)) else None
        token = trace.activate(trace_id, parent_span)
        route = metrics_route(path)
        fkey = flight.begin(trace_id, server_label, self.command, route)
        # samples of this handler thread carry the request's trace id
        # and route (the profiler's per-endpoint and slow slices)
        contprof.request_begin(trace_id, route)
        inflight = _IN_FLIGHT.labels(server_label)
        inflight.inc()
        t0 = time.perf_counter()
        name = server_label.lower()
        name = name.removeprefix("pio") or name
        error: Optional[str] = None
        try:
            with trace.span(f"http.{name}", method=self.command,
                            route=route, server=name):
                fn(self)
        except BaseException as e:
            error = f"{type(e).__name__}: {e}"
            raise
        finally:
            inflight.dec()
            server._exit()
            status = getattr(self, "_metrics_status", None)
            # the frame the sampler saw most in this request names code
            # on a slow record, beside its stages
            dominant = contprof.request_end()
            if dominant is not None:
                flight.note_field("dominant_frame", dominant)
            flight.finish(fkey, status, error)
            trace.deactivate(token)
            if status is not None:
                _REQUESTS_TOTAL.labels(server_label, self.command, route,
                                       str(status)).inc()
                _REQUEST_SECONDS.labels(server_label, self.command,
                                        route).observe(
                    time.perf_counter() - t0,
                    exemplar={"trace_id": trace_id})

    wrapper._pio_instrumented = True
    return wrapper


class JSONRequestHandler(BaseHTTPRequestHandler):
    """Base handler: JSON responses, body parsing, quiet logging, and
    the shared routes and request telemetry on every ``do_METHOD``."""

    server_version = "PIOServer/0.1"
    server_ref: Any = None  # set via subclass attribute by each server
    # keep-alive is safe: every response carries Content-Length and
    # _send drains unread request bodies first
    protocol_version = "HTTP/1.1"
    timeout = 120
    # without TCP_NODELAY, Nagle + delayed ACK add ~40 ms per exchange
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        log.debug("%s: " + fmt, self.server_version, *args)

    def handle_one_request(self):
        self._body_consumed = False  # per request, not per connection
        self._metrics_status = None  # captured by send_response
        super().handle_one_request()

    def send_response(self, code, message=None):
        # every response path funnels through here: the one place the
        # final status is always known for the request metrics
        self._metrics_status = code
        super().send_response(code, message)

    def _send(self, status: int, body: Any,
              content_type: str = "application/json; charset=UTF-8",
              extra_headers: Optional[dict] = None) -> None:
        t_ser = time.perf_counter()
        if isinstance(body, bytes):
            data = body
        elif isinstance(body, str):
            data = body.encode()
        else:
            data = json.dumps(body).encode()
        # an unread request body would desynchronize the keep-alive
        # connection: drain it (or close when it is chunked or > 1 MB)
        try:
            unread = int(self.headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            unread = 0
        if not getattr(self, "_body_consumed", False):
            if self.headers.get("Transfer-Encoding") or unread > (1 << 20):
                self.close_connection = True
            elif unread:
                self.rfile.read(unread)
        self._body_consumed = True
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        trace_id = trace.current_trace_id()
        if trace_id:
            # echo the request's trace id so clients can join their logs
            self.send_header(trace.TRACE_HEADER, trace_id)
        if self.close_connection:
            self.send_header("Connection", "close")
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)
        # response encode+write billed to the request's flight record
        # (no-op when no record is open, e.g. the shared /metrics route)
        flight.note_stage("serialize", time.perf_counter() - t_ser)

    def _read_body(self) -> bytes:
        t0 = time.perf_counter()
        length = int(self.headers.get("Content-Length", 0))
        self._body_consumed = True
        data = self.rfile.read(length) if length else b""
        flight.note_stage("parse", time.perf_counter() - t0)
        return data

    def _read_json(self) -> Any:
        """Parsed JSON body; raises json.JSONDecodeError."""
        return json.loads(self._read_body() or b"{}")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for name in ("do_GET", "do_POST", "do_PUT", "do_DELETE"):
            fn = cls.__dict__.get(name)
            if fn is not None:
                setattr(cls, name, _instrument(fn))

    def _not_found(self):
        self._send(404, {"message": "Not Found"})

    # servers without a do_GET / do_POST of their own still answer the
    # shared routes and 404 everything else
    do_GET = _instrument(_not_found)
    do_POST = _instrument(_not_found)


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # the stdlib backlog of 5 drops connections under serving bursts
    request_queue_size = 128


class HTTPServerBase:
    """Bind (with retry), run on a daemon thread, stop cleanly.

    Bind-retry contract from the reference engine server
    (CreateServer.scala:340-350): ``bind_retries`` attempts, 1s apart.
    """

    def __init__(self, host: str, port: int, handler_cls: type,
                 bind_retries: int = 1):
        handler = type("Handler", (handler_cls,), {"server_ref": self})
        attempts = max(1, bind_retries)
        for attempt in range(attempts):
            try:
                self.httpd = _ThreadingHTTPServer((host, port), handler)
                break
            except OSError as e:
                log.warning("bind attempt %d failed: %s", attempt + 1, e)
                if attempt + 1 == attempts:
                    raise
                time.sleep(1)
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._stopped = threading.Event()
        # this instance's hold on the process-wide continuous profiler:
        # taken at start, given back once at stop
        self._prof_owner = f"{type(self).__name__}:{id(self):#x}"
        self._prof_retained = False

    def _enter(self) -> bool:
        """Count a request in; False once the server has stopped."""
        with self._inflight_lock:
            if self._stopped.is_set():
                return False
            self._inflight += 1
            return True

    def _exit(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def inflight_count(self) -> int:
        """Requests of this server inside their handlers now."""
        with self._inflight_lock:
            return self._inflight

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def _start_env_services(self) -> None:
        """The environment's process services every server start wires
        up: the metrics pusher, the SLO alert webhook sink, the
        declarative SLO objectives and the chaos rules (each a no-op
        without its variable); and this server's hold on the continuous
        profiler (refcounted, so one sampler serves every server of the
        process and a restart never starts a second)."""
        push.start_from_env()
        alerts.start_from_env()
        slo.configure_from_env()
        chaos.configure_from_env()
        if not self._prof_retained:
            self._prof_retained = True
            contprof.retain(self._prof_owner)

    def _release_profiler(self) -> None:
        if self._prof_retained:
            self._prof_retained = False
            contprof.release(self._prof_owner)

    def start(self):
        # flag set BEFORE the thread runs, so a racing stop() still calls
        # shutdown() instead of closing the socket under the serve loop
        self._serving = True
        self._start_env_services()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("%s listening on %s", type(self).__name__, self.port)
        return self

    def serve_forever(self) -> None:
        self._serving = True
        self._start_env_services()
        self.httpd.serve_forever()

    def wait_stopped(self, timeout: float) -> bool:
        """True once ``stop()`` has run (a SIGTERM drain ends in it)."""
        return self._stopped.wait(timeout)

    def stop(self) -> None:
        """Stop serving and close the socket; the port is free on return.
        Requests that arrive afterwards on open keep-alive connections
        are answered 503."""
        with self._inflight_lock:
            self._stopped.set()
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
        self._release_profiler()

    def drain_stop(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop ACCEPTING first (serve loop halted,
        listening socket closed so new connections are refused instead
        of waiting in the backlog), then wait, up to ``timeout``
        (default ``PIO_DRAIN_TIMEOUT``, 30 s), for the requests in
        flight to write their responses, then ``stop()`` (which also
        stops per-server parts, e.g. the engine server's batcher).
        True when everything drained inside the window."""
        if timeout is None:
            timeout = drain_timeout()
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
        deadline = time.monotonic() + max(0.0, timeout)
        while self.inflight_count() > 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        leftover = self.inflight_count()
        if leftover:
            log.warning("%s drain window (%.1fs) expired with %d request(s) "
                        "still in flight; stopping anyway",
                        type(self).__name__, timeout, leftover)
        self.stop()
        return leftover == 0


DEFAULT_DRAIN_TIMEOUT_SEC = 30.0


def drain_timeout() -> float:
    """The SIGTERM drain window: ``PIO_DRAIN_TIMEOUT`` seconds, the
    default when unset or not a number."""
    return max(0.0, metrics.env_float("PIO_DRAIN_TIMEOUT",
                                      DEFAULT_DRAIN_TIMEOUT_SEC))


def install_drain_handler(*servers, timeout: Optional[float] = None):
    """SIGTERM -> drain-then-stop for every server of this process.

    On SIGTERM each server stops accepting, finishes what it already
    admitted (bounded by ``PIO_DRAIN_TIMEOUT``) and stops, after which
    ``serve_forever`` returns and the main exits normally. The drain
    runs on its own NON-daemon thread, and both properties matter: the
    signal fires in the main thread, usually the one blocked inside
    ``serve_forever``, so calling ``shutdown()`` there would deadlock
    waiting for a serve loop that cannot advance under the handler; and
    once ``drain_stop`` unblocks that ``serve_forever`` the main returns
    and the interpreter starts exiting, which would kill a daemon drain
    thread (and the daemon handler threads still writing responses)
    mid-drain. Non-daemon, the interpreter waits for the drain.

    Returns the installed handler, so tests can call it directly
    without delivering a signal. Must be called from the main thread
    (CPython's signal contract)."""
    import signal

    def _drain(signum=None, frame=None):
        def run():
            log.info("SIGTERM: draining %d server(s), window %.1fs",
                     len(servers),
                     drain_timeout() if timeout is None else timeout)
            for server in servers:
                try:
                    server.drain_stop(timeout)
                except Exception:  # noqa: BLE001 — one server's failed
                    # drain must not leave its siblings serving
                    log.exception("drain failed for %r", server)

        threading.Thread(target=run, daemon=False, name="pio-drain").start()

    signal.signal(signal.SIGTERM, _drain)
    return _drain
