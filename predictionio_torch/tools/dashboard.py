"""Evaluation dashboard server.

The port's copy of ``predictionio_tpu/tools/dashboard.py``, on the
port's own storage, ``obs/``, ``resilience/`` and ``serving/fleet.py``:
the evaluation routes answer the JAX dashboard's bytes for the same
stored instances, and ``/memory`` reads ``obs/memacct.py`` (the card's
allocator figures where a card is in use; a capacity that is not known
shows as ``-``). It touches no device itself.

Behavior contract from the reference (tools/.../dashboard/
Dashboard.scala:37-141): an HTML index of completed evaluation
instances (newest first) with per-instance result routes

  GET /                                                -> HTML listing
  GET /engine_instances/<id>/evaluator_results.txt     -> one-liner
  GET /engine_instances/<id>/evaluator_results.html    -> HTML report
  GET /engine_instances/<id>/evaluator_results.json    -> JSON report

plus CORS headers (ref: CorsSupport.scala), and — beyond the
reference — operator views of this process's diagnostics:

  GET /flight[?slow=1]  -> HTML table of the last recorded requests
                           (stage timings, trace ids; ?slow=1 keeps
                           only slow/errored ones). The JSON dump is
                           at /admin/flight like on every PIO server.
  GET /slo              -> HTML panel of the SLO burn-rate evaluation
                           (obs/slo.py) — per SLO, the burn in every
                           window and whether the fast/slow page is
                           firing. JSON at /admin/slo.
  GET /resilience       -> HTML panel of the resilience subsystem:
                           circuit breaker states, shed counters and
                           the active chaos rules of THIS process.
                           JSON at /admin/resilience.
  GET /timeline         -> HTML panel of the metric timelines
                           (obs/timeline.py): per-series sparklines of
                           MFU, model staleness, serving p50/p99 and
                           request rate, plus the data-path ledger's
                           per-run stage table. JSON at
                           /admin/timeline.
  GET /quality          -> HTML panel of the model-quality plane
                           (obs/quality.py): drift-vs-shadow-retrain
                           sparklines off the ``quality.*`` timeline
                           series, the latest replay comparison
                           report, and the canary verdict. JSON at
                           /admin/quality.
  GET /data             -> HTML panel of the data & ingest plane
                           (obs/dataobs.py): ingest rates, entity
                           heavy hitters + Zipf skew, cardinality,
                           quantile sketches, schema drift and the
                           unknown-entity coverage ratio. JSON at
                           /admin/data.
  GET /memory           -> HTML panel of the device-memory
                           accounting plane (obs/memacct.py):
                           headroom + basis, the per-model HBM
                           ledger, train peaks and the last OOM
                           preflight decision. JSON at /admin/memory.
  GET /trace[?id=...]   -> HTML view of the cross-process trace
                           stitcher (obs/collect.py): a lookup form +
                           this process's recently seen traces, and —
                           given an id — the stitched tree assembled
                           from the federation members, rendered by
                           the same ASCII renderer ``pio trace`` uses.
  GET /prof             -> HTML view of the continuous host profiler
                           (obs/contprof.py): the process flame tree
                           + hot frames via the same renderer
                           ``pio prof`` uses; ?slow=1 and ?endpoint=
                           slices. JSON at /admin/prof.
  GET /fleet            -> HTML panel of the serving fleet(s)
                           supervised IN THIS PROCESS
                           (serving/fleet.py ACTIVE registry —
                           `pio deploy --replicas` / threaded tests;
                           a remote fleet's JSON lives on its router
                           at /admin/fleet): per-replica state,
                           version, restarts, outstanding load, and
                           rolling-swap progress.
"""

from __future__ import annotations

import html
import json as _json
import logging
from typing import Optional
from urllib.parse import parse_qs, urlparse

from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.obs import flight
from predictionio_torch.obs import logging as obs_logging
from predictionio_torch.serving.http import HTTPServerBase, JSONRequestHandler

log = logging.getLogger(__name__)

DEFAULT_PORT = 9000


class _DashboardRequestHandler(JSONRequestHandler):
    server_version = "PIODashboard/0.1"

    def _send_cors(self, status, body, content_type):
        # CORS on result routes (ref: CorsSupport.scala)
        self._send(status, body, content_type,
                   extra_headers={"Access-Control-Allow-Origin": "*"})

    def do_GET(self):
        url = urlparse(self.path)
        path = url.path
        storage: Storage = self.server_ref.storage
        if path == "/":
            self._send_cors(200, self.server_ref.index_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/flight":
            slow_only = (parse_qs(url.query).get("slow")
                         or ["0"])[0].lower() in ("1", "true")
            self._send_cors(200, self.server_ref.flight_html(slow_only),
                            "text/html; charset=UTF-8")
            return
        if path == "/slo":
            self._send_cors(200, self.server_ref.slo_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/resilience":
            self._send_cors(200, self.server_ref.resilience_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/timeline":
            self._send_cors(200, self.server_ref.timeline_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/fleet":
            self._send_cors(200, self.server_ref.fleet_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/quality":
            self._send_cors(200, self.server_ref.quality_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/data":
            self._send_cors(200, self.server_ref.data_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/trace":
            trace_id = (parse_qs(url.query).get("id") or [None])[0]
            self._send_cors(200, self.server_ref.trace_html(trace_id),
                            "text/html; charset=UTF-8")
            return
        if path == "/memory":
            self._send_cors(200, self.server_ref.memory_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/anomaly":
            self._send_cors(200, self.server_ref.anomaly_html(),
                            "text/html; charset=UTF-8")
            return
        if path == "/prof":
            params = parse_qs(url.query)
            slow = (params.get("slow") or ["0"])[0].lower() in ("1",
                                                                "true")
            endpoint = (params.get("endpoint") or [None])[0]
            self._send_cors(200,
                            self.server_ref.prof_html(endpoint, slow),
                            "text/html; charset=UTF-8")
            return
        parts = [p for p in path.split("/") if p]
        # path form: /engine_instances/<id>/evaluator_results.<fmt>
        if len(parts) == 3 and parts[0] == "engine_instances":
            instance = storage.evaluation_instances().get(parts[1])
            if instance is None:
                self._send(404, {"message": "Not Found"})
                return
            mapping = {
                "evaluator_results.txt": (instance.evaluator_results,
                                          "text/plain; charset=UTF-8"),
                "evaluator_results.html": (instance.evaluator_results_html,
                                           "text/html; charset=UTF-8"),
                "evaluator_results.json": (instance.evaluator_results_json,
                                           "application/json; charset=UTF-8"),
            }
            if parts[2] in mapping:
                body, ctype = mapping[parts[2]]
                self._send_cors(200, body, ctype)
                return
        self._send(404, {"message": "Not Found"})


class DashboardServer(HTTPServerBase):
    """ref: Dashboard.createDashboard (Dashboard.scala:58)."""

    def __init__(
        self,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = DEFAULT_PORT,
    ):
        self.storage = storage or get_storage()
        super().__init__(host, port, _DashboardRequestHandler)

    def index_html(self) -> str:
        """Completed evaluations, newest first (ref: Dashboard.scala:76)."""
        instances = sorted(
            (
                i
                for i in self.storage.evaluation_instances().get_completed()
            ),
            key=lambda i: i.start_time,
            reverse=True,
        )
        rows = "\n".join(
            "<tr><td>{id}</td><td>{start}</td><td>{cls}</td><td>{batch}</td>"
            '<td><a href="/engine_instances/{id}/evaluator_results.html">HTML</a> '
            '<a href="/engine_instances/{id}/evaluator_results.json">JSON</a> '
            '<a href="/engine_instances/{id}/evaluator_results.txt">TXT</a></td></tr>'.format(
                id=html.escape(i.id),
                start=html.escape(i.start_time.isoformat()),
                cls=html.escape(i.evaluation_class),
                batch=html.escape(i.batch),
            )
            for i in instances
        )
        return (
            "<!DOCTYPE html><html><head><title>PredictionIO-TPU Dashboard"
            "</title></head><body><h1>Evaluation Instances</h1>"
            "<table border='1'><tr><th>ID</th><th>Started</th>"
            "<th>Evaluation</th><th>Batch</th><th>Results</th></tr>"
            f"{rows}</table>"
            '<p><a href="/flight">Flight recorder</a> · '
            '<a href="/flight?slow=1">slow/errored requests</a> · '
            '<a href="/admin/flight">JSON dump</a> · '
            '<a href="/slo">SLO burn rates</a> · '
            '<a href="/resilience">resilience</a> · '
            '<a href="/timeline">timelines</a> · '
            '<a href="/anomaly">anomaly sentinel</a> · '
            '<a href="/quality">model quality</a> · '
            '<a href="/data">data &amp; ingest</a> · '
            '<a href="/memory">device memory</a> · '
            '<a href="/trace">trace stitcher</a> · '
            '<a href="/prof">profiler flame</a> · '
            '<a href="/prof?slow=1">slow-cohort flame</a> · '
            '<a href="/fleet">fleet</a> · '
            '<a href="/metrics">metrics</a> · '
            '<a href="/readyz">readiness</a></p>'
            "</body></html>"
        )

    def flight_html(self, slow_only: bool = False) -> str:
        """The flight recorder as an operator table: one row per
        recorded request (newest first), stage breakdown inline — the
        slow-query view when ``slow_only``."""
        records = flight.RECORDER.records(slow_only=slow_only)
        rows = "\n".join(
            "<tr><td>{trace}</td><td>{server}</td><td>{method} {route}</td>"
            "<td>{status}</td><td>{dur:.1f}</td><td><code>{stages}</code>"
            "</td><td>{flags}</td></tr>".format(
                trace=html.escape(str(r.get("trace", ""))[:16]),
                server=html.escape(str(r.get("server", ""))),
                method=html.escape(str(r.get("method", ""))),
                route=html.escape(str(r.get("route", ""))),
                status=html.escape(str(r.get("status"))),
                dur=r.get("duration_ms", 0.0),
                stages=html.escape(_json.dumps(r.get("stages", {}))),
                flags=html.escape(
                    ("SLOW " if r.get("slow") else "")
                    + (f"ERROR: {r.get('error')}" if r.get("error") else "")),
            )
            for r in reversed(records)
        )
        title = "Slow / errored requests" if slow_only else "Flight recorder"
        return (
            "<!DOCTYPE html><html><head><title>{t}</title></head><body>"
            "<h1>{t}</h1><p>{n} record(s); slow threshold "
            "{ms:.0f} ms (PIO_SLOW_MS). <a href='/flight'>all</a> · "
            "<a href='/flight?slow=1'>slow only</a> · "
            "<a href='/admin/flight'>JSON</a></p>"
            "<table border='1'><tr><th>Trace</th><th>Server</th>"
            "<th>Request</th><th>Status</th><th>ms</th><th>Stages (ms)"
            "</th><th>Flags</th></tr>{rows}</table></body></html>"
        ).format(t=title, n=len(records), ms=flight.slow_threshold_ms(),
                 rows=rows)

    def slo_html(self) -> str:
        """The SLO evaluation as an operator panel: one row per SLO
        with its burn rate in every window, colored by alert state."""
        from predictionio_torch.obs import slo as _slo

        report = _slo.MONITOR.report()
        window_labels: list = []
        for entry in report["slos"]:
            for label in entry["burn_rates"]:
                if label not in window_labels:
                    window_labels.append(label)
        header = "".join(f"<th>burn {html.escape(w)}</th>"
                         for w in window_labels)
        rows = []
        for entry in report["slos"]:
            color = {"firing": "#c0392b", "ok": "#27ae60"}.get(
                entry["state"], "#888")
            cells = "".join(
                "<td>{}</td>".format(
                    "–" if entry["burn_rates"].get(w) is None
                    else f"{entry['burn_rates'][w]:.2f}")
                for w in window_labels)
            objective = entry["objective"]
            target = f"{objective:.3%}"
            if entry.get("threshold_ms") is not None:
                target += f" &le; {entry['threshold_ms']:.0f} ms"
            rows.append(
                "<tr><td>{name}</td><td>{kind}</td><td>{target}</td>{cells}"
                '<td style="color:{color};font-weight:bold">{state}'
                "</td></tr>".format(
                    name=html.escape(entry["name"]),
                    kind=html.escape(entry["kind"]),
                    target=target, cells=cells, color=color,
                    state=html.escape(entry["state"])))
        return (
            "<!DOCTYPE html><html><head><title>SLO burn rates</title>"
            "</head><body><h1>SLO burn rates</h1>"
            "<p>Multi-window burn-rate alerting: the fast page needs "
            "burn &ge; 14.4 over both 5m and 1h; the slow page needs "
            "&ge; 6 over both 30m and 6h. "
            '<a href="/admin/slo">JSON</a> · <a href="/">index</a></p>'
            "<table border='1'><tr><th>SLO</th><th>Kind</th>"
            f"<th>Objective</th>{header}<th>State</th></tr>"
            f"{''.join(rows)}</table></body></html>"
        )


    def timeline_html(self) -> str:
        """The metric timelines as an operator panel: one row per
        tracked series with a unicode sparkline (the same renderer
        `pio top` uses) and the latest/min/max values, followed by the
        data-path ledger's per-run stage table and the staleness
        clock."""
        from predictionio_torch.obs import perfacct
        from predictionio_torch.obs.timeline import TIMELINE, sparkline

        TIMELINE.sample()  # watching the panel builds its history
        payload = TIMELINE.series()
        rows = []
        for name in sorted(payload["series"]):
            points = payload["series"][name]
            if not points:
                continue
            values = [p[1] for p in points]
            rows.append(
                "<tr><td>{name}</td><td><code>{spark}</code></td>"
                "<td>{last:.4g}</td><td>{lo:.4g}</td><td>{hi:.4g}</td>"
                "<td>{n}</td></tr>".format(
                    name=html.escape(name),
                    spark=html.escape(sparkline(values, 48)),
                    last=values[-1], lo=min(values), hi=max(values),
                    n=len(values)))
        series_rows = "".join(rows) or (
            "<tr><td colspan='6'>no samples yet — traffic or a train "
            "run feeds the timeline</td></tr>")
        datapath = perfacct.LEDGER.snapshot()
        run_rows = "".join(
            "<tr><td>{run}</td><td><code>{stages}</code></td></tr>".format(
                run=html.escape(str(r["run"])[:16]),
                stages=html.escape(" ".join(
                    f"{k}={v:.2f}s" for k, v in sorted(r["stages"].items()))
                    or "(no stages)"))
            for r in reversed(datapath["runs"])
        ) or "<tr><td colspan='2'>no training runs recorded</td></tr>"
        return (
            "<!DOCTYPE html><html><head><title>Metric timelines</title>"
            "</head><body><h1>Metric timelines</h1>"
            "<p>Cadence {interval:g}s, {cap} samples/series "
            "(PIO_TIMELINE_INTERVAL_SEC / PIO_TIMELINE_CAPACITY). "
            '<a href="/admin/timeline">JSON</a> · '
            '<a href="/admin/tail">tail attribution</a> · '
            '<a href="/">index</a></p>'
            "<table border='1'><tr><th>Series</th><th>Sparkline</th>"
            "<th>Last</th><th>Min</th><th>Max</th><th>Samples</th></tr>"
            "{series_rows}</table>"
            "<h2>Data-path ledger</h2>"
            "<p>Model staleness: {stale:.1f}s</p>"
            "<table border='1'><tr><th>Run</th><th>Stage seconds</th>"
            "</tr>{run_rows}</table>"
            "</body></html>"
        ).format(interval=payload["interval_sec"], cap=payload["capacity"],
                 series_rows=series_rows,
                 stale=datapath["staleness_seconds"], run_rows=run_rows)

    def anomaly_html(self) -> str:
        """The regression sentinel as an operator panel: active
        change-points with their causal journal attribution, each
        series' sparkline with the anomaly onset (^) and nearby
        journal events (|) marked under it, plus the journal tail."""
        from predictionio_torch.obs import anomaly, journal
        from predictionio_torch.obs.timeline import TIMELINE, sparkline

        report = anomaly.SENTINEL.scan()  # watching the panel scans
        payload = TIMELINE.series()
        events = journal.JOURNAL.recent(30)

        def marker_line(points, width, onset_ts, window) -> str:
            """A second code line under a sparkline: ``^`` at the
            anomaly onset sample, ``|`` at journal events that fall
            inside the attribution window around it."""
            if not points or len(points) < 2:
                return ""
            t0, t1 = points[0][0], points[-1][0]
            span = max(t1 - t0, 1e-9)

            def col(ts) -> int:
                return min(width - 1,
                           max(0, int((ts - t0) / span * (width - 1))))

            line = [" "] * width
            for event in events:
                ets = event.get("ts")
                if (isinstance(ets, (int, float)) and t0 <= ets <= t1
                        and event.get("kind") not in ("anomaly",
                                                      "anomaly_resolved")
                        and onset_ts is not None
                        and abs(ets - onset_ts) <= window):
                    line[col(ets)] = "|"
            if onset_ts is not None and t0 <= onset_ts <= t1:
                line[col(onset_ts)] = "^"
            return "".join(line).rstrip()

        window = report.get("window_sec", 30.0)
        active_rows = []
        for name, entry in sorted((report.get("active") or {}).items()):
            points = payload["series"].get(name) or []
            values = [p[1] for p in points]
            spark = sparkline(values, 48) if values else ""
            marks = marker_line(points, 48, entry.get("onset_ts"),
                                window)
            cause = entry.get("cause") or {}
            cause_text = (
                "{kind} ({gap:+.1f}s)".format(
                    kind=cause.get("kind", "?"),
                    gap=cause.get("gap_sec", 0.0))
                if cause else "(no journal event in window)")
            active_rows.append(
                "<tr><td>{name}</td><td>{mode}/{direction}</td>"
                "<td>{z:.1f}</td><td>{baseline:.4g} → {value:.4g}</td>"
                "<td>{cause}</td>"
                "<td><code>{spark}<br>{marks}</code></td></tr>".format(
                    name=html.escape(name),
                    mode=html.escape(str(entry.get("mode", "?"))),
                    direction=html.escape(str(entry.get("direction",
                                                        "?"))),
                    z=entry.get("z", 0.0),
                    baseline=entry.get("baseline", 0.0),
                    value=entry.get("recent", 0.0),
                    cause=html.escape(cause_text),
                    spark=html.escape(spark),
                    marks=html.escape(marks).replace(" ", "&nbsp;")))
        active_table = "".join(active_rows) or (
            "<tr><td colspan='6'>no active anomalies — the sentinel "
            "scans every timeline sample</td></tr>")
        resolved_rows = "".join(
            "<tr><td>{name}</td><td>{dur:.0f}s</td><td>{cause}</td>"
            "</tr>".format(
                name=html.escape(str(entry.get("series", "?"))),
                dur=entry.get("duration_sec", 0.0),
                cause=html.escape(str((entry.get("cause") or {}).get(
                    "kind", "-"))))
            for entry in reversed(report.get("recent_resolved") or [])
        ) or "<tr><td colspan='3'>none</td></tr>"
        journal_rows = "".join(
            "<tr><td>{ts:.1f}</td><td>{kind}</td><td><code>{rest}"
            "</code></td></tr>".format(
                ts=event.get("ts", 0.0),
                kind=html.escape(str(event.get("kind", "?"))),
                rest=html.escape(" ".join(
                    f"{k}={v}" for k, v in event.items()
                    if k not in ("ts", "mono", "kind"))))
            for event in reversed(events)
        ) or "<tr><td colspan='3'>journal is empty</td></tr>"
        return (
            "<!DOCTYPE html><html><head><title>Regression sentinel"
            "</title></head><body><h1>Regression sentinel</h1>"
            "<p>Change-point scan over the metric timelines on the "
            "snapshot cadence; onsets join the ops journal within "
            "{window:g}s (PIO_ANOMALY_WINDOW_SEC). Last scan "
            "{scan_ms:.2f}ms. "
            '<a href="/admin/anomaly">JSON</a> · '
            '<a href="/admin/journal">journal JSON</a> · '
            '<a href="/timeline">timelines</a> · '
            '<a href="/">index</a></p>'
            "<h2>Active</h2>"
            "<table border='1'><tr><th>Series</th><th>Mode</th>"
            "<th>z</th><th>Baseline → now</th><th>Attributed cause</th>"
            "<th>Sparkline (^ onset, | journal)</th></tr>"
            "{active_table}</table>"
            "<h2>Recently resolved</h2>"
            "<table border='1'><tr><th>Series</th><th>Duration</th>"
            "<th>Cause</th></tr>{resolved_rows}</table>"
            "<h2>Journal tail</h2>"
            "<table border='1'><tr><th>ts</th><th>Kind</th>"
            "<th>Fields</th></tr>{journal_rows}</table>"
            "</body></html>"
        ).format(window=window, scan_ms=report.get("scan_ms") or 0.0,
                 active_table=active_table, resolved_rows=resolved_rows,
                 journal_rows=journal_rows)

    def quality_html(self) -> str:
        """The model-quality plane as an operator panel: drift values
        + their timeline sparklines (the ``quality.*`` series the
        timeline samples off the gauges), the latest replay comparison
        report, and the canary verdict — every number read from
        obs/quality.py's one STATE, so this panel, ``pio canary`` and
        the gauges can never disagree."""
        from predictionio_torch.obs import quality
        from predictionio_torch.obs.timeline import TIMELINE, sparkline

        report = quality.STATE.report()
        TIMELINE.sample()
        series = TIMELINE.series()["series"]
        spark_rows = "".join(
            "<tr><td>{name}</td><td><code>{spark}</code></td>"
            "<td>{last:.4g}</td></tr>".format(
                name=html.escape(name),
                spark=html.escape(
                    sparkline([p[1] for p in series[name]], 48)),
                last=series[name][-1][1])
            for name in sorted(series)
            if name.startswith("quality.") and series[name])
        drift = report.get("drift")
        if drift:
            breached = drift.get("breached") or []
            verdict = ("<b style='color:#c0392b'>BREACHED: "
                       + html.escape(", ".join(breached)) + "</b>"
                       if breached else
                       "<b style='color:#27ae60'>inside band</b>")
            drift_html = (
                f"<p>shadow instance <code>"
                f"{html.escape(str(drift.get('shadow_instance'))[:16])}"
                f"</code>, band {report['band']:g} — {verdict}</p>"
                "<table border='1'><tr><th>recall_vs_retrain</th>"
                "<th>rmse_drift</th><th>factor_drift</th>"
                "<th>sampled users</th></tr>"
                f"<tr><td>{drift.get('recall_vs_retrain')}</td>"
                f"<td>{drift.get('rmse_drift')}</td>"
                f"<td>{drift.get('factor_drift')}</td>"
                f"<td>{drift.get('sampled_users')}</td></tr></table>")
        else:
            drift_html = ("<p>no drift probe yet — <code>pio stream"
                          "</code> against a trained instance feeds the "
                          "gauges.</p>")
        rep = report.get("replay")
        if rep:
            replay_html = (
                "<table border='1'><tr><th>queries</th><th>diffed</th>"
                "<th>mean overlap</th><th>worst overlap</th>"
                "<th>mean |score Δ|</th><th>errors</th></tr>"
                f"<tr><td>{rep.get('n')}</td><td>{rep.get('diffed')}</td>"
                f"<td>{rep.get('mean_overlap')}</td>"
                f"<td>{rep.get('worst_overlap')}</td>"
                f"<td>{rep.get('mean_score_delta')}</td>"
                f"<td>{html.escape(_json.dumps(rep.get('errors')))}</td>"
                "</tr></table>")
        else:
            replay_html = ("<p>no replay report yet — <code>pio replay"
                           "</code> registers one here.</p>")
        canary = report.get("canary")
        if canary:
            verdict = canary.get("verdict") or {}
            state = ("ACTIVE" if canary.get("active")
                     else canary.get("outcome") or "inactive")
            paired = canary.get("paired") or {}
            reasons = "".join(f"<li>{html.escape(r)}</li>"
                              for r in verdict.get("reasons") or [])
            canary_html = (
                f"<p>[{html.escape(state)}] replica <code>"
                f"{html.escape(str(canary.get('replica')))}</code>: "
                f"candidate <code>"
                f"{html.escape(str(canary.get('candidate_version'))[:16])}"
                "</code> vs baseline <code>"
                f"{html.escape(str(canary.get('baseline_version'))[:16])}"
                f"</code> — verdict <b>"
                f"{html.escape(str(verdict.get('verdict', '–')).upper())}"
                f"</b></p><p>paired samples: {paired.get('n')} "
                f"(errors {paired.get('errors')}), mean overlap "
                f"{paired.get('mean_overlap')}</p><ul>{reasons}</ul>")
        else:
            canary_html = ("<p>no canary — <code>pio canary --start"
                           "</code> (or <code>pio deploy --canary"
                           "</code> mode) runs one.</p>")
        return (
            "<!DOCTYPE html><html><head><title>Model quality</title>"
            "</head><body><h1>Model quality</h1>"
            "<h2>Drift vs shadow retrain</h2>"
            f"{drift_html}"
            "<table border='1'><tr><th>Series</th><th>Sparkline</th>"
            f"<th>Last</th></tr>{spark_rows}</table>"
            "<h2>Replay comparison</h2>"
            f"{replay_html}"
            "<h2>Canary</h2>"
            f"{canary_html}"
            '<p><a href="/admin/quality">JSON</a> · '
            '<a href="/">index</a></p></body></html>'
        )

    def data_html(self) -> str:
        """The data & ingest plane as an operator panel
        (obs/dataobs.py): ingest rates per (app, event), entity heavy
        hitters with the fitted Zipf skew, HLL cardinalities, the
        payload/value/inter-arrival quantiles, the live-vs-frozen
        schema diff and the unknown-entity coverage ratio — plus the
        ``data.*`` timeline sparklines."""
        from predictionio_torch.obs import dataobs
        from predictionio_torch.obs.timeline import TIMELINE, sparkline

        report = dataobs.DATAOBS.report()
        TIMELINE.sample()
        series = TIMELINE.series()["series"]
        spark_rows = "".join(
            "<tr><td>{name}</td><td><code>{spark}</code></td>"
            "<td>{last:.4g}</td></tr>".format(
                name=html.escape(name),
                spark=html.escape(
                    sparkline([p[1] for p in series[name]], 48)),
                last=series[name][-1][1])
            for name in sorted(series)
            if name.startswith("data.") and series[name])
        entities = report.get("entities") or {}
        breaches = [k for k, v in
                    (report.get("breach_active") or {}).items() if v]
        breach_html = (
            "<p><b style='color:#c0392b'>ACTIVE BREACH: "
            + html.escape(", ".join(sorted(breaches))) + "</b></p>"
            if breaches else "")
        rate_rows = "".join(
            f"<tr><td>{html.escape(str(r.get('app')))}</td>"
            f"<td>{html.escape(str(r.get('event')))}</td>"
            f"<td>{r.get('count')}</td></tr>"
            for r in (report.get("rates") or [])[:20])
        hot_rows = "".join(
            f"<tr><td><code>{html.escape(str(r.get('id')))}</code></td>"
            f"<td>{r.get('count')}</td><td>±{r.get('err')}</td></tr>"
            for r in entities.get("top") or [])
        card = entities.get("cardinality") or {}
        quant = report.get("quantiles") or {}
        quant_rows = "".join(
            f"<tr><td>{html.escape(name)}</td><td>{s.get('p50')}</td>"
            f"<td>{s.get('p90')}</td><td>{s.get('p99')}</td>"
            f"<td>{s.get('n')}</td></tr>"
            for name, s in sorted(quant.items()) if s and s.get("n"))
        schema = report.get("schema") or {}
        change_rows = "".join(
            f"<tr><td>{html.escape(str(c.get('event')))}</td>"
            f"<td>{html.escape(str(c.get('field')))}</td>"
            f"<td>{html.escape(str(c.get('change')))}</td>"
            f"<td>{html.escape(str(c.get('old_type') or '–'))}</td>"
            f"<td>{html.escape(str(c.get('new_type') or '–'))}</td></tr>"
            for c in (schema.get("changes") or [])[-20:])
        frozen = (f"frozen at instance <code>"
                  f"{html.escape(str(schema.get('frozen_instance'))[:16])}"
                  "</code>" if schema.get("frozen_instance")
                  else "no frozen profile yet (a COMPLETED train "
                       "freezes one)")
        return (
            "<!DOCTYPE html><html><head><title>Data plane</title>"
            "</head><body><h1>Data &amp; ingest</h1>"
            f"{breach_html}"
            f"<p>events {report.get('events_total')} "
            f"({report.get('eps')}/s), tail "
            f"{report.get('tail_events_total')}, bytes "
            f"{report.get('bytes_total')} — entity skew "
            f"<b>{entities.get('skew')}</b>, unknown-entity ratio "
            f"<b>{report.get('unknown_ratio')}</b> over "
            f"{report.get('queries_seen')} query refs; cardinality "
            + " ".join(f"{html.escape(k)}={v}"
                       for k, v in sorted(card.items()))
            + "</p>"
            "<table border='1'><tr><th>Series</th><th>Sparkline</th>"
            f"<th>Last</th></tr>{spark_rows}</table>"
            "<h2>Rates</h2><table border='1'><tr><th>app</th>"
            f"<th>event</th><th>count</th></tr>{rate_rows}</table>"
            "<h2>Hot entities</h2><table border='1'><tr><th>id</th>"
            f"<th>count</th><th>err</th></tr>{hot_rows}</table>"
            "<h2>Quantiles</h2><table border='1'><tr><th>sketch</th>"
            "<th>p50</th><th>p90</th><th>p99</th><th>n</th></tr>"
            f"{quant_rows}</table>"
            f"<h2>Schema drift</h2><p>{frozen}</p>"
            "<table border='1'><tr><th>event</th><th>field</th>"
            "<th>change</th><th>old</th><th>new</th></tr>"
            f"{change_rows}</table>"
            '<p><a href="/admin/data">JSON</a> · '
            '<a href="/">index</a></p></body></html>'
        )

    def trace_html(self, trace_id: Optional[str] = None) -> str:
        """The cross-process trace view (obs/collect.py): without an
        id, a lookup form plus the traces recently seen by THIS
        process's ring; with ``?id=``, the stitched tree fan-out over
        the federation members (this process, ACTIVE fleets,
        PIO_OBS_MEMBERS) rendered through the SAME ASCII renderer
        ``pio trace`` uses — one renderer, no drift."""
        from predictionio_torch.obs import collect, trace as _trace

        form = (
            '<form method="get" action="/trace">'
            '<input name="id" size="40" placeholder="trace id '
            '(X-PIO-Trace-Id)" value="{}"/> '
            "<button>stitch</button></form>"
        ).format(html.escape(trace_id or ""))
        if trace_id and _trace.valid_trace_id(trace_id):
            doc = collect.stitch_trace(trace_id,
                                       collect.default_members())
            body = ("<pre>"
                    + html.escape(collect.format_trace_tree(doc))
                    + "</pre>")
        elif trace_id:
            body = "<p>that is not an id-shaped trace id.</p>"
        else:
            recent: dict = {}
            for record in _trace.recent_spans():
                entry = recent.setdefault(
                    record["trace"], {"spans": 0, "names": set()})
                entry["spans"] += 1
                entry["names"].add(record["name"])
            rows = "".join(
                '<tr><td><a href="/trace?id={t}"><code>{t}</code></a>'
                "</td><td>{n}</td><td><code>{names}</code></td></tr>"
                .format(t=html.escape(t), n=entry["spans"],
                        names=html.escape(", ".join(
                            sorted(entry["names"])[:6])))
                for t, entry in list(recent.items())[-20:][::-1]
            ) or ("<tr><td colspan='3'>no spans in this process's "
                  "ring yet</td></tr>")
            body = ("<table border='1'><tr><th>Trace</th><th>Spans "
                    "here</th><th>Span names</th></tr>" + rows
                    + "</table>")
        return (
            "<!DOCTYPE html><html><head><title>Trace</title></head>"
            "<body><h1>Cross-process trace</h1>"
            f"{form}{body}"
            '<p><a href="/admin/trace">JSON (?id=)</a> · '
            '<a href="/">index</a></p></body></html>'
        )

    def memory_html(self) -> str:
        """The device-memory accounting plane (obs/memacct.py) as an
        operator panel: capacity/headroom with their basis, a
        ``mem.headroom`` timeline sparkline, the per-model component
        ledger, train peaks and the last OOM-preflight decision —
        every number read from memacct's one report, so this panel,
        ``pio mem`` and ``GET /admin/memory`` can never disagree."""
        import html as _html

        from predictionio_torch.obs import memacct
        from predictionio_torch.obs.timeline import TIMELINE, sparkline

        report = memacct.report()

        def esc(v) -> str:
            return _html.escape(str(v))

        def bytes_or_dash(v) -> str:
            # an unknown_size decision stores estimated_bytes=None, and a
            # host without a card or PIO_PEAK_HBM_BYTES has no capacity:
            # render '-' like `pio mem`, never the Python None repr
            return "-" if v is None else f"{int(v):,} B"

        model_rows = []
        for model in sorted(report.get("models") or {}):
            block = report["models"][model]
            components = ", ".join(
                f"{name}: {nbytes:,} B" for name, nbytes in
                sorted(block["components"].items()))
            model_rows.append(
                f"<tr><td>{esc(model)}</td>"
                f"<td>{block['total_bytes']:,} B</td>"
                f"<td>{esc(components)}</td></tr>")
        peak_rows = [
            f"<tr><td>{esc(model)}</td><td>{peak['bytes']:,} B</td>"
            f"<td>{esc(peak['source'])}</td></tr>"
            for model, peak in sorted(
                (report.get("train_peaks") or {}).items())]
        series = (TIMELINE.series().get("series") or {}).get(
            "mem.headroom") or []
        spark = sparkline([p[1] for p in series], 40)
        pre = report.get("preflight") or {}
        last = pre.get("last")
        last_line = ("no preflight decision yet" if not last else
                     f"last: {esc(last.get('result'))} for instance "
                     f"{esc(last.get('instance'))} (estimated "
                     f"{bytes_or_dash(last.get('estimated_bytes'))} vs "
                     f"headroom "
                     f"{bytes_or_dash(last.get('headroom_bytes'))})")
        return (
            "<!DOCTYPE html><html><head><title>Device memory</title>"
            "</head><body><h1>Device memory</h1>"
            f"<p>Basis <b>{esc(report['basis'])}</b>: "
            f"{bytes_or_dash(report['in_use_bytes'])} in use of "
            f"{bytes_or_dash(report['capacity_bytes'])} — headroom "
            f"<b>{bytes_or_dash(report['headroom_bytes'])}</b> (floor "
            f"{report['headroom_floor_fraction']:.0%} of capacity; "
            "PIO_PEAK_HBM_BYTES / PIO_MEM_HEADROOM_FLOOR).</p>"
            f"<p>headroom <code>{esc(spark) or '(no samples yet)'}"
            "</code></p>"
            "<h2>Per-model ledger</h2>"
            "<table border='1'><tr><th>Model</th><th>Total</th>"
            "<th>Components</th></tr>"
            f"{''.join(model_rows) or '<tr><td colspan=3>(empty)</td></tr>'}"
            "</table>"
            "<h2>Train peaks</h2>"
            "<table border='1'><tr><th>Model</th><th>Peak bytes</th>"
            "<th>Basis</th></tr>"
            f"{''.join(peak_rows) or '<tr><td colspan=3>(none)</td></tr>'}"
            "</table>"
            "<h2>OOM preflight</h2>"
            f"<p>{'enabled' if pre.get('enabled') else 'DISABLED'} "
            f"(estimate scale x{pre.get('estimate_scale')}); "
            f"{last_line}</p>"
            '<p><a href="/admin/memory">JSON</a> · '
            '<a href="/">index</a></p></body></html>'
        )

    def prof_html(self, endpoint: Optional[str] = None,
                  slow: bool = False) -> str:
        """The continuous profiler's flame (obs/contprof.py) rendered
        through the SAME ASCII renderer ``pio prof`` uses — one
        renderer, every surface. ``?slow=1`` shows the above-PIO_SLOW_MS
        tail cohort, ``?endpoint=`` one route's slice."""
        from urllib.parse import quote

        from predictionio_torch.obs import contprof

        payload = contprof.snapshot(endpoint=endpoint, slow=slow)
        flame = contprof.format_flame(payload)
        slices = [
            '<a href="/prof">all</a>',
            '<a href="/prof?slow=1">slow cohort</a>',
        ]
        for ep in payload.get("endpoints") or []:
            slices.append(
                '<a href="/prof?endpoint={}"><code>{}</code></a>'.format(
                    quote(ep, safe=""), html.escape(ep)))
        return (
            "<!DOCTYPE html><html><head><title>Continuous profile"
            "</title></head><body><h1>Continuous profile"
            f" [{html.escape(str(payload.get('slice')))}]</h1>"
            f"<p>slices: {' · '.join(slices)}</p>"
            f"<pre>{html.escape(flame)}</pre>"
            '<p><a href="/admin/prof">JSON</a> · '
            '<a href="/admin/prof?format=collapsed">collapsed</a> · '
            '<a href="/">index</a></p></body></html>'
        )

    def fleet_html(self) -> str:
        """The serving fleet(s) supervised in THIS process as an
        operator panel: one table per supervisor — replica state
        (colored), version, restarts, outstanding router requests —
        plus the last rolling-swap verdict. A fleet running in another
        process is one `pio fleet --url <router>` away."""
        from predictionio_torch.serving import fleet as _fleet

        color = {"ready": "#27ae60", "starting": "#e67e22",
                 "evicted": "#e67e22", "draining": "#2980b9",
                 "dead": "#c0392b", "stopped": "#888"}
        sections = []
        for i, supervisor in enumerate(list(_fleet.ACTIVE)):
            snap = supervisor.snapshot()
            rows = "".join(
                '<tr><td>{name}</td><td style="color:{c};'
                'font-weight:bold">{state}</td><td>{port}</td>'
                "<td><code>{version}</code></td><td>{restarts}</td>"
                "<td>{outstanding}</td></tr>".format(
                    name=html.escape(r["name"]),
                    c=color.get(r["state"], "#888"),
                    state=html.escape(r["state"]),
                    port=r["port"] or "–",
                    version=html.escape(str(r["version"] or "–")[:16]),
                    restarts=r["restarts"],
                    outstanding=r["outstanding"])
                for r in snap["replicas"])
            swap_line = _fleet.format_swap(snap["swap"])
            sections.append(
                f"<h2>Fleet {i}: {snap['ready']}/{snap['size']} ready, "
                f"version <code>"
                f"{html.escape(str(snap['version'] or 'mixed/none'))}"
                "</code></h2>"
                "<table border='1'><tr><th>Replica</th><th>State</th>"
                "<th>Port</th><th>Version</th><th>Restarts</th>"
                f"<th>Outstanding</th></tr>{rows}</table>"
                f"<p>{html.escape(swap_line)}</p>")
        body = "".join(sections) or (
            "<p>No fleet supervised in this process — "
            "<code>pio deploy --replicas N</code> runs one, and a "
            "remote fleet answers <code>pio fleet --url "
            "&lt;router&gt;</code>.</p>")
        return (
            "<!DOCTYPE html><html><head><title>Serving fleet</title>"
            "</head><body><h1>Serving fleet</h1>"
            f"{body}"
            '<p><a href="/admin/fleet">JSON (on the router)</a> · '
            '<a href="/">index</a></p></body></html>'
        )

    def resilience_html(self) -> str:
        """Breaker states, shed counters and chaos rules of THIS
        process (each serving process owns its breakers — fleet views
        scrape ``pio_circuit_state`` instead)."""
        from predictionio_torch.obs import metrics as _metrics
        from predictionio_torch.resilience import chaos as _chaos
        from predictionio_torch.resilience import policy as _policy

        color = {"closed": "#27ae60", "half_open": "#e67e22",
                 "open": "#c0392b"}
        circuit_rows = "".join(
            '<tr><td>{t}</td><td style="color:{c};font-weight:bold">{s}'
            "</td><td>{f}/{th}</td><td>{r:.0f}s</td></tr>".format(
                t=html.escape(b["target"]),
                c=color.get(b["state"], "#888"),
                s=html.escape(b["state"]),
                f=b["consecutive_failures"], th=b["failure_threshold"],
                r=b["reset_timeout_sec"])
            for b in _policy.breakers_snapshot()
        ) or "<tr><td colspan='4'>no circuits yet</td></tr>"
        shed_family = _metrics.REGISTRY.get("pio_shed_total")
        shed_rows = ""
        if shed_family is not None:
            shed_rows = "".join(
                f"<tr><td>{html.escape('/'.join(values))}</td>"
                f"<td>{int(child.value)}</td></tr>"
                for values, child in shed_family.children())
        shed_rows = shed_rows or ("<tr><td colspan='2'>nothing shed"
                                  "</td></tr>")
        state = _chaos.describe()
        chaos_line = (html.escape(state["spec"]) if state["enabled"]
                      else "inactive")
        return (
            "<!DOCTYPE html><html><head><title>Resilience</title></head>"
            "<body><h1>Resilience</h1>"
            "<h2>Circuit breakers</h2>"
            "<table border='1'><tr><th>Target</th><th>State</th>"
            "<th>Failures</th><th>Reset</th></tr>"
            f"{circuit_rows}</table>"
            "<h2>Admission control (shed counters)</h2>"
            "<table border='1'><tr><th>server/reason</th><th>shed</th>"
            f"</tr>{shed_rows}</table>"
            f"<h2>Chaos</h2><p><code>{chaos_line}</code> — toggle via "
            "<code>pio chaos --url ... --set SPEC</code> or "
            "<code>POST /admin/chaos</code>.</p>"
            '<p><a href="/admin/resilience">JSON</a> · '
            '<a href="/">index</a></p>'
            "</body></html>"
        )


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="PredictionIO dashboard")
    parser.add_argument("--ip", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = parser.parse_args(argv)
    obs_logging.setup(level=logging.INFO)
    server = DashboardServer(host=args.ip, port=args.port)
    log.info("dashboard running on %s:%s", args.ip, server.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
