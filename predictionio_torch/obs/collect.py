"""Fleet-wide observability federation: cross-process trace stitching,
merged metrics and fleet tail attribution.

Copy of ``predictionio_tpu/obs/collect.py``. The span surface of one
process (``span_page``, ``build_tree``) lives in the port's
``obs/trace.py``, which serves ``GET /admin/spans``; this module fans
out to the members and stitches. ``fleet_members`` reads the port's
``serving/fleet.py``. What follows is the JAX module's account.

PredictionIO is multi-process by construction — each deployed engine is
its own REST service beside the event server (PAPER.md §0), and the
serving fleet mirrors that: a router, N replicas, event/storage servers
and the stream daemon each keep their OWN span ring (obs/trace.py),
flight recorder (obs/flight.py), ``/admin/tail`` and ``/metrics``.
Diagnosing one slow query used to mean hand-correlating five processes.
This module is the out-of-band collector the Dapper trace model calls
for (PAPERS.md): per-process buffers plus a federation pass that
assembles the cross-process view.

Three federations, one member list:

  span queries + trace stitching
    Every server answers ``GET /admin/spans?trace=<id>&n=N`` from its
    in-process ring (serving/http.py routes it like ``/metrics``).
    :func:`stitch_trace` fans out to the fleet members, dedupes spans
    by span id (threaded tier-1 replicas SHARE one ring; subprocess
    fleets do not), and builds ONE annotated tree: per node the owning
    process (the nearest ancestor edge span's ``server`` attribute),
    the replica name (the router's attempt spans carry it), the
    parent-edge latency, and an explicit placeholder node wherever a
    referenced parent span was not collected — with each member's
    ``pio_trace_spans_evicted_total`` quoted so "partial" comes with a
    why. Hedged second attempts and canary shadow queries are real
    sibling spans (``router.attempt`` / ``router.shadow``) under the
    same trace. Rendered by ``pio trace <id>``, the dashboard's
    ``/trace`` view, and ``GET /admin/trace?id=`` on any server.

  metric federation
    ``GET /admin/fleet/metrics`` (on servers that supervise a fleet —
    normally the router) merges the members' ``/metrics`` snapshots:
    counters SUM, histograms sum BUCKET-WISE over the shared bucket
    layout (obs/metrics.py DEFAULT_BUCKETS — every member buckets
    identically by construction; a member with foreign bounds merges
    over the union), gauges keep a ``member`` label (summing gauges
    would fabricate numbers no process reported). A member answering
    5xx or nothing at all DEGRADES the merge (its absence is reported
    per member), never fails it. Fleet-level SLO burn is computed over
    the MERGED serving histogram with the same tightest-covering-bucket
    math obs/slo.py uses.

  fleet tail attribution
    ``GET /admin/fleet/tail`` merges the members' flight-recorder stage
    timings (each record annotated with its member) and runs
    obs/perfacct.py's :func:`~predictionio_torch.obs.perfacct.tail_report`
    over the union — tail attribution finally sees the whole fleet, not
    one replica's slice — plus a per-member split of the tail cohort
    (which replica the p99 lives on).

  journal + anomaly federation
    ``GET /admin/fleet/journal`` merges the members' ops-journal pages
    (obs/journal.py) into one member-annotated, wall-clock-ordered
    stream; ``GET /admin/fleet/anomaly`` lays the members' regression-
    sentinel reports (obs/anomaly.py) side by side and unions the
    active anomalies — "what changed, where, and what did it" across
    the whole fleet. Rendered by ``pio journal --fleet`` /
    ``pio anomalies --fleet``.

Members come from the fleet snapshot (every live replica's address)
plus ``PIO_OBS_MEMBERS`` — a comma-separated list of ``name=url`` (or
bare ``url``) entries naming the event server, storage server, stream
daemon or any other PIO process to fold into the pane of glass.

Honesty note (threaded tier-1 fleets): in-process replicas share one
metrics registry, so merging their ``/metrics`` multiplies the shared
counters by the member count — the merge is still exactly "the sum of
what the members answered" (the property tests pin). Subprocess fleets
have per-process registries and merge truthfully.

Config (all env):
  PIO_OBS_MEMBERS        extra members, ``name=url[,name=url...]``
  PIO_COLLECT_TIMEOUT    per-member fan-out deadline (default 5s)
  PIO_SPAN_RING          span ring size per process (obs/trace.py)
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from predictionio_torch.obs import metrics, perfacct, trace

log = logging.getLogger(__name__)

DEFAULT_COLLECT_TIMEOUT_SEC = 5.0


def collect_timeout() -> float:
    return max(0.1, metrics.env_float("PIO_COLLECT_TIMEOUT",
                                      DEFAULT_COLLECT_TIMEOUT_SEC))


_SCRAPE_ERRORS = metrics.counter(
    "pio_collect_member_errors_total",
    "Federation fan-outs that lost a member (timeout/5xx/transport) — "
    "the merge degraded to the members that answered",
)


# -- the member list -----------------------------------------------------------

class Member:
    """One federated process: a name and a base URL. ``url=None`` is
    THIS process (its ring/registry read directly, no HTTP hop)."""

    def __init__(self, name: str, url: Optional[str], role: str = "member"):
        self.name = name
        self.url = url.rstrip("/") if url else None
        self.role = role

    def __repr__(self) -> str:  # test failure readability
        return f"Member({self.name!r}, {self.url!r})"


def env_members() -> List[Member]:
    """``PIO_OBS_MEMBERS`` parsed: ``name=url`` entries (bare URLs get
    a host:port-derived name) — the configured event/storage/stream
    addresses the ISSUE's pane of glass folds in."""
    raw = os.environ.get("PIO_OBS_MEMBERS", "")
    out: List[Member] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" in entry:
            name, _, url = entry.partition("=")
            name, url = name.strip(), url.strip()
        else:
            url = entry
            name = re.sub(r"^https?://", "", url).rstrip("/")
        if url:
            out.append(Member(name, url, role="configured"))
    return out


def fleet_members(fleet: Any) -> List[Member]:
    """Every live replica of a fleet supervisor, by address (DEAD
    replicas have no port to ask; their absence is the federation's
    business to report, not to guess around)."""
    out: List[Member] = []
    if fleet is None:
        return out
    for replica in list(getattr(fleet, "replicas", ())):
        try:
            snap_state = replica.state
            port = replica.port
        except Exception:  # noqa: BLE001 — a half-torn replica must not
            # kill the whole federation pass
            continue
        if snap_state in ("dead", "stopped") or not port:
            continue
        out.append(Member(replica.name, replica.base_url, role="replica"))
    return out


def default_members(server_ref: Any = None,
                    include_local: bool = True) -> List[Member]:
    """The federation's member list: this process (its own ring —
    the router's spans live here), the supervised fleet's replicas
    (``server_ref.fleet`` when given, else every ACTIVE supervisor in
    this process), and the ``PIO_OBS_MEMBERS`` extras."""
    members: List[Member] = []
    if include_local:
        members.append(Member("local", None, role="local"))
    fleet = getattr(server_ref, "fleet", None)
    if fleet is not None:
        members.extend(fleet_members(fleet))
    else:
        from predictionio_torch.serving import fleet as fleet_mod

        for supervisor in list(fleet_mod.ACTIVE):
            members.extend(fleet_members(supervisor))
    members.extend(env_members())
    # first occurrence of a name OR address wins (a replica both ACTIVE
    # and named in the env — under either name — would otherwise be
    # scraped twice and double-counted by the metric merge)
    seen: set = set()
    out = []
    for m in members:
        if m.name in seen or (m.url is not None and m.url in seen):
            continue
        seen.add(m.name)
        if m.url is not None:
            seen.add(m.url)
        out.append(m)
    return out


def _fetch(url: str, timeout: float) -> Tuple[Optional[bytes],
                                              Optional[str]]:
    """(body, error) for one member GET — the fan-out's degrade-not-
    fail seam. The collector's own trace context rides along so a
    federation pass is itself traceable."""
    req = urllib.request.Request(url, headers=trace.traced_headers())
    token = os.environ.get("PIO_ADMIN_TOKEN")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read(), None
    except urllib.error.HTTPError as e:
        e.read()
        return None, f"HTTP {e.code}"
    except (OSError, ValueError) as e:
        return None, f"{type(e).__name__}: {e}"


def _fan_out(members: List[Member],
             fn: Callable[[Member], Tuple[Any, Optional[str]]]
             ) -> List[Tuple[Member, Any, Optional[str]]]:
    """Run ``fn(member)`` concurrently (one hung member must cost one
    timeout, not N stacked); bounded joins (JT12). Returns
    (member, result, error) triples in member order."""
    results: List[Tuple[Member, Any, Optional[str]]] = [None] * len(members)  # type: ignore[list-item]

    def run(i: int, member: Member) -> None:
        try:
            value, error = fn(member)
        except Exception as e:  # noqa: BLE001 — a member failure is a
            # degraded merge, never a crashed federation pass
            value, error = None, f"{type(e).__name__}: {e}"
        results[i] = (member, value, error)

    threads = []
    for i, member in enumerate(members):
        t = threading.Thread(target=run, args=(i, member), daemon=True,
                             name=f"pio-collect-{member.name}")
        t.start()
        threads.append(t)
    deadline = collect_timeout() + 1.0
    for t in threads:
        t.join(timeout=deadline)
    out = []
    for i, member in enumerate(members):
        if results[i] is None:  # thread still wedged past the deadline
            out.append((member, None, "collect deadline expired"))
        else:
            out.append(results[i])
    for _m, _v, error in out:
        if error is not None:
            _SCRAPE_ERRORS.inc()
    return out


# -- span-query surface --------------------------------------------------------

def _fetch_spans(member: Member, trace_id: str,
                 timeout: float) -> Tuple[Optional[Dict[str, Any]],
                                          Optional[str]]:
    if member.url is None:
        return trace.span_page("local", trace_id), None
    body, error = _fetch(
        f"{member.url}/admin/spans?trace={trace_id}", timeout)
    if error is not None:
        return None, error
    try:
        return json.loads(body or b"{}"), None
    except ValueError as e:
        return None, f"unparseable spans payload: {e}"


# -- trace stitching -----------------------------------------------------------

def collect_trace(trace_id: str,
                  members: List[Member]) -> Dict[str, Any]:
    """Fan out to every member's span surface; dedupe by span id
    (shared-ring threaded replicas all answer the same spans) and
    report per-member status + eviction counts."""
    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    spans: Dict[str, Dict[str, Any]] = {}
    for member, page, error in _fan_out(
            members, lambda m: _fetch_spans(m, trace_id, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            report["evicted_total"] = page.get("evicted_total")
            report["server"] = page.get("server")
            count = 0
            for record in page.get("spans") or []:
                span_id = record.get("span")
                if not span_id or record.get("trace") != trace_id:
                    continue
                count += 1
                if span_id not in spans:
                    record = dict(record)
                    record["member"] = member.name
                    spans[span_id] = record
            report["spans"] = count
        member_reports.append(report)
    return {"trace": trace_id, "members": member_reports,
            "spans": list(spans.values())}


def stitch_trace(trace_id: str, members: List[Member]) -> Dict[str, Any]:
    """collect + build: the document ``GET /admin/trace?id=`` serves
    and ``pio trace`` / the dashboard render."""
    collected = collect_trace(trace_id, members)
    doc = trace.build_tree(trace_id, collected["spans"],
                           members=collected["members"])
    doc["members"] = collected["members"]
    return doc


def format_trace_tree(doc: Dict[str, Any]) -> str:
    """The one ASCII renderer ``pio trace`` and the dashboard share."""
    lines: List[str] = []
    status = "COMPLETE" if doc.get("complete") else "PARTIAL"
    lines.append(
        f"trace {doc.get('trace')} — {doc.get('span_count', 0)} span(s) "
        f"across {len(doc.get('processes') or [])} process(es) "
        f"[{status}]")
    for member in doc.get("members") or []:
        state = ("ok" if member.get("ok")
                 else f"ERROR: {member.get('error')}")
        extra = ""
        if member.get("ok") and member.get("evicted_total"):
            extra = f", {member['evicted_total']} span(s) evicted"
        lines.append(f"  member {member['name']:<12} {state}"
                     f" ({member.get('spans', 0)} span(s){extra})")

    def walk(node: Dict[str, Any], prefix: str, is_last: bool) -> None:
        branch = "└─ " if is_last else "├─ "
        if node.get("missing"):
            label = (f"(missing span {str(node.get('span'))[:16]}) "
                     f"— {node.get('note')}")
        else:
            label = node.get("name", "?")
            attrs = []
            if node.get("replica") is not None:
                attrs.append(f"replica={node['replica']}")
            if node.get("hedge"):
                attrs.append("hedge")
            if node.get("shadow"):
                attrs.append("shadow")
            if attrs:
                label += " [" + " ".join(attrs) + "]"
            label += f"  {node.get('duration_ms', 0):g}ms"
            if "edge_ms" in node:
                label += f" (+{node['edge_ms']:g}ms)"
            label += f"  <{node.get('process') or '?'}>"
            if node.get("error"):
                label += f"  ERROR: {node['error']}"
            if node.get("cycle"):
                label += f"  ({node.get('note')})"
        lines.append(prefix + branch + label)
        children = node.get("children") or []
        child_prefix = prefix + ("   " if is_last else "│  ")
        for i, child in enumerate(children):
            walk(child, child_prefix, i == len(children) - 1)

    roots = doc.get("roots") or []
    for i, root in enumerate(roots):
        walk(root, "", i == len(roots) - 1)
    if not roots:
        lines.append("  (no spans collected for this trace)")
    return "\n".join(lines)


# -- metric federation ---------------------------------------------------------

_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


def _unescape(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str) -> Dict[str, Dict[str, Any]]:
    """A Prometheus/OpenMetrics text document parsed into families:
    ``{family: {"kind": ..., "samples": {(sample_name, labels): value}}}``
    with ``labels`` a sorted tuple of (name, value) pairs. Histogram
    samples (``_bucket``/``_sum``/``_count``) attach to their base
    family via the ``# TYPE`` declarations, so bucket-wise merging has
    the structure it needs (a flat name->value dict does not)."""
    kinds: Dict[str, str] = {}
    families: Dict[str, Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        line = line.split(" # ", 1)[0].rstrip()  # strip exemplars
        name_part, _, value_str = line.rpartition(" ")
        if not name_part:
            continue
        try:
            value = float(value_str)
        except ValueError:
            continue
        brace = name_part.find("{")
        if brace >= 0:
            sample_name = name_part[:brace]
            labels = tuple(sorted(
                (k, _unescape(v)) for k, v in
                _LABEL_PAIR_RE.findall(name_part[brace:])))
        else:
            sample_name, labels = name_part, ()
        family = sample_name
        if family not in kinds:
            for suffix in ("_bucket", "_sum", "_count", "_total"):
                if sample_name.endswith(suffix) and (
                        sample_name[: -len(suffix)] in kinds):
                    family = sample_name[: -len(suffix)]
                    break
        entry = families.setdefault(
            family, {"kind": kinds.get(family, "untyped"), "samples": {}})
        entry["samples"][(sample_name, labels)] = value
    return families


def _fetch_member_metrics(member: Member, timeout: float
                          ) -> Tuple[Optional[Dict[str, Any]],
                                     Optional[str]]:
    if member.url is None:
        return parse_exposition(metrics.REGISTRY.render()), None
    body, error = _fetch(f"{member.url}/metrics", timeout)
    if error is not None:
        return None, error
    try:
        return parse_exposition(body.decode("utf-8", "replace")), None
    except Exception as e:  # noqa: BLE001 — a garbled exposition is a
        # degraded member, not a failed merge
        return None, f"unparseable exposition: {e}"


def merge_families(member_families: List[Tuple[str, Dict[str, Dict[str, Any]]]]
                   ) -> Dict[str, Dict[str, Any]]:
    """The merge core (pure, so the math is testable without HTTP):
    counters and histogram samples SUM by identical (sample, labels)
    key — bucket-wise over the shared bucket layout, disjoint label
    sets union — while gauges gain a ``member`` label per member
    (summing gauges would report a fleet-wide value no process
    measured; keeping the member visible is the pane of glass)."""
    merged: Dict[str, Dict[str, Any]] = {}
    for member_name, families in member_families:
        for family, entry in families.items():
            out = merged.setdefault(
                family, {"kind": entry["kind"], "samples": {}})
            if out["kind"] == "untyped" and entry["kind"] != "untyped":
                out["kind"] = entry["kind"]
            samples = out["samples"]
            if entry["kind"] in ("counter", "histogram"):
                for key, value in entry["samples"].items():
                    samples[key] = samples.get(key, 0.0) + value
            else:
                # gauge / untyped: one series per member
                for (sample_name, labels), value in (
                        entry["samples"].items()):
                    labeled = tuple(sorted(
                        labels + (("member", member_name),)))
                    samples[(sample_name, labeled)] = value
    return merged


def render_merged(merged: Dict[str, Dict[str, Any]]) -> str:
    """The merged document in Prometheus text format (the ``?format=
    prom`` answer a fleet-level scraper ingests directly)."""
    lines: List[str] = []
    for family in sorted(merged):
        entry = merged[family]
        lines.append(f"# TYPE {family} {entry['kind']}")
        for (sample_name, labels), value in sorted(
                entry["samples"].items()):
            label_str = ""
            if labels:
                inner = ",".join(
                    '{}="{}"'.format(
                        k, v.replace("\\", "\\\\").replace('"', '\\"')
                        .replace("\n", "\\n"))
                    for k, v in labels)
                label_str = "{" + inner + "}"
            if value == math.inf:
                rendered = "+Inf"
            elif float(value).is_integer() and abs(value) < 1e15:
                rendered = str(int(value))
            else:
                rendered = repr(float(value))
            lines.append(f"{sample_name}{label_str} {rendered}")
    return "\n".join(lines) + "\n"


def flat_samples(merged: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """``{"name{labels}": value}`` — the same shape
    ``metrics.samples_dict`` parses from a single /metrics document, so
    the sum-equality acceptance test compares like with like."""
    out: Dict[str, float] = {}
    for entry in merged.values():
        for (sample_name, labels), value in entry["samples"].items():
            if labels:
                inner = ",".join(f'{k}="{v}"' for k, v in labels)
                out[f"{sample_name}{{{inner}}}"] = value
            else:
                out[sample_name] = value
    return out


def fleet_slo(merged: Dict[str, Dict[str, Any]],
              metric: str = "pio_serving_request_seconds"
              ) -> Dict[str, Any]:
    """Fleet-level serving-latency SLO over the MERGED histogram: good
    = observations in buckets whose upper bound covers the threshold
    (the tightest covering bucket — identical math to obs/slo.py's
    latency measure, so the fleet number and a member's /admin/slo can
    never disagree on the rule). The burn here is CUMULATIVE (whole
    uptime) — the windowed paging alerts stay per-process where the
    sample history lives."""
    threshold = metrics.env_float("PIO_SLO_LATENCY_MS", 100.0) / 1e3
    objective = metrics.env_float("PIO_SLO_LATENCY_OBJECTIVE", 0.99)
    budget = max(1e-9, 1.0 - objective)
    entry = merged.get(metric)
    good = total = 0.0
    if entry is not None:
        # per label-child cumulative buckets: {base labels: {le: count}}
        children: Dict[Tuple, Dict[float, float]] = {}
        for (sample_name, labels), value in entry["samples"].items():
            if sample_name == metric + "_count":
                total += value
            elif sample_name == metric + "_bucket":
                le = None
                base = []
                for k, v in labels:
                    if k == "le":
                        le = math.inf if v == "+Inf" else float(v)
                    else:
                        base.append((k, v))
                if le is not None:
                    children.setdefault(tuple(base), {})[le] = value
        for buckets in children.values():
            for bound in sorted(buckets):
                if bound >= threshold or bound == math.inf:
                    good += buckets[bound]
                    break
    out: Dict[str, Any] = {
        "metric": metric,
        "threshold_ms": threshold * 1e3,
        "objective": objective,
        "total": total,
        "good": min(good, total),
    }
    if total > 0:
        error_rate = max(0.0, (total - out["good"]) / total)
        out["error_rate"] = round(error_rate, 6)
        out["burn"] = round(error_rate / budget, 3)
    else:
        out["error_rate"] = None
        out["burn"] = None
    return out


def _member_summary(families: Dict[str, Dict[str, Any]]
                    ) -> Dict[str, Any]:
    """Per-member at-a-glance numbers for the federation report."""
    requests = 0.0
    entry = families.get("pio_http_requests_total")
    if entry is not None:
        requests = sum(entry["samples"].values())
    serving = families.get("pio_serving_request_seconds")
    served = 0.0
    if serving is not None:
        served = sum(v for (name, _l), v in serving["samples"].items()
                     if name.endswith("_count"))
    return {"http_requests": requests, "serving_requests": served}


def federate_metrics(members: List[Member]) -> Dict[str, Any]:
    """The full ``GET /admin/fleet/metrics`` report: per-member status,
    the merged samples (flat form) and the fleet SLO burn. The merged
    structure itself is also returned for the text renderer."""
    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    collected: List[Tuple[str, Dict[str, Dict[str, Any]]]] = []
    for member, families, error in _fan_out(
            members,
            lambda m: _fetch_member_metrics(m, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            report.update(_member_summary(families))
            collected.append((member.name, families))
        member_reports.append(report)
    merged = merge_families(collected)
    import time as _time

    return {
        "generated_unix": round(_time.time(), 3),
        "members": member_reports,
        "merged_from": [name for name, _f in collected],
        "slo": fleet_slo(merged),
        "samples": flat_samples(merged),
        "_merged": merged,  # for render_merged; stripped by the route
    }


_FLAT_BUCKET_RE = re.compile(r'le="([^"]+)"')


def quantile_from_flat(samples: Dict[str, float], metric: str,
                       q: float) -> Optional[float]:
    """A quantile estimate (seconds) over a merged histogram in FLAT
    sample form (``{"name{labels}": value}`` — what the federation
    report carries over the wire): bucket counts are summed across
    every label set, then interpolated exactly like
    obs/metrics.py's ``HistogramChild.quantile`` — the consumer for
    ``pio top --fleet``'s fleet-wide percentiles."""
    prefix = metric + "_bucket{"
    by_le: Dict[float, float] = {}
    for name, value in samples.items():
        if not name.startswith(prefix):
            continue
        m = _FLAT_BUCKET_RE.search(name)
        if not m:
            continue
        le = math.inf if m.group(1) == "+Inf" else float(m.group(1))
        by_le[le] = by_le.get(le, 0.0) + value
    if not by_le:
        return None
    cum = sorted(by_le.items())
    total = cum[-1][1]
    if total <= 0:
        return None
    rank = q * total
    lower = 0.0
    prev = 0.0
    for bound, running in cum:
        if running >= rank:
            if bound == math.inf:
                return lower
            span = running - prev
            frac = (rank - prev) / span if span else 1.0
            return lower + (bound - lower) * frac
        lower, prev = bound, running
    return lower


# -- fleet tail attribution ----------------------------------------------------

def _fetch_flight(member: Member, n: Optional[int],
                  timeout: float) -> Tuple[Optional[List[Dict[str, Any]]],
                                           Optional[str]]:
    if member.url is None:
        from predictionio_torch.obs import flight

        return flight.RECORDER.records(n), None
    url = f"{member.url}/admin/flight"
    if n is not None:
        url += f"?n={int(n)}"
    body, error = _fetch(url, timeout)
    if error is not None:
        return None, error
    try:
        return (json.loads(body or b"{}").get("records") or []), None
    except ValueError as e:
        return None, f"unparseable flight dump: {e}"


def federate_tail(members: List[Member], q: float = 0.95,
                  n: Optional[int] = None) -> Dict[str, Any]:
    """Fleet-wide tail attribution: the members' flight records merged
    (deduped — threaded replicas share one recorder), each annotated
    with its member, run through the SAME
    :func:`~predictionio_torch.obs.perfacct.tail_report` a single process
    serves at ``/admin/tail`` — plus the per-member split of the tail
    cohort, the "which replica is my p99" answer a single process can
    never give."""
    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    records: List[Dict[str, Any]] = []
    seen: set = set()
    for member, recs, error in _fan_out(
            members, lambda m: _fetch_flight(m, n, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            kept = 0
            for record in recs:
                key = (record.get("trace"), record.get("server"),
                       record.get("route"), record.get("start_unix"),
                       record.get("duration_ms"))
                if key in seen:
                    continue
                seen.add(key)
                record = dict(record)
                record.pop("spans", None)  # stage math never reads them
                record["fleet_member"] = member.name
                records.append(record)
                kept += 1
            report["records"] = kept
        member_reports.append(report)
    report = perfacct.tail_report(records, q=q)
    threshold = report.get("threshold_ms")
    member_tail: Dict[str, Dict[str, float]] = {}
    if threshold is not None:
        tail = [r for r in records
                if isinstance(r.get("duration_ms"), (int, float))
                and r["duration_ms"] >= threshold]
        for record in tail:
            entry = member_tail.setdefault(
                record["fleet_member"], {"tail_count": 0, "tail_ms": 0.0})
            entry["tail_count"] += 1
            entry["tail_ms"] = round(
                entry["tail_ms"] + record["duration_ms"], 3)
        for entry in member_tail.values():
            entry["tail_share"] = round(
                entry["tail_count"] / max(1, len(tail)), 4)
    report["members"] = member_reports
    report["member_tail"] = member_tail
    return report


# -- fleet profile federation --------------------------------------------------

def _fetch_prof(member: Member, endpoint: Optional[str], slow: bool,
                timeout: float) -> Tuple[Optional[Dict[str, Any]],
                                         Optional[str]]:
    from predictionio_torch.obs import contprof

    if member.url is None:
        return contprof.snapshot(endpoint=endpoint, slow=slow), None
    url = f"{member.url}/admin/prof"
    params = []
    if slow:
        params.append("slow=1")
    if endpoint:
        from urllib.parse import quote

        params.append(f"endpoint={quote(endpoint, safe='')}")
    if params:
        url += "?" + "&".join(params)
    body, error = _fetch(url, timeout)
    if error is not None:
        return None, error
    try:
        return json.loads(body or b"{}"), None
    except ValueError as e:
        return None, f"unparseable profile payload: {e}"


def federate_prof(members: List[Member], endpoint: Optional[str] = None,
                  slow: bool = False) -> Dict[str, Any]:
    """Member-merged continuous profile (``GET /admin/fleet/prof``):
    every member's folded stacks summed into one fleet flame
    (obs/contprof.merge_folded), per-member sample counts / overhead /
    effective rate annotated, dead members degrading the merge exactly
    like the metric federation. The slow slice unions the members'
    slow-cohort trace ids so the fleet flame still joins against each
    flight recorder's slow ring."""
    from predictionio_torch.obs import contprof

    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    payloads: List[Dict[str, Any]] = []
    slow_traces: List[str] = []
    for member, payload, error in _fan_out(
            members,
            lambda m: _fetch_prof(m, endpoint, slow, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            samples = payload.get("samples") or {}
            report["samples"] = (samples.get("cpu", 0)
                                 + samples.get("wait", 0))
            report["effective_hz"] = payload.get("effective_hz")
            report["overhead_ratio"] = payload.get("overhead_ratio")
            payloads.append(payload)
            for tid in payload.get("slow_trace_ids") or []:
                if tid not in slow_traces:
                    slow_traces.append(tid)
        member_reports.append(report)
    merged = contprof.merge_folded(payloads)
    out: Dict[str, Any] = {
        "slice": ("slow" if slow
                  else f"endpoint:{endpoint}" if endpoint else "all"),
        "members": member_reports,
        "merged_from": [r["name"] for r in member_reports if r["ok"]],
        "merged": merged,
    }
    if slow:
        out["slow_trace_ids"] = slow_traces
    return out


# -- fleet journal / anomaly federation ----------------------------------------

def _fetch_journal(member: Member, n: int, kind: Optional[str],
                   since: Optional[float], timeout: float
                   ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    from predictionio_torch.obs import journal as journal_mod

    if member.url is None:
        return journal_mod.JOURNAL.page(n=n, kind=kind, since=since), None
    params = [f"n={int(n)}"]
    if kind:
        from urllib.parse import quote

        params.append(f"kind={quote(kind, safe='')}")
    if since is not None:
        params.append(f"since={since}")
    url = f"{member.url}/admin/journal?" + "&".join(params)
    body, error = _fetch(url, timeout)
    if error is not None:
        return None, error
    try:
        return json.loads(body or b"{}"), None
    except ValueError as e:
        return None, f"unparseable journal payload: {e}"


def federate_journal(members: List[Member], n: int = 200,
                     kind: Optional[str] = None,
                     since: Optional[float] = None) -> Dict[str, Any]:
    """Member-merged ops journal (``GET /admin/fleet/journal``): every
    member's ring page annotated with its member name and merged into
    ONE wall-clock-ordered stream — "what changed across the fleet,
    in order" — with the newest ``n`` kept after the merge. Threaded
    replicas share one process journal, so identical events (same
    ts/mono/kind) dedupe to the first member that reported them. A
    dead member degrades the merge, never fails it."""
    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    merged: List[Dict[str, Any]] = []
    seen: set = set()
    for member, payload, error in _fan_out(
            members,
            lambda m: _fetch_journal(m, n, kind, since, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            events = payload.get("events") or []
            kept = 0
            for event in events:
                key = (event.get("ts"), event.get("mono"),
                       event.get("kind"), event.get("trace"))
                if key in seen:
                    continue
                seen.add(key)
                event = dict(event)
                event["fleet_member"] = member.name
                merged.append(event)
                kept += 1
            report["events"] = kept
            report["dropped_total"] = payload.get("dropped_total")
        member_reports.append(report)
    merged.sort(key=lambda e: (e.get("ts") or 0.0))
    if n > 0:
        merged = merged[-n:]
    return {"members": member_reports,
            "merged_from": [r["name"] for r in member_reports if r["ok"]],
            "events": merged}


def _fetch_anomaly(member: Member, timeout: float
                   ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    from predictionio_torch.obs import anomaly as anomaly_mod

    if member.url is None:
        return anomaly_mod.SENTINEL.report(), None
    body, error = _fetch(f"{member.url}/admin/anomaly", timeout)
    if error is not None:
        return None, error
    try:
        return json.loads(body or b"{}"), None
    except ValueError as e:
        return None, f"unparseable anomaly payload: {e}"


def federate_anomaly(members: List[Member]) -> Dict[str, Any]:
    """Per-member regression-sentinel reports (``GET
    /admin/fleet/anomaly``) plus the union of active anomalies, each
    stamped with the member it fired on — a latency shift on ONE
    replica is a fleet regression, and the member stamp names the
    replica without grepping N sentinel reports. Dead members degrade
    the merge (their ``ok: false`` row still shows) so a sentinel
    check during a rolling restart stays answerable."""
    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    active: List[Dict[str, Any]] = []
    seen: set = set()
    for member, payload, error in _fan_out(
            members, lambda m: _fetch_anomaly(m, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            report["report"] = payload
            # the sentinel's page keys active verdicts by series name;
            # the fleet union flattens that into rows so one list names
            # every (member, series) pair
            block = payload.get("active") or {}
            for series, entry in sorted(block.items()):
                key = (member.name, series, entry.get("onset_ts"))
                if key in seen:
                    continue
                seen.add(key)
                entry = dict(entry)
                entry["series"] = series
                entry["fleet_member"] = member.name
                active.append(entry)
            report["active"] = len(block)
        member_reports.append(report)
    return {"members": member_reports,
            "merged_from": [r["name"] for r in member_reports if r["ok"]],
            "active": active,
            "any_active": bool(active)}


def _fetch_data(member: Member, timeout: float
                ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    from predictionio_torch.obs import dataobs as dataobs_mod

    if member.url is None:
        return dataobs_mod.DATAOBS.report(), None
    body, error = _fetch(f"{member.url}/admin/data", timeout)
    if error is not None:
        return None, error
    try:
        return json.loads(body or b"{}"), None
    except ValueError as e:
        return None, f"unparseable data payload: {e}"


def federate_data(members: List[Member]) -> Dict[str, Any]:
    """Per-member data-plane reports (``GET /admin/fleet/data``) plus
    fleet-merged headline numbers: counters sum, eps sums (each member
    ingests its own stream), skew and unknown-ratio take the fleet max
    (a hot key on ONE replica is a hot key), and schema changes union
    member-stamped. Dead members degrade the merge (their ``ok:
    false`` row still shows), never fail it."""
    timeout = collect_timeout()
    member_reports: List[Dict[str, Any]] = []
    totals = {"events_total": 0, "tail_events_total": 0,
              "bytes_total": 0, "eps": 0.0}
    skew = 0.0
    unknown = 0.0
    changes: List[Dict[str, Any]] = []
    breach_active: Dict[str, bool] = {}
    for member, payload, error in _fan_out(
            members, lambda m: _fetch_data(m, timeout)):
        report = {"name": member.name, "url": member.url,
                  "role": member.role, "ok": error is None}
        if error is not None:
            report["error"] = error
        else:
            report["report"] = payload
            for key in ("events_total", "tail_events_total",
                        "bytes_total"):
                totals[key] += int(payload.get(key) or 0)
            totals["eps"] += float(payload.get("eps") or 0.0)
            entities = payload.get("entities") or {}
            skew = max(skew, float(entities.get("skew") or 0.0))
            unknown = max(unknown,
                          float(payload.get("unknown_ratio") or 0.0))
            schema = payload.get("schema") or {}
            for change in schema.get("changes") or []:
                stamped = dict(change)
                stamped["fleet_member"] = member.name
                changes.append(stamped)
            for kind, on in (payload.get("breach_active") or {}).items():
                breach_active[kind] = breach_active.get(kind, False) or on
        member_reports.append(report)
    changes.sort(key=lambda c: (c.get("ts") or 0.0))
    totals["eps"] = round(totals["eps"], 3)
    return {"members": member_reports,
            "merged_from": [r["name"] for r in member_reports if r["ok"]],
            "totals": totals,
            "skew": round(skew, 4),
            "unknown_ratio": round(unknown, 4),
            "schema_changes": changes,
            "breach_active": breach_active}
