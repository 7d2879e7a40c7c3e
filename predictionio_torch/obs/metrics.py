"""Metrics core: labeled Counter / Gauge / Histogram in one registry.

Copy of ``predictionio_tpu/obs/metrics.py``: the same operations give
byte-equal exposition text in both packages. What follows is the JAX
module's account (its ``obs/jaxmon.py`` is the port's
``obs/torchmon.py``).

The reference's only operational numbers are the event server's hourly
Stats buckets and the engine server's request count/average
(Stats.scala:48, CreateServer.scala:552-559) — nothing an operator can
alert on, nothing cross-server. This module is the first-party
replacement: every server, the storage client and the JAX runtime hooks
(obs/jaxmon.py) record into one process-global Registry, exposed in
Prometheus text format at ``GET /metrics`` on every HTTP server
(serving/http.py) and via ``pio metrics``.

Design constraints:

  - stdlib only (no prometheus_client — the container pins its deps);
    the text exposition format is small and stable, so first-party is
    cheaper than a dependency
  - thread-safe: serving handler threads, the micro-batch worker and
    training loops all record concurrently; one lock per metric family
    (children share it — label lookup and value update are a few ns
    next to an HTTP round-trip)
  - re-import friendly: creating a family with a name that already
    exists returns the existing family (same type + labels required),
    so module reloads and test re-imports never double-register
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def env_float(name: str, default: float) -> float:
    """A float env knob, falling back on unset OR unparseable values —
    a typo'd threshold must degrade to the default, never crash a
    probe/pusher/monitor (shared by the obs modules)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    """Integer twin of :func:`env_float`."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default

#: serving-latency oriented default histogram buckets (seconds): the
#: north-star budget is p50 < 10ms, so sub-ms resolution at the bottom,
#: compile-scale tails (tens of seconds) at the top.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.0075, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Child:
    """One labeled time series; shares its family's lock."""

    def __init__(self, family: "MetricFamily"):
        self._lock = family._lock


class CounterChild(_Child):
    def __init__(self, family: "MetricFamily"):
        super().__init__(family)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class GaugeChild(_Child):
    def __init__(self, family: "MetricFamily"):
        super().__init__(family)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class HistogramChild(_Child):
    def __init__(self, family: "Histogram"):
        super().__init__(family)
        self._bounds = family.buckets
        self._counts = [0] * (len(self._bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        # last exemplar per bucket index: (labels, value, unix_ts) —
        # OpenMetrics exposition attaches these to _bucket lines so a
        # collector can jump from a latency bucket to the trace that
        # landed in it
        self._exemplars: Dict[int, Tuple[Dict[str, str], float, float]] = {}

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    break
            else:
                i = len(self._bounds)
                self._counts[-1] += 1
            if exemplar:
                self._exemplars[i] = (dict(exemplar), value, time.time())

    def exemplars(self) -> Dict[int, Tuple[Dict[str, str], float, float]]:
        """Bucket index -> (labels, observed value, unix ts) — the last
        exemplar-bearing observation per bucket."""
        with self._lock:
            return dict(self._exemplars)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Tuple[int, float]:
        """(count, sum) read atomically — an average computed from two
        separate property reads can pair a newer sum with an older
        count under concurrent observes."""
        with self._lock:
            return self._count, self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper bound, cumulative count) pairs, ending at +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, c in zip(list(self._bounds) + [math.inf], counts):
            running += c
            out.append((bound, running))
        return out

    def quantile(self, q: float) -> float:
        """Approximate quantile by linear interpolation inside the
        bucket that crosses rank q — the standard Prometheus
        ``histogram_quantile`` estimate, so the status page and a
        PromQL dashboard agree by construction."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return 0.0
        rank = q * total
        lower = 0.0
        for (bound, running), prev in zip(cum, [0] + [c for _, c in cum]):
            if running >= rank:
                if bound == math.inf:
                    return lower  # open-ended tail: best effort
                span = running - prev
                frac = (rank - prev) / span if span else 1.0
                return lower + (bound - lower) * frac
            lower = bound
        return lower


class MetricFamily:
    """Name + help + label names; children keyed by label values."""

    kind = "untyped"
    child_cls: type = _Child

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def children(self) -> List[Tuple[Tuple[str, ...], "_Child"]]:
        """A consistent snapshot of (label values, child) pairs — the
        public walk for consumers (health probes, SLO measurement,
        flight snapshots) that would otherwise reach into the family's
        private storage."""
        with self._lock:
            return list(self._children.items())

    def labels(self, *values, **kwargs):
        if kwargs:
            if values:
                raise ValueError("pass labels positionally or by name, not both")
            values = tuple(str(kwargs[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def _new_child(self):
        return self.child_cls(self)

    def _default_child(self):
        """The unlabeled series (valid only for label-less families)."""
        return self.labels()

    def reset(self) -> None:
        """Drop every child (tests; a restarted server's fresh stats)."""
        with self._lock:
            self._children.clear()

    def remove(self, *values) -> None:
        """Drop one labeled series (e.g. a re-created in-process server
        starting its stats from zero)."""
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    # -- value passthrough for label-less families -------------------------
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        self._default_child().observe(value, exemplar=exemplar)

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self):
        return self._default_child().value

    # -- exposition --------------------------------------------------------
    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            children = list(self._children.items())
        for values, child in sorted(children):
            lines.extend(self._render_child(values, child))
        return lines

    def _render_child(self, values, child) -> List[str]:
        return [f"{self.name}{_label_str(self.labelnames, values)} "
                f"{_fmt(child.value)}"]

    # -- OpenMetrics exposition --------------------------------------------
    def _om_name(self) -> str:
        """OpenMetrics metric-family name (counters drop the ``_total``
        suffix — it belongs to the sample, not the family)."""
        return self.name

    def render_openmetrics(self) -> List[str]:
        om = self._om_name()
        lines = [
            f"# HELP {om} {self.help}",
            f"# TYPE {om} {self.kind}",
        ]
        with self._lock:
            children = list(self._children.items())
        for values, child in sorted(children):
            lines.extend(self._render_child_openmetrics(values, child))
        return lines

    def _render_child_openmetrics(self, values, child) -> List[str]:
        return self._render_child(values, child)


class Counter(MetricFamily):
    kind = "counter"
    child_cls = CounterChild

    def _om_name(self) -> str:
        return self.name[:-6] if self.name.endswith("_total") else self.name

    def _render_child_openmetrics(self, values, child) -> List[str]:
        # OpenMetrics: the sample is <family>_total, whatever the
        # Prometheus-format name was — identical here by convention
        # (every counter in this tree is registered as *_total)
        return [f"{self._om_name()}_total"
                f"{_label_str(self.labelnames, values)} "
                f"{_fmt(child.value)}"]


class Gauge(MetricFamily):
    kind = "gauge"
    child_cls = GaugeChild


class Histogram(MetricFamily):
    kind = "histogram"
    child_cls = HistogramChild

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = tuple(b for b in bounds if b != math.inf)

    def _render_child(self, values, child: HistogramChild) -> List[str]:
        lines = []
        for bound, running in child.cumulative():
            labels = _label_str(
                self.labelnames + ("le",), tuple(values) + (_fmt(bound),)
            )
            lines.append(f"{self.name}_bucket{labels} {running}")
        base = _label_str(self.labelnames, values)
        lines.append(f"{self.name}_sum{base} {_fmt(child.sum)}")
        lines.append(f"{self.name}_count{base} {child.count}")
        return lines

    def _render_child_openmetrics(self, values,
                                  child: HistogramChild) -> List[str]:
        """Bucket lines carry exemplars: ``... 17 # {trace_id="ab..."}
        0.0042 1712345678.9`` — the OpenMetrics syntax a collector
        needs to jump from a bucket to the request that landed in it."""
        exemplars = child.exemplars()
        lines = []
        for i, (bound, running) in enumerate(child.cumulative()):
            labels = _label_str(
                self.labelnames + ("le",), tuple(values) + (_fmt(bound),)
            )
            line = f"{self.name}_bucket{labels} {running}"
            ex = exemplars.get(i)
            if ex is not None:
                ex_labels, ex_value, ex_ts = ex
                inner = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in sorted(ex_labels.items())
                )
                line += (f" # {{{inner}}} {_fmt(ex_value)} "
                         f"{round(ex_ts, 3)}")
            lines.append(line)
        base = _label_str(self.labelnames, values)
        lines.append(f"{self.name}_sum{base} {_fmt(child.sum)}")
        lines.append(f"{self.name}_count{base} {child.count}")
        return lines


class Registry:
    """Process-global metric index; renders the /metrics document."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if type(existing) is not cls or (
                    existing.labelnames != tuple(labelnames)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}"
                    )
                want = kwargs.get("buckets")
                if want is not None and existing.buckets != tuple(
                    sorted(float(b) for b in want if b != math.inf)
                ):
                    # a silently-different bucket layout would misbucket
                    # the second caller's observations with no symptom
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing.buckets}"
                    )
                return existing
            family = cls(name, help, labelnames, **kwargs)
            self._families[name] = family
            return family

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def collect(self) -> Iterable[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        """The full Prometheus text-format document (version 0.0.4)."""
        lines: List[str] = []
        for family in sorted(self.collect(), key=lambda f: f.name):
            lines.extend(family.render())
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """The OpenMetrics 1.0 document (served when a scraper sends
        ``Accept: application/openmetrics-text``): counter samples keep
        their ``_total`` suffix under a suffix-less family name,
        histogram buckets carry exemplars, and the document ends with
        the mandatory ``# EOF``."""
        lines: List[str] = []
        for family in sorted(self.collect(), key=lambda f: f.name):
            lines.extend(family.render_openmetrics())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Clear every family's children, keeping registrations (tests)."""
        for family in self.collect():
            family.reset()


#: the process-global registry every subsystem records into
REGISTRY = Registry()

#: Prometheus exposition content type for /metrics responses
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: OpenMetrics exposition content type (negotiated via Accept)
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def samples_dict(text: str) -> Dict[str, float]:
    """Parse a Prometheus text-format document into a flat
    ``{"name{labels}": value}`` mapping — the machine-readable shape
    ``pio metrics --json`` emits, identical whether the document came
    from the in-process registry or a server's ``GET /metrics``."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # OpenMetrics exemplars trail the sample after " # "; the
        # sample value is everything before that marker
        line = line.split(" # ", 1)[0].rstrip()
        name_part, _, value = line.rpartition(" ")
        if not name_part:
            continue
        try:
            out[name_part] = float(value)
        except ValueError:
            continue  # tolerate foreign exposition extensions
    return out


def counter(name: str, help: str, labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str, labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str, labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)
