"""The port's metrics, trace, flight and journal copies against the JAX
package's.

The same operations, drawn from one numpy seed, go into a fresh
registry of each package: both expositions (Prometheus text and
OpenMetrics with exemplars) must be byte-equal. Span, flight and
journal records must be equal too, under one injected clock: the JAX
modules read the ``time`` module, so each gets a fake in its place
(``monkeypatch``), while the port's recorder and journal take theirs
as ``clock=``; span ids come from a fake ``uuid`` in both.
"""

import itertools

import numpy as np
import pytest

from predictionio_tpu.obs import flight as jax_flight
from predictionio_tpu.obs import journal as jax_journal
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import trace as jax_trace
from predictionio_torch.obs import (collect, flight, health, journal, metrics,
                                    trace)

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401


class FakeClock:
    """``time``'s three clocks, advanced by hand."""

    def __init__(self, start: float = 1_700_000_000.0):
        self.now = start

    def time(self) -> float:
        return self.now

    def perf_counter(self) -> float:
        return self.now - 1_600_000_000.0

    def monotonic(self) -> float:
        return self.now - 1_650_000_000.0

    def sleep(self, seconds: float) -> None:
        self.now += seconds


class FakeUUID:
    """``uuid.uuid4()`` as a counter: the same ids in both packages."""

    def __init__(self):
        self._n = itertools.count(1)

    def uuid4(self):
        class _Id:
            hex = f"{next(self._n):016x}" * 2   # span ids: the first 16
        return _Id()


def _drive(mod, seed: int) -> str:
    """Seeded counter/gauge/histogram operations into a fresh registry
    of ``mod``; returns both expositions."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("pio_t_requests_total", "Requests", ("route", "status"))
    g = reg.gauge("pio_t_depth", "Depth")
    h = reg.histogram("pio_t_seconds", "Seconds", ("route",))
    h2 = reg.histogram("pio_t_bytes", "Bytes", buckets=(1, 10, 100, 1e3))
    routes = ["/q", "/e", 'we"ird\\route\n']
    for _ in range(200):
        op = rng.integers(5)
        route = routes[rng.integers(len(routes))]
        if op == 0:
            c.labels(route, str(200 + 100 * rng.integers(4))).inc(
                float(rng.integers(1, 4)))
        elif op == 1:
            g.set(float(rng.normal()) * 1e3)
        elif op == 2:
            g.inc(float(rng.random()))
        elif op == 3:
            h.labels(route).observe(float(rng.exponential(0.01)),
                                    exemplar={"trace_id": f"{rng.integers(1 << 30):x}"})
        else:
            h2.observe(float(rng.exponential(50.0)))
    g.dec(0.5)
    return reg.render() + "\n----\n" + reg.render_openmetrics()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_equal(monkeypatch, seed):
    monkeypatch.setattr(jax_metrics, "time", FakeClock())
    monkeypatch.setattr(metrics, "time", FakeClock())
    port_text = _drive(metrics, seed)
    assert port_text == _drive(jax_metrics, seed)
    assert "# EOF" in port_text and 'trace_id="' in port_text


def test_helpers_match():
    doc = _drive(jax_metrics, 5).split("\n----\n")[0]
    assert metrics.samples_dict(doc) == jax_metrics.samples_dict(doc)
    port_h = metrics.Registry().histogram("x", "x")
    jax_h = jax_metrics.Registry().histogram("x", "x")
    for v in np.random.default_rng(1).exponential(0.02, 300):
        port_h.observe(float(v))
        jax_h.observe(float(v))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert port_h.labels().quantile(q) == jax_h.labels().quantile(q)


def _spans(mod, monkeypatch, clock):
    monkeypatch.setattr(mod, "time", clock)
    monkeypatch.setattr(mod, "uuid", FakeUUID())
    mod.clear_recent()
    with mod.new_trace() as tid:
        with mod.span("serve.query", engine="e1"):
            clock.sleep(0.002)
            with mod.span("serve.dispatch", batch_size=1):
                clock.sleep(0.0035)
        with pytest.raises(ValueError):
            with mod.span("storage.find"):
                clock.sleep(0.001)
                raise ValueError("boom")
        headers = mod.traced_headers({"A": "b"})
    return tid, mod.recent_spans(trace_id=tid), headers


def test_spans_equal_under_one_clock(monkeypatch):
    port = _spans(trace, monkeypatch, FakeClock())
    assert port == _spans(jax_trace, monkeypatch, FakeClock())
    tid, spans, headers = port
    assert [s["name"] for s in spans] == ["serve.dispatch", "serve.query",
                                          "storage.find"]
    assert spans[0]["duration_ms"] == 3.5
    assert spans[2]["error"] == "ValueError: boom"
    assert headers == {"A": "b", trace.TRACE_HEADER: tid}
    # the trace document of this process: one root, its child, and the
    # failed span
    doc = collect.stitch_trace(tid, [collect.Member("local", None)])
    assert doc["span_count"] == 3 and doc["complete"]
    query = next(r for r in doc["roots"] if r["name"] == "serve.query")
    assert [c["name"] for c in query["children"]] == ["serve.dispatch"]
    assert query["children"][0]["edge_ms"] == 2.0


def _flight(rec, clock):
    k1 = rec.begin("t" * 32, "PIOEngineServer", "POST", "/queries.json")
    clock.sleep(0.001)
    rec.note_stage("parse", 0.0002, trace_id="t" * 32)
    rec.note_stage("dispatch", 0.0031, trace_id="t" * 32)
    rec.note_field("batch_size", 3, trace_id="t" * 32)
    clock.sleep(0.004)
    rec.finish(k1, 200)
    k2 = rec.begin("u" * 32, "PIOEventServer", "POST", "/events.json")
    rec.note_field("error", "StorageError: down", trace_id="u" * 32)
    clock.sleep(2.0)
    rec.finish(k2, 500)
    rec.record_payload("/queries.json", {"user": "u1"}, nbytes=15)
    return rec.dump(include_payloads=True)


def test_flight_records_equal_under_one_clock(monkeypatch):
    monkeypatch.delenv("PIO_FLIGHT_DIR", raising=False)
    monkeypatch.delenv("PIO_SLOW_MS", raising=False)
    monkeypatch.setenv("PIO_FLIGHT_PAYLOADS", "4")
    jax_clock = FakeClock()
    monkeypatch.setattr(jax_flight, "time", jax_clock)
    # an interval no fake step reaches: no registry snapshot, which
    # would read two different process registries
    jax_dump = _flight(jax_flight.FlightRecorder(
        capacity=8, snapshot_interval=1e12), jax_clock)
    port_clock = FakeClock()
    port_dump = _flight(flight.FlightRecorder(
        capacity=8, snapshot_interval=1e12, clock=port_clock), port_clock)
    assert port_dump == jax_dump
    ok, failed = port_dump["records"]
    assert ok["stages"] == {"parse": 0.2, "dispatch": 3.1,
                            "unattributed": 1.7}
    assert failed["slow"] and failed["error"] == "StorageError: down"


def _journal(j, clock):
    j.emit("reload", instance="i2", prev="i1", requested=None)
    clock.sleep(1.5)
    j.emit("patch", outcome="ok", applied=1)
    clock.sleep(0.25)
    j.emit("fold", outcome="rebased")
    page = j.page(n=2)
    # the process-wide drop counter: other tests in this process move it
    assert isinstance(page.pop("dropped_total"), float)
    return j.recent(), j.recent(kind="patch"), page


def test_journal_records_equal_under_one_clock(monkeypatch):
    monkeypatch.delenv("PIO_JOURNAL_PATH", raising=False)
    jax_clock = FakeClock()
    monkeypatch.setattr(jax_journal, "time", jax_clock)
    port_clock = FakeClock()
    got = _journal(journal.Journal(clock=port_clock), port_clock)
    assert got == _journal(jax_journal.Journal(), jax_clock)
    events = got[0]
    assert [e["kind"] for e in events] == ["reload", "patch", "fold"]
    assert events[1]["ts"] - events[0]["ts"] == 1.5
    assert "requested" not in events[0]


def test_journal_writer_is_joined_by_close(tmp_path, monkeypatch):
    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("PIO_JOURNAL_PATH", str(path))
    j = journal.Journal(clock=FakeClock())
    j.emit("reload", instance="a")
    j.emit("patch", outcome="ok")
    assert j.flush(timeout=10)
    writer = j._writer
    assert writer is not None and writer.is_alive()
    assert j.close(timeout=10)
    assert not writer.is_alive()
    events, corrupt = journal.read_back(str(path))
    assert corrupt == 0
    assert [e["kind"] for e in events] == ["reload", "patch"]
    assert events == jax_journal.read_back(str(path))[0]


def test_watchdog_fires_on_an_injected_clock():
    """No thread and no wait: the watchdog's own monitor fires when
    polled after the fake clock passes the deadline."""
    clock = FakeClock()
    family = metrics.REGISTRY.get("pio_watchdog_stall_total")
    before = family.labels("t-fake").value
    wd = health.Watchdog("t-fake", min_seconds=0.5, min_history=2,
                         factor=4.0, clock=clock)
    wd.record(0.1)
    assert wd.deadline_seconds() is None
    wd.record(0.3)
    assert wd.deadline_seconds() == 2.0       # max(0.5, median 0.2) x 4
    with wd.watch():
        clock.sleep(1.9)
        assert wd.poll() == 0
        clock.sleep(0.2)
        assert wd.poll() == 1
        assert wd.poll() == 0                 # once per armed window
    assert family.labels("t-fake").value - before == 1
    assert wd._monitor._thread is None
