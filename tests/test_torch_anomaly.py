"""The port's regression sentinel (``obs/anomaly.py``) against the JAX
package's.

``detect`` over seeded series (steps up and down, slow drifts, shifts
inside the deadband, too little history, single outliers) and
``attribute`` over one journal must give both packages' verdicts; a
sentinel scan over the same timeline rings and journal must start,
continue and resolve the same episodes; and the port's sentinel rides
the flight recorder's snapshot cadence after the timeline's listener.
"""

import collections

import numpy as np
import pytest

from predictionio_tpu.obs import anomaly as jax_anomaly
from predictionio_tpu.obs import journal as jax_journal
from predictionio_tpu.obs import timeline as jax_timeline
from predictionio_torch.obs import anomaly, flight, journal, timeline

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

BASE = [10.0 + (0.2 if i % 2 else -0.2) for i in range(24)]


def _series(seed: int):
    """Seeded rings: steps up and down, a slow ramp, a shift inside the
    deadband, a single outlier, short histories and noise."""
    rng = np.random.default_rng(seed)
    out = [BASE + [10.0] * 6 + [15.0] * 6, BASE + [10.0] * 6 + [5.0] * 6,
           BASE + [10.0 + 0.05 * k for k in range(12)],
           BASE + [10.1] * 12, BASE + [10.0] * 11 + [500.0],
           [10.0] * 10, [10.0] * 24 + [15.0] * 6]
    for _ in range(12):
        n = int(rng.integers(8, 60))
        level = float(rng.uniform(0.5, 50.0))
        vals = level + rng.normal(0, level * 0.02, n)
        cut = int(rng.integers(0, n))
        vals[cut:] *= float(rng.choice([1.0, 1.5, 0.6]))
        out.append(vals.tolist())
    return out


def _pts(vals, t0=1000.0, dt=15.0):
    return [(t0 + i * dt, float(v)) for i, v in enumerate(vals)]


CONFIGS = [{"direction": "up", "deadband": 0.10, "abs_deadband": 1.0},
           {"direction": "down", "deadband": 0.10, "abs_deadband": 1.0},
           {"direction": "both", "deadband": 0.02, "abs_deadband": 0.1}]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_gives_the_jax_verdicts(seed):
    verdicts = {"jax": [], "port": []}
    for vals in _series(seed):
        for cfg in CONFIGS:
            for z, h in ((3.0, 6.0), (10.0, 6.0)):
                for name, mod in (("jax", jax_anomaly), ("port", anomaly)):
                    verdicts[name].append(mod.detect(
                        _pts(vals), cfg=dict(cfg), z_threshold=z,
                        cusum_h=h, min_samples=12))
    assert verdicts["port"] == verdicts["jax"]
    assert any(v is not None for v in verdicts["port"])
    assert any(v is None for v in verdicts["port"])


def test_series_config_and_attribution_match_jax(monkeypatch):
    monkeypatch.setenv("PIO_ANOMALY_WINDOW_SEC", "30")
    names = ["quality.rmse_drift.eng", "quality.recall.eng",
             "serve_p99_ms.e", "data.eps", "prof.overhead", "mfu",
             "never_configured"]
    assert [anomaly.series_config(n) for n in names] == [
        jax_anomaly.series_config(n) for n in names]
    events = [{"ts": 960.0, "kind": "patch"},
              {"ts": 985.0, "kind": "reload", "instance": "i-2"},
              {"ts": 995.0, "kind": "breaker", "target": "t"},
              {"ts": 999.0, "kind": "anomaly", "series": "x"},
              {"ts": 1003.0, "kind": "swap"}]
    for onset in (950.0, 990.0, 1000.0, 1002.0, 1100.0):
        for window in (events, events[-2:], events[:1], []):
            assert anomaly.attribute(onset, window) == \
                jax_anomaly.attribute(onset, window)
    assert anomaly.attribute(1000.0, events)["kind"] == "breaker"


def _fill(tl, name, vals, t0=1000.0, dt=15.0):
    ring = tl._series.setdefault(name, collections.deque(maxlen=360))
    ring.clear()
    for i, v in enumerate(vals):
        ring.append((t0 + i * dt, float(v)))


def _lifecycle(mods, monkeypatch):
    anomaly_mod, journal_mod, timeline_mod = mods
    tl = timeline_mod.Timeline()
    monkeypatch.setattr(timeline_mod, "TIMELINE", tl)
    sentinel = anomaly_mod.Sentinel()
    series = "serve_p99_ms.eng"
    _fill(tl, series, BASE + [10.0] * 6 + [15.0] * 6)
    _fill(tl, "mfu", BASE + [10.0] * 6 + [4.0] * 6)
    journal_mod.JOURNAL.emit("reload", instance="i-9")
    journal_mod.JOURNAL._ring[-1]["ts"] = 1445.0
    out = []
    for now, refill in ((1540.0, None), (1555.0, None),
                        (1600.0, BASE + [10.0] * 12)):
        if refill is not None:
            _fill(tl, series, refill)
        report = sentinel.scan(now=now)
        report.pop("scan_ms")
        out.append(report)
    out.append([{k: v for k, v in e.items() if k not in ("ts", "mono")}
                for e in journal_mod.JOURNAL.recent()
                if e["kind"].startswith("anomaly")])
    return out


def test_the_sentinel_scans_like_jax(monkeypatch):
    monkeypatch.setenv("PIO_ANOMALY_WINDOW_SEC", "60")
    jax_journal.JOURNAL.reset()
    journal.JOURNAL.reset()
    try:
        jax = _lifecycle((jax_anomaly, jax_journal, jax_timeline),
                         monkeypatch)
        port = _lifecycle((anomaly, journal, timeline), monkeypatch)
    finally:
        jax_journal.JOURNAL.reset()
        journal.JOURNAL.reset()
    assert port == jax
    first, second, resolved, events = port
    assert first["active"]["serve_p99_ms.eng"]["cause"]["kind"] == "reload"
    assert second["active"]["serve_p99_ms.eng"]["since"] == 1540.0
    assert "serve_p99_ms.eng" not in resolved["active"]
    assert [e["kind"] for e in events].count("anomaly_resolved") == 1


def test_the_sentinel_rides_the_snapshot_cadence_after_the_timeline():
    names = [name for name, _ in flight._snapshot_listeners]
    assert "anomaly" in names and "timeline" in names
    assert names.index("timeline") < names.index("anomaly")
    report = anomaly.SENTINEL.report()
    assert set(report) == set(jax_anomaly.SENTINEL.report())
