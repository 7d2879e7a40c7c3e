"""`pio bench-compare`: per-metric deltas across the bench trajectory.

Copy of ``predictionio_tpu/tools/benchcmp.py`` (pure Python: the same
files give the same rows and exit codes through either package). What
follows is the JAX module's account.

Each bench round leaves one ``BENCH_r<NN>.json`` (the bench.py
headline record under ``parsed``: a named metric + a ``detail`` object
of numeric evidence). Regressions hide in that trajectory — a step-time
number drifting 15% over three rounds never trips any single run's
gate. This tool makes the drift visible at review time: it loads every
round, extracts the numeric metrics, and compares the newest round
against a baseline (the previous round by default), printing per-metric
deltas and exiting non-zero when any metric regressed beyond the
tolerance band.

Direction is inferred from the metric name: latency/time-shaped metrics
(``*_ms``, ``*_sec``, ``*latency*``) regress by going UP, everything
else (throughput, QPS, rates, MFU) regresses by going DOWN. Deltas
within the tolerance band (default 10%) are noise, beyond it they are
verdicts: REGRESSION (exit 1) or IMPROVED (exit 0, still printed —
an unexplained improvement is worth a look too).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

#: rate-shaped fragments where HIGHER is better — checked first so
#: ``*_per_sec_per_chip`` is not misread as a duration,
#: ``retrieval_qps_recall95`` is not misread via nothing at all, and
#: ``quality_recall_vs_retrain`` / replay ``overlap`` read as quality
#: floors (a drop IS the regression)
_HIGHER_BETTER = re.compile(r"(per_sec|_qps|qps$|throughput|mfu|"
                            r"_per_chip|hit|recall|overlap)")
#: metric-name fragments where a LOWER value is better —
#: ``canary_verdict_ms`` rides the ``_ms$`` tail, drift gauges the
#: ``drift`` fragment, and the device-memory plane's
#: ``model_hbm_bytes`` / ``train_peak_bytes`` the anchored ``_bytes$``
#: tail (resident bytes growing IS the regression the memacct keys
#: gate; the anchor stays — a bare ``bytes`` fragment would flip
#: direction on any future metric merely containing the word). The
#: ``overhead`` fragment gates the continuous profiler's cost
#: (``prof_overhead_pct``): the sampler rides every serving process,
#: so its growth taxes every request. The ``_us`` tails gate the
#: sentinel stage's ``journal_append_us`` — the journal emit rides
#: every breaker flip and canary verdict on the serving path, so
#: microsecond creep there is a real regression
_LOWER_BETTER = re.compile(r"(_ms$|_ms_|_us$|_us_|_sec$|_sec_|_seconds|"
                           r"latency|_bytes$|p50|p99|debt|rmse|drift|"
                           r"overhead)")

#: detail keys that are run configuration, not performance — a change
#: is reported as CONFIG-CHANGED (never a regression verdict: comparing
#: perf across different configs is the reader's call)
_CONFIG_KEYS = re.compile(r"^(n_|rank$|iterations$|epochs$|seed$|"
                          r"max_|batch)")


@dataclasses.dataclass
class Delta:
    metric: str
    base: float
    new: float
    pct: Optional[float]          # None when base == 0
    verdict: str                  # ok | regression | improved | config-changed

    def line(self) -> str:
        pct = "n/a" if self.pct is None else f"{self.pct:+.1f}%"
        return (f"{self.metric}: {self.base:g} -> {self.new:g} ({pct}) "
                f"{self.verdict.upper()}")


def load_metrics(path: str) -> Dict[str, float]:
    """The numeric metrics of one bench round: the headline
    ``{metric, value}`` pair plus every numeric scalar under
    ``parsed.detail`` (as ``detail.<key>``) and ``parsed.key`` (as
    ``key.<name>`` — the compact headline block real rounds carry, so
    ``twotower_mfu``, the serve percentiles and the data-path seconds
    all sit in the direction-aware gate set)."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    parsed = doc.get("parsed") or {}
    out: Dict[str, float] = {}
    name = parsed.get("metric")
    value = parsed.get("value")
    if name and isinstance(value, (int, float)) and not isinstance(
            value, bool):
        out[str(name)] = float(value)
    for block, prefix in ((parsed.get("detail"), "detail"),
                          (parsed.get("key"), "key")):
        if isinstance(block, dict):
            for key, v in block.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f"{prefix}.{key}"] = float(v)
    return out


def lower_is_better(metric: str) -> bool:
    if _HIGHER_BETTER.search(metric):
        return False
    return bool(_LOWER_BETTER.search(metric))


def is_config_key(metric: str) -> bool:
    leaf = metric.rsplit(".", 1)[-1]
    return bool(_CONFIG_KEYS.match(leaf))


def compare(base: Dict[str, float], new: Dict[str, float],
            tolerance_pct: float) -> List[Delta]:
    """Deltas for every metric present in BOTH rounds, worst first."""
    deltas: List[Delta] = []
    for metric in sorted(set(base) & set(new)):
        b, n = base[metric], new[metric]
        pct = None if b == 0 else (n - b) / abs(b) * 100.0
        if is_config_key(metric):
            verdict = "ok" if b == n else "config-changed"
        elif pct is None:
            verdict = "ok" if n == 0 else "config-changed"
        elif abs(pct) <= tolerance_pct:
            verdict = "ok"
        else:
            worse = pct > 0 if lower_is_better(metric) else pct < 0
            verdict = "regression" if worse else "improved"
        deltas.append(Delta(metric, b, n, pct, verdict))
    rank = {"regression": 0, "config-changed": 1, "improved": 2, "ok": 3}
    deltas.sort(key=lambda d: (rank[d.verdict],
                               -(abs(d.pct) if d.pct is not None else 0.0)))
    return deltas


def default_files(directory: str = ".") -> List[str]:
    return sorted(glob.glob(os.path.join(directory, "BENCH_r*.json")))


def run(files: List[str], tolerance_pct: float = 10.0,
        against: str = "prev", out=None) -> int:
    """Compare the newest round against the baseline; print the deltas;
    exit 1 on any REGRESSION beyond tolerance."""
    import sys

    out = out if out is not None else sys.stdout
    files = [f for f in files if os.path.isfile(f)]
    # a round whose headline failed to parse (empty ``parsed``) holds
    # no metrics — skip it when picking newest/baseline instead of
    # reporting a useless "no common metrics" against it
    rounds = [(f, load_metrics(f)) for f in files]
    skipped = [f for f, m in rounds if not m]
    for f in skipped:
        print(f"bench-compare: {os.path.basename(f)} has no extractable "
              "metrics; skipping", file=out)
    rounds = [(f, m) for f, m in rounds if m]
    if len(rounds) < 2:
        print("bench-compare: need at least two bench files with "
              f"extractable metrics (got {len(rounds)})", file=out)
        return 2
    newest, new_metrics = rounds[-1]
    baseline, base_metrics = (rounds[0] if against == "first"
                              else rounds[-2])
    common = set(base_metrics) & set(new_metrics)
    if not common:
        print(f"bench-compare: no common metrics between "
              f"{os.path.basename(baseline)} and "
              f"{os.path.basename(newest)}", file=out)
        return 2
    print(f"bench-compare: {os.path.basename(newest)} vs "
          f"{os.path.basename(baseline)} "
          f"(tolerance ±{tolerance_pct:g}%)", file=out)
    deltas = compare(base_metrics, new_metrics, tolerance_pct)
    regressions = 0
    for d in deltas:
        if d.verdict != "ok":
            print("  " + d.line(), file=out)
            regressions += d.verdict == "regression"
    within = sum(1 for d in deltas if d.verdict == "ok")
    print(f"  ({within} metric(s) within tolerance)", file=out)
    if regressions:
        print(f"bench-compare: {regressions} regression(s) beyond "
              f"{tolerance_pct:g}%", file=out)
        return 1
    print("bench-compare: no regressions beyond tolerance", file=out)
    return 0
