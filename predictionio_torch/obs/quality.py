"""Model-quality observability: the numbers behind "is it still good?".

Copy of ``predictionio_tpu/obs/quality.py``. ``_live_topk_ids`` goes
through the port model's ``retrieval_index()`` (so ``topk_dot`` on a
card) or ``index/recall.py``'s brute force. The stream's
shadow-quality probe (``StreamUpdater.probe_quality``) feeds
:func:`drift_report`, pushes the drift to its patch targets and fires
the drift-band reload of ``pio stream --reload-url``.

The rest of ``obs/`` can say the system is fast (latency histograms)
and up (health probes, fleet gauges) but not whether the model it is
serving still answers like the model the last full retrain produced.
This module is the ONE place those quality numbers are computed, so the
drift gauges the ``pio stream`` daemon exports, the replay report
``GET /admin/quality`` serves and the ``pio canary`` verdict can never
disagree about the same underlying measurement:

  drift      :func:`drift_report` scores a LIVE (patched/folded) model
             against a :class:`ShadowRef` snapshot of the last
             full-retrain COMPLETED instance — recall@k-vs-retrain on
             sampled users (live answers judged against the shadow's
             brute-force top-k, ``index/recall.py``'s machinery),
             rmse drift of predicted scores on a held-out sampled
             slice (normalized by the shadow's score RMS so the band
             is dimensionless), and relative factor-norm drift —
             exported as ``pio_model_quality_*`` gauges with an
             SLO-style band (``PIO_QUALITY_DRIFT_BAND``): any metric
             outside the band is a breach.
  replay     :func:`compare_answers` diffs two serving answers per
             query (top-k overlap of item ids, score deltas); the
             replay harness (workflow/replay.py) aggregates it into
             the report this module stores.
  canary     :class:`QualityState` accumulates the router's paired
             baseline/canary samples and per-lane latency histograms
             (``pio_canary_request_seconds{lane}``) and renders the
             promote/rollback verdict: quality deltas gated through
             the replay differ's overlap, latency deltas gated through
             the same bucket→burn math the SLO monitor uses
             (obs/slo.py) against the serving-latency threshold.

``GET /admin/quality`` on every server serves :func:`QualityState.report`
of the process-global :data:`STATE`.

Config (all env, read per call so tests can monkeypatch):
  PIO_QUALITY_DRIFT_BAND     allowed drift before breach (default 0.10):
                             recall_vs_retrain may fall to 1 - band,
                             rmse_drift / factor_drift may rise to band
  PIO_QUALITY_SAMPLE         users sampled per drift probe (default 32)
  PIO_QUALITY_K              k for recall/overlap (default 10)
  PIO_CANARY_MIN_PAIRS       paired samples before a verdict (default 20)
  PIO_CANARY_OVERLAP_FLOOR   mean top-k overlap floor (default 0.5)
  PIO_CANARY_BURN_FACTOR     canary latency burn may exceed baseline by
                             this factor (default 2.0)
  PIO_CANARY_LATENCY_SLACK   absolute over-threshold-rate slack added on
                             top of the factor (default 0.02)
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_torch.obs import metrics

_RECALL = metrics.gauge(
    "pio_model_quality_recall_vs_retrain",
    "Recall@k of the live (patched) model's top-k against the shadow "
    "full-retrain reference on sampled users (worst across algorithms)",
)
_RMSE_DRIFT = metrics.gauge(
    "pio_model_quality_rmse_drift",
    "RMSE of live-vs-shadow predicted scores on a sampled held-out "
    "slice, normalized by the shadow scores' RMS (worst across "
    "algorithms)",
)
_FACTOR_DRIFT = metrics.gauge(
    "pio_model_quality_factor_drift",
    "Relative Frobenius-norm drift of the shared factor rows between "
    "the live model and the shadow reference (worst side, worst "
    "algorithm)",
)
_BREACHES = metrics.counter(
    "pio_model_quality_breaches_total",
    "Drift probes that landed outside PIO_QUALITY_DRIFT_BAND, by metric",
    ("metric",),
)
_RELOADS = metrics.counter(
    "pio_quality_reloads_total",
    "Rolling /reload lanes auto-triggered by a drift-band breach "
    "(exactly one per breach episode: the trigger latches until a new "
    "trained instance binds)",
)

#: per-lane serving latency while a canary is active — the router
#: observes every 2xx answer here tagged baseline/canary, and the
#: verdict's latency gate reads the buckets back through the same
#: bucket→burn math obs/slo.py uses (lane labels are bounded: 2)
CANARY_SECONDS = metrics.histogram(
    "pio_canary_request_seconds",
    "Router-observed serve time per lane while a canary is active",
    ("lane",),
)

LANE_BASELINE = "baseline"
LANE_CANARY = "canary"

#: paired-sample examples kept for the report (bounded)
_PAIR_EXAMPLES = 32


def drift_band() -> float:
    return metrics.env_float("PIO_QUALITY_DRIFT_BAND", 0.10)


def _sample_n() -> int:
    return max(1, metrics.env_int("PIO_QUALITY_SAMPLE", 32))


def _k() -> int:
    return max(1, metrics.env_int("PIO_QUALITY_K", 10))


class ShadowRef:
    """A frozen snapshot of a factor model's serving-relevant state —
    the reference the drift gauges score the live model against.

    Taken at stream bind time from the freshly loaded COMPLETED
    instance (before any fold touches it), so "drift" always means
    "distance from the last full retrain". Copies the factor tables
    (the live model mutates its own arrays copy-on-write, but the
    REFERENCES move) and the id→row maps as plain dicts.
    """

    def __init__(self, model: Any, instance_id: str = ""):
        self.instance_id = instance_id
        self.user_factors = np.array(model.user_factors, np.float32,
                                     copy=True)
        self.item_factors = np.array(model.item_factors, np.float32,
                                     copy=True)
        self.user_ids: Dict[str, int] = dict(model.user_ids)
        self.item_ids: Dict[str, int] = dict(model.item_ids)
        self._inv_items: Optional[Dict[int, str]] = None

    def inv_items(self) -> Dict[int, str]:
        if self._inv_items is None:
            self._inv_items = {row: iid for iid, row in self.item_ids.items()}
        return self._inv_items

    @staticmethod
    def supports(model: Any) -> bool:
        return (getattr(model, "user_factors", None) is not None
                and getattr(model, "item_factors", None) is not None
                and hasattr(model, "user_ids")
                and hasattr(model, "item_ids"))


def topk_overlap(got: Sequence[Any], want: Sequence[Any]) -> float:
    """Fraction of ``want`` that ``got`` retrieved — the replay differ's
    and the drift probe's shared overlap currency (1.0 when ``want`` is
    empty: nothing to miss)."""
    if not want:
        return 1.0
    want_set = set(want)
    return len(want_set & set(got)) / len(want_set)


def _live_topk_ids(model: Any, user_vecs: np.ndarray, k: int) -> List[List[str]]:
    """The live model's top-k item ids per query row: through its
    retrieval index when one is built/buildable (the same lane serving
    answers ride), else brute force over its item table. A model that
    serves from a card never takes the host lane: its index failing to
    build there (a device OOM) raises, as serving would."""
    from predictionio_torch.index.recall import brute_force_topk

    inv = model.item_ids.inverse() if hasattr(model.item_ids, "inverse") \
        else {row: iid for iid, row in dict(model.item_ids).items()}
    idx = None
    if hasattr(model, "retrieval_index"):
        try:
            idx = model.retrieval_index()
        except Exception:  # noqa: BLE001 — drift must still measure on
            # models whose index backend cannot build on the CPU (brute
            # force below is the last resort); on a card it must not
            # quietly move to the host
            if getattr(getattr(model, "device", None), "type",
                       None) == "cuda":
                raise
            idx = None
    if idx is not None:
        _, rows = idx.search(user_vecs, k)
    else:
        _, rows = brute_force_topk(model.item_factors, user_vecs, k)
    out: List[List[str]] = []
    n = int(np.asarray(model.item_factors).shape[0])
    for b in range(rows.shape[0]):
        got = [int(r) for r in rows[b] if 0 <= int(r) < n]
        out.append([inv[r] for r in got if r in inv])
    return out


def drift_report(model: Any, shadow: ShadowRef,
                 sample: Optional[int] = None, k: Optional[int] = None,
                 seed: int = 0xD81F7) -> Dict[str, Any]:
    """Score a live model against its shadow reference; returns the
    report dict WITHOUT touching gauges/state (callers aggregate across
    algorithms first — see :func:`publish_drift`).

      recall_vs_retrain  mean over sampled shared users of: fraction of
                         the shadow's brute-force top-k the live model's
                         top-k retrieved (item ids compared, so items
                         the fold added simply cannot match — honest:
                         they did not exist at the last retrain)
      rmse_drift         rmse(live - shadow predicted scores) over the
                         sampled users x a sampled shared-item slice,
                         normalized by the shadow scores' RMS
      factor_drift       max over sides of ||live - shadow||_F over the
                         shared rows / (||shadow||_F + eps)
    """
    from predictionio_torch.index.recall import brute_force_topk

    sample = _sample_n() if sample is None else sample
    k = _k() if k is None else k
    rng = np.random.default_rng(seed)
    shared_users = [u for u in shadow.user_ids if u in model.user_ids]
    shared_items = [i for i in shadow.item_ids if i in model.item_ids]
    report: Dict[str, Any] = {
        "shadow_instance": shadow.instance_id,
        "k": int(k),
        "shared_users": len(shared_users),
        "shared_items": len(shared_items),
    }
    if not shared_users or not shared_items:
        report.update({"recall_vs_retrain": None, "rmse_drift": None,
                       "factor_drift": None, "sampled_users": 0})
        return report
    picked = [shared_users[int(j)] for j in rng.choice(
        len(shared_users), min(sample, len(shared_users)), replace=False)]
    report["sampled_users"] = len(picked)

    # -- recall@k vs the shadow's brute-force truth --------------------------
    shadow_vecs = np.stack([shadow.user_factors[shadow.user_ids[u]]
                            for u in picked])
    kk = min(k, shadow.item_factors.shape[0])
    _, shadow_rows = brute_force_topk(shadow.item_factors, shadow_vecs, kk)
    inv_items = shadow.inv_items()
    shadow_ids = [[inv_items[int(r)] for r in shadow_rows[b]]
                  for b in range(len(picked))]
    live_vecs = np.stack([np.asarray(model.user_factors)[model.user_ids[u]]
                          for u in picked])
    live_ids = _live_topk_ids(model, live_vecs, kk)
    recalls = [topk_overlap(live_ids[b], shadow_ids[b])
               for b in range(len(picked))]
    report["recall_vs_retrain"] = round(float(np.mean(recalls)), 4)

    # -- rmse drift on a sampled held-out slice ------------------------------
    item_slice = [shared_items[int(j)] for j in rng.choice(
        len(shared_items), min(64, len(shared_items)), replace=False)]
    shadow_iv = np.stack([shadow.item_factors[shadow.item_ids[i]]
                          for i in item_slice])
    live_iv = np.stack([np.asarray(model.item_factors)[model.item_ids[i]]
                        for i in item_slice])
    shadow_scores = shadow_vecs @ shadow_iv.T
    live_scores = live_vecs @ live_iv.T
    rms = float(np.sqrt(np.mean(shadow_scores ** 2)))
    rmse = float(np.sqrt(np.mean((live_scores - shadow_scores) ** 2)))
    report["rmse_drift"] = round(rmse / max(rms, 1e-9), 4)

    # -- relative factor-norm drift over the shared rows ---------------------
    drifts = []
    for side_shadow, side_ids, side_live, live_ids_map in (
            (shadow.user_factors, shadow.user_ids, model.user_factors,
             model.user_ids),
            (shadow.item_factors, shadow.item_ids, model.item_factors,
             model.item_ids)):
        shared = [(row, live_ids_map[gid])
                  for gid, row in side_ids.items() if gid in live_ids_map]
        if not shared:
            continue
        ref_rows = side_shadow[[r for r, _ in shared]]
        live_rows = np.asarray(side_live)[[r for _, r in shared]]
        ref_norm = float(np.linalg.norm(ref_rows))
        drifts.append(float(np.linalg.norm(live_rows - ref_rows))
                      / max(ref_norm, 1e-9))
    report["factor_drift"] = round(max(drifts), 4) if drifts else None
    return report


def breached_metrics(report: Dict[str, Any],
                     band: Optional[float] = None) -> List[str]:
    """The drift metrics outside the band: recall may fall to
    ``1 - band``; the (dimensionless) rmse and factor drifts may rise
    to ``band``."""
    band = drift_band() if band is None else band
    out: List[str] = []
    recall = report.get("recall_vs_retrain")
    if recall is not None and recall < 1.0 - band:
        out.append("recall_vs_retrain")
    for name in ("rmse_drift", "factor_drift"):
        v = report.get(name)
        if v is not None and v > band:
            out.append(name)
    return out


def publish_drift(report: Dict[str, Any]) -> Dict[str, Any]:
    """Export one (already worst-case-aggregated) drift report to the
    gauges + the process-global state; stamps band/breach verdicts in.
    Returns the stamped report — what the caller (the stream daemon)
    acts on."""
    band = drift_band()
    report = dict(report)
    report["band"] = band
    report["breached"] = breached_metrics(report, band)
    report["ts"] = round(time.time(), 3)
    if report.get("recall_vs_retrain") is not None:
        _RECALL.set(report["recall_vs_retrain"])
    if report.get("rmse_drift") is not None:
        _RMSE_DRIFT.set(report["rmse_drift"])
    if report.get("factor_drift") is not None:
        _FACTOR_DRIFT.set(report["factor_drift"])
    for name in report["breached"]:
        _BREACHES.labels(name).inc()
    STATE.set_drift(report)
    return report


def note_auto_reload() -> None:
    _RELOADS.inc()


# -- answer diffing (the replay differ + the canary's paired samples) ---------

def ranked_items(answer: Any) -> Optional[List[Tuple[str, float]]]:
    """The (id, score) ranking inside a serving answer, or None when
    the answer carries no ranking (scalar regression/classification
    answers compare by value instead — see compare_answers)."""
    if not isinstance(answer, dict):
        return None
    scores = answer.get("itemScores")
    if not isinstance(scores, list):
        return None
    out: List[Tuple[str, float]] = []
    for entry in scores:
        if isinstance(entry, dict) and "item" in entry:
            try:
                out.append((str(entry["item"]),
                            float(entry.get("score", 0.0))))
            except (TypeError, ValueError):
                continue
    return out


def compare_answers(base: Any, cand: Any,
                    k: Optional[int] = None) -> Dict[str, float]:
    """Diff two serving answers for the SAME query: top-k overlap of
    item ids and the mean |score delta| over the shared ids. Non-ranked
    answers (a regression scalar, a classification label) degrade to
    exact-match overlap and absolute value delta."""
    k = _k() if k is None else k
    base_ranked, cand_ranked = ranked_items(base), ranked_items(cand)
    if base_ranked is None or cand_ranked is None:
        same = base == cand
        delta = 0.0
        if isinstance(base, dict) and isinstance(cand, dict):
            b, c = base.get("result"), cand.get("result")
            if isinstance(b, (int, float)) and isinstance(c, (int, float)):
                delta = abs(float(b) - float(c))
                same = math.isclose(float(b), float(c), rel_tol=1e-6,
                                    abs_tol=1e-9)
        return {"overlap": 1.0 if same else 0.0, "score_delta": delta}
    base_top = base_ranked[:k]
    cand_top = cand_ranked[:k]
    overlap = topk_overlap([i for i, _ in cand_top],
                           [i for i, _ in base_top])
    base_scores = dict(base_top)
    deltas = [abs(s - base_scores[i]) for i, s in cand_top
              if i in base_scores]
    return {
        "overlap": round(overlap, 4),
        "score_delta": round(float(np.mean(deltas)), 6) if deltas else 0.0,
    }


# -- canary verdict math -------------------------------------------------------

def _latency_good_total(lane: str, threshold_ms: float) -> Tuple[float, float]:
    """(good, total) for one canary lane from the shared histogram —
    the same tightest-covering-bucket math obs/slo.py applies, so the
    canary's latency gate and the SLO burn alerts agree by construction."""
    family = metrics.REGISTRY.get("pio_canary_request_seconds")
    if family is None:
        return 0.0, 0.0
    threshold = threshold_ms / 1e3
    for values, child in family.children():
        if values and values[0] == lane:
            good = 0.0
            for bound, running in child.cumulative():
                if bound >= threshold or bound == math.inf:
                    good = float(running)
                    break
            return good, float(child.count)
    return 0.0, 0.0


def latency_threshold_ms() -> float:
    """The serving-latency SLO threshold the canary gate reuses."""
    return metrics.env_float("PIO_SLO_LATENCY_MS", 100.0)


def canary_verdict(pairs: Dict[str, Any],
                   threshold_ms: Optional[float] = None) -> Dict[str, Any]:
    """The promote/rollback verdict from accumulated paired samples +
    the per-lane latency histograms.

    Quality gate (the replay differ's currency): mean top-k overlap of
    the canary's paired answers against the baseline's must be at or
    above ``PIO_CANARY_OVERLAP_FLOOR``, and paired canary errors must
    be rarer than 10% of pairs. Latency gate (the SLO burn math): with
    error = over-threshold answers, the canary lane's burn may exceed
    the baseline lane's by at most ``PIO_CANARY_BURN_FACTOR`` x plus
    ``PIO_CANARY_LATENCY_SLACK`` of absolute error-rate slack — an
    already-burning baseline never blames the canary for shared pain,
    and a clean baseline still allows the canary sampling noise.
    """
    threshold_ms = (latency_threshold_ms() if threshold_ms is None
                    else threshold_ms)
    min_pairs = metrics.env_int("PIO_CANARY_MIN_PAIRS", 20)
    overlap_floor = metrics.env_float("PIO_CANARY_OVERLAP_FLOOR", 0.5)
    burn_factor = metrics.env_float("PIO_CANARY_BURN_FACTOR", 2.0)
    slack = metrics.env_float("PIO_CANARY_LATENCY_SLACK", 0.02)
    budget = max(1e-9, 1.0
                 - metrics.env_float("PIO_SLO_LATENCY_OBJECTIVE", 0.99))

    base_good, base_total = _latency_good_total(LANE_BASELINE, threshold_ms)
    can_good, can_total = _latency_good_total(LANE_CANARY, threshold_ms)
    base_err = 0.0 if base_total == 0 else (base_total - base_good) / base_total
    can_err = 0.0 if can_total == 0 else (can_total - can_good) / can_total

    n = int(pairs.get("n", 0))
    mean_overlap = pairs.get("mean_overlap")
    pair_errors = int(pairs.get("errors", 0))
    reasons: List[str] = []
    verdict = "undecided"
    # enough pairs decide — even with ZERO canary-lane answers: a
    # candidate that errors on every request produces only pair_errors
    # and must reach the rollback verdict, not hide behind
    # "insufficient data" forever
    if n >= min_pairs and (can_total > 0 or pair_errors > 0):
        quality_ok = (mean_overlap is not None
                      and mean_overlap >= overlap_floor
                      and pair_errors <= max(1, n // 10))
        if not quality_ok:
            reasons.append(
                f"quality: mean overlap {mean_overlap} < floor "
                f"{overlap_floor:g}" if mean_overlap is not None
                and mean_overlap < overlap_floor else
                f"quality: {pair_errors} paired canary errors over {n} "
                "pairs")
        latency_ok = can_err <= base_err * burn_factor + slack
        if not latency_ok:
            reasons.append(
                f"latency: canary over-threshold rate {can_err:.3f} "
                f"(burn {can_err / budget:.1f}) vs baseline "
                f"{base_err:.3f} (burn {base_err / budget:.1f}) beyond "
                f"{burn_factor:g}x + {slack:g}")
        verdict = "promote" if (quality_ok and latency_ok) else "rollback"
    else:
        reasons.append(f"insufficient data: {n}/{min_pairs} pairs, "
                       f"{int(can_total)} canary answers")
    return {
        "verdict": verdict,
        "reasons": reasons,
        "pairs": n,
        "mean_overlap": mean_overlap,
        "pair_errors": pair_errors,
        "threshold_ms": threshold_ms,
        "latency": {
            "baseline": {"answers": int(base_total),
                         "over_threshold_rate": round(base_err, 4),
                         "burn": round(base_err / budget, 2)},
            "canary": {"answers": int(can_total),
                       "over_threshold_rate": round(can_err, 4),
                       "burn": round(can_err / budget, 2)},
        },
    }


class QualityState:
    """Process-global holder of the latest quality artifacts: drift
    report, replay report, canary progress + paired-sample
    accumulators. ``GET /admin/quality`` serves :meth:`report`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._drift: Optional[Dict[str, Any]] = None
        self._replay: Optional[Dict[str, Any]] = None
        self._canary: Optional[Dict[str, Any]] = None
        self._pairs_n = 0
        self._overlap_sum = 0.0
        self._worst_overlap: Optional[float] = None
        self._score_delta_sum = 0.0
        self._pair_errors = 0
        self._examples: "collections.deque" = collections.deque(
            maxlen=_PAIR_EXAMPLES)

    # -- drift / replay ------------------------------------------------------
    def set_drift(self, report: Dict[str, Any]) -> None:
        with self._lock:
            self._drift = report

    def set_replay(self, report: Dict[str, Any]) -> None:
        with self._lock:
            self._replay = report

    def drift(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._drift

    def replay(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._replay

    # -- canary lifecycle ----------------------------------------------------
    def canary_begin(self, replica: str, baseline_version: Optional[str],
                     candidate_version: Optional[str]) -> None:
        """Arm a fresh canary window: paired accumulators and the
        per-lane latency histogram children reset so the verdict reads
        only THIS canary's evidence."""
        family = metrics.REGISTRY.get("pio_canary_request_seconds")
        if family is not None:
            family.remove(LANE_BASELINE)
            family.remove(LANE_CANARY)
        with self._lock:
            self._canary = {
                "active": True,
                "replica": replica,
                "baseline_version": baseline_version,
                "candidate_version": candidate_version,
                "started_unix": round(time.time(), 3),
            }
            self._pairs_n = 0
            self._overlap_sum = 0.0
            self._worst_overlap = None
            self._score_delta_sum = 0.0
            self._pair_errors = 0
            self._examples.clear()

    def canary_end(self, outcome: str,
                   detail: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            if self._canary is not None:
                self._canary = {**self._canary, "active": False,
                                "outcome": outcome,
                                "finished_unix": round(time.time(), 3),
                                **(detail or {})}

    def canary(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._canary) if self._canary else None

    def add_paired(self, diff: Optional[Dict[str, float]],
                   error: Optional[str] = None,
                   example: Optional[Dict[str, Any]] = None) -> None:
        """One paired baseline/canary sample from the router: the
        answer diff, or the canary-side error that prevented one."""
        with self._lock:
            self._pairs_n += 1
            if error is not None:
                self._pair_errors += 1
            elif diff is not None:
                overlap = float(diff.get("overlap", 0.0))
                self._overlap_sum += overlap
                self._score_delta_sum += float(diff.get("score_delta", 0.0))
                if (self._worst_overlap is None
                        or overlap < self._worst_overlap):
                    self._worst_overlap = overlap
            if example is not None:
                self._examples.append(example)

    def paired_stats(self) -> Dict[str, Any]:
        with self._lock:
            n = self._pairs_n
            diffed = n - self._pair_errors
            return {
                "n": n,
                "errors": self._pair_errors,
                "mean_overlap": (round(self._overlap_sum / diffed, 4)
                                 if diffed else None),
                "worst_overlap": self._worst_overlap,
                "mean_score_delta": (round(self._score_delta_sum / diffed, 6)
                                     if diffed else None),
                "examples": list(self._examples),
            }

    def canary_verdict(self) -> Dict[str, Any]:
        return canary_verdict(self.paired_stats())

    # -- the /admin/quality payload ------------------------------------------
    def report(self) -> Dict[str, Any]:
        # the per-query replay examples carry RAW captured payloads —
        # user data under the same contract /admin/flight enforces.
        # This surface serves aggregates; the full per-query diff stays
        # with whoever ran `pio replay` (paired canary examples are
        # stripped below for the same reason).
        replay = self.replay()
        if isinstance(replay, dict) and "queries" in replay:
            replay = {k: v for k, v in replay.items() if k != "queries"}
        canary = self.canary()
        entry: Dict[str, Any] = {
            "band": drift_band(),
            "drift": self.drift(),
            "replay": replay,
            "canary": None,
        }
        if canary is not None:
            pairs = self.paired_stats()
            pairs.pop("examples", None)
            entry["canary"] = {**canary, "paired": pairs,
                               **({"verdict": self.canary_verdict()}
                                  if canary.get("active") else {})}
        return entry

    def clear(self) -> None:
        with self._lock:
            self._drift = None
            self._replay = None
            self._canary = None
            self._pairs_n = 0
            self._overlap_sum = 0.0
            self._worst_overlap = None
            self._score_delta_sum = 0.0
            self._pair_errors = 0
            self._examples.clear()


#: the process-global quality state every server's /admin/quality reads
STATE = QualityState()
