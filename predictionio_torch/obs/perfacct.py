"""Performance accounting: live MFU/roofline gauges, the data-path
ledger, and tail-latency attribution.

Port of ``predictionio_tpu/obs/perfacct.py``. The data-path ledger and
the tail attribution are copies; two things change:

  The cost basis is analytic. The JAX package reads
  ``Compiled.cost_analysis()`` first; a PyTorch step has no compiled
  program to ask, so every trainer passes the formulas the JAX package
  already falls back to: :func:`twotower_matmul_flops`, ALS's
  ``work_model`` (``ops/als.py``), and :func:`sessionrec_step_flops`
  for the session recommender (the tied ``[B, L, V]`` product and the
  encoder's matmuls, forward and backward).

  The peaks are the card's. ``PIO_PEAK_FLOPS`` / ``PIO_PEAK_HBM_BYTES``
  override; without them an H100 uses the rates that
  ``tools/device_time.py`` names (dense bf16 tensor cores, device
  memory), and any other device (another card, the CPU) has no peak:
  the MFU and roofline gauges stay unset and one log line says why. No
  peak is guessed.

The gauges keep the JAX names:

  pio_train_mfu{model=}           achieved FLOP/s over the card's peak
  pio_step_flops{model=}          FLOPs per step (cost basis)
  pio_step_bytes{model=}          device-memory bytes per step (when known)
  pio_roofline_position{model=}   operational intensity / ridge point
  pio_datapath_stage_seconds{stage=}, pio_model_staleness_seconds
                                  the data-path ledger (:data:`LEDGER`)

Importing this module imports no torch: the card's name is read only
when a peak is asked for, and only from a process that already holds
torch.
"""

from __future__ import annotations

import collections
import logging
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from predictionio_torch.obs import flight, metrics

log = logging.getLogger(__name__)

_unknown_logged: set = set()


def device_name(device: Any = None) -> Optional[str]:
    """The name of ``device`` (default: the current card) when torch is
    loaded and the device is a CUDA card, else None. Never initialises
    CUDA in a process that has not touched it."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    if device is None and not torch.cuda.is_initialized():
        return None
    return torch.cuda.get_device_name(device)


def _card_peaks(device: Any) -> Tuple[Optional[float], Optional[float]]:
    """(dense bf16 FLOP/s, memory bytes/s) of ``device``: an H100's from
    ``tools/device_time.py``; (None, None) elsewhere, logged once."""
    name = device_name(device)
    if name is not None and "H100" in name:
        from predictionio_torch.tools import device_time

        return device_time.BF16_FLOPS, device_time.HBM_BYTES_PER_S
    why = (f"no peak rates known for {name!r}" if name is not None
           else "not on a CUDA card")
    if why not in _unknown_logged:
        _unknown_logged.add(why)
        log.info("MFU/roofline gauges stay unset: %s (set PIO_PEAK_FLOPS "
                 "and PIO_PEAK_HBM_BYTES to account against it)", why)
    return None, None


def _env_peak(name: str) -> Optional[float]:
    value = metrics.env_float(name, -1.0)
    return value if value > 0.0 else None


def peak_flops(device: Any = None) -> Optional[float]:
    """The accounting FLOP/s peak: ``PIO_PEAK_FLOPS``, else the card's
    dense bf16 rate where the card is known, else None."""
    return _env_peak("PIO_PEAK_FLOPS") or _card_peaks(device)[0]


def peak_hbm_bytes(device: Any = None) -> Optional[float]:
    """The accounting memory rate: ``PIO_PEAK_HBM_BYTES``, else the
    card's where it is known, else None."""
    return _env_peak("PIO_PEAK_HBM_BYTES") or _card_peaks(device)[1]


def mfu(flops: float, seconds: float,
        peak: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over ``peak`` (default
    :func:`peak_flops`); None when no peak is known."""
    peak = peak_flops() if peak is None else peak
    if peak is None:
        return None
    if seconds <= 0.0:
        return 0.0
    return flops / seconds / peak


def twotower_matmul_flops(batch: int, dim: int,
                          tail_widths: Sequence[int]) -> float:
    """Analytic matmul FLOPs per two-tower training step (fwd + bwd):
    the [B, B] logits einsum and its two rank-D backward products, plus
    the tail MLP matmuls — moved here from bench.py so the live MFU
    gauge and the bench capture can never drift apart. The optimizer's
    elementwise work deliberately does not count."""
    B, D = float(batch), float(dim)
    flops = 3 * 2.0 * B * B * D          # logits fwd + dL/du + dL/dv
    per_row = sum(2.0 * a * b
                  for a, b in zip(tail_widths[:-1], tail_widths[1:]))
    flops += 2 * 3 * per_row * B         # two towers, fwd+bwd(x2)
    return flops


def sessionrec_step_flops(batch: int, max_len: int, vocab: int,
                          dim: int, layers: int, heads: int,
                          ffn_mult: int) -> float:
    """Analytic matmul FLOPs per session-recommender training step
    (forward + backward, each counted as 3x the forward): the tied
    ``[B, L, V]`` product ``2*B*L*V*dim``, plus per encoder block the
    fused QKV and output projections, the causal attention's two
    ``[L, L]`` products (the full square, as the reference attention
    computes it) and the feed-forward pair. Layer norms, softmax and the
    optimizer do not count."""
    B, L, V, d = float(batch), float(max_len), float(vocab), float(dim)
    inner = float(heads * (dim // heads))
    per_block = (2.0 * B * L * d * 3.0 * inner      # fused QKV
                 + 2.0 * 2.0 * B * L * L * inner     # QK^T and PV
                 + 2.0 * B * L * inner * d           # output projection
                 + 2.0 * 2.0 * B * L * d * d * ffn_mult)  # FFN in/out
    return 3.0 * (2.0 * B * L * V * d + layers * per_block)


# -- gauges -------------------------------------------------------------------

_TRAIN_MFU = metrics.gauge(
    "pio_train_mfu",
    "Model FLOPs utilization of the last observed training step: "
    "achieved FLOP/s over the card's peak (PIO_PEAK_FLOPS, default the "
    "card's dense bf16 rate where it is known)",
    ("model",),
)
_STEP_FLOPS = metrics.gauge(
    "pio_step_flops",
    "FLOPs per training step (the analytic formula of the trainer)",
    ("model",),
)
_STEP_BYTES = metrics.gauge(
    "pio_step_bytes",
    "Device-memory bytes accessed per training step where the cost "
    "basis reports them (0 = unknown)",
    ("model",),
)
_ROOFLINE_POSITION = metrics.gauge(
    "pio_roofline_position",
    "Operational intensity of the step over the card's ridge point "
    "(peak FLOPs / peak memory bytes): > 1 compute-bound, < 1 "
    "memory-bound (only set when the byte cost and both peaks are "
    "known)",
    ("model",),
)
_MODEL_STALENESS = metrics.gauge(
    "pio_model_staleness_seconds",
    "Seconds the oldest ingested event not yet reflected in the "
    "servable model has been waiting (0 when the model covers every "
    "ingested event)",
)
_DATAPATH_STAGE_SECONDS = metrics.gauge(
    "pio_datapath_stage_seconds",
    "Wall seconds the current/last training run spent per "
    "events->model pipeline stage (read / prepare / bin / transfer / "
    "fit / train / bin_cache_load / bin_cache_save / compile). The "
    "zero-copy lane reports read = the native scan share, bin = the "
    "native resolve+plan+fill share, transfer = the host->device wire "
    "window (put dispatch -> confirmed resident)",
    ("stage",),
)


class StepAccountant:
    """Per-model step cost + the gauge updates for each observed step.

    Built once per trainer (the cost basis is shape-stable across
    steps); ``observe(seconds, steps=n)`` after a timed stretch of work
    that ended on the host refreshes the MFU gauge from ``steps``
    steps' worth of the basis over the measured wall time. ``device``
    is where the steps run: its peaks are the denominators, and a
    device without known peaks leaves MFU and roofline unset.
    """

    def __init__(self, model: str, flops_per_step: float,
                 bytes_per_step: float = 0.0, source: str = "analytic",
                 device: Any = None):
        self.model = model
        self.flops_per_step = float(flops_per_step)
        self.bytes_per_step = float(bytes_per_step)
        self.source = source
        self.peak_flops = peak_flops(device)
        self.peak_hbm_bytes = peak_hbm_bytes(device)
        self.last_mfu: Optional[float] = None
        _STEP_FLOPS.labels(model).set(self.flops_per_step)
        _STEP_BYTES.labels(model).set(self.bytes_per_step)
        if (self.bytes_per_step > 0.0 and self.peak_flops is not None
                and self.peak_hbm_bytes is not None):
            intensity = self.flops_per_step / self.bytes_per_step
            ridge = self.peak_flops / self.peak_hbm_bytes
            _ROOFLINE_POSITION.labels(model).set(intensity / ridge)

    def observe(self, seconds: float, steps: int = 1) -> Optional[float]:
        """Record one timed stretch covering ``steps`` steps; returns
        (and gauges) the resulting MFU, or None without a peak."""
        if self.peak_flops is None:
            return None
        self.last_mfu = mfu(self.flops_per_step * steps, seconds,
                            peak=self.peak_flops)
        _TRAIN_MFU.labels(self.model).set(self.last_mfu)
        return self.last_mfu


# -- data-path ledger ---------------------------------------------------------

#: completed/in-progress runs kept in the ledger snapshot
LEDGER_RUN_CAPACITY = 8


class DataPathLedger:
    """Stage wall-times per training run + the model-freshness clock.

    SCOPE: the clock is **per process**. It is exact wherever ingest
    and publish share a process (the bench, `pio train` after an
    import, single-process deployments, tier-1) and is the substrate
    the streaming path (ROADMAP item C) will build on; a split
    deployment (event server here, trainer there) sees only its own
    seams — item C moves the horizon into storage so every process
    reads the same clock. The gauge refreshes on every ingest/publish
    note AND on every timeline sample (the staleness collector calls
    :meth:`staleness_seconds`), so a scraped value is at most one
    sample interval stale while any server is being watched.

    Freshness bookkeeping (all wall-clock receipt times, not event
    times — the operator question is "how long are events waiting",
    not "how old is the data"):

      note_ingest      an event (batch) landed in the store
      note_train_read  a training read finished: the model being built
                       will reflect everything ingested up to now
      note_publish     that model became servable — the horizon the
                       last training read captured is now live

    ``staleness_seconds`` = now - (oldest ingest past the servable
    horizon). Events arriving DURING a train are conservatively dated
    at the publish horizon (the ledger tracks boundaries, not every
    event timestamp).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._runs: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=LEDGER_RUN_CAPACITY)
        self._current: Optional[Dict[str, Any]] = None
        self._last_ingest: Optional[float] = None
        self._first_unreflected: Optional[float] = None
        self._pending_horizon: Optional[float] = None
        self._model_horizon: Optional[float] = None

    # -- per-run stage timings ---------------------------------------------
    def start_run(self, run_id: str) -> None:
        with self._lock:
            self._start_run_locked(run_id)
        # the gauge describes the CURRENT run: stages the new run never
        # executes (a warm run skipping compile) must not keep exporting
        # the previous run's seconds; history lives in snapshot().runs
        _DATAPATH_STAGE_SECONDS.reset()

    def note_stage(self, stage: str, seconds: float) -> None:
        """Attribute ``seconds`` to ``stage`` of the current run
        (additive — bin-cache loads can happen per side). Stages noted
        outside any run land in an implicit one, so ad-hoc trainer use
        (tests, notebooks) still shows up."""
        with self._lock:
            if self._current is None:
                self._start_run_locked("adhoc")
            stages = self._current["stages"]
            total = round(stages.get(stage, 0.0) + seconds, 4)
            stages[stage] = total
        _DATAPATH_STAGE_SECONDS.labels(stage).set(total)

    def _start_run_locked(self, run_id: str) -> None:
        # caller holds the lock
        run = {"run": run_id, "start_unix": round(time.time(), 3),
               "stages": {}}
        self._current = run
        self._runs.append(run)

    # -- freshness ----------------------------------------------------------
    def note_ingest(self, ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            self._last_ingest = ts
            if self._first_unreflected is None:
                self._first_unreflected = ts
        self._refresh_staleness()

    def note_train_read(self, ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            # the model being built covers everything ingested so far
            self._pending_horizon = (
                self._last_ingest if self._last_ingest is not None else ts)

    def note_publish(self, ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        with self._lock:
            horizon = (self._pending_horizon
                       if self._pending_horizon is not None else ts)
            self._model_horizon = horizon
            self._pending_horizon = None
            if self._first_unreflected is not None:
                if (self._last_ingest is None
                        or self._last_ingest <= horizon):
                    self._first_unreflected = None
                elif self._first_unreflected <= horizon:
                    # events landed during the train: they have waited
                    # at most since the horizon (boundary approximation)
                    self._first_unreflected = horizon
        self._refresh_staleness()

    def staleness_seconds(self, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        with self._lock:
            first = self._first_unreflected
        value = 0.0 if first is None else max(0.0, now - first)  # graftlint: disable=JT15 — staleness spans processes: ingest horizons are wall timestamps serialized with the log, and tests drive synthetic ts/now clocks through the same arithmetic
        _MODEL_STALENESS.set(value)
        return value

    def _refresh_staleness(self) -> None:
        self.staleness_seconds()

    # -- reading ------------------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        staleness = self.staleness_seconds(now)
        with self._lock:
            runs = [dict(r, stages=dict(r["stages"])) for r in self._runs]
            last_ingest = self._last_ingest
            horizon = self._model_horizon
        return {
            "staleness_seconds": round(staleness, 3),
            "last_ingest_unix": (round(last_ingest, 3)
                                 if last_ingest is not None else None),
            "model_horizon_unix": (round(horizon, 3)
                                   if horizon is not None else None),
            "runs": runs,
        }

    def clear(self) -> None:
        with self._lock:
            self._runs.clear()
            self._current = None
            self._last_ingest = None
            self._first_unreflected = None
            self._pending_horizon = None
            self._model_horizon = None
        _MODEL_STALENESS.set(0.0)
        _DATAPATH_STAGE_SECONDS.reset()


#: the process-global ledger every seam records into
LEDGER = DataPathLedger()


def note_ingest(ts: Optional[float] = None) -> None:
    """Module-level ingest hook (the storage writers and event server
    call this once per accepted event batch)."""
    LEDGER.note_ingest(ts)


# -- tail-latency attribution --------------------------------------------------

#: minimum sealed records for a meaningful tail split
MIN_TAIL_RECORDS = 4


def _stage_shares(records: List[Dict[str, Any]]) -> Tuple[
        Dict[str, float], float]:
    """(stage -> summed ms, total ms) over a record cohort."""
    sums: Dict[str, float] = {}
    total = 0.0
    for r in records:
        for stage, ms in (r.get("stages") or {}).items():
            if isinstance(ms, (int, float)) and ms > 0:
                sums[stage] = sums.get(stage, 0.0) + float(ms)
        total += float(r.get("duration_ms") or 0.0)
    return sums, total


def tail_report(records: Optional[List[Dict[str, Any]]] = None,
                q: float = 0.95) -> Dict[str, Any]:
    """Where does the time of above-p``q`` requests go, stage by stage,
    and how does that differ from the median request?

    For both cohorts — the tail (duration >= the q-quantile) and the
    median half (duration <= p50) — each stage's share of the cohort's
    total request time is reported; ``delta_share`` (tail - median) is
    the attribution answer: the stage whose share GROWS in the tail is
    what the p99 is made of. Shares are never negative (flight clamps
    the unattributed remainder at 0), and the named stages plus
    ``unattributed`` sum to ~1 by the recorder's construction."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile {q} outside (0, 1)")
    if records is None:
        records = flight.RECORDER.records()
    timed = [r for r in records
             if isinstance(r.get("duration_ms"), (int, float))]
    out: Dict[str, Any] = {"quantile": q, "total_count": len(timed)}
    if len(timed) < MIN_TAIL_RECORDS:
        out.update({"tail_count": 0, "stages": {},
                    "note": f"need >= {MIN_TAIL_RECORDS} recorded "
                            "requests for a tail split"})
        return out
    durations = sorted(r["duration_ms"] for r in timed)
    threshold = durations[min(len(durations) - 1,
                              int(len(durations) * q))]
    p50 = durations[len(durations) // 2]
    tail = [r for r in timed if r["duration_ms"] >= threshold]
    median = [r for r in timed if r["duration_ms"] <= p50]
    tail_sums, tail_total = _stage_shares(tail)
    med_sums, med_total = _stage_shares(median)
    stages: Dict[str, Dict[str, float]] = {}
    for stage in sorted(set(tail_sums) | set(med_sums)):
        t_share = (tail_sums.get(stage, 0.0) / tail_total
                   if tail_total > 0 else 0.0)
        m_share = (med_sums.get(stage, 0.0) / med_total
                   if med_total > 0 else 0.0)
        stages[stage] = {
            "tail_ms_total": round(tail_sums.get(stage, 0.0), 3),
            "tail_share": round(t_share, 4),
            "median_share": round(m_share, 4),
            "delta_share": round(t_share - m_share, 4),
        }
    unattributed = stages.get("unattributed", {}).get("tail_share", 0.0)
    named = {s: v for s, v in stages.items() if s != "unattributed"}
    top = max(named, key=lambda s: named[s]["tail_share"]) if named else None
    out.update({
        "threshold_ms": round(threshold, 3),
        "p50_ms": round(p50, 3),
        "tail_count": len(tail),
        "stages": stages,
        "attributed_tail_share": round(max(0.0, 1.0 - unattributed), 4),
        "dominant_tail_stage": top,
    })
    return out
