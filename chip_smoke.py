#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``predictionio_torch``) on one card.

    python3 chip_smoke.py

The quickest proof that the port starts on the GPU. It imports numpy,
torch and ``predictionio_torch`` only (no JAX, nothing of
``predictionio_tpu``), needs one CUDA card, and fails loudly: no phase
catches its own failure, and without CUDA or without the package it
exits non-zero before printing any result.

1. Build every kernel under ``predictionio_torch/ops/kernels/csrc/``
   with ``nvcc`` for sm_90a, one process per source, all started
   together.
2. Kernel phase: the ``topk_dot`` kernel against its plain version
   ``topk_dot_reference`` on the card, over I in {513, 26744, 66000},
   D in {32, 64, 128}, B in {1, 8, 64, 128}, k in {8, 16, 128},
   E in {1, 2, 4, 64} (2 and 4 are the serve path's item query with a
   blacklist and a bucketed user blacklist), plus duplicated item rows
   (exact ties), a whole tile of top candidates excluded, and two
   adversarial tables at three shapes each: rows whose scores rise
   along the table (every block's buffer fills and it sorts again and
   again) and every row identical (all ties: ids 0..k-1). Scores
   must agree within
   1e-5 * |q| * max|item| (the kernel sums in another order than
   cuBLAS), on slots scoring above -1e29. Indices must be equal, except
   where the reference itself has two scores within that tolerance (a
   near-tie the summation order may flip): there the kernel's item must
   score within the tolerance of the reference's slot. 60 calls
   alternating over the serve (B=1, I=26744, D=64, k=16, E=1), catalog
   (B=1, I=1M, D=128, k=16, E=1) and widest (B=128, I=66000, D=128,
   k=128, E=64) shapes must each give their shape's first bits (the
   kernel's ticket counters reset), and at each of the three the
   profiler must trace exactly one device kernel and no memset per
   call (the traced counts go on the ``kernels`` line as
   ``traced_per_call``). Then the kernel, the plain version and one library call
   (``torch.matmul`` + ``torch.topk``) are timed at the serve and the
   catalog shape: ``ms`` is device time per call from
   ``torch.profiler`` (the serve table warm in L2 as in serving; the
   512 MB catalog never fits), ``cold_ms`` the same with L2 flushed
   before each call (the case the HBM bound ``bound_ms`` describes),
   ``call_ms`` the CUDA-event time per call of back-to-back calls (the
   host's issue time when that is longer), ``cold_event_ms`` the median
   CUDA-event time of one call after a flush. ``ptxas``'s registers and
   spills of the kernel go on the ``kernels`` line.
3. Serve phase, the port's main path: seeded MovieLens-20M-shaped
   factors (138,493 users, 26,744 items, rank 64) become an ALS model
   via ``als_model_from_arrays``; a COMPLETED engine instance and its
   blob go into a temporary localfs store through the port's storage;
   the port's ``EngineServer`` deploys it on ``cuda`` (127.0.0.1, port
   0) and answers lone sequential queries (users with and without a
   blacklist, items, a whitelist, an unknown user) and a concurrent
   burst of 64 user queries (the micro-batch path), and a user query
   whose k is outside the kernel's caps (the scorer's device route,
   which on a card never moves to the host). Every answer is
   checked against a float64 host computation under the same order
   (score descending, item id ascending); the kernel's launch counter,
   reset just before the deploy, must have risen by at least the number
   of lone user and item queries.

4. Two-tower kernel phase: the ``flash_ce`` kernels (the forward, and
   the backward kernel twice: du, then dv with the roles swapped)
   against their plain version ``flash_ce_reference`` over B in {128,
   130, 1000, 8192}, D in {8, 64, 128, 256}, cdt in {float32, bfloat16},
   uniform and real-valued weights, with in-batch duplicate users and
   items and a zero-weight tail; the loss within the JAX package's
   kernel-test tolerance (f32 rtol 1e-5, bf16 5e-3), both gradients
   within its tolerances (f32 rtol 1e-4 / atol 1e-6, bf16 1e-1 / 2e-3)
   and also within the same rtol with an atol scaled to the gradient's
   size (1e-4 / 2e-3 of max|ref|) and a relative norm error of at most
   1e-4 / 2e-2. At the train shape (B=8192, D=128) deliberately wrong
   gradients (zeros, rows shifted, scaled by 0.9, one tile zeroed) must
   fail that check, and two kernel calls there must give the same
   loss, du and dv bit for bit. The ``embed_update``
   kernel against ``embed_update_reference`` at (N, E, B, vocab) =
   (64, 24, 37, 64), (50, 8, 24, 6) (every row collides) and (1M, 128,
   8192, 1M), rtol 1e-5 / atol 1e-6. Both are timed at the train
   phase's shapes (B=8192, D=128, bf16; 8192 rows into a [1M, 128]
   table) against their plain versions and, for ``embed_update``, one
   ``index_add_`` (no single PyTorch call computes the flash-CE loss):
   device time from ``torch.profiler``, for ``embed_update`` with L2
   flushed before each call (``warm_ms`` beside it); for ``flash_ce``
   the forward and the backward kernel apart, and ``ptxas``'s registers
   and spills of each of its kernels.
5. Train phase, the second main path: the repo's stretch two-tower
   configuration (BASELINE.json configs[4], sized in bench.py: 1M
   users, 1M items, 4M positives synthesized as bench.py does from
   ``default_rng(1)``, dim 128, batch 8192, temperature 0.07, lr 3e-3,
   seed 11, bf16, 3 epochs) through ``TwoTowerAlgorithm.train``, with
   the launch counters reset just before: ``flash_ce`` must launch 3
   times and ``embed_update`` twice per step, losses must be finite and
   fall, vectors unit-norm. The model is serialized into a memory
   store, deployed with the port's ``EngineServer`` and asked user and
   item queries over the 1M-item catalog through ``topk_dot``, each
   checked against a float64 host top-k as in the serve phase. Then,
   off the counted path, 20 steps at the same widths are profiled:
   device time per step by kernel group and the device's idle share.
6. ALS train phase, the north star's main path: bench.py's synthetic
   MovieLens-20M ratings (``synthesize`` at ``DEFAULT_KNOBS``: 138,493
   users, 26,744 items, 20,000,000 ratings from ``default_rng(0)``),
   every 20th held out, bench's config (rank 64, 5 iterations, reg
   0.05, block 4096, the rest default: bf16 gather and Gramians, 6-step
   Jacobi CG in bf16). First an ``ALSTrainer`` on ``cuda``: host
   binning (the native one-pass route, ``ops/ragged.py``), the
   transfer, ``compile()`` (one warm alternation), then 5
   timed alternations; its held-out RMSE must land in bench's
   ``RMSE_BAND`` (0.38, 0.48); peak device memory; then, off the timed
   run, device time per alternation by stage (gather+Gramian,
   segment-sum, solve) from ``torch.profiler``, the launches and the
   device's idle share per alternation, and ``work_model`` bytes over
   device time as a share of the card's HBM rate
   (``tools/als_timing.py``). Then the main path, with the launch
   counters reset just before: ``ALSAlgorithm.train`` on ``cuda`` over
   the same prepared ratings (RMSE in the band again), the model stored
   in a memory store and deployed with the port's ``EngineServer``;
   user and item queries through ``topk_dot``, each checked against a
   float64 host top-k of the model's factors, and the kernel's counter
   must rise by at least the number of lone queries.
7. Ingest phase, the data lane of the same main path at bench.py's
   cold-stage width, uncut: the ALS phase's 20,000,000 ratings go into a
   port ``eventlog`` store under the temporary directory (which must
   have ``INGEST_DISK_BYTES`` free) by ``insert_columnar``; 100,000
   events of another name through the event server's JSON row lane
   (``insert_json_batch``); the template's binned request then makes
   one fused native scan+bin with bench's 5% holdout and ``_bench_cfg``'s
   layout knobs: ``n_rows`` plus the holdout must be every rating, and
   both sides must be byte-equal to ``build_compressed_side`` over the
   same split with the ids renumbered in the scan's first-seen order.
   ``ALSTrainer.from_sides`` on ``cuda``, ``compile()``, 5 timed
   alternations: RMSE in the band, the stage profile beside the ALS
   phase's. Then the main path, counters reset: ``ALSAlgorithm.train``
   on the template's binned request, cold (exactly one scan) and again
   on the unchanged events (a layout-cache hit, no scan), the model
   deployed and asked 20 queries through ``topk_dot``, each checked
   against a float64 host top-k. The log and the cache are removed at
   the end, pass or fail.
8. Front-door phase, the same main path from ``pio app new``, at the
   ALS phase's width, uncut: in a new temporary ``eventlog`` store
   (``INGEST_DISK_BYTES`` free), ``cli app new ml20m`` and ``cli
   accesskey new ml20m view``; the first 19,000,000 ratings in time
   order by ``insert_columnar`` (the bulk lane, as history), the store
   closed; ``cli eventserver`` then takes the last 1,000,000 as API
   ``rate`` events: 998,000 in ``/batch/events.json`` bodies of 10,000
   over 4 keep-alive connections (every status 201) and 2,000 lone
   ``POST /events.json`` (201 with an ``eventId``); the whitelisted
   key's batch of 990 ``view`` events (201) and 10 ``rate`` events
   (403); 20 ``GET /events.json`` reads that must list exactly that
   user's history and live events; ``/stats.json`` counts equal to
   what was sent. SIGTERM while a 10,000-event batch is in flight: the
   batch is answered and the server exits 0 within
   ``PIO_DRAIN_TIMEOUT``. ``cli train`` (bench's ALS knobs) must log
   the binned lane with one scan of exactly 20,000,000 ratings; ``cli
   deploy``'s 20 answers are checked against a float64 host top-k, and
   ``topk_dot``'s launches in its ``GET /`` rise by at least the lone
   queries; ``cli status`` exits 0. The batch route's per-event split
   (native lane, result loop and stats, JSON) is measured in process
   on a store of its own first. The store is removed at the end.
9. ``pio train`` phase: seeded rate events at MovieLens-100K's shape
   (943 users, 1,682 items, 100,000 ratings) go into a localfs event
   store through ``cli app new`` and ``cli import`` of a JSONL file,
   and ``cli export`` must give them back; ``python -m
   predictionio_torch.tools.cli train`` trains ``twotower_engine`` (dim
   64, batch 1024: flash_ce eligible) and ``... cli deploy`` serves it,
   then the same two commands train and serve ``recommendation_engine``
   (ALS, rank 16) over the same events, and again over the same events
   imported into an ``eventlog`` store, where ``cli train``'s log must
   show the binned lane; queries are checked against each stored
   model's factors.
10. Eval phase, the evaluation half (``pio eval``). (a) The ALS phase's
   ratings and holdout as ``PreparedRatings``; ``ALSAlgorithm.grid_train``
   on ``cuda`` trains G = 4 candidates at once (``lambda_`` 0.05, 0.02,
   0.1 at 5 iterations of 6 CG steps, and 0.05 at 3 iterations of 4):
   every held-out RMSE finite, candidate 1 in ``RMSE_BAND`` and within
   1e-2 of the ALS phase's ``ALSAlgorithm.train`` (its sequential
   oracle: the same params and seed), candidate 4
   within 1e-2 of one sequential ``ALSAlgorithm.train`` at 3 iterations
   of 4 CG steps. Then an ``ALSGridTrainer`` of the same grid is
   profiled (``tools/als_timing.grid_profile``): device ms, launches
   and idle share per grid alternation. (b) ``python -m
   predictionio_torch.tools.cli eval`` of a module written into the
   temporary directory: an ``Evaluation`` of ``recommendation_engine``
   with a rating-MSE metric, and a generator of six ``lambda_`` (0.01
   to 5.0; 3 folds, rank 64, 3 iterations, f32) over the ``pio train``
   phase's eventlog events. It must exit 0, print the one-liner, log 6
   candidates grid-trained in 3 runs and no fallback, and leave one
   EVALCOMPLETED EvaluationInstance whose JSON scores match an
   in-process sequential ``FastEvalEngineWorkflow`` on the card (rtol
   1e-4, atol 1e-5, the same ranking).

Output: the card's name and power limit (``nvidia-smi``), a ``serve``,
a ``train``, an ``als_train``, an ``ingest``, a ``front_door`` (with
the card's line), a ``pio_train`` and an ``eval`` line,
the ``kernels`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 20
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64     # bench.py DEFAULT_KNOBS
# flash_ce gradients against the plain version, per cdt: the JAX
# package's kernel-test tolerances (rtol, atol), then the same rtol with
# an atol scaled to the gradient's own size (a fraction of max|ref|), and
# a bound on ||g - ref|| / ||ref||. The JAX atol alone says nothing at
# the train shape, where |du| is ~1e-4.
GRAD_TOLS = {"float32": (1e-4, 1e-6, 1e-4, 1e-4),
             "bfloat16": (1e-1, 2e-3, 2e-3, 2e-2)}
TOPK_SOURCE = "predictionio_torch/ops/kernels/csrc/topk_dot.cu"
TOPK_REPLACES = "predictionio_tpu/ops/pallas/topk_dot.py:70"
FLASH_SOURCE = "predictionio_torch/ops/kernels/csrc/flash_ce.cu"
FLASH_REPLACES = "predictionio_tpu/ops/pallas/flash_ce.py:192"
EMBED_SOURCE = "predictionio_torch/ops/kernels/csrc/embed_update.cu"
EMBED_REPLACES = "predictionio_tpu/ops/pallas/embed_update.py:100"
# the stretch two-tower configuration (BASELINE.json configs[4]; bench.py)
TT_IDS, TT_POS, TT_DIM, TT_BATCH = 1_000_000, 4_000_000, 128, 8192
TT_EPOCHS = 3
TEMP = 0.07
# bench.py's ALS run: DEFAULT_KNOBS ratings, its 5% holdout, _bench_cfg
# (rank 64 above, 5 iterations, reg 0.05, block 4096), and RMSE_BAND
ALS_RATINGS, ALS_ITERS, ALS_REG, ALS_BLOCK = 20_000_000, 5, 0.05, 4096
RMSE_BAND = (0.38, 0.48)
# free disk the ingest phase needs: the log (~173 bytes an event), its
# index snapshot and two layout-cache entries
INGEST_DISK_BYTES = 6 << 30
# the front-door phase: the ALS phase's ratings, of which the first
# FD_HISTORY go in as history and the rest through the event server
# (batches of FD_BATCH over FD_CONNS connections, then FD_LONE lone
# POSTs); a whitelisted key's batch of FD_VIEWS views and FD_DENIED
# rates; FD_READS reads; the server's drain window
FD_HISTORY, FD_BATCH, FD_CONNS, FD_LONE = 19_000_000, 10_000, 4, 2_000
FD_VIEWS, FD_DENIED, FD_READS = 990, 10, 20
FD_DRAIN_TIMEOUT = 30
# the eval phase: (a) the grid's candidates (lambda_, iterations, CG
# steps), the first the ALS phase's own training; (b) pio eval's sweep
GRID_REGS, GRID_ITERS, GRID_CG = (0.05, 0.02, 0.1, 0.05), (5, 5, 5, 3), \
    (6, 6, 6, 4)
EVAL_REGS, EVAL_K = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0), 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def own_split(split: dict, prefix: str) -> dict:
    """The device split by kernel, the port's own kernels by name and
    PyTorch's summed under ``torch ops``."""
    out = {"torch ops": 0.0}
    for name, ms in split.items():
        if prefix in name:
            out[name] = ms
        else:
            out["torch ops"] += ms
    return out


# -- kernel phase ------------------------------------------------------------

def check_topk(q, items, excl, k, s_k, i_k, what: str) -> float:
    """Kernel output against topk_dot_reference; returns max |err|."""
    import torch
    from predictionio_torch.ops.kernels.topk_dot import topk_dot_reference

    s_r, i_r = topk_dot_reference(q, items, excl, k)
    B, I = q.shape[0], items.shape[0]
    tol = 1e-5 * q.norm(dim=1, keepdim=True) * items.norm(dim=1).max()
    live = s_r > -1e29
    err = (s_k - s_r).abs()
    if bool(((err > tol) & live).any()):
        fail(f"topk_dot scores differ ({what}): max err "
             f"{float(err[live].max())} vs tol {float(tol.max())}")
    if s_k.shape != (B, k) or i_k.shape != (B, k):
        fail(f"topk_dot output shape ({what}): {tuple(s_k.shape)}")
    if bool(((i_k < 0) | (i_k >= I)).any()):
        fail(f"topk_dot returned an id outside the table ({what})")
    rows_sorted = torch.sort(i_k.long(), dim=1).values
    if bool((rows_sorted[:, 1:] == rows_sorted[:, :-1]).any()):
        fail(f"topk_dot returned a duplicate id ({what})")
    mismatch = (i_k.long() != i_r.long()) & live
    if bool(mismatch.any()):
        # only a near-tie of the reference may reorder: the kernel's item
        # must score (by the reference's own product) within tol of the slot
        full = q @ items.T
        got = torch.gather(full, 1, i_k.long())
        near = (got - s_r).abs() <= tol
        if bool((mismatch & ~near).any()):
            b, j = [int(x) for x in torch.nonzero(mismatch & ~near)[0]]
            fail(f"topk_dot index differs ({what}) at row {b} slot {j}: "
                 f"kernel {int(i_k[b, j])} vs reference {int(i_r[b, j])}")
    return float(err[live].max()) if bool(live.any()) else 0.0


def kernel_phase() -> dict:
    import torch
    from predictionio_torch.ops import kernels
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.tools.device_time import profile_call

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    cases = 0
    for I in (513, 26_744, 66_000):
        for D in (32, 64, 128):
            items = torch.randn((I, D), generator=gen, device=dev)
            for B in (1, 8, 64, 128):
                q = torch.randn((B, D), generator=gen, device=dev)
                for k in (8, 16, 128):
                    for E in (1, 2, 4, 64):
                        # -1 pads, ids in range, and stale ids outside
                        # [0, I) that must be ignored
                        excl = torch.randint(-2, I + 3, (B, E), generator=gen,
                                             device=dev, dtype=torch.int32)
                        s, i = tkd.topk_dot(q, items, excl, k)
                        torch.cuda.synchronize()
                        max_err = max(max_err, check_topk(
                            q, items, excl, k, s, i,
                            f"I={I} D={D} B={B} k={k} E={E}"))
                        cases += 1

    # exact ties: every item row appears twice
    half = torch.randn((N_ITEMS // 2, RANK), generator=gen, device=dev)
    items = torch.cat([half, half])
    q = torch.randn((8, RANK), generator=gen, device=dev)
    excl = torch.full((8, 1), -1, dtype=torch.int32, device=dev)
    s, i = tkd.topk_dot(q, items, excl, 16)
    torch.cuda.synchronize()
    max_err = max(max_err, check_topk(q, items, excl, 16, s, i, "ties"))
    # ties resolve to the lower id first: each twin pair appears in order
    pos = i.long() % (N_ITEMS // 2)
    if not bool((i[:, 0::2].long() < N_ITEMS // 2).all()) or not bool(
            (pos[:, 0::2] == pos[:, 1::2]).all()):
        fail("topk_dot tie order: twins must come lower id first, paired")

    # a whole tile of top candidates excluded: the 64 best items sit in
    # one tile and are all banned, so the answer comes from other tiles
    items = torch.randn((N_ITEMS, RANK), generator=gen, device=dev)
    q = torch.randn((1, RANK), generator=gen, device=dev)
    items[1000:1064] += 10.0 * q / q.norm()
    excl = torch.arange(1000, 1064, dtype=torch.int32,
                        device=dev).reshape(1, 64)
    s, i = tkd.topk_dot(q, items, excl, 8)
    torch.cuda.synchronize()
    max_err = max(max_err, check_topk(q, items, excl, 8, s, i,
                                      "tile excluded"))
    if bool(((i >= 1000) & (i < 1064)).any()):
        fail("topk_dot returned an excluded id")

    # adversarial tables: scores that rise along the table (every block
    # sorts again and again) and every row identical (all ties)
    for name in ("rising", "identical"):
        for I, D, B, k in ((N_ITEMS, RANK, 1, 16), (66_000, 128, 8, 128),
                           (TT_IDS, TT_DIM, 1, 16)):
            q, items = adversarial_table(name, I, D, B, gen)
            excl = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
            s, i = tkd.topk_dot(q, items, excl, k)
            torch.cuda.synchronize()
            what = f"{name} I={I} D={D} B={B} k={k}"
            max_err = max(max_err, check_topk(q, items, excl, k, s, i, what))
            if name == "identical" and not bool(
                    (i == torch.arange(k, device=dev)).all()):
                fail(f"topk_dot on identical rows must return ids 0..k-1 "
                     f"({what})")
            cases += 1

    # the two lone-query shapes the main paths run, and the largest one
    shapes = {"serve": (1, N_ITEMS, RANK, 16, 1),
              "catalog": (1, TT_IDS, TT_DIM, 16, 1),
              "widest": (128, 66_000, 128, 128, 64)}
    inputs = {}
    for name, (B, I, D, k, E) in shapes.items():
        items = torch.randn((I, D), generator=gen, device=dev)
        q = torch.randn((B, D), generator=gen, device=dev)
        excl = (torch.full((B, E), -1, dtype=torch.int32, device=dev)
                if B == 1 else torch.randint(-1, I, (B, E), generator=gen,
                                             device=dev, dtype=torch.int32))
        inputs[name] = (q, items, excl, k)
    # repeated calls, shapes alternating, give their first call's bits:
    # each search's last block puts its ticket counter back to 0
    first = {name: tkd.topk_dot(*args) for name, args in inputs.items()}
    for n in range(60):
        name = list(inputs)[n % len(inputs)]
        s, i = tkd.topk_dot(*inputs[name])
        if not (torch.equal(s, first[name][0])
                and torch.equal(i, first[name][1])):
            fail(f"topk_dot call {n} at the {name} shape differs from the "
                 f"first call's bits")
    torch.cuda.synchronize()
    traced_per_call = {}
    for name, args in inputs.items():
        max_err = max(max_err, check_topk(*args, *first[name], name))
        # one device kernel per call and no memset, from the profiler:
        # the topk kernel is the only one traced, and it ran once a call
        # (CUPTI can drop an event now and then, never add one)
        traced = profile_call(lambda: tkd.topk_dot(*args), 20)
        per_call = traced["kernels_per_call"]
        if (len(traced["kernels"]) != 1 or "topk_dot_kernel" not in
                traced["kernels"][0] or not 0.9 < per_call <= 1.0
                or traced["memsets_per_call"] != 0):
            fail(f"topk_dot at the {name} shape: {per_call} device kernels "
                 f"({traced['kernels']}) and {traced['memsets_per_call']} "
                 f"memsets per call, want one kernel and no memset")
        traced_per_call[name] = {
            key: traced[key] for key in (
                "kernels_per_call", "memsets_per_call", "kernels")}
    timed = {name: time_topk(*inputs[name], shapes[name])
             for name in ("serve", "catalog")}
    serve = timed["serve"]
    return {
        "name": "topk_dot", "route": "cuda", "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES, "max_abs_err": max_err,
        **{key: serve[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shapes": timed, "traced_per_call": traced_per_call,
        "ptxas": kernels.ptxas_report("topk_dot"), "cases": cases,
        "shape": serve["shape"],
    }


def adversarial_table(name: str, I: int, D: int, B: int, gen):
    """(q, items): ``rising``, rows ordered so that every row of q scores
    them in rising order; ``identical``, one row repeated."""
    import torch

    dev = torch.device("cuda")
    direction = torch.nn.functional.normalize(
        torch.randn(D, generator=gen, device=dev), dim=0)
    q = direction + 0.01 * torch.randn((B, D), generator=gen, device=dev)
    if name == "rising":
        items = torch.linspace(0.1, 10.0, I, device=dev)[:, None] * direction
    else:
        items = torch.randn((1, D), generator=gen, device=dev).repeat(I, 1)
    return q, items.contiguous()


def time_topk(q, items, excl, k, shape) -> dict:
    """The kernel, its plain version and one library call (``torch.matmul``
    + ``torch.topk``) at one shape: ``ms`` is device time per call from
    ``torch.profiler`` (table warm in L2 where it fits), ``cold_ms`` the
    same with L2 flushed before each call, ``call_ms`` the CUDA-event time
    per call of back-to-back calls (the host's issue time when that is
    longer), ``cold_event_ms`` the median CUDA-event time of one call
    after an L2 flush."""
    import torch
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.tools.device_time import (call_ms, cold_ms,
                                                      profile_call)
    from predictionio_torch.tools.topk_dot_timing import bound

    B, I, D, _, E = shape
    kernel = lambda: tkd.topk_dot(q, items, excl, k)  # noqa: E731
    plain = lambda: tkd.topk_dot_reference(q, items, excl, k)  # noqa: E731
    library = lambda: torch.topk(q @ items.T, k, dim=1)  # noqa: E731
    # event timing first: launches run slower after profiling
    kernel_call_ms, plain_call_ms, library_call_ms = (
        call_ms(f) for f in (kernel, plain, library))
    kernel_cold_event_ms, library_cold_event_ms = (
        cold_ms(f) for f in (kernel, library))
    warm, plain_warm, library_warm = (
        profile_call(f) for f in (kernel, plain, library))
    kernel_cold, library_cold = (
        profile_call(f, 50, cold=True) for f in (kernel, library))
    bound_ms, bound_by = bound(B, I, D, k, E)
    return {
        "ms": warm["ms"], "cold_ms": kernel_cold["ms"],
        "plain_ms": plain_warm["ms"], "library_ms": library_warm["ms"],
        "library_cold_ms": library_cold["ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
        "library_call_ms": library_call_ms,
        "cold_event_ms": kernel_cold_event_ms,
        "library_cold_event_ms": library_cold_event_ms,
        "device_split_ms": warm["split"],
        "shape": f"B={B},I={I},D={D},k={k},E={E}",
    }


# -- serve phase -------------------------------------------------------------

def post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class Truth:
    """Factor tables and id maps of a served model, in float64 on the
    host: what every answer is checked against."""

    def __init__(self, U, V, user_names, item_names):
        self.U = np.asarray(U, np.float64)
        self.V = np.asarray(V, np.float64)
        self.item_names = list(item_names)
        self.users = {n: j for j, n in enumerate(user_names)}
        self.items = {n: j for j, n in enumerate(self.item_names)}
        self.vmax = float(np.linalg.norm(self.V, axis=1).max())


def expected_answer(t: Truth, q: dict):
    """(ids, scores, all scores) the query must get, under (score
    descending, item id ascending)."""
    num = int(q.get("num", 10))
    if "user" in q and q["user"] not in t.users:
        return np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
    qvec = t.U[t.users[q["user"]]] if "user" in q else t.V[t.items[q["item"]]]
    scores = t.V @ qvec
    allowed = np.ones(len(t.V), bool)
    if "whitelist" in q:
        allowed[:] = False
        allowed[[t.items[w] for w in q["whitelist"] if w in t.items]] = True
    allowed[[t.items[b] for b in q.get("blacklist", ()) if b in t.items]] = False
    if "user" not in q:
        allowed[t.items[q["item"]]] = False
    cand = np.flatnonzero(allowed)
    order = np.lexsort((cand, -scores[cand]))[:num]
    return cand[order], scores[cand[order]], scores


def check_answer(t: Truth, q: dict, got: dict, what: str) -> None:
    ids, exp_scores, all_scores = expected_answer(t, q)
    served = got["itemScores"]
    if len(served) != len(ids):
        fail(f"{what}: {len(served)} items served, {len(ids)} expected "
             f"for {q}")
    if not len(ids):
        return
    qvec = t.U[t.users[q["user"]]] if "user" in q else t.V[t.items[q["item"]]]
    tol = 1e-5 * float(np.linalg.norm(qvec)) * t.vmax
    for j, entry in enumerate(served):
        if abs(entry["score"] - exp_scores[j]) > tol:
            fail(f"{what}: slot {j} score {entry['score']} vs "
                 f"{exp_scores[j]} for {q}")
        if entry["item"] != t.item_names[ids[j]]:
            true = all_scores[t.items[entry["item"]]]
            if abs(true - exp_scores[j]) > tol:
                fail(f"{what}: slot {j} item {entry['item']} vs "
                     f"{t.item_names[ids[j]]} for {q}")


def serve_phase() -> dict:
    import torch
    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.models.als import ALSParams, als_model_from_arrays
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    import dataclasses
    import datetime as dt

    rng = np.random.default_rng(SEED)
    U = (0.3 * rng.standard_normal((N_USERS, RANK))).astype(np.float32)
    V = (0.3 * rng.standard_normal((N_ITEMS, RANK))).astype(np.float32)
    user_names = [f"u{j}" for j in range(N_USERS)]
    item_names = [f"i{j}" for j in range(N_ITEMS)]
    truth = Truth(U, V, user_names, item_names)
    model = als_model_from_arrays(U, V, user_names, item_names, rank=RANK)

    store = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    server = None
    try:
        storage = Storage.from_env({
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": store})
        now = dt.datetime.now(tz=dt.timezone.utc)
        storage.engine_instances().insert(EngineInstance(
            id="ml20m-rank64", status="COMPLETED", start_time=now,
            end_time=now, engine_id="ml20m", engine_version="0",
            engine_variant="default",
            engine_factory=("predictionio_torch.templates.recommendation."
                            "recommendation_engine"),
            data_source_params=json.dumps(
                {"name": "", "params": {"app_name": "ml20m"}}),
            preparator_params=json.dumps({"name": "", "params": {}}),
            algorithms_params=json.dumps([{"name": "als", "params":
                dataclasses.asdict(ALSParams(rank=RANK))}]),
            serving_params=json.dumps({"name": "", "params": {}})))
        storage.models().insert(Model(id="ml20m-rank64",
                                      models=pickle.dumps([model])))
        del model

        pick = rng.integers(0, N_USERS, size=40)
        pick_items = rng.integers(0, N_ITEMS, size=12)
        lone = []
        for j in range(20):
            lone.append({"user": user_names[pick[j]], "num": 10})
        for j in range(20, 30):
            top = np.argsort(-(V @ U[pick[j]]))[:3]
            lone.append({"user": user_names[pick[j]], "num": 10,
                         "blacklist": [item_names[t] for t in top]
                         + ["not-an-item"]})
        for j in range(30, 33):
            lone.append({"user": user_names[pick[j]], "num": 100})
        for j in range(10):
            lone.append({"item": item_names[pick_items[j]], "num": 10})
        lone.append({"item": item_names[pick_items[10]], "num": 10,
                     "blacklist": [item_names[pick_items[11]]]})
        kernel_queries = len(lone)
        lone.append({"user": user_names[pick[33]], "num": 5,
                     "whitelist": [item_names[t] for t in
                                   rng.integers(0, N_ITEMS, size=50)]})
        lone.append({"user": "no-such-user", "num": 10})
        lone.append({"user": "another-unknown", "num": 10})
        # k bucket 256 is past the kernel's cap: the scorer's device route
        lone.append({"user": user_names[pick[34]], "num": 200,
                     "blacklist": [item_names[pick_items[0]]]})

        # the main path starts here: deploy, warm up, serve
        tkd.launches.reset()
        t0 = time.perf_counter()
        server = EngineServer(recommendation_engine(), "ml20m",
                              host="127.0.0.1", port=0, storage=storage,
                              device="cuda").start()
        deploy_sec = time.perf_counter() - t0
        status = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/", timeout=60).read())
        plan = status["retrieval"][0]["kernel"]
        if not plan["engaged"] or not plan["device"].startswith("cuda"):
            fail(f"topk_dot not engaged on the card: {plan}")
        before = tkd.launches.value
        lat = []
        for j, q in enumerate(lone):
            t0 = time.perf_counter()
            got = post(server.port, q)
            lat.append(time.perf_counter() - t0)
            check_answer(truth, q, got, f"lone query {j}")
        lone_launches = tkd.launches.value - before

        burst = [{"user": user_names[u], "num": 10}
                 for u in rng.integers(0, N_USERS, size=64)]
        answers = [None] * len(burst)

        def send(j):
            answers[j] = post(server.port, burst[j])

        threads = [threading.Thread(target=send, args=(j,))
                   for j in range(len(burst))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        burst_sec = time.perf_counter() - t0
        for j, (q, got) in enumerate(zip(burst, answers)):
            if got is None:
                fail(f"burst query {j} got no answer")
            check_answer(truth, q, got, f"burst query {j}")
        launches = tkd.launches.value
        status = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/", timeout=60).read())
        if lone_launches < kernel_queries:
            fail(f"topk_dot launched {lone_launches} times for "
                 f"{kernel_queries} lone user/item queries")
        # the burst and the k=200 query went through scorers: on the card
        # they must have taken the device route, never the host's
        served = server.deployment.models[0]
        scorers = [served.scorer(), served.retrieval_index()._fallback()]
        if any(s.placement != "device" or s.device.type != "cuda"
               for s in scorers):
            fail(f"a scorer left the card: "
                 f"{[(s.placement, str(s.device)) for s in scorers]}")
        lat_ms = sorted(1e3 * x for x in lat[:kernel_queries])
        return {
            "launches": launches, "lone_queries": len(lone),
            "lone_kernel_queries": kernel_queries,
            "lone_launches": lone_launches, "burst_queries": len(burst),
            "deploy_sec": deploy_sec, "burst_sec": burst_sec,
            "lone_ms_p50": lat_ms[len(lat_ms) // 2],
            "lone_ms_max": lat_ms[-1],
            "batcher": status["batcher"],
            "device": status["device"],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(store, ignore_errors=True)


# -- two-tower kernel phase ---------------------------------------------------

def ce_batch(B, D, gen, uniform_w):
    """Unit-norm towers, ids drawn from small ranges (many in-batch
    duplicate users and items), a zero-weight tail of B // 16 rows."""
    import torch

    dev = torch.device("cuda")
    u = torch.nn.functional.normalize(
        torch.randn((B, D), generator=gen, device=dev), dim=1)
    v = torch.nn.functional.normalize(
        torch.randn((B, D), generator=gen, device=dev), dim=1)
    w = (torch.ones(B, device=dev) if uniform_w
         else 0.5 + 4.0 * torch.rand(B, generator=gen, device=dev))
    w[B - max(1, B // 16):] = 0.0
    return (u, v, torch.randint(0, max(2, B // 3), (B,), generator=gen,
                                device=dev),
            torch.randint(0, max(2, B // 4), (B,), generator=gen, device=dev),
            w)


def ce_step(fn, u, v, u_idx, i_idx, w, cdt):
    """One loss forward and backward: (loss, du, dv)."""
    u = u.detach().requires_grad_(True)
    v = v.detach().requires_grad_(True)
    loss = fn(u, v, u_idx, i_idx, w, TEMP, cdt)
    loss.backward()
    return loss.detach(), u.grad, v.grad


def grad_close(g, r, cdt_name: str):
    """(agrees, ||g - r|| / ||r||): ``g`` against the plain version's
    ``r`` under ``GRAD_TOLS[cdt_name]``."""
    rtol, atol, atol_scaled, norm_tol = GRAD_TOLS[cdt_name]
    err = (g - r).abs()
    rel_norm = float((g - r).norm() / r.norm())
    agrees = (not bool((err > atol + rtol * r.abs()).any())
              and not bool((err > atol_scaled * r.abs().max()
                            + rtol * r.abs()).any())
              and rel_norm <= norm_tol)
    return agrees, rel_norm


def grad_controls(g, r, cdt_name: str) -> dict:
    """Deliberately wrong gradients that ``grad_close`` must refuse at
    the shape it checks: zeros, rows shifted by one (a permuted coef),
    a 10% scale error, one 64-row tile zeroed. -> their relative
    errors."""
    import torch

    tile = g.clone()
    tile[:64] = 0.0
    wrong = {"zeros": torch.zeros_like(g), "rows_shifted": g.roll(1, 0),
             "scaled_0.9": 0.9 * g, "one_tile_zeroed": tile}
    out = {}
    for name, bad in wrong.items():
        agrees, rel_norm = grad_close(bad, r, cdt_name)
        if agrees:
            fail(f"flash_ce gradient check passed a wrong gradient "
                 f"({name}, {cdt_name}): it cannot catch a broken kernel")
        out[name] = rel_norm
    return out


def flash_ce_phase() -> dict:
    import torch
    from predictionio_torch.ops import kernels
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.tools.device_time import (
        BF16_FLOPS, HBM_BYTES_PER_S, SFU_PER_S, call_ms, profile_call)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    max_err, cases = 0.0, 0
    rel_norm_max = {"float32": 0.0, "bfloat16": 0.0}
    controls = {}
    for B in (128, 130, 1000, 8192):
        for D in (8, 64, 128, 256):
            for cdt in (torch.float32, torch.bfloat16):
                for uniform_w in (True, False):
                    batch = ce_batch(B, D, gen, uniform_w)
                    got = ce_step(fce.flash_ce, *batch, cdt)
                    want = ce_step(fce.flash_ce_reference, *batch, cdt)
                    torch.cuda.synchronize()
                    cdt_name = str(cdt).split(".")[-1]
                    l_rtol = 1e-5 if cdt == torch.float32 else 5e-3
                    what = f"B={B} D={D} cdt={cdt_name} uniform_w={uniform_w}"
                    if not bool(torch.isfinite(got[0])) or abs(
                            float(got[0] - want[0])) > l_rtol * abs(
                            float(want[0])):
                        fail(f"flash_ce loss differs ({what}): "
                             f"{float(got[0])} vs {float(want[0])}")
                    for name, g, r in (("du", got[1], want[1]),
                                       ("dv", got[2], want[2])):
                        agrees, rel_norm = grad_close(g, r, cdt_name)
                        if not agrees:
                            fail(f"flash_ce {name} differs ({what}): max "
                                 f"err {float((g - r).abs().max())}, max "
                                 f"|ref| {float(r.abs().max())}, relative "
                                 f"norm err {rel_norm}")
                        max_err = max(max_err, float((g - r).abs().max()))
                        rel_norm_max[cdt_name] = max(rel_norm_max[cdt_name],
                                                     rel_norm)
                        if B == TT_BATCH and D == TT_DIM and uniform_w:
                            controls[f"{name},{cdt_name}"] = grad_controls(
                                g, r, cdt_name)
                    cases += 1

    # timing at the train phase's shape: one loss forward and backward
    B, D, cdt = TT_BATCH, TT_DIM, torch.bfloat16
    batch = ce_batch(B, D, gen, True)
    # partials summed in a fixed order, no atomics: the same bits twice
    first, second = (ce_step(fce.flash_ce, *batch, cdt) for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail("flash_ce is not deterministic: two calls at B=8192, D=128 "
             "gave different loss or gradients")
    kernel = lambda: ce_step(fce.flash_ce, *batch, cdt)  # noqa: E731
    plain = lambda: ce_step(fce.flash_ce_reference, *batch, cdt)  # noqa: E731
    kernel_call_ms, plain_call_ms = call_ms(kernel, 50), call_ms(plain, 10)
    traced, plain_ms = profile_call(kernel, 20), profile_call(plain, 5)["ms"]
    # necessary work: 2 B^2 D products forward and 4 B^2 D backward on
    # the tensor cores (the kernels' logits recompute is a cost of their
    # design), B^2 exponentials forward and 2 B^2 backward on the
    # special-function units; each runs at its own peak, so the larger
    # of the two times (and of the bytes') bounds the kernels
    products_ms = 6.0 * B * B * D / BF16_FLOPS * 1e3
    exps_ms = 3.0 * B * B / SFU_PER_S * 1e3
    bytes_ms = (4 * B * D * 4 + B * (8 + 8 + 4)) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(products_ms, exps_ms)
    kernel_split = own_split(traced["split"], "flash_ce_kernel")
    # the backward kernel is the one template instance with BWD = true
    bwd_ms = sum(ms for name, ms in kernel_split.items()
                 if name.startswith("flash_ce_kernel") and "true" in name)
    fwd_ms = sum(ms for name, ms in kernel_split.items()
                 if name.startswith("flash_ce_kernel") and "true" not in name)
    return {
        "name": "flash_ce", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "max_abs_err": max_err,
        "ms": traced["ms"], "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_terms_ms": {"products": products_ms, "exps": exps_ms,
                           "bytes": bytes_ms},
        "grad_rel_norm_err_max": rel_norm_max,
        "grad_controls_rel_norm_err": controls,
        "library_ms": None,
        "library_note": "no single PyTorch call computes this loss",
        "call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
        "device_split_ms": kernel_split, "fwd_ms": fwd_ms,
        "bwd_ms": bwd_ms,
        "deterministic": True, "split": fce.split_for(B),
        "ptxas": kernels.ptxas_report("flash_ce"),
        "cases": cases, "shape": f"B={B},D={D},cdt=bfloat16,fwd+bwd",
    }


def embed_update_phase() -> dict:
    import torch
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.tools.device_time import (
        F32_FLOPS, HBM_BYTES_PER_S, call_ms, profile_call)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    max_err = 0.0
    for N, E, B, vocab in ((64, 24, 37, 64), (50, 8, 24, 6),
                           (TT_IDS, TT_DIM, TT_BATCH, TT_IDS)):
        table = torch.randn((N, E), generator=gen, device=dev)
        idx = torch.randint(0, vocab, (B,), generator=gen, device=dev)
        grad = torch.randn((B, E), generator=gen, device=dev)
        scale = torch.rand(B, generator=gen, device=dev)
        want = eu.embed_update_reference(table.clone(), idx, grad, scale)
        eu.embed_update(table, idx, grad, scale)
        torch.cuda.synchronize()
        err = (table - want).abs()
        if bool((err > 1e-6 + 1e-5 * want.abs()).any()):
            fail(f"embed_update differs at N={N} E={E} B={B}: max err "
                 f"{float(err.max())}")
        max_err = max(max_err, float(err.max()))

    # timing at the train phase's shape: 8192 rows into a [1M, 128] table
    scale = scale * 1e-6          # the timed calls keep adding in place
    kernel = lambda: eu.embed_update(table, idx, grad, scale)  # noqa: E731
    plain = lambda: eu.embed_update_reference(  # noqa: E731
        table, idx, grad, scale)
    library = lambda: table.index_add_(  # noqa: E731
        0, idx, -scale[:, None] * grad)
    k_call, p_call, l_call = (call_ms(f) for f in (kernel, plain, library))
    warm_ms, plain_warm_ms, library_warm_ms = (
        profile_call(f)["ms"] for f in (kernel, plain, library))
    # the bound is HBM's: time each call with L2 flushed before it (the
    # warm times above find the rows and gradients in the 50 MB L2)
    kernel_ms, plain_ms, library_ms = (
        profile_call(f, 50, cold=True)["ms"]
        for f in (kernel, plain, library))
    touched = int(torch.unique(idx).numel())
    nbytes = B * E * 4 + B * 8 + B * 4 + 2 * touched * E * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * B * E / F32_FLOPS * 1e3
    return {
        "name": "embed_update", "route": "cuda", "source": EMBED_SOURCE,
        "replaces": EMBED_REPLACES, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library_note": "table.index_add_(0, idx, -scale[:, None] * grad)",
        "warm_ms": warm_ms, "plain_warm_ms": plain_warm_ms,
        "library_warm_ms": library_warm_ms, "timing": "ms: cold L2",
        "call_ms": k_call, "plain_call_ms": p_call, "library_call_ms": l_call,
        "touched_rows": touched, "shape": f"N={N},E={E},B={B}",
    }


# -- train phase ---------------------------------------------------------------

def synth_positives():
    """bench.py's stretch positives: 64 clusters, 80% in-cluster."""
    rng = np.random.default_rng(1)
    n_clusters = 64
    user_cluster = rng.integers(0, n_clusters, size=TT_IDS)
    uu = rng.integers(0, TT_IDS, size=TT_POS)
    in_cluster = rng.random(TT_POS) < 0.8
    per_cluster = TT_IDS // n_clusters
    ii = np.where(
        in_cluster,
        user_cluster[uu] + n_clusters * rng.integers(0, per_cluster, TT_POS),
        rng.integers(0, TT_IDS, size=TT_POS)).astype(np.int64)
    return uu.astype(np.int64), ii


def step_profile(uu, ii, steps: int = 20) -> dict:
    """Where a steady stretch-width step's time goes: a trainer at the
    train phase's widths on its first ``steps`` batches runs one warm-up
    epoch, one timed epoch and one under ``torch.profiler``; device time
    by kernel group per step, and the device's idle share (1 - device
    time over the timed epoch's wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from predictionio_torch.ops.twotower import (TwoTowerConfig,
                                                 TwoTowerTrainer)

    n = steps * TT_BATCH
    cfg = TwoTowerConfig(dim=TT_DIM, batch_size=TT_BATCH, epochs=3,
                         learning_rate=3e-3, seed=11, temperature=TEMP)
    trainer = TwoTowerTrainer((uu[:n], ii[:n], None), TT_IDS, TT_IDS, cfg,
                              device="cuda")
    trainer.run(epochs=2)
    wall_ms = trainer.epoch_seconds[1] * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.run(epochs=3)
        torch.cuda.synchronize()
    groups = {"flash_ce": 0.0, "embed_update": 0.0, "torch ops": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        group = next((g for g in ("flash_ce", "embed_update")
                      if g + "_kernel" in e.key), "torch ops")
        groups[group] += e.self_device_time_total / 1e3 / steps
    device_ms = sum(groups.values())
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_ms_by_group": groups,
            "device_idle_share": 1.0 - device_ms / wall_ms}


def deploy_and_check(engine, storage, engine_id: str, truth: Truth,
                     queries, what: str) -> dict:
    """Deploy the engine's latest instance with the port's EngineServer
    on the card and check every answer."""
    from predictionio_torch.serving.engine_server import EngineServer

    server = EngineServer(engine, engine_id, host="127.0.0.1", port=0,
                          storage=storage, device="cuda").start()
    try:
        lat = []
        for j, q in enumerate(queries):
            t0 = time.perf_counter()
            got = post(server.port, q)
            lat.append(1e3 * (time.perf_counter() - t0))
            check_answer(truth, q, got, f"{what} query {j}")
        lat.sort()
        return {"queries": len(queries), "ms_p50": lat[len(lat) // 2],
                "ms_max": lat[-1]}
    finally:
        server.stop()


def tt_queries(truth: Truth, rng, n_users: int, n_items: int):
    users = [f"u{j}" for j in rng.integers(0, n_users, 12)]
    items = [truth.item_names[j] for j in rng.integers(0, n_items, 6)]
    qs = [{"user": u, "num": 10} for u in users]
    qs += [{"item": i, "num": 10} for i in items]
    qs.append({"user": users[0], "num": 20, "blacklist": items[:2]})
    qs.append({"user": "no-such-user", "num": 10})
    return qs


def train_phase() -> dict:
    import datetime as dt

    import torch
    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import PreparedRatings
    from predictionio_torch.models.twotower import (TwoTowerAlgorithm,
                                                    TwoTowerParams)
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.templates.twotower import twotower_engine
    from predictionio_torch.workflow.train import serialize_models

    t0 = time.perf_counter()
    uu, ii = synth_positives()
    user_names = [f"u{j}" for j in range(TT_IDS)]
    item_names = [f"i{j}" for j in range(TT_IDS)]
    pd = PreparedRatings(user_ids=BiMap.from_vocab(user_names),
                         item_ids=BiMap.from_vocab(item_names),
                         user_idx=uu, item_idx=ii,
                         ratings=np.ones(TT_POS, np.float32))
    setup_sec = time.perf_counter() - t0
    params = TwoTowerParams(dim=TT_DIM, batch_size=TT_BATCH, epochs=TT_EPOCHS,
                            learning_rate=3e-3, seed=11, temperature=TEMP)
    algo = TwoTowerAlgorithm(params)

    # the main path starts here: train, serialize, deploy, serve
    for counter in (fce.launches, eu.launches, tkd.launches):
        counter.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = algo.train(DeviceContext("cuda"), pd)
    train_sec = time.perf_counter() - t0
    flash_launches, embed_launches = fce.launches.value, eu.launches.value
    peak_mem = torch.cuda.max_memory_allocated()
    plan = model.kernel_plan
    if not (plan["flash_ce"] and plan["embed_update"]):
        fail(f"the trainer did not plan both kernels: {plan}")
    steps = -(-TT_POS // TT_BATCH) * TT_EPOCHS
    if flash_launches != 3 * steps or embed_launches != 2 * steps:
        fail(f"{steps} steps launched flash_ce {flash_launches} times "
             f"(want {3 * steps}) and embed_update {embed_launches} times "
             f"(want {2 * steps})")
    losses = model.train_losses
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"two-tower losses not finite and falling: {losses}")
    for side, vecs in (("user", model.user_factors),
                       ("item", model.item_factors)):
        norms = np.linalg.norm(vecs, axis=1)
        if not np.all(np.abs(norms - 1.0) < 1e-4):
            fail(f"{side} vectors not unit-norm: {norms.min()}..{norms.max()}")

    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id="tt-stretch", status="COMPLETED", start_time=now, end_time=now,
        engine_id="tt-stretch", engine_version="0", engine_variant="default",
        engine_factory="predictionio_torch.templates.twotower.twotower_engine",
        data_source_params=json.dumps({"name": "", "params": {}}),
        preparator_params=json.dumps({"name": "", "params": {}}),
        algorithms_params=json.dumps([{"name": "twotower", "params":
                                       dataclasses.asdict(params)}]),
        serving_params=json.dumps({"name": "", "params": {}})))
    storage.models().insert(Model(id="tt-stretch",
                                  models=serialize_models([model])))
    truth = Truth(model.user_factors, model.item_factors, user_names,
                  item_names)
    epoch_sec = [float(x) for x in model.train_epoch_seconds]
    del model
    served = deploy_and_check(twotower_engine(), storage, "tt-stretch", truth,
                              tt_queries(truth, np.random.default_rng(SEED),
                                         TT_IDS, TT_IDS), "train phase")
    topk_launches = tkd.launches.value
    profiled = step_profile(uu, ii)

    steady = min(epoch_sec[1:])
    steps_per_epoch = steps // TT_EPOCHS
    return {
        "config": {"users": TT_IDS, "items": TT_IDS, "positives": TT_POS,
                   "dim": TT_DIM, "batch": TT_BATCH, "epochs": TT_EPOCHS,
                   "compute_dtype": "bfloat16", "temperature": TEMP},
        "setup_sec": setup_sec, "train_sec": train_sec,
        "epoch_sec": epoch_sec, "steps_per_epoch": steps_per_epoch,
        "step_ms": steady / steps_per_epoch * 1e3,
        "examples_per_sec": steps_per_epoch * TT_BATCH / steady,
        "losses": losses, "final_loss": losses[-1],
        "loss_bar_0.75_ln_batch": 0.75 * float(np.log(TT_BATCH)),
        "flash_ce_launches": flash_launches,
        "embed_update_launches": embed_launches,
        "topk_dot_launches": topk_launches, "kernel_plan": plan,
        "peak_train_mem_bytes": peak_mem, "serve": served,
        "step_profile": profiled,
    }


# -- ALS train phase -----------------------------------------------------------

def synth_ratings():
    """bench.py's ``synthesize`` at DEFAULT_KNOBS from ``default_rng(0)``:
    ratings with planted rank-8 structure, clip(3 + 1.2 z + noise) in
    half-stars, over Zipf-popular items."""
    rng = np.random.default_rng(0)
    n = ALS_RATINGS
    uu = rng.integers(0, N_USERS, size=n, dtype=np.int64)
    ii = (rng.zipf(1.2, size=n) % N_ITEMS).astype(np.int64)
    U = rng.normal(size=(N_USERS, 8)).astype(np.float32)
    V = rng.normal(size=(N_ITEMS, 8)).astype(np.float32)
    z = np.einsum("nk,nk->n", U[uu], V[ii]) / np.sqrt(8.0)
    raw = 3.0 + 1.2 * z + rng.normal(0, 0.35, size=n).astype(np.float32)
    vals = np.clip(np.round(raw * 2.0) / 2.0, 0.5, 5.0).astype(np.float64)
    return uu, ii, vals


def store_and_deploy(model, params, instance_id: str, user_names,
                     item_names, what: str) -> dict:
    """A trained ALS model as a COMPLETED engine instance and its blob in
    a memory store, deployed with the port's EngineServer on the card
    and asked 20 queries, each checked against a float64 host top-k of
    the model's factors."""
    import datetime as dt

    from predictionio_torch.data.metadata import EngineInstance, Model
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.templates.recommendation import (
        recommendation_engine)
    from predictionio_torch.workflow.train import serialize_models

    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    now = dt.datetime.now(tz=dt.timezone.utc)
    storage.engine_instances().insert(EngineInstance(
        id=instance_id, status="COMPLETED", start_time=now, end_time=now,
        engine_id=instance_id, engine_version="0", engine_variant="default",
        engine_factory=("predictionio_torch.templates.recommendation."
                        "recommendation_engine"),
        data_source_params=json.dumps({"name": "", "params": {}}),
        preparator_params=json.dumps({"name": "", "params": {}}),
        algorithms_params=json.dumps([{"name": "als", "params":
                                       dataclasses.asdict(params)}]),
        serving_params=json.dumps({"name": "", "params": {}})))
    storage.models().insert(Model(id=instance_id,
                                  models=serialize_models([model])))
    truth = Truth(model.user_factors, model.item_factors, user_names,
                  item_names)
    queries = tt_queries(truth, np.random.default_rng(SEED + 5),
                         len(user_names), len(item_names))
    lone = sum(1 for q in queries if "item" in q or q["user"] in truth.users)
    served = deploy_and_check(recommendation_engine(), storage, instance_id,
                              truth, queries, what)
    return {**served, "lone_queries": lone}


def als_train_phase(ratings) -> dict:
    import torch
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                               PreparedRatings)
    from predictionio_torch.ops.als import (ALSConfig, ALSFactors,
                                            ALSTrainer, predict_rmse)
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.tools.als_timing import stage_profile

    uu, ii, vals = ratings
    hold = np.arange(ALS_RATINGS) % 20 == 0          # bench's 5% holdout
    train = (uu[~hold], ii[~hold], vals[~hold].astype(np.float32))
    held = (uu[hold], ii[hold], vals[hold])
    cfg = ALSConfig(rank=RANK, iterations=ALS_ITERS, reg=ALS_REG,
                    block_size=ALS_BLOCK)

    # the trainer alone: binning, transfer, compile, 5 timed alternations
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = ALSTrainer(train, N_USERS, N_ITEMS, cfg, device="cuda")
    trainer.compile()
    t0 = time.perf_counter()
    trainer.step_n()
    train_sec = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    factors = trainer.factors()
    rmse_trainer = predict_rmse(factors, held)
    if not (np.all(np.isfinite(factors.user_factors))
            and np.all(np.isfinite(factors.item_factors))):
        fail("ALS factors are not finite")
    if not RMSE_BAND[0] < rmse_trainer < RMSE_BAND[1]:
        fail(f"ALS held-out RMSE {rmse_trainer} outside {RMSE_BAND}")
    layout = trainer.layout()
    profile = stage_profile(trainer, train_sec * 1e3 / ALS_ITERS)
    timing = {"bin_sec": trainer.bin_sec, "put_sec": trainer.put_sec,
              "compile_sec": trainer.compile_sec, "train_sec": train_sec,
              "work_model": trainer.work_model()}
    del trainer
    torch.cuda.empty_cache()

    # the main path: ALSAlgorithm.train, serialize, deploy, serve
    user_names = [f"u{j}" for j in range(N_USERS)]
    item_names = [f"i{j}" for j in range(N_ITEMS)]
    pd = PreparedRatings(user_ids=BiMap.from_vocab(user_names),
                         item_ids=BiMap.from_vocab(item_names),
                         user_idx=train[0], item_idx=train[1],
                         ratings=train[2])
    params = ALSParams(rank=RANK, num_iterations=ALS_ITERS, lambda_=ALS_REG,
                       block_size=ALS_BLOCK)
    for counter in (fce.launches, eu.launches, tkd.launches):
        counter.reset()
    t0 = time.perf_counter()
    algorithm = ALSAlgorithm(params)
    model = algorithm.train(DeviceContext("cuda"), pd)
    algorithm_train_sec = time.perf_counter() - t0
    rmse = predict_rmse(ALSFactors(model.user_factors, model.item_factors),
                        held)
    if not RMSE_BAND[0] < rmse < RMSE_BAND[1]:
        fail(f"ALSAlgorithm.train held-out RMSE {rmse} outside {RMSE_BAND}")
    served = store_and_deploy(model, params, "als-ml20m", user_names,
                              item_names, "ALS phase")
    del model
    topk_launches = tkd.launches.value
    if topk_launches < served["lone_queries"]:
        fail(f"topk_dot launched {topk_launches} times for "
             f"{served['lone_queries']} lone user/item queries to the "
             "trained ALS model")
    if fce.launches.value or eu.launches.value:
        fail("the ALS path launched a two-tower kernel")
    return {
        "config": {"users": N_USERS, "items": N_ITEMS,
                   "ratings": ALS_RATINGS, "held_out": int(hold.sum()),
                   "rank": RANK, "iterations": ALS_ITERS, "reg": ALS_REG,
                   "block_size": ALS_BLOCK, "compute_dtype": "bfloat16",
                   "cg": "jacobi, 6 steps, bfloat16"},
        "layout": layout, **timing,
        "rmse_heldout": rmse_trainer, "rmse_band": RMSE_BAND,
        "peak_train_mem_bytes": peak_mem, "profile": profile,
        "algorithm_train_sec": algorithm_train_sec,
        "algorithm_lane": algorithm.last_train,
        "algorithm_rmse_heldout": rmse,
        "topk_dot_launches": topk_launches, "serve": served,
    }


# -- ingest phase --------------------------------------------------------------

def first_seen(codes: np.ndarray, n: int):
    """(old code -> its rank in first-appearance order, the codes in
    that order): the native scan's dictionary order."""
    uniq, first = np.unique(codes, return_index=True)
    order = uniq[np.argsort(first)]
    remap = np.full(n, -1, np.int64)
    remap[order] = np.arange(len(order))
    return remap, order


def same_side(got, want, what: str) -> None:
    """Two compressed sides must be byte-equal."""
    for name in ("idx_lo", "idx_hi", "val", "mask", "seg", "counts"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or a.shape != b.shape
                or a.tobytes() != b.tobytes())):
            fail(f"{what}: {name} differs from build_compressed_side's")
    for name in ("affine", "row_block", "group_block", "groups_per_shard",
                 "n_shards"):
        if getattr(got, name) != getattr(want, name):
            fail(f"{what}: {name} {getattr(got, name)} != "
                 f"{getattr(want, name)}")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def temp_store(prefix: str, need: int) -> str:
    """A new temporary directory with ``need`` bytes free, for a
    20M-event log and its layout cache."""
    root = tempfile.mkdtemp(prefix=prefix)
    free = shutil.disk_usage(root).free
    if free < need:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"{root} has {free} bytes free; the 20M-event log and its "
             f"layout cache need {need}")
    return root


def ingest_phase(ratings, coo_profile: dict) -> dict:
    """The north star's data lane at bench.py's cold-stage width: the
    ALS phase's 20M ratings into a port eventlog store, the row lane,
    the fused scan+bin, a trainer from the binned sides, then the main
    path through ALSAlgorithm (cold, then warm from the layout cache),
    deployed and answered through topk_dot."""
    import torch
    from predictionio_torch.data.storage import EventColumns, Storage
    from predictionio_torch.data.storage import set_storage
    from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                               PreparedRatings)
    from predictionio_torch.ops.als import (ALSConfig, ALSFactors,
                                            ALSTrainer, als_row_cost_slots,
                                            build_compressed_side,
                                            predict_rmse,
                                            side_layout_from_binned)
    from predictionio_torch.ops.kernels import embed_update as eu
    from predictionio_torch.ops.kernels import flash_ce as fce
    from predictionio_torch.ops.kernels import topk_dot as tkd
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.templates.recommendation import (
        RecoDataSource, RecoDataSourceParams)
    from predictionio_torch.tools.als_timing import stage_profile

    uu, ii, vals = ratings
    n = len(uu)
    root = temp_store("pio_chip_smoke_eventlog_", INGEST_DISK_BYTES)
    free = shutil.disk_usage(root).free
    old_cache = os.environ.get("PIO_BIN_CACHE_DIR")
    os.environ["PIO_BIN_CACHE_DIR"] = os.path.join(root, "bin_cache")
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                                "PIO_STORAGE_SOURCES_EL_PATH": root})
    events = storage.events()
    set_storage(storage)
    try:
        app = storage.apps().insert("ml20m")
        events.init(app.id)
        cols = EventColumns(
            entity_codes=uu.astype(np.int32), target_codes=ii.astype(np.int32),
            name_codes=np.zeros(n, np.int32), values=vals,
            times_us=np.arange(n, dtype=np.int64) * 1_000_000,
            entity_vocab=[f"u{j}" for j in range(N_USERS)],
            target_vocab=[f"i{j}" for j in range(N_ITEMS)], names=["rate"])
        t0 = time.perf_counter()
        if events.insert_columnar(cols, app.id, entity_type="user",
                                  target_entity_type="item",
                                  value_property="rating") != n:
            fail("insert_columnar did not take every row")
        ingest_sec = time.perf_counter() - t0
        del cols
        log_bytes = dir_bytes(os.path.join(root, "events"))

        # the event server's row lane: bench.py's 100,000-row JSON array
        # of an event the training read leaves out
        sample = 100_000
        raw = json.dumps([
            {"event": "bench-row", "entityType": "user",
             "entityId": f"u{int(uu[k])}", "targetEntityType": "item",
             "targetEntityId": f"i{int(ii[k])}",
             "properties": {"rating": float(vals[k])},
             "eventTime": f"2026-01-01T{(k // 3600) % 24:02d}:"
                          f"{(k // 60) % 60:02d}:{k % 60:02d}.000Z"}
            for k in range(sample)]).encode()
        t0 = time.perf_counter()
        _, codes, _, _ = events.insert_json_batch(raw, app.id)
        row_lane_sec = time.perf_counter() - t0
        if len(codes) != sample or any(codes):
            fail("the JSON row lane rejected rows")
        del raw

        # the fused scan+bin, as the template's request makes it, with
        # bench's 5% holdout
        source = RecoDataSource(RecoDataSourceParams(app_name="ml20m"))
        request = source.read_training(None).binned_request
        if request is None:
            fail("the template did not take the binned lane on eventlog")
        cfg = ALSConfig(rank=RANK, iterations=ALS_ITERS, reg=ALS_REG,
                        block_size=ALS_BLOCK)
        t0 = time.perf_counter()
        binned = request.bin(skip_mod=20, skip_rem=0, seg_len=cfg.seg_len,
                             n_shards=1, block_size=cfg.block_size,
                             row_cost_slots=als_row_cost_slots(cfg.rank))
        bin_wall_sec = time.perf_counter() - t0
        n_hold = len(binned.holdout[0])
        if binned.n_rows + n_hold != n or n_hold != (n + 19) // 20:
            fail(f"scan+bin kept {binned.n_rows} + {n_hold} held-out rows "
                 f"of {n}")
        # byte-equal to the COO route over the same split, the ids
        # renumbered in the scan's first-seen order
        (ru, users), (ri, items) = (first_seen(uu, N_USERS),
                                    first_seen(ii, N_ITEMS))
        if (binned.entity_vocab != [f"u{j}" for j in users]
                or binned.target_vocab != [f"i{j}" for j in items]):
            fail("the scan's vocabularies are not first-seen order")
        keep = np.arange(n) % 20 != 0
        tu, ti = ru[uu[keep]], ri[ii[keep]]
        tv = vals[keep].astype(np.float32)
        t0 = time.perf_counter()
        want_user = build_compressed_side(tu, ti, tv, len(users), cfg, 1,
                                          None)
        want_item = build_compressed_side(ti, tu, tv, len(items), cfg, 1,
                                          None)
        coo_bin_sec = time.perf_counter() - t0
        user_side = side_layout_from_binned(binned.user_side)
        item_side = side_layout_from_binned(binned.item_side)
        same_side(user_side, want_user, "binned user side")
        same_side(item_side, want_item, "binned item side")
        del want_user, want_item, tu, ti, tv
        held = tuple(np.asarray(a) for a in binned.holdout)

        # a trainer from the binned sides: compile, 5 timed alternations
        torch.cuda.empty_cache()
        trainer = ALSTrainer.from_sides(
            user_side, item_side, len(binned.entity_vocab),
            len(binned.target_vocab), binned.n_rows, cfg, device="cuda")
        del user_side, item_side
        scan = {"scan_sec": binned.scan_sec, "bin_sec": binned.bin_sec,
                "bin_wall_sec": bin_wall_sec}
        del binned
        trainer.compile()
        t0 = time.perf_counter()
        trainer.step_n()
        train_sec = time.perf_counter() - t0
        factors = trainer.factors()
        rmse = predict_rmse(factors, held)
        if not RMSE_BAND[0] < rmse < RMSE_BAND[1]:
            fail(f"binned-lane held-out RMSE {rmse} outside {RMSE_BAND}")
        profile = stage_profile(trainer, train_sec * 1e3 / ALS_ITERS)
        from_sides = {"put_sec": trainer.put_sec,
                      "compile_sec": trainer.compile_sec,
                      "train_sec": train_sec, "rmse_heldout": rmse,
                      "layout": trainer.layout(), "profile": profile,
                      "device_ms_vs_coo_phase":
                      profile["device_ms_per_alternation"]
                      / coo_profile["device_ms_per_alternation"]}
        del trainer, factors
        torch.cuda.empty_cache()

        # the main path: pio train's read and ALSAlgorithm on all the
        # events, cold (one scan+bin, saved to the cache), then warm (the
        # cache, no scan), deployed and answered through topk_dot
        params = ALSParams(rank=RANK, num_iterations=ALS_ITERS,
                           lambda_=ALS_REG, block_size=ALS_BLOCK)
        for counter in (fce.launches, eu.launches, tkd.launches):
            counter.reset()
        runs = {}
        for run in ("cold", "warm"):
            calls = events.bin_columnar_calls
            td = source.read_training(None)
            pd = PreparedRatings(binned_request=td.binned_request,
                                 fingerprint=td.fingerprint)
            algorithm = ALSAlgorithm(params)
            t0 = time.perf_counter()
            model = algorithm.train(DeviceContext("cuda"), pd)
            runs[run] = {"sec": time.perf_counter() - t0,
                         "scans": events.bin_columnar_calls - calls,
                         **algorithm.last_train}
        if runs["cold"]["scans"] != 1 or runs["cold"]["cache_hit"]:
            fail(f"the cold train did not scan once: {runs['cold']}")
        if runs["warm"]["scans"] != 0 or not runs["warm"]["cache_hit"]:
            fail(f"the warm retrain did not load the cache: {runs['warm']}")
        if not (np.all(np.isfinite(model.user_factors))
                and np.all(np.isfinite(model.item_factors))):
            fail("the warm-trained factors are not finite")
        served = store_and_deploy(model, params, "als-eventlog",
                                  list(model.user_ids.keys()),
                                  list(model.item_ids.keys()),
                                  "ingest phase")
        topk_launches = tkd.launches.value
        if topk_launches < served["lone_queries"]:
            fail(f"topk_dot launched {topk_launches} times for "
                 f"{served['lone_queries']} lone queries in the ingest "
                 "phase")
        if fce.launches.value or eu.launches.value:
            fail("the ingest phase launched a two-tower kernel")
        return {
            "events": n, "ingest_sec": ingest_sec,
            "ingest_events_per_sec": n / ingest_sec,
            "log_bytes": log_bytes, "log_bytes_per_event": log_bytes / n,
            "disk_free_bytes": free,
            "row_lane": {"events": sample, "sec": row_lane_sec,
                         "events_per_sec": sample / row_lane_sec},
            **scan, "n_rows": n - n_hold, "held_out": n_hold,
            "coo_native_bin_sec": coo_bin_sec, "from_sides": from_sides,
            "algorithm": runs,
            "events_to_model_sec": ingest_sec + runs["cold"]["sec"],
            "topk_dot_launches": topk_launches, "serve": served,
        }
    finally:
        set_storage(None)
        events.close()
        shutil.rmtree(root, ignore_errors=True)
        if old_cache is None:
            os.environ.pop("PIO_BIN_CACHE_DIR", None)
        else:
            os.environ["PIO_BIN_CACHE_DIR"] = old_cache


# -- front-door phase ----------------------------------------------------------

def iso_at(sec: int) -> str:
    """The API form of an event time ``sec`` seconds after the epoch."""
    import datetime as dt

    t = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(
        seconds=int(sec))
    return t.isoformat().replace("+00:00", "Z")


def rate_json(u: int, i: int, v: float, sec: int) -> str:
    return (f'{{"event":"rate","entityType":"user","entityId":"u{u}",'
            f'"targetEntityType":"item","targetEntityId":"i{i}",'
            f'"properties":{{"rating":{v}}},"eventTime":"{iso_at(sec)}"}}')


def view_json(name: str, u: str, i: int, sec: int) -> str:
    return (f'{{"event":"{name}","entityType":"user","entityId":"{u}",'
            f'"targetEntityType":"item","targetEntityId":"i{i}",'
            f'"eventTime":"{iso_at(sec)}"}}')


def send_bodies(port: int, path: str, bodies, conns: int):
    """POST every body over ``conns`` keep-alive connections at once. ->
    ([(status, response bytes)] in body order, wall seconds)."""
    import http.client

    results = [None] * len(bodies)
    errors = []

    def worker(w: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            for j in range(w, len(bodies), conns):
                conn.request("POST", path, body=bodies[j],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                results[j] = (resp.status, resp.read())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{type(e).__name__}: {e}")
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"batch POSTs failed: {errors[:3]}")
    return results, wall


def batch_statuses(status: int, raw: bytes, what: str) -> list:
    if status != 200:
        fail(f"{what}: POST /batch/events.json answered {status}: "
             f"{raw[:300]!r}")
    return [row["status"] for row in json.loads(raw)]


def batch_lane_split(bodies) -> dict:
    """Where the batch route's server time goes, per event, in this
    process on a store of its own: the native lane alone
    (``insert_json_batch``), ``EventServerCore.create_events_batch`` on
    the same bodies (the native lane, then the per-row result dicts and
    ``Stats.update``), and the response's JSON encoding."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.serving.event_server import (AuthData,
                                                         EventServerCore)

    root = tempfile.mkdtemp(prefix="pio_chip_smoke_split_")
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                                "PIO_STORAGE_SOURCES_EL_PATH": root})
    events = storage.events()
    try:
        app = storage.apps().insert("split")
        events.init(app.id)
        core = EventServerCore(storage)
        auth = AuthData(app_id=app.id, channel_id=None, events=[])
        native = route = encode = 0.0
        n = 0
        for body in bodies:
            t0 = time.perf_counter()
            events.insert_json_batch(body, app.id, strict=False)
            t1 = time.perf_counter()
            status, results = core.create_events_batch(auth, body)
            t2 = time.perf_counter()
            json.dumps(results).encode()
            t3 = time.perf_counter()
            if status != 200:
                fail(f"the batch route answered {status} in process")
            native += t1 - t0
            route += t2 - t1
            encode += t3 - t2
            n += len(results)
        return {"events": n, "native_us": 1e6 * native / n,
                "route_us": 1e6 * route / n,
                "result_loop_us": 1e6 * (route - native) / n,
                "encode_us": 1e6 * encode / n}
    finally:
        events.close()
        shutil.rmtree(root, ignore_errors=True)


def front_door_phase(ratings) -> dict:
    """The main path from its front door, at the ALS phase's width: ``cli
    app new`` and ``accesskey new``; the first 19M ratings as history by
    ``insert_columnar``; ``cli eventserver`` takes the last 1M as live
    traffic (batches over 4 keep-alive connections, lone POSTs), a
    whitelisted key's batch (the per-row lane, 403s), reads and stats,
    and drains an in-flight batch on SIGTERM; ``cli train`` scans all
    20M ratings once on the binned lane, ``cli deploy`` answers through
    ``topk_dot``, and ``cli status`` passes."""
    import ast
    import http.client

    from predictionio_torch.data.storage import EventColumns, Storage

    uu, ii, vals = ratings
    n = len(uu)
    hist = FD_HISTORY
    root = temp_store("pio_chip_smoke_front_door_", INGEST_DISK_BYTES)
    env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
           "PIO_STORAGE_SOURCES_EL_PATH": root}
    here = os.path.dirname(os.path.abspath(__file__))
    sub_env = {**os.environ, **env, "PYTHONPATH": here,
               "PIO_BIN_CACHE_DIR": os.path.join(root, "bin_cache"),
               "PIO_DRAIN_TIMEOUT": str(FD_DRAIN_TIMEOUT)}
    cli = [sys.executable, "-m", "predictionio_torch.tools.cli"]
    server = None
    server_log = os.path.join(root, "eventserver.log")
    try:
        # 1. the app and its keys, through the CLI
        out = run_cli(cli, ["app", "new", "ml20m"], sub_env, here,
                      "front door").stdout
        key = next(line.split(": ", 1)[1] for line in out.splitlines()
                   if line.startswith("Access Key: "))
        out = run_cli(cli, ["accesskey", "new", "ml20m", "view"], sub_env,
                      here, "front door").stdout
        view_key = next(line.split(": ", 1)[1] for line in out.splitlines()
                        if line.startswith("Created new access key: "))

        # 2. the history: bench's bulk lane, then close (one writer)
        storage = Storage.from_env(env)
        app = storage.apps().get_by_name("ml20m")
        cols = EventColumns(
            entity_codes=uu[:hist].astype(np.int32),
            target_codes=ii[:hist].astype(np.int32),
            name_codes=np.zeros(hist, np.int32), values=vals[:hist],
            times_us=np.arange(hist, dtype=np.int64) * 1_000_000,
            entity_vocab=[f"u{j}" for j in range(N_USERS)],
            target_vocab=[f"i{j}" for j in range(N_ITEMS)], names=["rate"])
        t0 = time.perf_counter()
        if storage.events().insert_columnar(
                cols, app.id, entity_type="user", target_entity_type="item",
                value_property="rating") != hist:
            fail("insert_columnar did not take every history row")
        history_sec = time.perf_counter() - t0
        storage.events().close()
        del cols

        # the live traffic, built before the clock starts
        live = [rate_json(u, i, v, k) for k, (u, i, v) in enumerate(
            zip(uu[hist:].tolist(), ii[hist:].tolist(),
                vals[hist:].tolist()), start=hist)]
        n_batched = n - hist - FD_LONE
        bodies = [("[" + ",".join(live[s:min(s + FD_BATCH, n_batched)])
                   + "]").encode() for s in range(0, n_batched, FD_BATCH)]
        lone = [row.encode() for row in live[n_batched:]]
        split = batch_lane_split(bodies[:10])
        rng = np.random.default_rng(SEED + 6)
        read_users = [f"u{j}" for j in rng.choice(uu[hist:], FD_READS,
                                                   replace=False)]
        views = []          # (user, item) of the whitelisted key's views
        wl_rows, wl_want = [], []
        for j in range(FD_VIEWS + FD_DENIED):
            user, item = read_users[j % FD_READS], int(ii[j])
            denied = j % ((FD_VIEWS + FD_DENIED) // FD_DENIED) == 0
            wl_rows.append(view_json("rate" if denied else "view", user,
                                     item, n + j))
            wl_want.append(403 if denied else 201)
            if not denied:
                views.append((user, item, n + j))
        if wl_want.count(403) != FD_DENIED:
            fail("the whitelist batch is not 990 views and 10 rates")
        wl_body = ("[" + ",".join(wl_rows) + "]").encode()
        drain_body = ("[" + ",".join(
            view_json("view", f"u{int(uu[j])}", int(ii[j]), 2 * n + j)
            for j in range(FD_BATCH)) + "]").encode()
        del live

        # 3. the server
        port = free_port()
        with open(server_log, "w") as logf:
            server = subprocess.Popen(
                cli + ["eventserver", "--ip", "127.0.0.1", "--port",
                       str(port)], env=sub_env, cwd=here, stdout=logf,
                stderr=subprocess.STDOUT)
        wait_healthy(port, server, "cli eventserver", server_log, 120)

        # 4. live traffic: batches, lone POSTs, the whitelist, reads, stats
        t_first_post = time.perf_counter()
        results, batch_wall = send_bodies(
            port, f"/batch/events.json?accessKey={key}", bodies, FD_CONNS)
        accepted = 0
        for j, (status, raw) in enumerate(results):
            codes = batch_statuses(status, raw, f"live batch {j}")
            if set(codes) != {201}:
                fail(f"live batch {j}: statuses {sorted(set(codes))}")
            accepted += len(codes)
        if accepted != n_batched:
            fail(f"{accepted} of {n_batched} batched events acknowledged")
        del results, bodies
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        lone_ms = []
        for j, body in enumerate(lone):
            t0 = time.perf_counter()
            conn.request("POST", f"/events.json?accessKey={key}", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            lone_ms.append(1e3 * (time.perf_counter() - t0))
            if resp.status != 201 or "eventId" not in json.loads(raw):
                fail(f"lone POST {j} answered {resp.status}: {raw[:300]!r}")
        t0 = time.perf_counter()
        conn.request("POST", f"/batch/events.json?accessKey={view_key}",
                     body=wl_body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        codes = batch_statuses(resp.status, resp.read(), "whitelist batch")
        wl_sec = time.perf_counter() - t0
        if codes != wl_want:
            fail(f"the whitelisted key's batch answered {codes[:20]}...")
        read_ms = []
        for user in read_users:
            t0 = time.perf_counter()
            conn.request("GET", f"/events.json?accessKey={key}&entityType="
                                f"user&entityId={user}&limit=-1")
            resp = conn.getresponse()
            got = json.loads(resp.read())
            read_ms.append(1e3 * (time.perf_counter() - t0))
            rows = np.flatnonzero(uu == int(user[1:]))
            want = sorted([("rate", f"i{int(ii[k])}", float(vals[k]),
                            iso_at(k)) for k in rows]
                          + [("view", f"i{i}", None, iso_at(sec))
                             for u, i, sec in views if u == user])
            have = sorted((d["event"], d.get("targetEntityId"),
                           d.get("properties", {}).get("rating"),
                           d["eventTime"]) for d in got) \
                if resp.status == 200 else []
            if have != want:
                fail(f"GET /events.json for {user}: {len(have)} events, "
                     f"{len(want)} expected")
        conn.request("GET", f"/stats.json?accessKey={key}")
        stats = json.loads(conn.getresponse().read())
        counts = {}
        for bucket in stats["buckets"]:
            for c in bucket["counts"]:
                k = (c["status"], c["event"], c["entityType"])
                counts[k] = counts.get(k, 0) + c["count"]
        want_counts = {(201, "rate", "user"): n - hist,
                       (201, "view", "user"): FD_VIEWS,
                       (403, "rate", "user"): FD_DENIED}
        if counts != want_counts:
            fail(f"/stats.json counts {counts}, sent {want_counts}")

        # 5. SIGTERM with a batch in flight on an open connection
        conn.request("GET", "/healthz")
        conn.getresponse().read()
        conn.request("POST", f"/batch/events.json?accessKey={key}",
                     body=drain_body,
                     headers={"Content-Type": "application/json"})
        t_term = time.perf_counter()
        server.send_signal(signal.SIGTERM)
        resp = conn.getresponse()
        codes = batch_statuses(resp.status, resp.read(), "in-flight batch")
        conn.close()
        if codes != [201] * FD_BATCH:
            fail("the batch in flight at SIGTERM was not acknowledged")
        try:
            rc = server.wait(timeout=FD_DRAIN_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"cli eventserver outlived its {FD_DRAIN_TIMEOUT} s drain")
        drain_sec = time.perf_counter() - t_term
        if rc != 0:
            fail(f"cli eventserver exited {rc} after SIGTERM")

        # 6. train on every rating, deploy, answer through topk_dot
        engine_json = os.path.join(root, "engine.json")
        with open(engine_json, "w") as f:
            json.dump({"id": "default", "engineId": "ml20m-front-door",
                       "engineFactory": ("predictionio_torch.templates."
                                         "recommendation."
                                         "recommendation_engine"),
                       "datasource": {"params": {"app_name": "ml20m"}},
                       "algorithms": [{"name": "als", "params": {
                           "rank": RANK, "num_iterations": ALS_ITERS,
                           "lambda_": ALS_REG, "block_size": ALS_BLOCK}}]},
                      f)
        lone_queries = []

        def queries(truth):
            qs = tt_queries(truth, np.random.default_rng(SEED + 7),
                            N_USERS, len(truth.item_names))
            lone_queries.extend(q for q in qs
                                if "item" in q or q["user"] in truth.users)
            return qs

        served = cli_train_and_deploy(cli, engine_json, "ml20m-front-door",
                                      env, sub_env, here, queries,
                                      "front door")
        lines = [line for line in served["train_log"].splitlines()
                 if "ALS trained on the " in line]
        if len(lines) != 1 or "on the binned lane" not in lines[0]:
            fail(f"cli train did not log one binned-lane train: {lines}")
        trained = ast.literal_eval(lines[0].split(" lane: ", 1)[1])
        if trained["cache_hit"] or "scan_sec" not in trained:
            fail(f"cli train did not scan the log once: {trained}")
        if trained["ratings"] != n:
            fail(f"cli train read {trained['ratings']} ratings of the {n} "
                 "acknowledged")
        before = served["retrieval_before"][0]
        after = served["retrieval_after"][0]
        launches = after["kernel_launches"] - before["kernel_launches"]
        if not after["kernel"]["engaged"] or launches < len(lone_queries):
            fail(f"topk_dot launched {launches} times for "
                 f"{len(lone_queries)} lone queries behind cli deploy")

        # 7. status
        out = run_cli(cli, ["status"], sub_env, here, "front door").stdout
        if "(sleeping)" not in out:
            fail(f"cli status: {out}")
        lone_ms.sort()
        return {
            "events": n, "history_events": hist,
            "history_insert_sec": history_sec,
            "live_batch": {"events": n_batched,
                           "requests": len(range(0, n_batched, FD_BATCH)),
                           "connections": FD_CONNS, "sec": batch_wall,
                           "events_per_sec": n_batched / batch_wall,
                           "requests_per_sec":
                           len(range(0, n_batched, FD_BATCH)) / batch_wall},
            "batch_lane_split": split,
            "lone_post": {"events": FD_LONE,
                          "ms_p50": lone_ms[len(lone_ms) // 2],
                          "ms_p99": lone_ms[int(0.99 * len(lone_ms))]},
            "whitelist": {"events": FD_VIEWS + FD_DENIED,
                          "denied": FD_DENIED, "sec": wl_sec,
                          "events_per_sec": (FD_VIEWS + FD_DENIED) / wl_sec},
            "reads": {"count": FD_READS,
                      "ms_max": max(read_ms),
                      "ms_p50": sorted(read_ms)[FD_READS // 2]},
            "drain_sec": drain_sec,
            "cli_train": {"sec": served["train_sec"],
                          "scan_sec": trained["scan_sec"],
                          "bin_sec": trained["native_bin_sec"],
                          "alternations_sec": trained["train_sec"],
                          "put_sec": trained["put_sec"],
                          "ratings": trained["ratings"]},
            "events_to_answers_sec": served["first_answer_at"] - t_first_post,
            "topk_dot_launches": launches,
            "lone_queries": len(lone_queries),
        }
    finally:
        if server is not None and server.poll() is None:
            server.kill()
            server.wait()
        shutil.rmtree(root, ignore_errors=True)


# -- pio train phase -----------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_cli(cli, args, sub_env: dict, cwd: str, what: str,
            timeout: float = 600) -> subprocess.CompletedProcess:
    """One ``predictionio_torch.tools.cli`` command in a subprocess; a
    non-zero exit fails the run."""
    out = subprocess.run(cli + args, env=sub_env, cwd=cwd,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        fail(f"pio {' '.join(args[:2])} ({what}) exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    return out


def wait_healthy(port: int, proc, what: str, log_path: str = None,
                 limit: float = 300) -> None:
    """Wait for the server ``proc`` to answer ``GET /healthz``; its output
    is in ``log_path`` or on its stdout pipe."""
    deadline = time.time() + limit
    while True:
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10).read()
            return
        except OSError:
            if proc.poll() is not None or time.time() > deadline:
                if log_path is None:
                    tail = proc.stdout.read()
                else:
                    with open(log_path) as f:
                        tail = f.read()
                fail(f"{what} did not come up: {tail[-2000:]}")
            time.sleep(0.2)


def get_json(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def cli_train_and_deploy(cli, engine_json: str, engine_id: str, env: dict,
                         sub_env: dict, cwd: str, queries, what: str) -> dict:
    """``cli train`` then ``cli deploy`` of one engine.json in
    subprocesses; every query's answer (``queries``, or ``queries(truth)``
    when it is a function of the stored model) is checked against the
    stored model's factors. -> the train's seconds and log, the stored
    model and instance id, the wall-clock time of the first checked
    answer, and ``GET /``'s retrieval block before and after the
    queries."""
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.workflow.deploy import load_blob

    t0 = time.perf_counter()
    out = run_cli(cli, ["train", "--engine-json", engine_json], sub_env,
                  cwd, what)
    train_sec = time.perf_counter() - t0
    instance = Storage.from_env(env).engine_instances() \
        .get_latest_completed(engine_id, "0", "default")
    if instance is None:
        fail(f"pio train ({what}) stored no COMPLETED instance")
    model = load_blob(Storage.from_env(env).models()
                      .get(instance.id).models)[0]
    truth = Truth(model.user_factors, model.item_factors,
                  list(model.user_ids.keys()), list(model.item_ids.keys()))
    if callable(queries):
        queries = queries(truth)
    port = free_port()
    proc = subprocess.Popen(
        cli + ["deploy", "--engine-json", engine_json, "--ip",
               "127.0.0.1", "--port", str(port)],
        env=sub_env, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        wait_healthy(port, proc, f"pio deploy ({what})")
        before = get_json(port, "/")["retrieval"]
        first_answer = None
        for j, q in enumerate(queries):
            check_answer(truth, q, post(port, q),
                         f"pio deploy ({what}) query {j}")
            if first_answer is None:
                first_answer = time.perf_counter()
        after = get_json(port, "/")["retrieval"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"train_sec": train_sec, "model": model, "instance": instance.id,
            "train_log": out.stderr, "queries": queries,
            "first_answer_at": first_answer, "retrieval_before": before,
            "retrieval_after": after}


def cli_app_with_events(cli, sub_env: dict, cwd: str, app: str,
                        jsonl: str, want: set, what: str) -> dict:
    """``cli app new``, ``cli import`` of a JSONL file, then ``cli
    export``, which must give back the same set of API-format events
    (``eventId`` and ``creationTime`` aside). -> seconds of each."""
    t0 = time.perf_counter()
    run_cli(cli, ["app", "new", app], sub_env, cwd, what)
    t1 = time.perf_counter()
    out = run_cli(cli, ["import", "--appname", app, "--input", jsonl],
                  sub_env, cwd, what)
    if f"Imported {len(want)} event(s)." not in out.stdout:
        fail(f"pio import ({what}): {out.stdout[-500:]}")
    t2 = time.perf_counter()
    exported = jsonl + ".export"
    run_cli(cli, ["export", "--appname", app, "--output", exported],
            sub_env, cwd, what)
    t3 = time.perf_counter()
    with open(exported) as f:
        got = [json.loads(line) for line in f]
    back = {json.dumps({k: v for k, v in d.items()
                        if k not in ("eventId", "creationTime")},
                       sort_keys=True) for d in got}
    if len(got) != len(want) or back != want:
        fail(f"pio export ({what}) did not give back the imported events")
    return {"app_new_sec": t1 - t0, "import_sec": t2 - t1,
            "export_sec": t3 - t2}


def pio_train_phase(store: str) -> dict:
    """In the directory ``store``, which the caller removes: the eval
    phase reads the eventlog events this phase imports."""
    import datetime as dt

    from predictionio_torch.data.event import Event

    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": store}
    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(SEED + 3)
    n_users, n_items, n = 943, 1682, 100_000
    us = rng.integers(1, n_users + 1, n)
    its = rng.integers(1, n_items + 1, n)
    rs = rng.integers(1, 6, n)
    t0 = dt.datetime(1998, 1, 1, tzinfo=dt.timezone.utc)
    lines = [json.dumps({k: v for k, v in Event(
        event="rate", entity_type="user", entity_id=f"u{u}",
        target_entity_type="item", target_entity_id=f"i{i}",
        properties={"rating": float(r)},
        event_time=t0 + dt.timedelta(seconds=j)).to_dict(True).items()
        if k not in ("eventId", "creationTime")}, sort_keys=True)
        for j, (u, i, r) in enumerate(zip(us, its, rs))]
    jsonl = os.path.join(store, "ml100k.jsonl")
    with open(jsonl, "w") as f:
        f.write("\n".join(lines) + "\n")
    want = set(lines)
    sub_env = {**os.environ, **env, "PYTHONPATH": root}
    cli = [sys.executable, "-m", "predictionio_torch.tools.cli"]
    # the events go in through the CLI: app new, import, export back
    cli_io = cli_app_with_events(cli, sub_env, store, "ml100k", jsonl,
                                 want, "localfs")
    rng = np.random.default_rng(SEED + 4)
    queries = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(1, n_users + 1, 10)]
    queries += [{"item": f"i{i}", "num": 5}
                for i in rng.integers(1, n_items + 1, 5)]

    engine_json = os.path.join(store, "engine.json")
    with open(engine_json, "w") as f:
        json.dump({
            "id": "default", "engineId": "ml100k-tt",
            "engineFactory":
                "predictionio_torch.templates.twotower.twotower_engine",
            "datasource": {"params": {"app_name": "ml100k"}},
            "algorithms": [{"name": "twotower", "params": {
                "dim": 64, "batch_size": 1024, "epochs": 5}}]}, f)
    tt = cli_train_and_deploy(cli, engine_json, "ml100k-tt", env,
                              sub_env, store, queries, "two-tower")
    model = tt["model"]
    plan = model.kernel_plan
    if not (plan["flash_ce"] and plan["embed_update"]):
        fail(f"pio train did not run both kernels: {plan}")
    if not model.train_losses[-1] < model.train_losses[0]:
        fail(f"pio train losses did not fall: {model.train_losses}")

    als_json = os.path.join(store, "engine-als.json")
    with open(als_json, "w") as f:
        json.dump({
            "id": "default", "engineId": "ml100k-als",
            "engineFactory": ("predictionio_torch.templates."
                              "recommendation.recommendation_engine"),
            "datasource": {"params": {"app_name": "ml100k"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 16, "num_iterations": 10}}]}, f)
    als = cli_train_and_deploy(cli, als_json, "ml100k-als", env,
                               sub_env, store, queries, "ALS")
    als_model = als["model"]
    if not (np.all(np.isfinite(als_model.user_factors))
            and np.all(np.isfinite(als_model.item_factors))):
        fail("pio train (ALS) stored factors that are not finite")

    # the same events in an eventlog store, through the CLI too: pio
    # train takes the binned lane (its log says so) and pio deploy
    # serves the model
    el_env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
              "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(store, "el")}
    el_sub_env = {**os.environ, **el_env, "PYTHONPATH": root,
                  "PIO_BIN_CACHE_DIR": os.path.join(store, "bin_cache")}
    el_io = cli_app_with_events(cli, el_sub_env, store, "ml100k", jsonl,
                                want, "eventlog")
    el_json = os.path.join(store, "engine-als-eventlog.json")
    with open(el_json, "w") as f:
        json.dump({"id": "default", "engineId": "ml100k-als-el",
                   "engineFactory": ("predictionio_torch.templates."
                                     "recommendation."
                                     "recommendation_engine"),
                   "datasource": {"params": {"app_name": "ml100k"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 16, "num_iterations": 10}}]}, f)
    el = cli_train_and_deploy(cli, el_json, "ml100k-als-el", el_env,
                              el_sub_env, store, queries,
                              "ALS, eventlog")
    lane = [line for line in el["train_log"].splitlines()
            if "ALS trained on the binned lane" in line]
    if len(lane) != 1:
        fail(f"pio train on eventlog did not log the binned lane: "
             f"{el['train_log'][-2000:]}")
    if len(el["model"].user_ids) != len(als_model.user_ids):
        fail("pio train on eventlog saw other users than on localfs")
    return {"events": n, "cli_io": cli_io, "cli_io_eventlog": el_io,
            "train_sec": tt["train_sec"],
            "losses": model.train_losses, "kernel_plan": plan,
            "queries": len(queries), "instance": tt["instance"],
            "als": {"train_sec": als["train_sec"],
                    "instance": als["instance"],
                    "rank": int(als_model.item_factors.shape[1]),
                    "queries": len(queries)},
            "als_eventlog": {"train_sec": el["train_sec"],
                             "instance": el["instance"],
                             "train_log": lane[0][-600:],
                             "queries": len(queries)}}


# -- eval phase -----------------------------------------------------------------

class LogRecords(logging.Handler):
    """Keeps the records a logger emits while it is attached."""

    def __init__(self, logger: str):
        super().__init__(logging.INFO)
        self.records = []
        self.logger = logging.getLogger(logger)

    def emit(self, record) -> None:
        self.records.append(record)

    def __enter__(self):
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self)


def grid_phase(ratings, seq_rmse: float) -> dict:
    """(a) ``ALSAlgorithm.grid_train`` of GRID_* on the ALS phase's
    ratings and holdout, each candidate's held-out RMSE against its
    sequential oracle; then a grid trainer of the same candidates,
    profiled."""
    import torch
    from predictionio_torch.data.bimap import BiMap
    from predictionio_torch.models.als import (ALSAlgorithm, ALSParams,
                                               PreparedRatings)
    from predictionio_torch.ops.als import (ALSConfig, ALSFactors,
                                            ALSGridTrainer, predict_rmse)
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.tools.als_timing import grid_profile

    uu, ii, vals = ratings
    hold = np.arange(ALS_RATINGS) % 20 == 0
    train = (uu[~hold], ii[~hold], vals[~hold].astype(np.float32))
    held = (uu[hold], ii[hold], vals[hold])
    pd = PreparedRatings(
        user_ids=BiMap.from_vocab([f"u{j}" for j in range(N_USERS)]),
        item_ids=BiMap.from_vocab([f"i{j}" for j in range(N_ITEMS)]),
        user_idx=train[0], item_idx=train[1], ratings=train[2])
    params = [ALSParams(rank=RANK, num_iterations=it, lambda_=reg,
                        cg_iters=cg, block_size=ALS_BLOCK)
              for reg, it, cg in zip(GRID_REGS, GRID_ITERS, GRID_CG)]
    ctx = DeviceContext("cuda")

    def rmse_of(model) -> float:
        return predict_rmse(ALSFactors(model.user_factors,
                                       model.item_factors), held)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with LogRecords("predictionio_torch.models.als") as log:
        t0 = time.perf_counter()
        models = ALSAlgorithm.grid_train(ctx, pd, params)
        wall_sec = time.perf_counter() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    if models is None or len(models) != len(params):
        fail("ALSAlgorithm.grid_train declined the grid")
    costs = [r.args[1] for r in log.records
             if r.getMessage().startswith("ALS grid of 4 candidates")]
    if len(costs) != 1:
        fail("ALSAlgorithm.grid_train did not log its costs")
    rmses = [rmse_of(m) for m in models]
    if not all(np.isfinite(rmses)):
        fail(f"grid RMSEs not finite: {rmses}")
    del models
    if not RMSE_BAND[0] < rmses[0] < RMSE_BAND[1]:
        fail(f"grid candidate 1 RMSE {rmses[0]} outside {RMSE_BAND}")
    if abs(rmses[0] - seq_rmse) > 1e-2:
        fail(f"grid candidate 1 RMSE {rmses[0]} is not within 1e-2 of the "
             f"ALS phase's {seq_rmse}")
    # candidate 4's sequential oracle: 3 iterations of 4 CG steps
    t0 = time.perf_counter()
    oracle = ALSAlgorithm(params[3]).train(ctx, pd)
    oracle_sec = time.perf_counter() - t0
    oracle_rmse = rmse_of(oracle)
    del oracle
    if abs(rmses[3] - oracle_rmse) > 1e-2:
        fail(f"grid candidate 4 RMSE {rmses[3]} is not within 1e-2 of its "
             f"sequential train's {oracle_rmse}")

    # off the main path: the same grid as a trainer, timed and profiled
    torch.cuda.empty_cache()
    cfg = ALSConfig(rank=RANK, iterations=max(GRID_ITERS), reg=GRID_REGS[0],
                    block_size=ALS_BLOCK, seed=params[0].seed)
    trainer = ALSGridTrainer(train, N_USERS, N_ITEMS, cfg, regs=GRID_REGS,
                             iterations=GRID_ITERS, cg_iters=GRID_CG,
                             device="cuda").compile()
    t0 = time.perf_counter()
    trainer.step_n()
    step_sec = time.perf_counter() - t0
    profile = grid_profile(trainer, step_sec * 1e3 / max(GRID_ITERS))
    layout = {"user_rows": int(trainer.sides()[0].idx.shape[0]),
              "item_rows": int(trainer.sides()[1].idx.shape[0]),
              "seg_len": [int(side.idx.shape[1])
                          for side in trainer.sides()]}
    del trainer
    torch.cuda.empty_cache()
    return {"candidates": {"lambda_": GRID_REGS, "iterations": GRID_ITERS,
                           "cg_iters": GRID_CG},
            "rmse_heldout": rmses, "seq_oracle_rmse": [seq_rmse, oracle_rmse],
            "grid_train_wall_sec": wall_sec, "grid_train_costs": costs[0],
            "oracle_train_sec": oracle_sec, "peak_mem_bytes": peak_mem,
            "layout": layout, "step_n_sec": step_sec, "profile": profile}


EVAL_MODULE = """
from predictionio_torch.core.evaluation import (AverageMetric,
                                                EngineParamsGenerator,
                                                Evaluation)
from predictionio_torch.core.params import EngineParams
from predictionio_torch.models.als import ALSParams
from predictionio_torch.templates.recommendation import (
    RecoDataSourceParams, recommendation_engine)


class RatingMSE(AverageMetric):
    higher_is_better = False

    def calculate_qpa(self, q, p, a):
        match = [s["score"] for s in p["itemScores"] if s["item"] == a["item"]]
        if not match:
            return None
        return (match[0] - a["rating"]) ** 2


Eval = Evaluation(engine=recommendation_engine(), metric=RatingMSE())


class Gen(EngineParamsGenerator):
    def __init__(self):
        super().__init__([EngineParams(
            data_source_params=("", RecoDataSourceParams(
                app_name="ml100k", columnar=False, eval_k=%d)),
            algorithm_params_list=[("als", ALSParams(
                rank=64, num_iterations=3, lambda_=reg,
                compute_dtype="float32", cg_dtype="float32"))])
            for reg in %r])
"""


def pio_eval_phase(store: str) -> dict:
    """(b) ``cli eval`` over the ``pio train`` phase's eventlog events,
    then the same candidates sequentially in this process."""
    import importlib

    from predictionio_torch.core.fast_eval import FastEvalEngineWorkflow
    from predictionio_torch.data.storage import Storage, set_storage
    from predictionio_torch.parallel.context import DeviceContext

    root = os.path.dirname(os.path.abspath(__file__))
    el_env = {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
              "PIO_STORAGE_SOURCES_EL_PATH": os.path.join(store, "el")}
    with open(os.path.join(store, "pio_eval_ml100k.py"), "w") as f:
        f.write(EVAL_MODULE % (EVAL_K, EVAL_REGS))
    sub_env = {**os.environ, **el_env,
               "PYTHONPATH": os.pathsep.join([root, store])}
    cli = [sys.executable, "-m", "predictionio_torch.tools.cli"]
    t0 = time.perf_counter()
    out = run_cli(cli, ["eval", "pio_eval_ml100k.Eval", "pio_eval_ml100k.Gen",
                        "--batch", "chip_smoke"], sub_env, store, "pio eval")
    cli_sec = time.perf_counter() - t0
    one_liner = out.stdout.strip().splitlines()[-1]
    want_log = (f"grid tuning: {len(EVAL_REGS)} candidates trained in "
                f"{EVAL_K} grid run(s)")
    if want_log not in out.stderr or "falling back" in out.stderr:
        fail(f"pio eval did not take the grid path: {out.stderr[-2000:]}")
    done = Storage.from_env(el_env).evaluation_instances().get_completed()
    if len(done) != 1 or done[0].evaluator_results != one_liner:
        fail(f"pio eval left {len(done)} EVALCOMPLETED instances, or not "
             f"the one-liner it printed ({one_liner!r})")
    result = json.loads(done[0].evaluator_results_json)
    cli_scores = [s["score"] for s in result["engineParamsScores"]]

    # the sequential oracle: the same candidates, no prefetch, on the card
    sys.path.insert(0, store)
    storage = Storage.from_env(el_env)
    set_storage(storage)
    try:
        module = importlib.import_module("pio_eval_ml100k")
        evaluation, candidates = module.Eval, module.Gen().engine_params_list
        t0 = time.perf_counter()
        ctx = DeviceContext("cuda")
        workflow = FastEvalEngineWorkflow(evaluation.engine, ctx)
        seq_scores = [evaluation.metric.calculate(ctx, workflow.eval(ep))
                      for ep in candidates]
        seq_sec = time.perf_counter() - t0
    finally:
        set_storage(None)
        storage.events().close()
        sys.path.remove(store)
    if workflow.counts["train"] != len(EVAL_REGS) or \
            workflow.counts["grid_dispatches"]:
        fail(f"the sequential oracle did not train one by one: "
             f"{workflow.counts}")
    diff = np.abs(np.array(cli_scores) - np.array(seq_scores))
    if not np.allclose(cli_scores, seq_scores, rtol=1e-4, atol=1e-5) or \
            np.argsort(cli_scores).tolist() != \
            np.argsort(seq_scores).tolist():
        fail(f"pio eval scores {cli_scores} do not match the sequential "
             f"evaluation's {seq_scores}")
    return {"cli_sec": cli_sec, "one_liner": one_liner,
            "grid_log": [line for line in out.stderr.splitlines()
                         if "grid tuning" in line or "ALS grid of" in line],
            "scores": cli_scores, "sequential_scores": seq_scores,
            "max_abs_diff": float(diff.max()), "sequential_sec": seq_sec,
            "best_idx": result["bestIdx"]}


def eval_phase(ratings, seq_rmse: float, store: str) -> dict:
    t0 = time.perf_counter()
    grid = grid_phase(ratings, seq_rmse)
    t1 = time.perf_counter()
    pio_eval = pio_eval_phase(store)
    return {"grid": grid, "grid_phase_sec": t1 - t0, "pio_eval": pio_eval,
            "pio_eval_phase_sec": time.perf_counter() - t1}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from predictionio_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: predictionio_torch not found beside the "
              f"script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    t0 = time.perf_counter()
    built = kernels.build_all()
    build_sec = time.perf_counter() - t0
    print(f"built {built} in {build_sec:.1f}s", flush=True)
    topk = kernel_phase()
    print(f"topk_dot: {topk['cases']} shapes agree", flush=True)
    flash = flash_ce_phase()
    print(f"flash_ce: {flash['cases']} cases agree", flush=True)
    embed = embed_update_phase()
    print("embed_update: 3 cases agree", flush=True)
    serve = serve_phase()
    topk["launches"] = serve["launches"]
    print(json.dumps({"serve": serve, "build_sec": build_sec}), flush=True)
    train = train_phase()
    flash["launches"] = train["flash_ce_launches"]
    embed["launches"] = train["embed_update_launches"]
    print(json.dumps({"train": train}), flush=True)
    t0 = time.perf_counter()
    ratings = synth_ratings()
    synth_sec = time.perf_counter() - t0
    als = als_train_phase(ratings)
    print(json.dumps({"als_train": {**als, "synth_sec": synth_sec}}),
          flush=True)
    ingest = ingest_phase(ratings, als["profile"])
    print(json.dumps({"ingest": ingest}), flush=True)
    front_door = front_door_phase(ratings)
    print(json.dumps({"front_door": {**front_door, "card": card}}),
          flush=True)
    topk["launches_by_path"] = {
        "serve": serve["launches"], "train_deploy": train["topk_dot_launches"],
        "als_train_deploy": als["topk_dot_launches"],
        "ingest_deploy": ingest["topk_dot_launches"],
        "front_door_deploy": front_door["topk_dot_launches"]}
    store = tempfile.mkdtemp(prefix="pio_chip_smoke_ml100k_")
    try:
        print(json.dumps({"pio_train": pio_train_phase(store)}), flush=True)
        evaluation = eval_phase(ratings, als["algorithm_rmse_heldout"],
                                store)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    del ratings
    print(json.dumps({"eval": {**evaluation, "card": card}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [topk, flash, embed]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
