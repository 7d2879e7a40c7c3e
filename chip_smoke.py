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
   (exact ties) and a whole tile of top candidates excluded. Scores
   must agree within
   1e-5 * |q| * max|item| (the kernel sums in another order than
   cuBLAS), on slots scoring above -1e29. Indices must be equal, except
   where the reference itself has two scores within that tolerance (a
   near-tie the summation order may flip): there the kernel's item must
   score within the tolerance of the reference's slot. Then the kernel,
   the plain version and one library call (``torch.matmul`` +
   ``torch.topk``) are timed at the serve shape (B=1, I=26744, D=64,
   k=16, E=1), table warm in L2 as in serving: ``ms`` is device time
   per call from ``torch.profiler``, ``call_ms`` the CUDA-event time per
   call of back-to-back calls (the host's issue time when that is
   longer). ``cold_ms`` and ``library_cold_ms`` time one call with the
   L2 flushed before it (CUDA events, median): the case that the HBM
   bound ``bound_ms`` describes.
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

Output: the card's name and power limit (``nvidia-smi``), a ``serve``
line, the ``kernels`` line, and last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SEED = 20
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64     # bench.py DEFAULT_KNOBS
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
L2_FLUSH_BYTES = 256 << 20       # five times the 50 MB L2
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TOPK_SOURCE = "predictionio_torch/ops/kernels/csrc/topk_dot.cu"
TOPK_REPLACES = "predictionio_tpu/ops/pallas/topk_dot.py:70"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """CUDA-event time per call over back-to-back calls: the device time
    or the host's time to issue the call, whichever is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 50) -> float:
    """Median CUDA-event time of one call issued right after a write of
    ``L2_FLUSH_BYTES``, so the call finds nothing of its inputs in L2."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def device_ms(fn, iters: int = 100):
    """Device time per call: the summed self time of every CUDA kernel
    and memset ``torch.profiler`` traced over ``iters`` calls, and that
    time split by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {e.key: e.self_device_time_total / iters / 1e3
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    if sum(split.values()) <= 0:
        fail("torch.profiler traced no device time")
    return sum(split.values()), split


def kernel_name(signature: str) -> str:
    """``void (anonymous namespace)::f<1>(float const*, ...)`` -> ``f<1>``."""
    if signature.endswith(")") and "(" in signature:
        signature = signature[:signature.rfind("(")]
    return signature.replace("void ", "").replace(
        "(anonymous namespace)::", "").strip()


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
    from predictionio_torch.ops.kernels import topk_dot as tkd

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

    # timing at the serve shape: one lone user query
    B, E, k = 1, 1, 16
    items = torch.randn((N_ITEMS, RANK), generator=gen, device=dev)
    q = torch.randn((B, RANK), generator=gen, device=dev)
    excl = torch.full((B, E), -1, dtype=torch.int32, device=dev)
    kernel = lambda: tkd.topk_dot(q, items, excl, k)  # noqa: E731
    plain = lambda: tkd.topk_dot_reference(q, items, excl, k)  # noqa: E731
    library = lambda: torch.topk(q @ items.T, k, dim=1)  # noqa: E731
    # event timing first: launches run slower after profiling
    kernel_call_ms, plain_call_ms, library_call_ms = (
        call_ms(f) for f in (kernel, plain, library))
    kernel_cold_ms, library_cold_ms = (cold_ms(f) for f in (kernel, library))
    (kernel_ms, split), (plain_ms, _), (library_ms, _) = (
        device_ms(f) for f in (kernel, plain, library))
    in_bytes = (q.numel() + items.numel()) * 4 + excl.numel() * 4
    out_bytes = B * k * (4 + 4)
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * B * N_ITEMS * RANK / F32_FLOPS * 1e3
    return {
        "name": "topk_dot", "route": "cuda", "source": TOPK_SOURCE,
        "replaces": TOPK_REPLACES, "max_abs_err": max_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "call_ms": kernel_call_ms,
        "plain_call_ms": plain_call_ms, "library_call_ms": library_call_ms,
        "cold_ms": kernel_cold_ms, "library_cold_ms": library_cold_ms,
        "device_split_ms": {kernel_name(name): ms
                            for name, ms in split.items()},
        "cases": cases,
        "shape": f"B={B},I={N_ITEMS},D={RANK},k={k},E={E}",
    }


# -- serve phase -------------------------------------------------------------

def post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def expected_answer(U, V, users, items, q: dict):
    """(ids, scores) the query must get, in float64 on the host, under
    (score descending, item id ascending)."""
    num = int(q.get("num", 10))
    if "user" not in q:
        row = items[q["item"]]
        scores = V.astype(np.float64) @ V[row].astype(np.float64)
        banned = {items[b] for b in q.get("blacklist", ()) if b in items}
        banned.add(row)
        cand = np.array([j for j in range(len(V)) if j not in banned])
    else:
        if q["user"] not in users:
            return [], np.zeros(0), np.zeros(0)
        scores = V.astype(np.float64) @ U[users[q["user"]]].astype(np.float64)
        banned = {items[b] for b in q.get("blacklist", ()) if b in items}
        if "whitelist" in q:
            cand = np.array(sorted({items[w] for w in q["whitelist"]
                                    if w in items} - banned))
        else:
            cand = np.array([j for j in range(len(V)) if j not in banned])
    order = np.lexsort((cand, -scores[cand]))[:num]
    return cand[order], scores[cand[order]], scores


def check_answer(U, V, users, items, item_names, q: dict, got: dict,
                 what: str) -> None:
    ids, exp_scores, all_scores = expected_answer(U, V, users, items, q)
    served = got["itemScores"]
    if len(served) != len(ids):
        fail(f"{what}: {len(served)} items served, {len(ids)} expected "
             f"for {q}")
    if not len(ids):
        return
    qvec = U[users[q["user"]]] if "user" in q else V[items[q["item"]]]
    tol = 1e-5 * float(np.linalg.norm(qvec)) * float(
        np.linalg.norm(V, axis=1).max())
    for j, entry in enumerate(served):
        if abs(entry["score"] - exp_scores[j]) > tol:
            fail(f"{what}: slot {j} score {entry['score']} vs "
                 f"{exp_scores[j]} for {q}")
        if entry["item"] != item_names[ids[j]]:
            true = all_scores[items[entry["item"]]]
            if abs(true - exp_scores[j]) > tol:
                fail(f"{what}: slot {j} item {entry['item']} vs "
                     f"{item_names[ids[j]]} for {q}")


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
    users = {n: j for j, n in enumerate(user_names)}
    items = {n: j for j, n in enumerate(item_names)}
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
            check_answer(U, V, users, items, item_names, q, got,
                         f"lone query {j}")
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
            check_answer(U, V, users, items, item_names, q, got,
                         f"burst query {j}")
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
    print(f"kernel phase: {topk['cases']} shapes agree", flush=True)
    serve = serve_phase()
    topk["launches"] = serve["launches"]
    print(json.dumps({"serve": serve, "build_sec": build_sec}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [topk]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
