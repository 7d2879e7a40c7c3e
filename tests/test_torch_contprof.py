"""The port's continuous host profiler (``obs/contprof.py``) against the
JAX package's.

Over synthetic stacks and frames, both packages' trie, thread roles,
waiting classification, ``merge_folded``, ``format_flame``,
``collapsed_text``, ``hot_frames`` and ``serve_path_breakdown`` must
give equal results; the overhead governor is driven tick by tick on an
injected clock (no racing sampler thread), and both governors must
take the same rate decisions. A live sampler over a request in flight
must attribute samples to the request's route, and the sampler thread
must stop when its last owner releases it: after a server's stop and
after the stream daemon's ``run_forever``.
"""

import math
import threading
import time

import pytest

from predictionio_tpu.obs import contprof as jax_contprof
from predictionio_torch.obs import contprof

from tests.torch_operator_fixtures import (no_thread_left,  # noqa: F401
                                           port_operator_state, train_const)

MODULES = {"jax": jax_contprof, "port": contprof}


@pytest.fixture(autouse=True)
def fresh_profiler():
    """The process-wide profiler without owners or samples: an owner an
    earlier test of the worker leaked would keep the sampler alive."""
    def scrub():
        for owner in contprof.PROFILER.owners():
            contprof.PROFILER.release(owner)
        contprof.PROFILER.reset()

    scrub()
    yield
    scrub()

STACKS = [
    (["[handler]", "socketserver.py:process_request_thread",
      "http.py:wrapper", "engine_server.py:_query", "encoder.py:encode"],
     False),
    (["[handler]", "socketserver.py:process_request_thread",
      "socket.py:readinto"], True),
    (["[batcher]", "engine_server.py:_loop", "queue.py:get"], True),
    (["[handler]", "socketserver.py:process_request_thread",
      "http.py:wrapper", "server.py:parse_request"], False),
    (["[other]", "threading.py:run", "models.py:predict"], False),
]

FRAMES = [
    ("pio-batcher-1", [("threading.py", "run"),
                       ("engine_server.py", "_loop")]),
    ("Thread-3", [("socketserver.py", "process_request_thread"),
                  ("server.py", "handle_one_request"),
                  ("socket.py", "readinto")]),
    ("Thread-9", [("threading.py", "run"), ("engine_server.py", "_loop"),
                  ("threading.py", "wait")]),
    ("router-pool-2", [("router.py", "request")]),
    ("MainThread", [("cli.py", "main"), ("selectors.py", "select")]),
    ("worker", [("app.py", "compute"), ("threading.py", "is_set")]),
    ("pio-contprof", []),
]


def _surfaces(mod, budget=16):
    trie = mod._Trie(budget)
    for stack, waiting in STACKS * 3:
        trie.add(stack, waiting)
    small = mod._Trie(16)
    for k in range(40):
        small.add(["[other]", f"f{k}.py:g"], k % 2 == 0)
    payload = {"slice": "all", "folded": trie.folded(),
               "samples": {"cpu": trie.cpu, "wait": trie.wait},
               "hz": 25.0, "effective_hz": 25.0, "overhead_ratio": 0.001,
               "max_overhead": 0.01}
    other = {"folded": small.folded(),
             "samples": {"cpu": small.cpu, "wait": small.wait}}
    merged = mod.merge_folded([payload, other])
    return {
        "folded": trie.folded(), "stats": trie.stats(),
        "evicting": (small.folded(), small.stats()),
        "roles": [mod._role_of(name, frames) for name, frames in FRAMES],
        "waiting": [mod._is_waiting(frames) for _, frames in FRAMES],
        "merged": merged,
        "flame": mod.format_flame(payload, top=5),
        "merged_flame": mod.format_flame(merged, top=3, max_lines=6),
        "collapsed": mod.collapsed_text(payload),
        "hot": mod.hot_frames(merged, 4),
        "breakdown": mod.serve_path_breakdown(payload),
    }


def test_trie_roles_and_renderers_match_jax():
    port, jax = _surfaces(contprof), _surfaces(jax_contprof)
    assert port == jax
    assert port["roles"] == ["batcher", "handler", "batcher",
                             "router-pool", "main", "other", "sampler"]
    assert port["waiting"] == [False, True, True, False, True, False,
                               False]
    assert port["evicting"][1]["evictions"] > 0
    assert set(port["breakdown"]) == {"json", "socket", "parse"}


class ScriptedClock:
    """A clock whose every reading is ``step`` later: one ``_tick``
    then measures a fixed sampling cost."""

    def __init__(self, step: float):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.mark.parametrize("warmup,step,ticks", [
    ("0", 0.001, 60),     # 10x the budget: it halves until it fits
    ("10", 0.01, 30),     # over budget in the warm-up: no shift there
    ("0", 1e-6, 40),      # cheap: never shifts
])
def test_governor_on_an_injected_clock_decides_like_jax(
        monkeypatch, warmup, step, ticks):
    monkeypatch.setenv("PIO_PROF_HZ", "25")
    monkeypatch.setenv("PIO_PROF_MAX_OVERHEAD", "0.01")
    monkeypatch.setenv("PIO_PROF_WARMUP_TICKS", warmup)
    runs = {}
    for name, mod in MODULES.items():
        profiler = mod.ContProfiler(clock=ScriptedClock(step))
        trace = []
        for _ in range(ticks):
            delay = profiler._tick()
            trace.append((round(profiler.effective_hz(), 6),
                          round(profiler.overhead_ratio(), 9),
                          round(delay, 9)))
        runs[name] = trace
    assert runs["port"] == runs["jax"]
    final_hz = runs["port"][-1][0]
    assert contprof.MIN_HZ <= final_hz <= 25.0
    if step == 0.001:
        assert final_hz < 25.0 and runs["port"][-1][1] <= 0.01
    else:
        assert final_hz == 25.0 or warmup == "10"


@pytest.mark.parametrize("coarse", [False, True])
def test_a_coarse_thread_clock_meters_on_the_wall_clock(monkeypatch,
                                                        coarse):
    """A thread CPU clock that steps in 10 ms scheduler ticks reads a
    sub-millisecond sampling pass as 0: the sampler then meters its
    passes on the wall clock, and its overhead ratio is above zero."""
    real = time.thread_time

    def thread_time():
        return math.floor(real() / 0.01) * 0.01

    assert contprof.clock_step(thread_time) == pytest.approx(0.01)
    assert contprof.clock_step(real) < contprof.COARSE_CLOCK_SEC
    monkeypatch.setenv("PIO_PROF_HZ", "100")
    if coarse:
        monkeypatch.setattr(time, "thread_time", thread_time)
    profiler = contprof.ContProfiler()
    with no_thread_left():
        profiler.retain("test")
        try:
            deadline = time.monotonic() + 10
            while (profiler.snapshot()["total_samples"] < 20
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert profiler.metering_clock() == (
                "perf_counter" if coarse else "thread_time")
            assert profiler.overhead_ratio() > 0
        finally:
            profiler.release("test")


def test_hz_zero_keeps_the_surfaces(monkeypatch):
    monkeypatch.setenv("PIO_PROF_HZ", "0")
    profiler = contprof.ContProfiler()
    assert profiler._tick() == 0.5
    snap = profiler.snapshot()
    assert snap["total_samples"] == 0 and snap["hz"] == 0.0


def test_a_request_in_flight_is_attributed_to_its_route(monkeypatch):
    """One sampling pass over a thread inside a registered request puts
    its stack under the route's slice, the slow cohort past
    ``PIO_SLOW_MS``, and names the dominant leaf at the request's end."""
    monkeypatch.setenv("PIO_SLOW_MS", "0")
    clock = ScriptedClock(0.001)
    profiler = contprof.ContProfiler(clock=clock)
    entered, release = threading.Event(), threading.Event()
    dominant = []

    def request():
        profiler.request_begin("3d" * 16, "/queries.json")
        entered.set()
        release.wait(10)
        dominant.append(profiler.request_end())

    thread = threading.Thread(target=request)
    thread.start()
    try:
        assert entered.wait(10)
        profiler._sample_once()
        profiler._sample_once()
    finally:
        release.set()
        thread.join(10)
    sliced = profiler.snapshot(endpoint="/queries.json")
    assert sliced["slice"] == "endpoint:/queries.json"
    assert sliced["samples"]["wait"] >= 2
    slow = profiler.snapshot(slow=True)
    assert slow["slow_trace_ids"] == ["3d" * 16]
    assert dominant and dominant[0].startswith("threading.py:")


def _samplers():
    return [t for t in threading.enumerate()
            if t.name == "pio-contprof" and t.is_alive()]


def test_the_sampler_stops_after_the_last_release():
    with no_thread_left():
        contprof.retain("a")
        contprof.retain("b")
        contprof.retain("a")
        assert len(_samplers()) == 1
        contprof.release("a")
        assert len(_samplers()) == 1
        contprof.release("b")
        assert not contprof.PROFILER.running()


def test_a_server_holds_the_sampler_from_start_to_stop(tmp_path):
    from predictionio_torch.data.storage import Storage
    from predictionio_torch.serving.engine_server import EngineServer

    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    engine, _ = train_const(storage)
    with no_thread_left():
        server = EngineServer(engine, "const", host="127.0.0.1", port=0,
                              storage=storage, device="cpu",
                              micro_batch=False).start()
        try:
            assert contprof.PROFILER.running()
            assert any(o.startswith("EngineServer:")
                       for o in contprof.PROFILER.owners())
        finally:
            server.stop()
        server.stop()       # a second stop releases nothing twice
        assert not contprof.PROFILER.running()


def test_the_stream_daemon_holds_the_sampler_while_it_runs():
    from predictionio_torch.workflow.stream import StreamUpdater

    polled = threading.Event()
    stop = threading.Event()

    class Updater:
        def poll_once(self):
            polled.set()
            stop.wait(5)
            return {}

    with no_thread_left():
        daemon = threading.Thread(
            target=StreamUpdater.run_forever,
            args=(Updater(), 0.01, stop))
        daemon.start()
        assert polled.wait(10)
        assert contprof.PROFILER.running()
        stop.set()
        daemon.join(10)
        assert not daemon.is_alive()
        assert not contprof.PROFILER.running()
