"""The serving accessors of the port against the JAX package's, on the
CPU: ``ServingStats.request_count``, ``total_serving_sec`` and
``recent(n)`` over the same records, and ``MicroBatcher.recent_splits(n)``
over the same requests (lone, queued behind a slow dispatch, and one
whose submitter gave up). The splits are wall times, so the two
packages' values differ: what must agree is which requests they hold,
in which order, and that each wait and dispatch covers what the test
made them wait for.
"""

import threading
import time

import pytest

from predictionio_tpu.serving.engine_server import MicroBatcher as JaxBatcher
from predictionio_tpu.serving.engine_server import ServingStats as JaxStats
from predictionio_torch.serving.engine_server import (MicroBatcher,
                                                      ServingStats)

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

PAIRS = [(ServingStats, JaxStats), (MicroBatcher, JaxBatcher)]


def test_stats_window_is_jaxs():
    assert ServingStats.WINDOW == JaxStats.WINDOW


@pytest.mark.parametrize("n_records", [0, 1, 5, 9000])
def test_serving_stats_accessors_match_jax(n_records):
    """The same serve times into both: the count, the total and every
    window read agree, the window keeping the last ``WINDOW`` oldest
    first."""
    secs = [0.001 * (1 + (k * 7919) % 113) for k in range(n_records)]
    got = ServingStats("port-serving-stats-test")
    want = JaxStats("port-serving-stats-test")
    for s in secs:
        got.record(s)
        want.record(s)
    assert got.request_count == want.request_count == n_records
    assert got.total_serving_sec == pytest.approx(want.total_serving_sec)
    assert got.total_serving_sec == pytest.approx(sum(secs))
    assert got.recent() == want.recent() == secs[-ServingStats.WINDOW:]
    for n in (1, 3, 10_000):
        assert got.recent(n) == want.recent(n)
    assert got.snapshot()["requestCount"] == n_records


class Gate:
    """A dispatch that waits for ``release`` when ``hold`` is set, so
    that requests queue behind it."""

    def __init__(self):
        self.hold = threading.Event()
        self.release = threading.Event()
        self.entered = threading.Event()

    def run_one(self, q):
        if self.hold.is_set():
            self.entered.set()
            self.release.wait(10)
        return q * 2

    def run_batch(self, qs):
        return [self.run_one(q) for q in qs]


def _drive(cls, hold_sec: float):
    """Four lone requests, then one held for ``hold_sec`` with three
    queued behind it and one submitter that gives up; -> the batcher's
    splits and the answers."""
    gate = Gate()
    batcher = cls(gate.run_batch, gate.run_one, max_batch=8)
    try:
        answers = [batcher.submit(q) for q in range(4)]
        gate.hold.set()
        out = {}

        def ask(q, timeout=10.0):
            try:
                out[q] = batcher.submit(q, timeout=timeout)
            except TimeoutError:
                out[q] = "timeout"

        first = threading.Thread(target=ask, args=(10,))
        first.start()
        assert gate.entered.wait(10)
        gate.hold.clear()
        queued = [threading.Thread(target=ask, args=(q,)) for q in (11, 12, 13)]
        for t in queued:
            t.start()
        ask(14, timeout=0.05)                  # gives up in the queue
        time.sleep(hold_sec)
        gate.release.set()
        for t in [first] + queued:
            t.join(10)
        answers += [out[q] for q in (10, 11, 12, 13, 14)]
        return batcher.recent_splits(100), batcher.recent_splits(2), answers
    finally:
        gate.release.set()
        batcher.stop()


def test_recent_splits_match_jax_under_the_same_requests():
    hold = 0.2
    got, got_last2, got_answers = _drive(MicroBatcher, hold)
    want, want_last2, want_answers = _drive(JaxBatcher, hold)
    assert got_answers == want_answers == [0, 2, 4, 6, 20, 22, 24, 26,
                                           "timeout"]
    # the abandoned request is in neither: four lone, the held one and
    # the three queued behind it
    assert len(got) == len(want) == 8
    assert got_last2 == got[-2:] and want_last2 == want[-2:]
    for splits in (got, want):
        assert all(w >= 0.0 and d >= 0.0 for w, d in splits)
        # the held request's dispatch covers the hold; the three queued
        # behind it waited about as long, then shared one dispatch
        assert splits[4][1] >= hold
        assert all(w >= 0.5 * hold for w, _ in splits[5:])
        assert len({d for _, d in splits[5:]}) == 1


def test_recent_splits_ring_is_bounded_like_jaxs():
    got = MicroBatcher(lambda qs: qs, lambda q: q)
    want = JaxBatcher(lambda qs: qs, lambda q: q)
    try:
        assert got._splits.maxlen == want._splits.maxlen
        assert got.recent_splits(5) == want.recent_splits(5) == []
    finally:
        got.stop()
        want.stop()
