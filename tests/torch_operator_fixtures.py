"""Shared fixtures of the port's operator tests (resilience, SLOs, the
feedback loop, fleets): process-global state reset around every test,
a thread-leak check, and a constant engine whose answers show which
instance served them.

``port_operator_state`` is autouse wherever it is imported: the port's
circuit breakers, chaos rules, SLO monitor (whose fast-window burn is
the admission controller's third shed signal), shed episodes, quality
state, timeline, regression sentinel and data plane are process-wide,
so one test's open circuit, active fault, slow traffic or sketches must
never reach the next test in the worker.
The JAX package's twins are reset by tests/conftest.py.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

import pytest

from predictionio_torch.core import (Algorithm, DataSource, FirstServing,
                                     IdentityPreparator)
from predictionio_torch.core.engine import Engine
from predictionio_torch.core.params import EngineParams, Params
from predictionio_torch.obs import (anomaly, dataobs, journal, quality, slo,
                                    timeline)
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.resilience import alerts, chaos, policy
from predictionio_torch.workflow.train import run_train


def reset_port_operator_state() -> None:
    policy.reset_breakers()
    chaos.reset()
    alerts.stop()
    slo.MONITOR.replace(slo.default_slos())
    slo.MONITOR.clear()
    slo.MONITOR.evaluate()   # no samples: the burn gauges back to 0
    journal.SHED_EPISODES.reset()
    quality.STATE.clear()
    timeline.TIMELINE.clear()
    anomaly.SENTINEL.reset()
    dataobs.DATAOBS.reset()


@pytest.fixture(autouse=True)
def port_operator_state():
    reset_port_operator_state()
    yield
    reset_port_operator_state()


def wait_for(predicate, timeout: float = 30.0, what: str = "condition"):
    """Poll ``predicate`` until it holds, failing after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@contextlib.contextmanager
def no_thread_left(timeout: float = 30.0):
    """Every thread started inside the block has ended by its exit (the
    wait covers threads that finish after their owner's stop returns,
    such as a router's pool workers or a keep-alive handler)."""
    before = set(threading.enumerate())
    yield
    wait_for(lambda: not [t for t in threading.enumerate()
                          if t not in before and t.is_alive()],
             timeout, "the block's threads to end: " + ", ".join(
                 sorted(t.name for t in threading.enumerate()
                        if t not in before)))


# -- a constant engine: answers {"result": (1 + value) * mult} -------------

@dataclass
class ConstParams(Params):
    value: float = 1.0


class ConstDataSource(DataSource):
    def __init__(self, params: ConstParams):
        super().__init__(params)

    def read_training(self, ctx):
        return self.params.value


class ConstAlgo(Algorithm):
    def __init__(self, params: ConstParams):
        super().__init__(params)

    def train(self, ctx, pd):
        return pd + self.params.value

    def predict(self, model, query):
        if "mult" not in query:
            raise KeyError("mult")
        return {"result": model * query["mult"]}


def const_engine() -> Engine:
    return Engine(ConstDataSource, IdentityPreparator,
                  {"const": ConstAlgo}, FirstServing)


def train_const(storage, engine_id: str = "const", value: float = 2.0):
    """Train the constant engine on the CPU: answers ``(1 + value) *
    mult``. Returns (engine, the COMPLETED instance)."""
    engine = const_engine()
    ep = EngineParams(
        data_source_params=("", ConstParams(value=1.0)),
        preparator_params=("", None),
        algorithm_params_list=[("const", ConstParams(value=value))],
        serving_params=("", None))
    return engine, run_train(engine, ep, engine_id=engine_id,
                             storage=storage, ctx=DeviceContext("cpu"))
