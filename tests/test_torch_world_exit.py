"""A ``torch.distributed`` world of the port leaves cleanly when its
processes end.

A rank that ends with a live gloo group can abort in the group's
teardown at interpreter exit (``terminate called without an active
exception``, exit -6) after its work is done, now and then and more
often under load. ``parallel.multihost.initialize_from_env`` registers
an exit hook that runs ``shutdown()``: a barrier over the world's store,
bounded by ``EXIT_BARRIER_SECONDS``, then ``destroy_process_group``.

- Three rounds of eight short worlds of two, run side by side, whose
  code ends without calling ``shutdown()``: every rank exits 0.
- A world whose rank 1 leaves at once (``os._exit``): rank 0's barrier
  gives up after its bound and the rank still exits 0, without hanging.
- ``pio train`` across two processes (``cli.main(["train", ...])`` on the
  CPU over one localfs store): both ranks exit 0.
"""

import concurrent.futures
import json
import time

import pytest

from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage

from tests.test_torch_multihost import _env, _seed
from tests.torch_world import run_world

_SHORT = """
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from predictionio_torch.parallel import multihost as mh
assert mh.initialize_from_env(device="cpu")
mh.barrier("short")
t = torch.full((4,), float(mh.process_index()))
dist.all_reduce(t)
assert float(t.sum()) == 4.0
assert mh.all_gather_rows(t).shape == (8,)
"""

WORLDS = 8


@pytest.mark.parametrize("round_", range(3))
def test_short_worlds_leave_without_shutdown(round_):
    with concurrent.futures.ThreadPoolExecutor(WORLDS) as pool:
        futures = [pool.submit(run_world, _SHORT, 2) for _ in range(WORLDS)]
        for future in futures:
            future.result()


_PEER_DIES = """
import os, time
import torch
torch.set_num_threads(1)
from predictionio_torch.parallel import multihost as mh
assert mh.initialize_from_env(device="cpu")
mh.barrier("both up")
mh.EXIT_BARRIER_SECONDS = 2.0
if mh.process_index() == 1:
    print("WORKER OK", flush=True)
    os._exit(0)
time.sleep(0.5)
"""


def test_a_rank_whose_peer_died_leaves_after_the_bound():
    t0 = time.perf_counter()
    outs = run_world(_PEER_DIES, 2, timeout=60)
    assert time.perf_counter() - t0 < 45
    assert "without the exit barrier" in outs[0]


_TRAIN = """
import sys
import torch
torch.set_num_threads(1)
from predictionio_torch.tools import cli
assert cli.main(["train", "--engine-json", sys.argv[1], "--device", "cpu"]) \\
    == 0
"""

ALS_VARIANT = {
    "engineId": "exit-reco",
    "engineFactory":
        "predictionio_torch.templates.recommendation.recommendation_engine",
    "datasource": {"name": "", "params": {"app_name": "mhapp"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "num_iterations": 2, "block_size": 8}}],
}


def test_two_process_pio_train_exits_zero(tmp_path):
    env = _env(tmp_path / "store")
    _seed(Storage.from_env(env), Event)
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps(ALS_VARIANT))
    run_world(_TRAIN, 2, args=[engine_json], env=env)
    completed = [i for i in Storage.from_env(env).engine_instances()
                 .get_all() if i.status == "COMPLETED"]
    assert len(completed) == 1
