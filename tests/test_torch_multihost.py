"""The port's multi-process runtime on the CPU, against the JAX package.

In one process:

- The six cases of ``tests/test_multihost.py`` on
  ``predictionio_torch.parallel.multihost``: with no world every helper
  is the identity.
- ``stable_hash`` equal to the JAX package's over 1,000 ids, so both
  packages shard alike; ``host_shard_by_entity`` picks the same records.
- ``shard_columns``, ``merge_columns`` and the npz round trip equal to
  the JAX package's on the same seeded columns.
- ``find_columnar(shard_index=, shard_count=)`` of the memory, localfs
  and event-log stores equal to the JAX package's same backend on the
  same events (each shard, and a row limit applied after the filter).
- The mesh with no world: a size-1 mesh needing no process group, and
  ``DeviceContext.data_parallel_size()`` 1.

On a world of two gloo processes (``tests/torch_world.py``), the
counterpart of ``tests/test_multihost_2proc.py``: one spawn checks, on
each rank, ``global_array`` of its ``host_shard_slice`` and ``to_host``
of it, ``all_hosts_sum == [21, 2]``, ``broadcast_string`` (rank 0's
string), ``barrier``, and the mesh over the world (a ``DeviceMesh`` with
a ``data`` axis of 2, whose ``named_sharding``/``replicated`` give
DTensor placements). Each rank then reads its entity-hash shard of
seeded columns, ``exchange_columns`` reassembles them, and the test
holds that against the JAX package's ``merge_columns`` of the two
shards, exactly. Last, the sharded ALS train (rank 8, 2 iterations,
f32, each rank putting only its half of the layout on its device) from
one start, in two configs:

- the JAX test's own (the default 6-step CG): user factors against
  JAX's single device and JAX's 8-device mesh at atol 2e-3, the JAX
  test's bound on its own sharded train. A 6-step CG stops short of
  convergence, so another summation order moves the item factors by
  up to 7e-3 (JAX's single device against JAX's mesh already differ
  by 7e-4 in the user factors);
- ``solver="direct"``: both tables against both JAX trains at 1e-4.

In both, the port's sharded train agrees with its unsharded train at
1e-4 (on the CPU the sums run in one order, and they agree exactly).

``pio train`` of the port across two processes, the counterpart of
``tests/test_multihost_workflow.py``: two gloo ranks run the real
workflow, ``workflow.train.run_train`` with the recommendation template,
over ONE shared localfs store (the JAX test shares a REST storage
server, which the port does not have yet; the event log has one writer
and cannot be shared):

- each rank reads only its ``stable_hash`` shard of the events (its row
  count equals the JAX package's ``shard_columns`` on the same events)
  and the columns are reassembled over the world;
- the ALS half-step shards over the two ranks (the context's mesh);
- process 0 alone writes: one EngineInstance row, one model blob, and
  both ranks return the same COMPLETED id;
- rank 1 then deploys that instance from a fresh view of the store and
  answers a query, and its factors agree at 1e-4 with the port's
  one-process train on the same reassembled read.

The spawned worlds live in this file, beside the one-process cases,
rather than in files of one test each: pytest-xdist's ``loadfile``
schedules the files with the fewest tests last, and a world's processes
started then would compete for the cores with the wall-clock budget of
``tests/test_lint_clean.py``.
"""

import datetime as dt
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.backends.eventlog import (
    EventLogEventStore as JaxEventLog)
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.parallel import multihost as jax_mh
from predictionio_tpu.parallel.mesh import create_mesh as jax_create_mesh
from predictionio_torch.core.params import EngineParams
from predictionio_torch.data import storage as S
from predictionio_torch.data import store as data_store
from predictionio_torch.data.backends.eventlog import EventLogEventStore
from predictionio_torch.data.event import Event
from predictionio_torch.models.als import ALSParams
from predictionio_torch.ops import als
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.parallel.mesh import (SingleMesh, axis_group,
                                              axis_size, create_mesh)
from predictionio_torch.templates import recommendation as reco_t
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.train import run_train

from tests.torch_world import run_world

UTC = dt.timezone.utc
T0 = dt.datetime(2026, 3, 1, 12, 0, tzinfo=UTC)


def test_initialize_without_env_is_single_process(monkeypatch):
    monkeypatch.delenv("PIO_COORDINATOR_ADDRESS", raising=False)
    assert mh.initialize_from_env(device="cpu") is False
    assert mh.process_count() == 1
    assert mh.process_index() == 0


def test_initialize_wants_all_three_variables(monkeypatch):
    monkeypatch.setenv("PIO_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("PIO_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("PIO_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="all three are required"):
        mh.initialize_from_env(device="cpu")
    assert mh.process_count() == 1


def test_stable_hash_is_process_independent_and_equal_to_jax():
    assert mh._stable_hash("u1") == mh._stable_hash("u1")
    assert mh._stable_hash("u1") != mh._stable_hash("u2")
    ids = [f"user-{n}" for n in range(990)] + ["", "é", "ü🙂", "a b",
                                               "x" * 300, "0", "-1",
                                               "user-1 ", "\t", "id/7"]
    assert len(ids) == 1000
    assert ([S.stable_hash(i) for i in ids]
            == [jax_storage.stable_hash(i) for i in ids])


def test_host_shard_by_entity_partitions_completely():
    events = [{"eid": f"u{n}"} for n in range(100)]
    shards = [mh.host_shard_by_entity(events, lambda e: e["eid"],
                                      n_hosts=4, host=h) for h in range(4)]
    total = [e["eid"] for s in shards for e in s]
    assert sorted(total) == sorted(e["eid"] for e in events)
    again = mh.host_shard_by_entity(events, lambda e: e["eid"], n_hosts=4,
                                    host=2)
    assert [e["eid"] for e in again] == [e["eid"] for e in shards[2]]
    assert len(mh.host_shard_by_entity(events, lambda e: e["eid"],
                                       n_hosts=1, host=0)) == 100
    # the same records as the JAX package's split
    for h in range(4):
        assert shards[h] == jax_mh.host_shard_by_entity(
            events, lambda e: e["eid"], n_hosts=4, host=h)


def test_host_shard_slice_covers_and_balances():
    for n_total in (0, 1, 7, 8, 100):
        slices = [mh.host_shard_slice(n_total, n_hosts=3, host=h)
                  for h in range(3)]
        covered = []
        for s in slices:
            covered.extend(range(s.start, s.stop))
        assert covered == list(range(n_total))
        sizes = [s.stop - s.start for s in slices]
        assert max(sizes) - min(sizes) <= 1
        assert slices == [jax_mh.host_shard_slice(n_total, n_hosts=3, host=h)
                          for h in range(3)]


def test_global_array_single_process_is_the_whole_array():
    mesh = create_mesh()
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    arr = mh.global_array(x, mesh, "data", None, device="cpu")
    assert arr.shape == (16, 4) and arr.device.type == "cpu"
    np.testing.assert_array_equal(arr.numpy(), x)
    np.testing.assert_array_equal(mh.to_host(arr), x)


def test_all_hosts_sum_single_process_identity():
    x = np.array([3.0, 4.0])
    np.testing.assert_array_equal(mh.all_hosts_sum(x, create_mesh()), x)
    # the rest of the helpers are identities too
    assert mh.broadcast_string("abc") == "abc"
    mh.barrier("nothing to wait for")


def test_mesh_without_a_world_is_size_one():
    mesh = create_mesh()
    assert isinstance(mesh, SingleMesh)
    assert mesh.mesh_dim_names == ("data", "model")
    assert axis_size(mesh, "data") == 1 and axis_group(mesh, "data") is None
    assert axis_size(None, "data") == 1
    ctx = DeviceContext("cpu")
    assert ctx.mesh is None and ctx.data_parallel_size() == 1
    assert isinstance(ctx.mesh, SingleMesh)
    with pytest.raises(ValueError, match="does not cover"):
        create_mesh({"data": 2})
    with pytest.raises(ValueError, match="at most one"):
        create_mesh({"data": -1, "model": -1})


def _columns(cls, n=400, seed=0):
    """Seeded dict-encoded columns: 37 users, 23 items (some rows with
    no target), three event names, times in random order."""
    rng = np.random.default_rng(seed)
    ent = rng.integers(0, 37, n).astype(np.int32)
    tgt = rng.integers(-1, 23, n).astype(np.int32)
    return cls(
        entity_codes=ent, target_codes=tgt,
        name_codes=rng.integers(0, 3, n).astype(np.int32),
        values=np.where(rng.random(n) < 0.2, np.nan,
                        rng.integers(1, 11, n) / 2.0),
        times_us=rng.integers(0, 10**9, n).astype(np.int64),
        entity_vocab=[f"u{k}" for k in range(37)],
        target_vocab=[f"i{k}" for k in range(23)],
        names=["rate", "buy", "view"])


def _same(a, b):
    for f in ("entity_codes", "target_codes", "name_codes", "values",
              "times_us"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.entity_vocab == b.entity_vocab
    assert a.target_vocab == b.target_vocab
    assert a.names == b.names


def test_shard_merge_and_npz_equal_to_jax():
    port, ref = _columns(S.EventColumns), _columns(jax_storage.EventColumns)
    n = 3
    port_parts = [S.shard_columns(port, h, n) for h in range(n)]
    ref_parts = [jax_storage.shard_columns(ref, h, n) for h in range(n)]
    for a, b in zip(port_parts, ref_parts):
        _same(a, b)
    assert sum(len(p) for p in port_parts) == len(port)
    for time_ordered in (False, True):
        merged = S.merge_columns(port_parts, time_ordered=time_ordered)
        _same(merged, jax_storage.merge_columns(ref_parts,
                                                time_ordered=time_ordered))
    _same(S.limit_columns(port, 50, newest_first=True),
          jax_storage.limit_columns(ref, 50, newest_first=True))
    blob = S.columns_to_npz(port_parts[1])
    _same(S.npz_to_columns(blob), port_parts[1])
    # each package reads the other's wire blob
    _same(jax_storage.npz_to_columns(blob), ref_parts[1])
    _same(S.npz_to_columns(jax_storage.columns_to_npz(ref_parts[2])),
          port_parts[2])
    # the one-process exchange is merge_columns of the one part
    _same(mh.exchange_columns(port_parts[0], time_ordered=True),
          S.merge_columns([port_parts[0]], time_ordered=True))


def _rows(cols):
    return sorted(
        (cols.entity_vocab[e], cols.target_vocab[t] if t >= 0 else None,
         cols.names[m], -1.0 if np.isnan(v) else float(v), int(tm))
        for e, t, m, v, tm in zip(cols.entity_codes, cols.target_codes,
                                  cols.name_codes, cols.values,
                                  cols.times_us))


def _event_dicts(n=300, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        rated = rng.random() < 0.7
        out.append(dict(
            event="rate" if rated else "buy", entity_type="user",
            entity_id=f"u{rng.integers(0, 41)}",
            target_entity_type="item",
            target_entity_id=f"i{rng.integers(0, 19)}",
            properties=({"rating": float(rng.integers(1, 11)) / 2}
                        if rated else {}),
            event_time=T0 + dt.timedelta(seconds=int(rng.integers(0, 9999))),
            creation_time=T0, event_id=f"{k:032x}"))
    return out


def _backend_stores(kind, tmp_path):
    if kind == "eventlog":
        port = EventLogEventStore(str(tmp_path / "port"))
        ref = JaxEventLog(str(tmp_path / "jax"))
    else:
        def env(root):
            return ({"PIO_STORAGE_SOURCES_S_TYPE": "memory"}
                    if kind == "memory" else
                    {"PIO_STORAGE_SOURCES_S_TYPE": "localfs",
                     "PIO_STORAGE_SOURCES_S_PATH": str(root)})

        port = S.Storage.from_env(env(tmp_path / "port")).events()
        ref = jax_storage.Storage.from_env(env(tmp_path / "jax")).events()
    dicts = _event_dicts()
    for store, cls in ((port, Event), (ref, JaxEvent)):
        store.init(1)
        store.insert_batch([cls(**d) for d in dicts], 1)
    return port, ref


@pytest.mark.parametrize("kind", ["memory", "localfs", "eventlog"])
def test_find_columnar_read_shards_equal_to_jax(kind, tmp_path):
    port, ref = _backend_stores(kind, tmp_path)
    try:
        kw = dict(value_property="rating", entity_type="user",
                  event_names=["rate", "buy"], target_entity_type="item")
        whole = port.find_columnar(1, **kw)
        rows = 0
        for h in range(3):
            got = port.find_columnar(1, shard_index=h, shard_count=3, **kw)
            _same(got, ref.find_columnar(1, shard_index=h, shard_count=3,
                                         **kw))
            # the shard of the whole read, row for row (the codes differ:
            # a shard read numbers its ids in its own first-seen order)
            assert _rows(got) == _rows(S.shard_columns(whole, h, 3))
            assert all(S.stable_hash(e) % 3 == h for e in got.entity_vocab)
            rows += len(got)
        assert rows == len(whole) == 300
        # a row limit applies after the shard filter
        got = port.find_columnar(1, shard_index=1, shard_count=3, limit=20,
                                 **kw)
        assert len(got) == 20
        _same(got, ref.find_columnar(1, shard_index=1, shard_count=3,
                                     limit=20, **kw))
        with pytest.raises(ValueError, match="together"):
            port.find_columnar(1, shard_index=0, **kw)
        with pytest.raises(ValueError, match="out of range"):
            port.find_columnar(1, shard_index=3, shard_count=3, **kw)
    finally:
        for store in (port, ref):
            close = getattr(store, "close", None)
            if close is not None:
                close()


# -- a world of two processes -----------------------------------------------

WORLD_USERS, WORLD_ITEMS, NNZ = 32, 16, 400
KW = dict(rank=8, iterations=2, reg=0.1, block_size=8, seg_len=8,
          compute_dtype="float32", cg_dtype="float32")
CONFIGS = [KW, dict(KW, solver="direct")]

_WORLD_WORKER = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.data import storage as S
from predictionio_torch.ops import als
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import (axis_size, create_mesh,
                                              named_sharding, replicated)

out = sys.argv[1]
assert mh.initialize_from_env(device="cpu") is True
assert mh.initialize_from_env(device="cpu") is True   # idempotent
assert mh.process_count() == 2
r = mh.process_index()
mesh = create_mesh()
assert type(mesh).__name__ == "DeviceMesh", type(mesh)
assert mesh.mesh_dim_names == ("data", "model")
assert axis_size(mesh, "data") == 2
assert [type(p).__name__ for p in named_sharding(mesh, "data", None)] == [
    "Shard", "Replicate"]
assert named_sharding(mesh, "data", None)[0].dim == 0
assert [type(p).__name__ for p in replicated(mesh)] == ["Replicate"] * 2

n = 16
full = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
sl = mh.host_shard_slice(n)
g = mh.global_array(full[sl], mesh, "data")
assert g.shape == (sl.stop - sl.start, 3) and g.device.type == "cpu"
np.testing.assert_array_equal(mh.to_host(g), full)
np.testing.assert_allclose(mh.all_hosts_sum(np.array([float(g.sum())])),
                           [full.sum()])
np.testing.assert_allclose(
    mh.all_hosts_sum(np.array([10.0 + r, 1.0]), mesh), [21.0, 2.0])
assert mh.broadcast_string(f"instance-of-rank-{r}") == "instance-of-rank-0"
mh.barrier("pio_test_barrier")

cols = S.npz_to_columns(out + "/cols.npz")
merged = mh.exchange_columns(S.shard_columns(cols, r, 2))
with open(out + f"/merged{r}.npz", "wb") as f:
    S.columns_to_npz_file(merged, f)

z = np.load(out + "/als.npz")
coo = (z["u"], z["i"], z["r"])
for j, kw in enumerate(json.loads(open(out + "/cfg.json").read())):
    cfg = als.ALSConfig(**kw)
    trainer = als.ALSTrainer(coo, int(z["n_users"]), int(z["n_items"]), cfg,
                             device="cpu", mesh=mesh)
    one = als.ALSTrainer(coo, int(z["n_users"]), int(z["n_items"]), cfg,
                         device="cpu")
    # only this rank's half of each side (binned for two shards) went to
    # its device
    sides = [als.build_compressed_side(a, b, coo[2], n_g, cfg, 2, None)
             for a, b, n_g in ((coo[0], coo[1], int(z["n_users"])),
                               (coo[1], coo[0], int(z["n_items"])))]
    for dev_side, side in zip(trainer.sides(), sides):
        assert dev_side.n_shards == 2 and dev_side.shard == r
        assert dev_side.idx.shape[0] * 2 == side.idx_lo.shape[0]
        assert dev_side.counts.shape[0] * 2 == side.counts.shape[0]
        np.testing.assert_array_equal(
            dev_side.counts.numpy(),
            side.counts[r * side.groups_per_shard:
                        (r + 1) * side.groups_per_shard])
    assert trainer.transfer_bytes * 2 == sum(s.transfer_bytes for s in sides)
    for t in (trainer, one):
        X = torch.zeros_like(t.X)
        Y = torch.zeros_like(t.Y)
        X[:z["X0"].shape[0]] = torch.from_numpy(z["X0"])
        Y[:z["Y0"].shape[0]] = torch.from_numpy(z["Y0"])
        t.X, t.Y = X, Y
    got, ref = trainer.run(), one.run()
    np.savez(out + f"/factors{r}_{j}.npz", X=got.user_factors,
             Y=got.item_factors, X1=ref.user_factors, Y1=ref.item_factors)
"""


def _world_columns(n=500, seed=5):
    rng = np.random.default_rng(seed)
    fields = dict(
        entity_codes=rng.integers(0, 61, n).astype(np.int32),
        target_codes=rng.integers(-1, 29, n).astype(np.int32),
        name_codes=rng.integers(0, 2, n).astype(np.int32),
        values=rng.integers(1, 11, n) / 2.0,
        times_us=rng.integers(0, 10**9, n).astype(np.int64),
        entity_vocab=[f"user{k}" for k in range(61)],
        target_vocab=[f"item{k}" for k in range(29)],
        names=["rate", "buy"])
    return S.EventColumns(**fields), jax_storage.EventColumns(**fields)


def _jax_train(coo, X0, Y0, kw, mesh):
    """JAX ``ALSTrainer`` from the real rows ``X0``/``Y0`` (pads 0)."""
    t = jax_als.ALSTrainer(coo, WORLD_USERS, WORLD_ITEMS, jax_als.ALSConfig(**kw),
                           mesh=mesh)
    X, Y = np.zeros(np.shape(t._X), np.float32), np.zeros(np.shape(t._Y),
                                                          np.float32)
    X[:WORLD_USERS], Y[:WORLD_ITEMS] = X0, Y0
    t._X, t._Y = X, Y
    return t.run()


def test_two_process_world(tmp_path):
    port_cols, jax_cols = _world_columns()
    with open(tmp_path / "cols.npz", "wb") as f:
        S.columns_to_npz_file(port_cols, f)
    rng = np.random.default_rng(3)
    coo = (rng.integers(0, WORLD_USERS, NNZ), rng.integers(0, WORLD_ITEMS, NNZ),
           (rng.random(NNZ) * 4 + 1).astype(np.float32))
    X0 = (rng.normal(size=(WORLD_USERS, 8)) / np.sqrt(8)).astype(np.float32)
    Y0 = (rng.normal(size=(WORLD_ITEMS, 8)) / np.sqrt(8)).astype(np.float32)
    np.savez(tmp_path / "als.npz", u=coo[0], i=coo[1], r=coo[2], X0=X0,
             Y0=Y0, n_users=WORLD_USERS, n_items=WORLD_ITEMS)
    (tmp_path / "cfg.json").write_text(json.dumps(CONFIGS))

    run_world(_WORLD_WORKER, 2, args=[tmp_path])

    # exchange_columns == JAX merge_columns of the two shards, exactly
    want = jax_storage.merge_columns(
        [jax_storage.shard_columns(jax_cols, h, 2) for h in range(2)])
    for r in range(2):
        got = S.npz_to_columns(str(tmp_path / f"merged{r}.npz"))
        for f in ("entity_codes", "target_codes", "name_codes", "values",
                  "times_us", "entity_vocab", "target_vocab", "names"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)))

    for j, kw in enumerate(CONFIGS):
        single = _jax_train(coo, X0, Y0, kw, None)
        meshed = _jax_train(coo, X0, Y0, kw, jax_create_mesh({"data": 8}))
        one = als.ALSTrainer(coo, WORLD_USERS, WORLD_ITEMS, als.ALSConfig(**kw),
                             device="cpu")
        one.X[:WORLD_USERS], one.Y[:WORLD_ITEMS] = (torch.from_numpy(X0),
                                            torch.from_numpy(Y0))
        one = one.run()
        for r in range(2):
            z = np.load(tmp_path / f"factors{r}_{j}.npz")
            for ref in (single, meshed):
                if kw.get("solver") == "direct":
                    np.testing.assert_allclose(z["X"], ref.user_factors,
                                               rtol=1e-4, atol=1e-4)
                    np.testing.assert_allclose(z["Y"], ref.item_factors,
                                               rtol=1e-4, atol=1e-4)
                else:
                    np.testing.assert_allclose(z["X"], ref.user_factors,
                                               rtol=2e-3, atol=2e-3)
            for x1 in (z["X1"], one.user_factors):
                np.testing.assert_allclose(z["X"], x1, rtol=1e-4, atol=1e-4)
            for y1 in (z["Y1"], one.item_factors):
                np.testing.assert_allclose(z["Y"], y1, rtol=1e-4, atol=1e-4)


# -- pio train across two processes ---------------------------------------

TRAIN_USERS, TRAIN_ITEMS, EVENTS_PER_USER = 20, 8, 6
ALS = dict(rank=4, num_iterations=2, block_size=8, compute_dtype="float32",
           cg_dtype="float32")

_TRAIN_WORKER = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.core.params import EngineParams
from predictionio_torch.data import store
from predictionio_torch.data.storage import Storage
from predictionio_torch.models.als import ALSParams
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.templates import recommendation as reco_t
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.train import run_train

out = sys.argv[1]
reads = []
_find = store.find_columnar


def find(*args, **kwargs):
    cols = _find(*args, **kwargs)
    reads.append([kwargs.get("shard_index"), kwargs.get("shard_count"),
                  len(cols)])
    return cols


store.find_columnar = find
engine = reco_t.recommendation_engine()
ep = EngineParams(
    data_source_params=("", reco_t.RecoDataSourceParams(app_name="mhapp")),
    algorithm_params_list=[("als", ALSParams(**json.loads(sys.argv[2])))])
ctx = DeviceContext("cpu")
inst = run_train(engine, ep, engine_id="mh-reco", ctx=ctx)
assert mh.process_count() == 2 and ctx.data_parallel_size() == 2
r = mh.process_index()
res = {"id": inst.id, "status": inst.status, "reads": reads}
if r == 1:
    fresh = Storage.from_env()
    stored = fresh.engine_instances().get_latest_completed("mh-reco", "0",
                                                           "default")
    assert stored is not None and stored.id == inst.id
    dep = prepare_deploy(engine, stored, ctx=DeviceContext("cpu"),
                         storage=fresh)
    res["answer"] = dep.query({"user": "user_1", "num": 3})
    model = dep.models[0]
    assert model.sharded_axis is None
    np.savez(out + "/model.npz", X=model.user_factors, Y=model.item_factors)
    res["users"] = list(model.user_ids.keys())
    res["items"] = list(model.item_ids.keys())
# process 0 stays up until rank 1 has deployed
mh.barrier("pio_test_done")
with open(out + f"/rank{r}.json", "w") as f:
    json.dump(res, f)
"""


def _events(cls):
    rng = np.random.default_rng(7)
    events, m = [], 0
    for u in range(TRAIN_USERS):
        for i in rng.choice(TRAIN_ITEMS, size=EVENTS_PER_USER, replace=False):
            events.append(cls(
                event="rate", entity_type="user", entity_id=f"user_{u}",
                target_entity_type="item", target_entity_id=f"item_{i}",
                properties={"rating": float(1 + (u * int(i)) % 5)},
                event_time=dt.datetime(2026, 1, 1, tzinfo=UTC)
                + dt.timedelta(minutes=m)))
            m += 1
    return events


def _seed(storage, cls):
    app = storage.apps().insert("mhapp")
    storage.events().init(app.id)
    storage.events().insert_batch(_events(cls), app.id)
    return app.id


def _env(root):
    env = {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(root)}
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "FS"
    return env


def _one_process_factors(monkeypatch):
    """The port's one-process train over the same events (a memory
    store), its read being the two shard reads merged in shard order, as
    the world reassembles them."""
    storage = S.Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    _seed(storage, Event)
    find = data_store.find_columnar

    def merged(*args, **kwargs):
        return S.merge_columns([find(*args, shard_index=h, shard_count=2,
                                     **kwargs) for h in range(2)])

    monkeypatch.setattr(data_store, "find_columnar", merged)
    engine = reco_t.recommendation_engine()
    ep = EngineParams(
        data_source_params=("", reco_t.RecoDataSourceParams(app_name="mhapp")),
        algorithm_params_list=[("als", ALSParams(**ALS))])
    S.set_storage(storage)
    try:
        inst = run_train(engine, ep, engine_id="mh-reco",
                         ctx=DeviceContext("cpu"), storage=storage)
        return prepare_deploy(engine, inst, ctx=DeviceContext("cpu"),
                              storage=storage).models[0]
    finally:
        S.set_storage(None)


def test_two_process_train_and_deploy_over_one_store(tmp_path, monkeypatch):
    root = tmp_path / "store"
    env = _env(root)
    _seed(S.Storage.from_env(env), Event)
    out = tmp_path / "out"
    out.mkdir()
    run_world(_TRAIN_WORKER, 2, args=[out, json.dumps(ALS)], env=env)
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]

    # both ranks returned the same broadcast COMPLETED instance
    assert res[0]["id"] == res[1]["id"]
    assert res[0]["status"] == res[1]["status"] == "COMPLETED"
    # single writer: one instance row, one model blob
    storage = S.Storage.from_env(env)
    instances = storage.engine_instances().get_all()
    assert len(instances) == 1 and instances[0].status == "COMPLETED"
    assert instances[0].id == res[0]["id"]
    assert storage.models().get(res[0]["id"]) is not None

    # each rank read its stable_hash shard once; the shards' rows are
    # the JAX package's shard_columns of the same events
    ref = jax_storage.Storage.from_env(
        {"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    app_id = _seed(ref, JaxEvent)
    whole = ref.events().find_columnar(
        app_id, value_property="rating", entity_type="user",
        event_names=["rate", "buy"], target_entity_type="item")
    for r in range(2):
        assert len(res[r]["reads"]) == 1
        shard_index, shard_count, rows = res[r]["reads"][0]
        assert (shard_index, shard_count) == (r, 2)
        assert rows == len(jax_storage.shard_columns(whole, r, 2))
        assert 0.25 * len(whole) < rows < 0.75 * len(whole)
    assert sum(x["reads"][0][2] for x in res) == TRAIN_USERS * EVENTS_PER_USER

    # rank 1 deployed and answered, with the one-process train's factors
    assert res[1]["answer"]["itemScores"], res[1]["answer"]
    got = np.load(out / "model.npz")
    one = _one_process_factors(monkeypatch)
    assert res[1]["users"] == list(one.user_ids.keys())
    assert res[1]["items"] == list(one.item_ids.keys())
    np.testing.assert_allclose(got["X"], one.user_factors, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["Y"], one.item_factors, rtol=1e-4,
                               atol=1e-4)
