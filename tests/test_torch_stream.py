"""The streaming freshness lane on the port against the JAX package's.

Counterpart of ``tests/test_stream.py`` (classes ``TestDeltaReads``,
``TestALSFoldIn``, ``TestModelPatch`` and ``TestTwoTowerOnline``), on
the CPU at small sizes. The same seeded events go into a JAX and a port
``eventlog`` store and the delta reads must agree exactly (cursors,
columns, rebases, errors). ``fold_in_solve`` and ``online_delta_step``
take the same numpy inputs in both packages. A store the JAX package
trained is copied, and a JAX and a port ``StreamUpdater`` fold the same
appended events, one on each copy: their patch blocks must name the same
rows with vectors within the stated tolerance, and both engine servers
must answer every ``/model/patch`` case with the same status and body.
The port alone checks the fold against a full retrain (the JAX test's
bound), the rebase, truncation, rewind and stale-patch paths, and the
CLI's ``stream`` and ``undeploy``.
"""

import datetime as dt
import json
import os
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage import Storage as JaxStorage
from predictionio_tpu.data.storage import set_storage as jax_set_storage
from predictionio_tpu.index import recall as jax_recall
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import twotower as jax_tt
from predictionio_tpu.serving.engine_server import (
    EngineServer as JaxEngineServer)
from predictionio_tpu.templates.recommendation import (
    recommendation_engine as jax_recommendation_engine)
from predictionio_tpu.workflow.stream import StreamUpdater as JaxUpdater
from predictionio_tpu.workflow.train import run_train as jax_run_train
from predictionio_torch import native
from predictionio_torch.core import Engine, FirstServing
from predictionio_torch.core.params import EngineParams
from predictionio_torch.data.event import Event
from predictionio_torch.data.storage import Storage, set_storage
from predictionio_torch.index import recall
from predictionio_torch.index.exact import ExactIndex
from predictionio_torch.ops import als
from predictionio_torch.ops import twotower as tt
from predictionio_torch.parallel.context import DeviceContext
from predictionio_torch.serving.engine_server import EngineServer
from predictionio_torch.templates.recommendation import recommendation_engine
from predictionio_torch.tools import cli
from predictionio_torch.workflow.deploy import prepare_deploy
from predictionio_torch.workflow.stream import (StreamUnsupported,
                                                StreamUpdater)
from predictionio_torch.workflow.train import run_train
from tests.torch_sample_engine import (Algo0, DataSource0, IdParams,
                                       Preparator0)
from tests.torch_operator_fixtures import port_operator_state  # noqa: F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTC = dt.timezone.utc
T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)
CPU = DeviceContext("cpu")
#: the JAX test's ALS knobs (tests/test_stream.py ``_train_reco``): f32
#: throughout, so the fold-in's 16-step CG converges at rank 8
ALS_PARAMS = {"rank": 8, "num_iterations": 15, "lambda_": 0.1,
              "compute_dtype": "float32", "cg_dtype": "float32",
              "cg_iters": 12}
#: folded vectors of the two packages: the same f32 normal equations,
#: solved in another summation order
FOLD_ATOL = 1e-4


def _el_env(path):
    return {"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
            "PIO_STORAGE_SOURCES_EL_PATH": str(path)}


def _rate(cls, user, item, rating, event="rate", sec=0):
    return cls(event=event, entity_type="user", entity_id=user,
               target_entity_type="item", target_entity_id=item,
               properties={"rating": float(rating)} if event == "rate"
               else {}, event_time=T0 + dt.timedelta(seconds=sec))


def _world_events(cls, n_users=40, n_items=25, n_events=1200, seed=3):
    """The JAX test's world: planted rank-4 half-star ratings."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 4)).astype(np.float32)
    V = rng.normal(size=(n_items, 4)).astype(np.float32)
    out = []
    for k in range(n_events):
        u = int(rng.integers(0, n_users))
        i = int(rng.integers(0, n_items))
        z = float(U[u] @ V[i]) / 2.0
        r = float(np.clip(np.round((3.0 + z) * 2) / 2, 0.5, 5.0))
        out.append(_rate(cls, f"u{u}", f"i{i}", r, sec=k))
    return out


def _variant(iterations=15):
    return {"datasource": {"params": {"app_name": "stream"}},
            "algorithms": [{"name": "als", "params": {
                **ALS_PARAMS, "num_iterations": iterations}}]}


def _port_world(path, n_events=1200):
    """A port eventlog store with the world's events and app
    "stream", installed as the port's singleton."""
    storage = Storage.from_env(_el_env(path))
    app = storage.apps().insert("stream")
    storage.events().init(app.id)
    storage.events().insert_batch(_world_events(Event, n_events=n_events),
                                  app.id)
    set_storage(storage)
    return storage, app.id


def _port_train(storage, engine_id, iterations=15):
    engine = recommendation_engine()
    instance = run_train(engine, engine.engine_params_from_variant(
        _variant(iterations)), engine_id=engine_id, ctx=CPU,
        storage=storage)
    assert instance.status == "COMPLETED"
    return engine, instance


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bin_cache"))
    monkeypatch.delenv("PIO_ADMIN_TOKEN", raising=False)
    yield
    set_storage(None)
    jax_set_storage(None)


# ---------------------------------------------------------------------------
# native delta reads
# ---------------------------------------------------------------------------

def _two_stores(tmp_path):
    """(port store, JAX store, app id), one log each under tmp_path."""
    port = Storage.from_env(_el_env(tmp_path / "port"))
    ref = JaxStorage.from_env(_el_env(tmp_path / "jax"))
    app = port.apps().insert("delta")
    assert ref.apps().insert("delta").id == app.id
    port.events().init(app.id)
    ref.events().init(app.id)
    return port.events(), ref.events(), app.id


def _insert_both(port, ref, app_id, rows):
    """The same events into both logs; the two stores' event ids."""
    return (port.insert_batch([_rate(Event, *r) for r in rows], app_id),
            ref.insert_batch([_rate(JaxEvent, *r) for r in rows], app_id))


def _same_columns(a, b):
    assert a.entity_vocab == b.entity_vocab
    assert a.target_vocab == b.target_vocab
    assert a.names == b.names
    for f in ("entity_codes", "target_codes", "name_codes", "times_us"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))


FILTERS = dict(value_property="rating", entity_type="user",
               event_names=["rate", "buy"], target_entity_type="item")


def test_exactly_the_rows_since_the_cursor_like_jax(tmp_path):
    port, ref, app_id = _two_stores(tmp_path)
    _insert_both(port, ref, app_id, [("a", "x", 1.0), ("b", "y", 2.0)])
    cursor = port.delta_cursor(app_id)
    assert cursor == ref.delta_cursor(app_id) == "g0:r2"
    _insert_both(port, ref, app_id, [("c", "x", 3.0), ("a", "z", 4.5),
                                     ("d", "w", 0, "buy")])
    got = port.find_columnar_since(app_id, cursor=cursor, **FILTERS)
    want = ref.find_columnar_since(app_id, cursor=cursor, **FILTERS)
    assert got[1:] == want[1:] == ("g0:r5", False)
    _same_columns(got[0], want[0])
    cols = got[0]
    assert [cols.entity_vocab[c] for c in cols.entity_codes] == ["c", "a",
                                                                 "d"]
    assert list(cols.values[:2]) == [3.0, 4.5] and np.isnan(cols.values[2])
    # the advanced cursor yields an empty delta
    cols2, cursor3, rebased = port.find_columnar_since(
        app_id, cursor=got[1], value_property="rating")
    assert len(cols2) == 0 and not rebased and cursor3 == got[1]


def test_filters_and_deletes_apply_to_the_delta_like_jax(tmp_path):
    port, ref, app_id = _two_stores(tmp_path)
    cursor = port.delta_cursor(app_id)
    ids = []
    for store, cls in ((port, Event), (ref, JaxEvent)):
        ids.append(store.insert_batch(
            [_rate(cls, "a", "x", 1.0),
             cls(event="$set", entity_type="user", entity_id="a",
                 properties={"p": 1}, event_time=T0),
             _rate(cls, "b", "y", 2.0)], app_id))
    port.delete(ids[0][2], app_id)      # tombstoned before the read
    ref.delete(ids[1][2], app_id)
    for filters in (FILTERS, {"value_property": "rating"},
                    {"entity_id": "a"}, {"target_entity_type": None}):
        got = port.find_columnar_since(app_id, cursor=cursor, **filters)
        want = ref.find_columnar_since(app_id, cursor=cursor, **filters)
        assert got[1:] == want[1:]
        _same_columns(got[0], want[0])
    cols, _, rebased = port.find_columnar_since(app_id, cursor=cursor,
                                                **FILTERS)
    assert not rebased
    assert [cols.entity_vocab[c] for c in cols.entity_codes] == ["a"]


def test_compaction_rebases_the_cursor_like_jax(tmp_path):
    port, ref, app_id = _two_stores(tmp_path)
    ids = _insert_both(port, ref, app_id, [("a", "x", 1.0), ("b", "y", 2.0)])
    cursor = port.delta_cursor(app_id)
    for store, sid in zip((port, ref), ids):
        store.delete(sid[0], app_id)
        store.compact(app_id)
    got = port.find_columnar_since(app_id, cursor=cursor, **FILTERS)
    want = ref.find_columnar_since(app_id, cursor=cursor, **FILTERS)
    # the rescan returns the live set, flagged as NOT a delta
    assert got[1:] == want[1:] and got[2] is True
    _same_columns(got[0], want[0])
    assert [got[0].entity_vocab[c] for c in got[0].entity_codes] == ["b"]
    # a cursor past the end of the log rebases as well
    past = port.find_columnar_since(app_id, cursor="g1:r99", **FILTERS)
    assert past[1:] == ref.find_columnar_since(
        app_id, cursor="g1:r99", **FILTERS)[1:] == ("g1:r1", True)


@pytest.mark.parametrize("cursor", ["nope", "", "x1:r2", "g1:x2", "g1",
                                    "ga:r1", "g1:r"])
def test_malformed_cursor_rejected_like_jax(tmp_path, cursor):
    port, ref, app_id = _two_stores(tmp_path)
    for store in (port, ref):
        with pytest.raises(ValueError, match="malformed delta cursor"):
            store.find_columnar_since(app_id, cursor=cursor)


@pytest.mark.parametrize("bad", [{"limit": 5}, {"reversed": True},
                                 {"entity": "u"}])
def test_unknown_filter_rejected_like_jax(tmp_path, bad):
    port, ref, app_id = _two_stores(tmp_path)
    for store in (port, ref):
        cursor = store.delta_cursor(app_id)
        with pytest.raises(TypeError, match="unexpected filters"):
            store.find_columnar_since(app_id, cursor=cursor, **bad)


def test_a_jax_cursor_reads_on_the_port_after_the_jax_store_closed(
        tmp_path):
    """The cursor string and the log are shared: a cursor the JAX package
    took survives a close, and the port reads the delta since it on the
    same directory (restart contract across packages)."""
    ref = JaxStorage.from_env(_el_env(tmp_path / "log"))
    app = ref.apps().insert("delta")
    ev = ref.events()
    ev.init(app.id)
    ev.insert_batch([_rate(JaxEvent, "a", "x", 1.0)], app.id)
    cursor = ev.delta_cursor(app.id)
    ev.insert_batch([_rate(JaxEvent, "b", "y", 2.0)], app.id)
    want = ev.find_columnar_since(app.id, cursor=cursor, **FILTERS)
    ev.close()
    port = Storage.from_env(_el_env(tmp_path / "log")).events()
    got = port.find_columnar_since(app.id, cursor=cursor, **FILTERS)
    assert got[1:] == want[1:] == ("g0:r2", False)
    _same_columns(got[0], want[0])
    port.insert_batch([_rate(Event, "c", "z", 3.0)], app.id)
    cols, _, rebased = port.find_columnar_since(app.id, cursor=got[1],
                                                **FILTERS)
    assert not rebased
    assert [cols.entity_vocab[c] for c in cols.entity_codes] == ["c"]
    port.close()


def test_a_library_older_than_its_source_is_rebuilt(tmp_path, monkeypatch):
    """A ``_build/`` left from before a source changed (here a stale
    stand-in older than ``eventlog.cpp``) is rebuilt at first use, so
    the new ``el_find_columnar_since`` is there; a library newer than
    its source is kept."""
    monkeypatch.setenv("PIO_NATIVE_BUILD_DIR", str(tmp_path))
    stale = tmp_path / "_eventlog.so"
    stale.write_bytes(b"stale")
    src = os.path.join(os.path.dirname(native.__file__), "eventlog.cpp")
    old = os.path.getmtime(src) - 60
    os.utime(stale, (old, old))
    path = native.build_library("eventlog")
    assert path == str(stale) and os.path.getmtime(path) >= old + 60
    import ctypes

    assert hasattr(ctypes.CDLL(path), "el_find_columnar_since")
    fresh = tmp_path / "_raggedbin.so"
    fresh.write_bytes(b"fresh")
    native.build_library("raggedbin")
    assert fresh.read_bytes() == b"fresh"


# ---------------------------------------------------------------------------
# fold-in solve and online step against the JAX package
# ---------------------------------------------------------------------------

def _fold_rows(rng, Y_rows, lengths):
    return [(rng.integers(0, Y_rows, size=n).astype(np.int32),
             (rng.integers(1, 11, size=n) / 2.0).astype(np.float32))
            for n in lengths]


@pytest.mark.parametrize("solver", ["cg", "direct"])
@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_solve_matches_jax(implicit, solver):
    """The same groups (one empty, which keeps its warm start) through
    both packages' fold-in: rtol 1e-4, atol 1e-5 (f32 normal equations
    in another summation order; the 16-step CG converges at rank 8)."""
    rng = np.random.default_rng(7)
    Y = rng.normal(size=(40, 8)).astype(np.float32)
    rows = _fold_rows(rng, 40, (3, 9, 1, 17, 0, 5))
    x0 = rng.normal(size=(len(rows), 8)).astype(np.float32)
    kw = dict(rank=8, reg=0.1, implicit=implicit, alpha=2.0, solver=solver)
    want = jax_als.fold_in_solve(Y, rows, jax_als.ALSConfig(**kw), x0=x0)
    got = als.fold_in_solve(Y, rows, als.ALSConfig(**kw), x0=x0,
                            device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[4], x0[4])
    # no warm start: new groups start from zero, as in the JAX package
    np.testing.assert_allclose(
        als.fold_in_solve(Y, rows[:4], als.ALSConfig(**kw), device="cpu"),
        jax_als.fold_in_solve(Y, rows[:4], jax_als.ALSConfig(**kw)),
        rtol=1e-4, atol=1e-5)


def test_fold_in_solve_of_no_groups_and_its_default_device():
    cfg = als.ALSConfig(rank=4)
    out = als.fold_in_solve(np.zeros((3, 4), np.float32), [], cfg)
    assert out.shape == (0, 4) and out.dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            als.fold_in_solve(np.zeros((3, 4), np.float32),
                              [(np.array([0]), np.array([1.0]))], cfg)


def _unit_rows(rng, n, d):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_online_delta_step_matches_jax(weighted):
    """Touched rows equal exactly; vectors within atol 1e-5 and losses
    within rtol 1e-5 (f32 autograd against jax.grad of the same dense
    CE; the JAX package's zero-weight pow2 padding adds nothing)."""
    rng = np.random.default_rng(5)
    U, V = _unit_rows(rng, 20, 16), _unit_rows(rng, 30, 16)
    u_rows = np.array([1, 1, 4, 7, 3, 4], np.int32)
    i_rows = np.array([2, 9, 9, 11, 2, 0], np.int32)
    w = rng.random(6).astype(np.float32) if weighted else None
    want = jax_tt.online_delta_step(U, V, u_rows, i_rows, weight=w, lr=0.1,
                                    steps=6, temp=0.07)
    got = tt.online_delta_step(U, V, u_rows, i_rows, weight=w, lr=0.1,
                               steps=6, temp=0.07, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[0].dtype == got[2].dtype == np.int32
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5)


def test_online_step_updates_only_touched_rows_and_reduces_delta_loss():
    rng = np.random.default_rng(5)
    U, V = _unit_rows(rng, 20, 16), _unit_rows(rng, 30, 16)
    U0, V0 = U.copy(), V.copy()
    uu, new_u, ii, new_v, losses = tt.online_delta_step(
        U, V, np.array([1, 1, 4, 7]), np.array([2, 9, 9, 11]), lr=0.1,
        steps=6, device="cpu")
    assert list(uu) == [1, 4, 7] and list(ii) == [2, 9, 11]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert np.allclose(np.linalg.norm(new_u, axis=1), 1.0, atol=1e-4)
    assert np.allclose(np.linalg.norm(new_v, axis=1), 1.0, atol=1e-4)
    # the source tables are never mutated
    np.testing.assert_array_equal(U, U0)
    np.testing.assert_array_equal(V, V0)


def test_empty_delta_is_a_noop():
    uu, new_u, ii, new_v, losses = tt.online_delta_step(
        np.zeros((4, 8), np.float32), np.zeros((4, 8), np.float32),
        np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert len(uu) == 0 and len(ii) == 0 and losses == []
    assert new_u.shape == new_v.shape == (0, 8)


# ---------------------------------------------------------------------------
# recall@k
# ---------------------------------------------------------------------------

class _Index:
    """An index answering from a fixed result table."""

    def __init__(self, vectors, idx):
        self.vectors = vectors
        self._idx = idx

    def search(self, queries, k):
        return None, self._idx[:len(queries), :k]


@pytest.mark.parametrize("case", ["exact", "shifted", "ties", "padded"])
def test_recall_and_brute_force_match_jax(case):
    rng = np.random.default_rng(11)
    vectors = rng.normal(size=(50, 8)).astype(np.float32)
    if case == "ties":
        vectors[10:20] = vectors[0]
    queries = rng.normal(size=(6, 8)).astype(np.float32)
    got_s, got_i = recall.brute_force_topk(vectors, queries, 5)
    want_s, want_i = jax_recall.brute_force_topk(vectors, queries, 5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    idx = {"exact": want_i, "shifted": np.roll(want_i, 1, axis=1) + 1,
           "ties": want_i[:, ::-1],
           "padded": np.where(np.arange(5) < 3, want_i, -1)}[case]
    index = _Index(vectors, idx)
    value = recall.recall_at_k(index, queries, 5)
    assert value == jax_recall.recall_at_k(index, queries, 5)
    assert (value == 1.0) == (case in ("exact", "ties"))
    assert recall.recall_at_k(index, queries[:0], 5) == 1.0
    assert recall.brute_force_topk(vectors, queries, 0)[1].shape == (6, 0)


def test_recall_of_a_patched_exact_index_reads_one(monkeypatch):
    monkeypatch.setenv("PIO_INDEX_KERNEL", "on")   # the kernel's plain version
    rng = np.random.default_rng(2)
    vectors = rng.normal(size=(40, 8)).astype(np.float32)
    index = ExactIndex(kernel="on", device="cpu")
    index.build(vectors)
    new = rng.normal(size=(3, 8)).astype(np.float32) * 3
    index.upsert(np.array([5, 40, 41]), new)
    table = np.vstack([vectors, new[1:]])
    table[5] = new[0]
    np.testing.assert_array_equal(index.vectors, table)
    queries = rng.normal(size=(8, 8)).astype(np.float32)
    assert recall.recall_at_k(index, queries, 10) == 1.0
    # probed against a table the index was not patched with, it drops
    assert recall.recall_at_k(index, queries, 10, vectors=vectors) < 1.0


# ---------------------------------------------------------------------------
# the whole updater against the JAX package's, on copies of one store
# ---------------------------------------------------------------------------

class _Recorder:
    """An in-process patch target that keeps every payload."""

    def __init__(self):
        self.payloads = []

    def apply_patch(self, payload):
        self.payloads.append(payload)
        return {"applied": len(payload["algorithms"])}


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """A store the JAX package trained once (engine "s"), closed: each
    test copies the directory."""
    root = tmp_path_factory.mktemp("jax_trained")
    storage = JaxStorage.from_env(_el_env(root / "store"))
    app = storage.apps().insert("stream")
    storage.events().init(app.id)
    storage.events().insert_batch(_world_events(JaxEvent), app.id)
    engine = jax_recommendation_engine()
    old_cache = os.environ.get("PIO_BIN_CACHE_DIR")
    os.environ["PIO_BIN_CACHE_DIR"] = str(root / "bin_cache")
    jax_set_storage(storage)
    try:
        instance = jax_run_train(engine, engine.engine_params_from_variant(
            _variant()), engine_id="s", storage=storage)
    finally:
        jax_set_storage(None)
        storage.events().close()
        if old_cache is None:
            os.environ.pop("PIO_BIN_CACHE_DIR")
        else:
            os.environ["PIO_BIN_CACHE_DIR"] = old_cache
    assert instance.status == "COMPLETED"
    return root / "store", app.id, instance.id


def _copies(jax_trained, tmp_path):
    """(JAX storage, port storage) over two copies of the trained store."""
    src, _, _ = jax_trained
    shutil.copytree(src, tmp_path / "jax")
    shutil.copytree(src, tmp_path / "port")
    jax_storage = JaxStorage.from_env(_el_env(tmp_path / "jax"))
    storage = Storage.from_env(_el_env(tmp_path / "port"))
    jax_set_storage(jax_storage)
    set_storage(storage)
    return jax_storage, storage


#: the appended deltas: new users over existing items, an existing
#: user's history re-solve, a new item rated by existing users; then
#: cache extensions, a buy (implicit rating), a rate without a rating
#: (decodes to 0.0) and a $set the filters leave out
DELTAS = (
    [(f"fresh{k}", f"i{(3 * k + j) % 25}", 1.0 + (k + j) % 9 / 2.0)
     for k in range(4) for j in range(6)]
    + [("u3", "i1", 4.5), ("u3", "i7", 4.5), ("u3", "i19", 4.5),
       ("u1", "newi", 5.0), ("u2", "newi", 3.5), ("fresh1", "newi", 4.0)],
    [("u3", "i2", 2.0), ("fresh0", "i4", 5.0), ("u5", "newi", 0, "buy"),
     ("u6", "i9", None), ("u7", None, 0, "$set")],
)


def _append(store, cls, app_id, rows):
    events = []
    for k, row in enumerate(rows):
        user, item, value = row[:3]
        name = row[3] if len(row) > 3 else "rate"
        props = ({"p": 1} if name == "$set" else {}
                 if value is None or name != "rate"
                 else {"rating": float(value)})
        events.append(cls(
            event=name, entity_type="user", entity_id=user,
            target_entity_type="item" if item else None,
            target_entity_id=item, properties=props,
            event_time=T0 + dt.timedelta(days=1, seconds=k)))
    store.events().insert_batch(events, app_id)


def _same_blocks(got, want):
    assert [b["index"] for b in got] == [b["index"] for b in want]
    for g, w in zip(got, want):
        for side in ("userRows", "itemRows"):
            assert [r[0] for r in g[side]] == [r[0] for r in w[side]], side
            if w[side]:
                np.testing.assert_allclose(
                    np.array([r[1] for r in g[side]], np.float32),
                    np.array([r[1] for r in w[side]], np.float32),
                    atol=FOLD_ATOL, rtol=0)


def test_the_updater_folds_like_the_jax_updater(jax_trained, tmp_path):
    """Row by row: the same touched ids in the same order, vectors within
    FOLD_ATOL; the same stats; the local models agree afterwards."""
    _, app_id, instance_id = jax_trained
    jax_storage, storage = _copies(jax_trained, tmp_path)
    jax_rec, rec = _Recorder(), _Recorder()
    want_up = JaxUpdater(jax_recommendation_engine(), "s",
                         storage=jax_storage, patch_servers=[jax_rec])
    got_up = StreamUpdater(recommendation_engine(), "s", storage=storage,
                           ctx=CPU, patch_servers=[rec])
    assert got_up.instance_id == want_up.instance_id == instance_id
    assert got_up.cursor == want_up.cursor
    for rows in DELTAS:
        _append(jax_storage, JaxEvent, app_id, rows)
        _append(storage, Event, app_id, rows)
        want = want_up.poll_once()
        got = got_up.poll_once()
        want.pop("seconds"), got.pop("seconds")
        assert got == want and got["published"]
        assert got_up.cursor == want_up.cursor
        _same_blocks(rec.payloads[-1]["algorithms"],
                     jax_rec.payloads[-1]["algorithms"])
        assert rec.payloads[-1]["instanceId"] == instance_id
    got_m, want_m = got_up._folders[0].model, want_up._folders[0].model
    assert list(got_m.user_ids.keys()) == list(want_m.user_ids.keys())
    assert list(got_m.item_ids.keys()) == list(want_m.item_ids.keys())
    np.testing.assert_allclose(got_m.user_factors, want_m.user_factors,
                               atol=FOLD_ATOL, rtol=0)
    np.testing.assert_allclose(got_m.item_factors, want_m.item_factors,
                               atol=FOLD_ATOL, rtol=0)
    assert got_up.folds == {"ok": 2, "empty": 0, "rebased": 0,
                            "patch_failed": 0}
    assert got_up.fold_events == got["events"] + len(DELTAS[0])
    jax_storage.events().close()
    storage.events().close()


#: quality reports of the two packages: the same folds within FOLD_ATOL
#: scored against the same shadow; the drift figures are rounded to 4
#: decimals by both, so they may differ by one unit in the last place
QUALITY_ATOL = 2e-4


def test_the_quality_probe_reports_like_the_jax_updater(
        jax_trained, tmp_path, monkeypatch):
    """``PIO_QUALITY_EVERY=1``: after each fold both updaters score the
    live model against the shadow of the bound instance; the reports
    must agree (recall exactly, drift within QUALITY_ATOL), and the
    port's report is the one ``obs/quality.py`` publishes."""
    from predictionio_tpu.obs import quality as jax_quality
    from predictionio_torch.obs import quality

    monkeypatch.setenv("PIO_QUALITY_EVERY", "1")
    _, app_id, _ = jax_trained
    jax_storage, storage = _copies(jax_trained, tmp_path)
    want_up = JaxUpdater(jax_recommendation_engine(), "s",
                         storage=jax_storage, patch_servers=[_Recorder()])
    got_up = StreamUpdater(recommendation_engine(), "s", storage=storage,
                           ctx=CPU, patch_servers=[_Recorder()])
    jax_quality.STATE.clear()
    try:
        for rows in DELTAS:
            _append(jax_storage, JaxEvent, app_id, rows)
            _append(storage, Event, app_id, rows)
            want = want_up.poll_once()["quality"]
            got = got_up.poll_once()["quality"]
            assert got["recall_vs_retrain"] == want["recall_vs_retrain"]
            assert got["breached"] == want["breached"]
            for name in ("rmse_drift", "factor_drift"):
                assert got[name] == pytest.approx(want[name], abs=QUALITY_ATOL)
            assert got["factor_drift"] > 0.0
            published = quality.STATE.drift()
            assert published["recall_vs_retrain"] == got["recall_vs_retrain"]
            assert published["shadow_instance"] == got_up.instance_id
            assert set(published) == set(jax_quality.STATE.drift())
    finally:
        jax_quality.STATE.clear()
        jax_storage.events().close()
        storage.events().close()


def test_one_reload_per_breach(port_trained, monkeypatch):
    """A band every fold breaches: the first probe fires the reload lane
    once (``drift_breach`` and ``auto_reload`` journaled, the updater
    resynced), and later breaches of the same bound instance do not
    fire it again."""
    from predictionio_torch.obs import journal

    storage, app_id, engine, _ = port_trained
    monkeypatch.setenv("PIO_QUALITY_EVERY", "1")
    monkeypatch.setenv("PIO_QUALITY_DRIFT_BAND", "0")
    fired = []
    up = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                       reload_trigger=lambda: fired.append(1))
    before = len(journal.JOURNAL.recent(kind="auto_reload"))
    for rows in DELTAS:
        _append(storage, Event, app_id, rows)
        stats = up.poll_once()
        assert stats["quality"]["breached"]
    assert fired == [1]
    assert len(journal.JOURNAL.recent(kind="auto_reload")) == before + 1
    assert journal.JOURNAL.recent(kind="drift_breach")[-1]["band"] == 0.0


def test_the_reload_lane_gets_the_servers_reload(port_trained,
                                                 monkeypatch):
    """``reload_urls``: the breach's ``GET /reload`` reaches a port
    engine server, which reloads in place (its journal's ``reload``)."""
    from predictionio_torch.obs import journal

    storage, app_id, engine, _ = port_trained
    monkeypatch.setenv("PIO_QUALITY_EVERY", "1")
    monkeypatch.setenv("PIO_QUALITY_DRIFT_BAND", "0")
    server = EngineServer(engine, "stream_p", host="127.0.0.1", port=0,
                          storage=storage, device="cpu",
                          micro_batch=False).start()
    try:
        up = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                           patch_servers=[server],
                           reload_urls=[f"http://127.0.0.1:{server.port}/"])
        reloads = len(journal.JOURNAL.recent(kind="reload"))
        _append(storage, Event, app_id, DELTAS[0])
        assert up.poll_once()["quality"]["breached"]
        assert len(journal.JOURNAL.recent(kind="reload")) == reloads + 1
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# /model/patch on both engine servers
# ---------------------------------------------------------------------------

def _post(port, payload, token=None, raw=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/model/patch",
                                 data=data, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _query(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _patch_cases(instance_id):
    """(name, payload or raw bytes, token, status) in the order sent."""
    ok = {"instanceId": instance_id,
          "algorithms": [{"index": 0, "userRows": [["patched_u",
                                                    [0.5] * 8]]}]}
    return [
        ("ok", ok, None, 200),
        ("new-item", {"instanceId": instance_id, "algorithms": [
            {"index": 0, "itemRows": [["patched_i", [0.25] * 8]]}]},
         None, 200),
        ("stale", {"instanceId": "not_the_deployed_instance",
                   "algorithms": [{"index": 0,
                                   "userRows": [["u", [0.0] * 8]]}]},
         None, 409),
        ("empty", {"instanceId": instance_id, "algorithms": []}, None, 400),
        ("index", {"instanceId": instance_id,
                   "algorithms": [{"index": 99, "userRows": []}]}, None,
         400),
        ("length", {"instanceId": instance_id, "algorithms": [
            {"index": 0, "userRows": [["u", [0.0] * 3]]}]}, None, 400),
        ("row", {"instanceId": instance_id, "algorithms": [
            {"index": 0, "itemRows": [["i1"]]}]}, None, 400),
        ("block", {"instanceId": instance_id, "algorithms": [7]}, None, 400),
        ("json", b"{not json", None, 400),
        ("not-an-object", b"[1, 2]", None, 500),
        ("no-token", ok, None, 401),
        ("wrong-token", ok, "nope", 401),
        ("token", ok, "s3cret", 200),
    ]


def test_model_patch_answers_every_status_like_jax(jax_trained, tmp_path,
                                                   monkeypatch):
    _, _, instance_id = jax_trained
    jax_storage, storage = _copies(jax_trained, tmp_path)
    want_srv = JaxEngineServer(jax_recommendation_engine(), "s",
                               host="127.0.0.1", port=0,
                               storage=jax_storage).start()
    got_srv = EngineServer(recommendation_engine(), "s", host="127.0.0.1",
                           port=0, storage=storage, device="cpu").start()
    try:
        assert _query(got_srv.port, {"user": "patched_u"}) == {
            "itemScores": []}
        for name, payload, token, status in _patch_cases(instance_id):
            if name == "no-token":
                monkeypatch.setenv("PIO_ADMIN_TOKEN", "s3cret")
            raw = payload if isinstance(payload, bytes) else None
            got = _post(got_srv.port, payload, token, raw)
            want = _post(want_srv.port, payload, token, raw)
            assert got == want, name
            assert got[0] == status, (name, got)
        assert got_srv.patches == {"applied": 3, "rejected": 5, "stale": 1}
        assert got_srv.status()["patches"] == got_srv.patches
        # the patched rows answer: the new user, and the new item
        got = _query(got_srv.port, {"user": "patched_u", "num": 3})
        want = _query(want_srv.port, {"user": "patched_u", "num": 3})
        assert len(got["itemScores"]) == 3
        assert ([e["item"] for e in got["itemScores"]]
                == [e["item"] for e in want["itemScores"]])
        np.testing.assert_allclose([e["score"] for e in got["itemScores"]],
                                   [e["score"] for e in want["itemScores"]],
                                   rtol=1e-5)
        assert _query(got_srv.port, {"item": "patched_i", "num": 2})[
            "itemScores"]
    finally:
        got_srv.stop()
        want_srv.stop()


def test_unsupported_algorithm_answers_400(tmp_path):
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_M_TYPE": "memory"})
    engine = Engine(data_source_classes={"ds": DataSource0},
                    preparator_classes={"prep": Preparator0},
                    algorithm_classes={"algo": Algo0},
                    serving_classes={"first": FirstServing})
    instance = run_train(engine, EngineParams(
        data_source_params=("ds", IdParams(id=1)),
        preparator_params=("prep", IdParams(id=2)),
        algorithm_params_list=[("algo", IdParams(id=3))],
        serving_params=("first", None)), engine_id="const", ctx=CPU,
        storage=storage)
    server = EngineServer(engine, "const", host="127.0.0.1", port=0,
                          storage=storage, micro_batch=False,
                          device="cpu").start()
    try:
        status, body = _post(server.port, {
            "instanceId": instance.id,
            "algorithms": [{"index": 0, "userRows": []}]})
        assert status == 400 and "does not support" in body["message"]
        with pytest.raises(StreamUnsupported, match="app_name"):
            StreamUpdater(engine, "const", storage=storage, ctx=CPU,
                          instance=instance)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the port's updater: fold-in vs retrain, and its failure paths
# ---------------------------------------------------------------------------

def _rng_delta(rng):
    """New users rating existing items, and an existing user's fresh
    ratings: both fold lanes (cold solve and warm re-solve)."""
    delta, touched = [], []
    for k in range(4):
        uid = f"fresh{k}"
        touched.append(uid)
        for i in rng.integers(0, 25, size=6):
            delta.append(_rate(Event, uid, f"i{int(i)}",
                               float(rng.integers(2, 11)) / 2.0))
    touched.append("u3")
    for i in (1, 7, 19):
        delta.append(_rate(Event, "u3", f"i{i}", 4.5))
    return delta, touched


def test_foldin_matches_full_retrain_within_tolerance(tmp_path):
    """tests/test_stream.py's bound: predictions of each folded user
    over the shared items within RMSE 0.12 (max 0.35) of a full retrain
    over base + delta."""
    storage, app_id = _port_world(tmp_path / "store")
    engine, instance = _port_train(storage, "stream_eq")
    updater = StreamUpdater(engine, "stream_eq", storage=storage, ctx=CPU,
                            instance=instance)
    delta, touched = _rng_delta(np.random.default_rng(9))
    storage.events().insert_batch(delta, app_id)
    stats = updater.poll_once()
    assert stats["events"] == len(delta) and stats["published"]
    folded = updater._folders[0].model
    engine2, instance2 = _port_train(storage, "stream_eq2")
    retrained = prepare_deploy(engine2, instance2, CPU, storage).models[0]
    items = [f"i{i}" for i in range(25)]
    for uid in touched:
        u_f = folded.user_factors[folded.user_ids[uid]]
        u_r = retrained.user_factors[retrained.user_ids[uid]]
        p_f = np.array([folded.item_factors[folded.item_ids[i]] @ u_f
                        for i in items])
        p_r = np.array([retrained.item_factors[retrained.item_ids[i]] @ u_r
                        for i in items])
        assert float(np.sqrt(np.mean((p_f - p_r) ** 2))) < 0.12, uid
        assert float(np.max(np.abs(p_f - p_r))) < 0.35, uid
    storage.events().close()


@pytest.fixture()
def port_trained(tmp_path):
    storage, app_id = _port_world(tmp_path / "store", n_events=400)
    engine, instance = _port_train(storage, "stream_p", iterations=4)
    yield storage, app_id, engine, instance
    storage.events().close()


def test_rebase_skips_fold_and_warns(port_trained, caplog):
    storage, app_id, engine, instance = port_trained
    updater = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                            instance=instance)
    ev = storage.events()
    eid = ev.insert(_rate(Event, "gone", "i1", 1.0), app_id)
    ev.delete(eid, app_id)
    ev.compact(app_id)  # renumbers records -> the cursor rebases
    stats = updater.poll_once()
    assert stats["rebased"] and stats["events"] == 0
    assert updater.folds["rebased"] == 1
    assert "rebased" in caplog.text
    # after the reset the tail is clean again
    ev.insert_batch([_rate(Event, "after", "i2", 4.0)], app_id)
    stats2 = updater.poll_once()
    assert not stats2["rebased"] and stats2["events"] == 1
    assert updater.poll_once()["events"] == 0
    assert updater.folds == {"ok": 1, "empty": 1, "rebased": 1,
                             "patch_failed": 0}


def test_truncated_backlog_folds_the_newest_and_drops_cached_histories(
        port_trained, monkeypatch):
    storage, app_id, engine, instance = port_trained
    updater = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                            instance=instance)
    folder = updater._folders[0]
    storage.events().insert_batch([_rate(Event, "u3", "i1", 4.0)], app_id)
    assert updater.poll_once()["published"]
    assert ("u", "u3") in folder._hist
    monkeypatch.setenv("PIO_STREAM_MAX_DELTA", "3")
    storage.events().insert_batch(
        [_rate(Event, f"tr{k}", "i1", 4.0) for k in range(8)], app_id)
    stats = updater.poll_once()
    assert stats["truncated"] and stats["published"]
    assert stats["events"] == 3 and stats["touched_users"] == 3
    assert ("u", "u3") not in folder._hist       # invalidated
    assert "tr7" in folder.model.user_ids and "tr0" not in folder.model.user_ids


def test_fold_failure_rewinds_cursor_for_retry(port_trained):
    storage, app_id, engine, instance = port_trained
    updater = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                            instance=instance)
    storage.events().insert_batch(
        [_rate(Event, "err_u", "i1", 4.0), _rate(Event, "err_u", "i2", 3.0)],
        app_id)
    folder = updater._folders[0]
    real_fold = folder.fold
    calls = {"n": 0}

    def flaky_fold(users, items, ratings):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient fold failure")
        return real_fold(users, items, ratings)

    folder.fold = flaky_fold
    before = updater.cursor
    with pytest.raises(RuntimeError, match="transient"):
        updater.poll_once()
    assert updater.cursor == before  # rewound: the delta survives
    stats = updater.poll_once()      # the next tick retries it
    assert stats["events"] == 2 and stats["published"]
    assert "err_u" in folder.model.user_ids


@pytest.mark.parametrize("lane", ["in-process", "http"])
def test_a_stale_patch_resyncs_to_the_served_instance(port_trained, lane):
    storage, app_id, engine, instance = port_trained
    server = EngineServer(engine, "stream_p", host="127.0.0.1", port=0,
                          storage=storage, device="cpu").start()
    try:
        target = ({"patch_servers": [server]} if lane == "in-process"
                  else {"patch_urls": [f"http://127.0.0.1:{server.port}/"]})
        updater = StreamUpdater(engine, "stream_p", storage=storage,
                                ctx=CPU, instance=instance, **target)
        storage.events().insert_batch([_rate(Event, "ok_u", "i1", 4.0)],
                                      app_id)
        assert updater.poll_once()["published"]
        assert _query(server.port, {"user": "ok_u"})["itemScores"]
        # a retrain lands and the server rolls to it behind the
        # streamer's back
        _, instance2 = _port_train(storage, "stream_p", iterations=4)
        server.reload()
        storage.events().insert_batch([_rate(Event, "sp_u", "i1", 4.0)],
                                      app_id)
        stats = updater.poll_once()
        # a counted failure AND a rebind to the served instance
        assert not stats["published"]
        assert updater.instance_id == instance2.id
        assert updater.patch_failures == 1
        assert updater.folds["patch_failed"] == 1
        storage.events().insert_batch([_rate(Event, "sp_u2", "i2", 4.5)],
                                      app_id)
        assert updater.poll_once()["published"]
        assert _query(server.port, {"user": "sp_u2"})["itemScores"]
    finally:
        server.stop()


def test_oversize_groups_are_skipped_and_counted(port_trained, monkeypatch):
    """An existing item past PIO_STREAM_MAX_GROUP is not re-solved; a
    user's history is cut to its newest rows; a new item's history is
    the delta, solved whatever its length."""
    storage, app_id, engine, instance = port_trained
    updater = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                            instance=instance)
    model = updater._folders[0].model
    monkeypatch.setenv("PIO_STREAM_MAX_GROUP", "3")
    before = model.item_factors[model.item_ids["i1"]].copy()
    rows = [_rate(Event, "u3", "i1", 4.0)] + [
        _rate(Event, f"u{10 + k}", "new_item", 3.0 + k % 3)
        for k in range(5)]
    storage.events().insert_batch(rows, app_id)
    stats = updater.poll_once()
    assert stats["published"]
    np.testing.assert_array_equal(model.item_factors[model.item_ids["i1"]],
                                  before)
    assert updater.groups_skipped["oversize"] == 1
    # six users' histories, cut in both user passes, and new_item's
    assert updater.groups_skipped["truncated"] == 13
    assert np.any(model.item_factors[model.item_ids["new_item"]] != 0)


def test_recall_probe_reads_one_on_the_patched_index(port_trained,
                                                     monkeypatch):
    monkeypatch.setenv("PIO_INDEX_KERNEL", "on")   # the kernel's plain version
    monkeypatch.setenv("PIO_STREAM_RECALL_EVERY", "1")
    storage, app_id, engine, instance = port_trained
    updater = StreamUpdater(engine, "stream_p", storage=storage, ctx=CPU,
                            instance=instance)
    updater._folders[0].model.retrieval_index()   # built before the fold
    storage.events().insert_batch(
        [_rate(Event, "u1", "brand_new", 5.0),
         _rate(Event, "u2", "brand_new", 4.0)], app_id)
    stats = updater.poll_once()
    assert stats["index_recall"] == 1.0 == updater.index_recall
    assert updater.recall_breaches == 0


def test_a_store_without_delta_reads_is_unsupported(tmp_path):
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                                "PIO_STORAGE_SOURCES_FS_PATH":
                                str(tmp_path / "fs")})
    app = storage.apps().insert("stream")
    storage.events().init(app.id)
    storage.events().insert_batch(_world_events(Event, n_events=300),
                                  app.id)
    set_storage(storage)
    engine, instance = _port_train(storage, "fs", iterations=2)
    with pytest.raises(StreamUnsupported, match="eventlog backend"):
        StreamUpdater(engine, "fs", storage=storage, ctx=CPU)
    with pytest.raises(StreamUnsupported, match="no COMPLETED instance"):
        StreamUpdater(engine, "nothing-trained", storage=storage, ctx=CPU)


# ---------------------------------------------------------------------------
# two-tower lane through the updater, against the JAX updater
# ---------------------------------------------------------------------------

def test_the_two_tower_lane_folds_like_the_jax_updater(tmp_path,
                                                        monkeypatch):
    """A two-tower engine the JAX package trained, both updaters on
    copies: new ids get the same seeded fresh rows, the online step the
    same vectors (atol 1e-5), and only touched rows change."""
    from predictionio_tpu.templates.twotower import (
        twotower_engine as jax_twotower_engine)
    from predictionio_torch.templates.twotower import twotower_engine

    monkeypatch.setenv("PIO_BIN_CACHE_DIR", str(tmp_path / "bc"))
    ref = JaxStorage.from_env(_el_env(tmp_path / "src"))
    app = ref.apps().insert("stream")
    ref.events().init(app.id)
    ref.events().insert_batch(_world_events(JaxEvent, n_events=300), app.id)
    jax_engine = jax_twotower_engine()
    jax_set_storage(ref)
    variant = {"datasource": {"params": {"app_name": "stream"}},
               "algorithms": [{"name": "twotower", "params": {
                   "dim": 8, "epochs": 2, "batch_size": 64,
                   "temperature": 0.1}}]}
    instance = jax_run_train(jax_engine, jax_engine.engine_params_from_variant(
        variant), engine_id="tt", storage=ref)
    assert instance.status == "COMPLETED"
    ref.events().close()
    jax_set_storage(None)
    jax_storage, storage = _copies((tmp_path / "src", app.id, instance.id),
                                   tmp_path)
    jax_rec, rec = _Recorder(), _Recorder()
    want_up = JaxUpdater(jax_engine, "tt", storage=jax_storage,
                         patch_servers=[jax_rec])
    got_up = StreamUpdater(twotower_engine(), "tt", storage=storage, ctx=CPU,
                           patch_servers=[rec])
    model = got_up._folders[0].model
    U0, V0 = model.user_factors.copy(), model.item_factors.copy()
    rows = [("u1", "i2", 4.0), ("tt_new", "i2", 5.0), ("u4", "tt_item", 3.0),
            ("u1", "i9", 2.0)]
    _append(jax_storage, JaxEvent, app.id, rows)
    _append(storage, Event, app.id, rows)
    want, got = want_up.poll_once(), got_up.poll_once()
    want.pop("seconds"), got.pop("seconds")
    assert got == want and got["published"]
    g, w = rec.payloads[0]["algorithms"], jax_rec.payloads[0]["algorithms"]
    for side in ("userRows", "itemRows"):
        assert [r[0] for r in g[0][side]] == [r[0] for r in w[0][side]]
        np.testing.assert_allclose(np.array([r[1] for r in g[0][side]]),
                                   np.array([r[1] for r in w[0][side]]),
                                   atol=1e-5)
    touched_u = {model.user_ids[r[0]] for r in g[0]["userRows"]}
    touched_i = {model.item_ids[r[0]] for r in g[0]["itemRows"]}
    for rows_, before, touched in ((model.user_factors, U0, touched_u),
                                   (model.item_factors, V0, touched_i)):
        keep = [j for j in range(len(before)) if j not in touched]
        np.testing.assert_array_equal(rows_[keep], before[keep])
    jax_storage.events().close()
    storage.events().close()


# ---------------------------------------------------------------------------
# pio stream / pio undeploy
# ---------------------------------------------------------------------------

def test_cli_stream_once_and_undeploy(tmp_path, monkeypatch, capsys):
    """``cli deploy`` serves a trained eventlog engine in a process of its
    own; ``cli stream --once --url --reload-url`` folds from the tail
    (0 events: the blind window belongs to retrains) and prints its
    stats; ``cli undeploy`` stops the server, whose process exits 0."""
    env = _el_env(tmp_path / "store")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    storage, _ = _port_world(tmp_path / "store", n_events=300)
    _port_train(storage, "reco-cli", iterations=2)
    storage.events().close()
    set_storage(None)
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        **_variant(2), "engineId": "reco-cli", "engineFactory":
        "predictionio_torch.templates.recommendation.recommendation_engine"}))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_torch.tools.cli", "deploy",
         "--engine-json", str(engine_json), "--port", str(port), "--ip",
         "127.0.0.1", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _wait_healthy(port, proc)
        capsys.readouterr()
        url = f"http://127.0.0.1:{port}"
        assert cli.main(["stream", "--engine-json", str(engine_json),
                         "--once", "--url", url, "--reload-url", url,
                         "--device", "cpu"]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["events"] == 0 and stats["rebased"] is False
        assert cli.main(["undeploy", "--port", str(port)]) == 0
        assert "stopping" in capsys.readouterr().out
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_stream_errors_are_command_errors(tmp_path, monkeypatch,
                                              capsys):
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        **_variant(2), "engineId": "reco-fs", "engineFactory":
        "predictionio_torch.templates.recommendation.recommendation_engine"}))
    args = ["stream", "--engine-json", str(engine_json), "--once",
            "--device", "cpu"]
    monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_TYPE", "localfs")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_PATH", str(tmp_path / "fs"))
    storage = Storage.from_env({"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                                "PIO_STORAGE_SOURCES_FS_PATH":
                                str(tmp_path / "fs")})
    app = storage.apps().insert("stream")
    storage.events().init(app.id)
    storage.events().insert_batch(_world_events(Event, n_events=300),
                                  app.id)
    set_storage(storage)
    _port_train(storage, "reco-fs", iterations=2)
    set_storage(None)
    assert cli.main(args) == 1
    assert "eventlog backend" in capsys.readouterr().err


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_healthy(port, proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"deploy exited: {proc.stdout.read()}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("deploy did not come up")
