"""The port's native event log against the JAX package's, on the CPU.

The same seeded events go through both packages' ``EventLogEventStore``,
each writing its own log under ``tmp_path``, and every read must agree
exactly: equal ``Event`` lists (ids, times and offsets, properties,
tags), equal ``EventColumns`` arrays and vocabularies, equal JSON-lane
codes, equal compaction counts and fingerprint contents. A log one
package wrote and closed is read by the other (each log has one writer,
an ``flock``, so a store closes before the other opens it). The native
libraries build into their own directory from two processes at once, and
a build that fails raises instead of falling back.
"""

import datetime as dt
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from predictionio_tpu.data.backends.eventlog import (
    EventLogEventStore as JaxStore)
from predictionio_tpu.data.backends.eventlog import (
    JsonRowsUnsupported as JaxJsonRowsUnsupported)
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.event import (
    EventValidationError as JaxEventValidationError)
from predictionio_tpu.data.event import validate_event as jax_validate_event
from predictionio_tpu.data.storage import EventColumns as JaxColumns
from predictionio_tpu.data.storage import UNSET as JAX_UNSET
from predictionio_torch.data import storage as S
from predictionio_torch.data.backends.eventlog import (EventLogEventStore,
                                                       JsonRowsUnsupported)
from predictionio_torch.data.event import (Event, EventValidationError,
                                           validate_event)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UTC = dt.timezone.utc
T0 = dt.datetime(2026, 3, 1, 12, 0, tzinfo=UTC)


def _stores(tmp_path):
    port = EventLogEventStore(str(tmp_path / "port"))
    ref = JaxStore(str(tmp_path / "jax"))
    port.init(1)
    ref.init(1)
    return port, ref


def _event_dicts(n=60, seed=0):
    """Seeded events as keyword dicts: rate (rating property) and buy
    events between users and items, $set events without a target, a
    tz-offset time, tags, a prId and caller-stamped ids (canonical hex
    and not)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = rng.integers(0, 4)
        d = dict(entity_type="user", entity_id=f"u{rng.integers(0, 9)}",
                 event_time=T0 + dt.timedelta(minutes=int(rng.integers(0, 50))),
                 creation_time=T0, event_id=f"{k:032x}")
        if kind == 3:
            d.update(event="$set", properties={"age": int(rng.integers(18, 70)),
                                               "tags": ["a", "b"]})
        else:
            d.update(event="rate" if kind else "buy",
                     target_entity_type="item",
                     target_entity_id=f"i{rng.integers(0, 7)}",
                     properties=({"rating": float(rng.integers(1, 11)) / 2}
                                 if kind else {}))
        if k % 11 == 0:
            d["event_time"] = d["event_time"].astimezone(
                dt.timezone(dt.timedelta(hours=5, minutes=30)))
            d["tags"] = ("t1", "t2")
            d["pr_id"] = "pr-1"
        if k % 13 == 0:
            d["event_id"] = f"custom-{k}"
        out.append(d)
    return out


def _canon(events):
    return [(e.event_id, e.event, e.entity_type, e.entity_id,
             e.target_entity_type, e.target_entity_id,
             e.properties.to_dict(), e.event_time, e.event_time.utcoffset(),
             e.creation_time, tuple(e.tags), e.pr_id) for e in events]


def _assert_columns_equal(got, want):
    for name in ("entity_codes", "target_codes", "name_codes", "times_us"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    np.testing.assert_array_equal(got.values, want.values)   # NaN == NaN
    assert got.entity_vocab == want.entity_vocab
    assert got.target_vocab == want.target_vocab
    assert got.names == want.names


def _columns(cls, n=500, seed=1):
    rng = np.random.default_rng(seed)
    names = (rng.random(n) < 0.3).astype(np.int32)
    vals = (0.5 + 0.5 * rng.integers(0, 10, n)).astype(np.float64)
    vals[names == 1] = np.nan
    tgt = rng.integers(0, 40, n).astype(np.int32)
    tgt[::17] = -1                       # rows without a target
    return cls(entity_codes=rng.integers(0, 60, n).astype(np.int32),
               target_codes=tgt, name_codes=names, values=vals,
               times_us=(rng.integers(0, 10**6, n) * 1000).astype(np.int64),
               entity_vocab=[f"u{i}" for i in range(60)],
               target_vocab=[f"i\0{i}" for i in range(40)],   # NUL in ids
               names=["rate", "buy"])


def _fill(port, ref, lane):
    """The same events into both stores through one lane."""
    dicts = _event_dicts()
    if lane == "insert":
        for d in dicts:
            port.insert(Event(**d), 1)
            ref.insert(JaxEvent(**d), 1)
    elif lane == "insert_batch":
        port.insert_batch([Event(**d) for d in dicts], 1)
        ref.insert_batch([JaxEvent(**d) for d in dicts], 1)
    elif lane == "insert_columnar":
        for store, cls in ((port, S.EventColumns), (ref, JaxColumns)):
            assert store.insert_columnar(
                _columns(cls), 1, entity_type="user",
                target_entity_type="item", value_property="rating") == 500
    else:
        rows = [Event(**d).to_dict() for d in dicts if not d["event_id"]
                .startswith("custom")]
        for r in rows:
            r.pop("eventId")    # the JSON lane mints its ids
        raw = json.dumps(rows).encode()
        got = port.insert_json_batch(raw, 1)
        want = ref.insert_json_batch(raw, 1)
        assert got[1:] == want[1:]
        assert all(got[0]) and len(got[0]) == len(rows)


@pytest.mark.parametrize("lane", ["insert", "insert_batch", "insert_columnar",
                                  "insert_json_batch"])
def test_every_insert_lane_stores_what_the_jax_store_stores(tmp_path, lane):
    port, ref = _stores(tmp_path)
    try:
        _fill(port, ref, lane)
        got, want = port.find(1), ref.find(1)
        assert len(got) == len(want) > 0
        if lane in ("insert", "insert_batch"):
            assert _canon(got) == _canon(want)
        else:
            # fresh ids (and the JSON lane's creation times) are minted
            # by each store
            strip = (lambda c: [r[1:9] + r[10:] for r in c])
            assert strip(_canon(got)) == strip(_canon(want))
        for time_ordered in (True, False):
            _assert_columns_equal(
                port.find_columnar(1, value_property="rating",
                                   time_ordered=time_ordered),
                ref.find_columnar(1, value_property="rating",
                                  time_ordered=time_ordered))
    finally:
        port.close()
        ref.close()


FILTERS = [
    {},
    {"start_time": T0 + dt.timedelta(minutes=10),
     "until_time": T0 + dt.timedelta(minutes=30)},
    {"entity_type": "user", "entity_id": "u3"},
    {"event_names": ["rate", "buy"]},
    {"event_names": ["$set"], "target_entity_type": None},
    {"target_entity_type": "item", "target_entity_id": "i2"},
    {"target_entity_id": None},
    {"limit": 7},
    {"limit": 7, "reversed": True},
    {"event_names": ["rate"], "limit": 5, "reversed": True,
     "start_time": T0 + dt.timedelta(minutes=5)},
]


@pytest.mark.parametrize("filters", FILTERS,
                         ids=[",".join(f) or "all" for f in FILTERS])
def test_find_and_find_columnar_match_jax_under_every_filter(tmp_path,
                                                             filters):
    port, ref = _stores(tmp_path)
    try:
        _fill(port, ref, "insert_batch")
        jax_filters = {k: (JAX_UNSET if v is S.UNSET else v)
                       for k, v in filters.items()}
        got = port.find(1, **filters)
        assert _canon(got) == _canon(ref.find(1, **jax_filters))
        assert len(got) > 0
        for time_ordered in (True, False):
            _assert_columns_equal(
                port.find_columnar(1, value_property="rating",
                                   time_ordered=time_ordered, **filters),
                ref.find_columnar(1, value_property="rating",
                                  time_ordered=time_ordered, **jax_filters))
        with pytest.raises(TypeError):
            port.find_columnar(1, entity_typ="user")   # a mistyped filter
    finally:
        port.close()
        ref.close()


BAD_ROWS = [
    ({"event": "", "entityType": "u", "entityId": "x"}, 4),
    ({"event": "$bogus", "entityType": "u", "entityId": "x"}, 11),
    ({"event": "r", "entityType": "u", "entityId": "x",
      "targetEntityType": "item"}, 7),
    ({"event": "$unset", "entityType": "u", "entityId": "x"}, 10),
    ({"event": "$set", "entityType": "u", "entityId": "x",
      "targetEntityType": "item", "targetEntityId": "i"}, 12),
    ({"event": "r", "entityType": "pio_x", "entityId": "x"}, 13),
    ({"event": "r", "entityType": "u", "entityId": "x",
      "properties": {"pio_k": 1}}, 15),
    ({"entityType": "u", "entityId": "x"}, 1),
]


def test_json_lane_codes_valid_and_malformed_rows_like_jax(tmp_path):
    port, ref = _stores(tmp_path)
    try:
        good = [{"event": "rate", "entityType": "user", "entityId": "ok",
                 "targetEntityType": "item", "targetEntityId": "i1",
                 "properties": {"rating": 4.5},
                 "eventTime": "2026-01-02T10:30:00+05:30"},
                {"event": "view", "entityType": "user", "entityId": "ué",
                 "eventTime": 1767225600000, "tags": ["t"], "prId": "p"}]
        raw = json.dumps(good + [r for r, _ in BAD_ROWS]).encode()
        got = port.insert_json_batch(raw, 1, strict=False)
        want = ref.insert_json_batch(raw, 1, strict=False)
        assert got[1] == want[1] == [0, 0] + [c for _, c in BAD_ROWS]
        assert got[2:] == want[2:]
        assert [i is None for i in got[0]] == [i is None for i in want[0]]
        strip = (lambda c: [r[1:9] + r[10:] for r in c])
        assert strip(_canon(port.find(1))) == strip(_canon(ref.find(1)))
        assert [e.entity_id for e in port.find(1)] == ["ué", "ok"]
        # strict: the first bad row raises and nothing lands
        with pytest.raises(S.RowValidationError, match="event 1"):
            port.insert_json_batch(json.dumps(
                [good[0], BAD_ROWS[0][0]]).encode(), 1)
        assert len(port.find(1)) == 2
        # bodies json.loads refuses: the same answer as the JAX lane's
        # (ValueError, or the per-row path, which then refuses them)
        for poison in (b'[{"event": "r",',
                       b'[{"event":"rate" "entityType":"u","entityId":"x"}]',
                       b'[{"event":"rate","entityType":"u","entityId":"x",'
                       b'"properties":{"a":1 "b":2}}]',
                       b'[{"event":"rate","entityType":"u","entityId":"x"},]',
                       b'{"event": "rate"}'):
            with pytest.raises((ValueError, JsonRowsUnsupported)) as got:
                port.insert_json_batch(poison, 1, strict=False)
            with pytest.raises((ValueError, JaxJsonRowsUnsupported)) as want:
                ref.insert_json_batch(poison, 1, strict=False)
            assert got.type.__name__ == want.type.__name__
        # constructs the native lane leaves to the per-row path
        for rows in ([{"event": "r", "entityType": "u", "entityId": "x",
                       "eventId": "abc"}],
                     [{"event": "r", "entityType": "u", "entityId": "x",
                       "eventTime": "20260101"}],
                     [{"event": "r", "entityType": "u", "entityId": "x",
                       "properties": "zz"}]):
            with pytest.raises(JsonRowsUnsupported):
                port.insert_json_batch(json.dumps(rows).encode(), 1)
            with pytest.raises(JaxJsonRowsUnsupported):
                ref.insert_json_batch(json.dumps(rows).encode(), 1)
        assert len(port.find(1)) == 2
    finally:
        port.close()
        ref.close()


def test_validate_event_rejects_what_the_jax_rules_reject():
    """The port's ``validate_event`` against the JAX one over the JSON
    lane's bad rows and good events."""
    for row, _ in BAD_ROWS[:-1]:
        with pytest.raises(EventValidationError) as got:
            validate_event(Event.from_dict(row))
        with pytest.raises(JaxEventValidationError) as want:
            jax_validate_event(JaxEvent.from_dict(row))
        assert str(got.value) == str(want.value)
    for d in _event_dicts(20):
        validate_event(Event(**d))
        jax_validate_event(JaxEvent(**d))


def test_insert_columnar_validates_and_guards_the_wire_format(tmp_path):
    port, ref = _stores(tmp_path)
    try:
        bad = _columns(S.EventColumns)
        bad.names = ["$rate", "buy"]
        with pytest.raises(EventValidationError, match="reserved"):
            port.insert_columnar(bad, 1, entity_type="user",
                                 target_entity_type="item",
                                 value_property="rating")
        with pytest.raises(EventValidationError, match="specified together"):
            port.insert_columnar(_columns(S.EventColumns), 1,
                                 entity_type="user", value_property="rating")
        with pytest.raises(EventValidationError, match="pio_"):
            port.insert_columnar(_columns(S.EventColumns), 1,
                                 entity_type="pio_user",
                                 target_entity_type="item")
        wide = _columns(S.EventColumns, n=3)
        wide.entity_vocab = ["u" * 0xFFFF] + wide.entity_vocab[1:]
        wide.entity_codes[:] = 0
        with pytest.raises(S.StorageError, match="65534"):
            port.insert_columnar(wide, 1, entity_type="user",
                                 target_entity_type="item")
        assert port.find(1) == []      # nothing was written
    finally:
        port.close()
        ref.close()


def test_get_delete_tombstones_compact_and_reopen_like_jax(tmp_path):
    port, ref = _stores(tmp_path)
    dicts = _event_dicts()
    try:
        _fill(port, ref, "insert_batch")
        fp0 = port.data_fingerprint(1)
        ids = [d["event_id"] for d in dicts]
        for eid in ids[::4]:
            assert port.delete(eid, 1) and ref.delete(eid, 1)
        assert not port.delete(ids[0], 1)          # already gone
        assert port.get(ids[0], 1) is None
        assert _canon([port.get(ids[1], 1)]) == _canon([ref.get(ids[1], 1)])
        assert _canon([port.get("custom-13", 1)]) == _canon(
            [ref.get("custom-13", 1)])
        # re-inserted after its delete, an id is live again
        again = Event(**{**dicts[0], "entity_id": "u-again"})
        port.insert(again, 1)
        ref.insert(JaxEvent(**{**dicts[0], "entity_id": "u-again"}), 1)
        assert port.get(ids[0], 1).entity_id == "u-again"
        fp1 = port.data_fingerprint(1)
        assert fp1 != fp0
        # the content quadruple after the log's identity hash
        assert fp1.split("-", 1)[1] == ref.data_fingerprint(1).split("-", 1)[1]
        assert _canon(port.find(1)) == _canon(ref.find(1))
        got, want = port.compact(1), ref.compact(1)
        assert got == want and got["dropped"] == len(ids[::4])
        assert got["after_bytes"] < got["before_bytes"]
        fp2 = port.data_fingerprint(1)
        assert fp2 not in (fp0, fp1)
        assert port.data_fingerprint(1) == fp2      # stable while unchanged
        assert _canon(port.find(1)) == _canon(ref.find(1))
        port.close()
        reopened = EventLogEventStore(str(tmp_path / "port"))
        try:
            assert _canon(reopened.find(1)) == _canon(ref.find(1))
            assert reopened.data_fingerprint(1) == fp2
        finally:
            reopened.close()
    finally:
        port.close()
        ref.close()


def test_fingerprint_tells_apps_and_channels_apart(tmp_path):
    port = EventLogEventStore(str(tmp_path / "port"))
    try:
        raw = json.dumps([{"event": "rate", "entityType": "u",
                           "entityId": f"u{i}", "targetEntityType": "i",
                           "targetEntityId": f"i{i}",
                           "properties": {"rating": 3.5}}
                          for i in range(20)]).encode()
        for app, channel in ((1, None), (2, None), (1, 7)):
            port.init(app, channel)
            port.insert_json_batch(raw, app, channel)
        fps = [port.data_fingerprint(a, c) for a, c in ((1, None), (2, None),
                                                        (1, 7))]
        assert len(set(fps)) == 3
        assert len({f.split("-", 1)[1] for f in fps}) == 1
        port.remove(2)
        with pytest.raises(S.StorageError, match="not initialized"):
            port.find(2)
    finally:
        port.close()


def test_a_log_written_by_either_package_is_read_by_the_other(tmp_path):
    dicts = _event_dicts()
    ref = JaxStore(str(tmp_path / "a"))
    ref.init(1)
    ref.insert_batch([JaxEvent(**d) for d in dicts], 1)
    ref.delete(dicts[3]["event_id"], 1)
    want = _canon(ref.find(1))
    ref.close()
    port = EventLogEventStore(str(tmp_path / "a"))
    try:
        assert _canon(port.find(1)) == want
        assert port.get(dicts[3]["event_id"], 1) is None
        port.insert_batch([Event(event="rate", entity_type="user",
                                 entity_id="from-port",
                                 target_entity_type="item",
                                 target_entity_id="i1",
                                 properties={"rating": 2.0},
                                 event_time=T0, creation_time=T0,
                                 event_id="ab" * 16)], 1)
        want = _canon(port.find(1))
        cols = port.find_columnar(1, value_property="rating")
    finally:
        port.close()
    ref = JaxStore(str(tmp_path / "a"))
    try:
        assert _canon(ref.find(1)) == want
        _assert_columns_equal(cols, ref.find_columnar(
            1, value_property="rating"))
    finally:
        ref.close()


def test_a_second_open_of_a_log_fails_cleanly(tmp_path):
    port = EventLogEventStore(str(tmp_path / "p"))
    port.init(1)
    try:
        code = ("import sys; sys.path.insert(0, %r)\n"
                "from predictionio_torch.data.backends.eventlog import "
                "EventLogEventStore\n"
                "from predictionio_torch.data.storage import StorageError\n"
                "try:\n"
                "    EventLogEventStore(%r).init(1)\n"
                "except StorageError as e:\n"
                "    print('refused', 'LOCK' in str(e))\n"
                % (ROOT, str(tmp_path / "p")))
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120)
        assert out.stdout.strip() == "refused True", out.stderr
    finally:
        port.close()


def test_storage_client_puts_events_in_the_log_and_metadata_in_localfs(
        tmp_path):
    storage = S.Storage.from_env({
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path)})
    app = storage.apps().insert("reco")
    storage.events().init(app.id)
    storage.events().insert_batch([Event(**d) for d in _event_dicts(5)],
                                  app.id)
    storage.events().close()
    assert os.path.isdir(tmp_path / "events" / f"events_{app.id}")
    assert os.path.exists(tmp_path / "meta" / "metadata.json")
    again = S.Storage.from_env({
        "PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
        "PIO_STORAGE_SOURCES_EL_PATH": str(tmp_path)})
    try:
        assert again.apps().get_by_name("reco").id == app.id
        assert len(again.events().find(app.id)) == 5
    finally:
        again.events().close()


_BUILD = """
import sys, time
sys.path.insert(0, {root!r})
from predictionio_torch import native
for name in ("eventlog", "raggedbin"):
    lib = native.load_library(name)
    assert hasattr(lib, "el_bin_columnar" if name == "eventlog"
                   else "rb_bin_compressed")
print("loaded")
"""


def test_two_processes_build_and_load_both_libraries_at_once(tmp_path):
    env = {**os.environ, "PIO_NATIVE_BUILD_DIR": str(tmp_path / "build")}
    procs = [subprocess.Popen([sys.executable, "-c",
                               _BUILD.format(root=ROOT)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        assert out.strip() == "loaded"
    built = sorted(os.listdir(tmp_path / "build"))
    assert built == [".lock", "_eventlog.so", "_raggedbin.so"]


_BROKEN = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from predictionio_torch.native import NativeBuildError
from predictionio_torch.data.storage import Storage
from predictionio_torch.ops import ragged
raised = []
try:
    Storage.from_env({{"PIO_STORAGE_SOURCES_EL_TYPE": "eventlog",
                      "PIO_STORAGE_SOURCES_EL_PATH": {path!r}}}).events()
except NativeBuildError:
    raised.append("eventlog")
n = ragged._NATIVE_MIN_NNZ
g = np.arange(n) % 7
try:
    ragged.build_segmented_groups(g, g, np.ones(n, np.float32), 7)
except NativeBuildError:
    raised.append("raggedbin")
print(",".join(raised))
"""


def test_a_library_that_fails_to_build_raises(tmp_path):
    env = {**os.environ, "PIO_NATIVE_BUILD_DIR": str(tmp_path / "build"),
           "PIO_CXX": str(tmp_path / "no-such-compiler")}
    out = subprocess.run([sys.executable, "-c", _BROKEN.format(
        root=ROOT, path=str(tmp_path / "store"))], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "eventlog,raggedbin"


@pytest.mark.parametrize("kind", ["memory", "localfs"])
def test_the_other_stores_get_delete_remove_and_ingest_columns_like_jax(
        tmp_path, kind):
    """get, delete, remove and the generic ``insert_columnar`` of the
    memory and localfs stores, against the JAX package's same backend
    and against the event log's columns."""
    from predictionio_tpu.data.storage import Storage as JaxStorage

    def env(root):
        return ({"PIO_STORAGE_SOURCES_S_TYPE": "memory"} if kind == "memory"
                else {"PIO_STORAGE_SOURCES_S_TYPE": "localfs",
                      "PIO_STORAGE_SOURCES_S_PATH": str(root)})

    port = S.Storage.from_env(env(tmp_path / "port")).events()
    ref = JaxStorage.from_env(env(tmp_path / "jax")).events()
    dicts = _event_dicts(30)
    for store, cls in ((port, Event), (ref, JaxEvent)):
        store.init(1)
        store.insert_batch([cls(**d) for d in dicts], 1)
        assert store.delete(dicts[4]["event_id"], 1)
        assert not store.delete(dicts[4]["event_id"], 1)
        store.init(2)
        assert store.insert_columnar(_columns(
            S.EventColumns if store is port else JaxColumns, n=200), 2,
            entity_type="user", target_entity_type="item",
            value_property="rating") == 200
    assert port.get(dicts[4]["event_id"], 1) is None
    assert _canon([port.get(dicts[5]["event_id"], 1)]) == _canon(
        [ref.get(dicts[5]["event_id"], 1)])
    assert _canon(port.find(1)) == _canon(ref.find(1))
    if kind == "localfs":   # the tombstone line survives a reopen
        again = S.Storage.from_env(env(tmp_path / "port")).events()
        assert ([e.event_id for e in again.find(1)]
                == [e.event_id for e in port.find(1)])
    log = EventLogEventStore(str(tmp_path / "log"))
    log.init(2)
    try:
        log.insert_columnar(_columns(S.EventColumns, n=200), 2,
                            entity_type="user", target_entity_type="item",
                            value_property="rating")
        for time_ordered in (True, False):
            want = log.find_columnar(2, value_property="rating",
                                     time_ordered=time_ordered)
            got = port.find_columnar(2, value_property="rating")
            # the generic read orders by time; compare as row sets
            key = (lambda c: sorted(zip(
                [c.entity_vocab[k] for k in c.entity_codes],
                [c.target_vocab[k] if k >= 0 else None
                 for k in c.target_codes],
                [c.names[k] for k in c.name_codes],
                np.nan_to_num(c.values, nan=-1.0).tolist(),
                c.times_us.tolist()), key=repr))
            assert key(got) == key(want)
    finally:
        log.close()
    assert port.compact(1) is None
    port.remove(1)
    ref.remove(1)
    with pytest.raises(S.StorageError):
        port.find(1)
