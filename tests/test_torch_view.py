"""Batch views, ``BiMap``'s batch surface, ``EntityIdIxMap``,
``EntityMap`` and ``extract_entity_map`` of the port against the JAX
package's, on the CPU: the same seeded events and keys through both,
every result equal, exactly (both fold the same Python values in the
same order)."""

import datetime as dt

import numpy as np
import pytest

from tests.torch_storage_tier import JAX, PORT, UTC, memory_storage, pkg

T0 = dt.datetime(2026, 1, 1, tzinfo=UTC)


def _events(P, n=80, seed=4):
    """Seeded ``$set``/``$unset``/``$delete`` and ``rate`` events over
    users and items, shuffled in time."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        kind = ["$set", "$set", "$unset", "$delete", "rate"][
            int(rng.integers(5))]
        etype = "user" if rng.random() < 0.7 else "item"
        props = ({"plan": ["free", "pro"][int(rng.integers(2))],
                  "n": int(rng.integers(9))} if kind == "$set"
                 else {"plan": None} if kind == "$unset"
                 else {"rating": float(rng.integers(1, 6))}
                 if kind == "rate" else {})
        out.append(P.Event(event=kind, entity_type=etype,
                           entity_id=f"{etype[0]}{int(rng.integers(6))}",
                           properties=props,
                           event_time=T0 + dt.timedelta(
                               minutes=int(rng.integers(600)))))
    return out


def _folds(name):
    P = pkg(name)
    V = P.view
    seq = V.EventSeq(_events(P))
    win = seq.filter(start_time=T0 + dt.timedelta(minutes=100),
                     until_time=T0 + dt.timedelta(minutes=400))
    order = seq.aggregate_by_entity_ordered(
        (), lambda acc, e: acc + ((e.event, e.event_time.isoformat()),))
    op = V.datamap_aggregator()
    st = memory_storage(P)
    app = st.apps().insert("viewapp")
    st.events().init(app.id)
    st.events().insert_batch(_events(P), app.id)
    view = V.BatchView("viewapp", storage=st,
                       start_time=T0 + dt.timedelta(minutes=50))
    emap = P.store.extract_entity_map(
        "viewapp", "user", lambda pm: sorted(pm.to_dict().items()),
        storage=st)
    return {
        "filters": [len(seq), len(seq.filter(event="rate")),
                    len(seq.filter(event="$set", entity_type="item")),
                    [e.entity_id for e in win],
                    len(seq.filter(predicate=lambda e: e.entity_id == "u1"))],
        "ordered": sorted(order.items()),
        "props": sorted(seq.aggregate_properties().items()),
        "aggregator": [op(None, e) for e in _events(P)[:20]],
        "view": [sorted(view.aggregate_properties().items()),
                 sorted(view.aggregate_properties("item").items()),
                 len(view.filter(event="rate"))],
        "entity map": [list(emap.to_dict().items()),
                       [emap.data(k) for k in emap.to_dict()],
                       [emap.data(i) for i in range(len(emap))],
                       emap.take(2).to_dict(), emap.get_data("zz", -1),
                       emap.get_data(99, -1)],
    }


def test_event_seq_folds_batch_view_and_entity_map_match_jax():
    assert _folds(PORT) == _folds(JAX)


def _bimaps(name):
    B = pkg(name).bimap
    rng = np.random.default_rng(1)
    keys = [f"k{int(v)}" for v in rng.integers(0, 40, 60)]
    m = B.BiMap.string_long(keys)
    ix = B.EntityIdIxMap.from_keys(keys)
    probe = [k for k in keys[:10]]
    out = {
        "map": list(m.items()), "to_dict": m.to_dict(),
        "contains_value": [m.contains_value(v) for v in (0, 5, 99)],
        "take": list(m.take(probe + ["missing"]).items()),
        "take_n": list(m.take_n(7).items()),
        "map_values": m.map_values(probe),
        "index_array": m.to_index_array(probe).tolist(),
        "index dtype": str(m.to_index_array(probe).dtype),
        "ix": [ix(k) for k in probe] + [ix(i) for i in range(5)],
        "contains": ["k3" in ix, 2 in ix, "zz" in ix, 999 in ix,
                     2.5 in ix],
        "get": [ix.get("zz"), ix.get(999), ix.get(None), ix.get(1)],
        "ix take": ix.take(3).to_dict(), "len": len(ix),
    }
    with pytest.raises(TypeError):
        ix(1.0)
    with pytest.raises(ValueError):
        B.BiMap({"a": 1, "b": 1})
    return out


def test_bimap_entity_id_ix_map_match_jax():
    assert _bimaps(PORT) == _bimaps(JAX)
