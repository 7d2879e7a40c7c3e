"""The port's session recommender (``predictionio_torch/ops/sessionrec.py``,
``models/sessionrec.py``) against the JAX package's, on the CPU.

- ``build_sequences``: bit-equal to the JAX function on seeded events
  with tied times.
- Weights: ``params_from_flax``/``params_to_flax`` round-trip a flax
  tree exactly; the port's own init has the flax tree's structure.
- Encoder: with the port's initial weights carried into the flax tree,
  the port's forward equals ``SessionEncoder.apply`` within atol 1e-5 (dim 16-32,
  2 layers, max_len 8-32, materialized and blockwise attention).
- Scorer: from a JAX-trained state, the port's top-k (through the
  scorer, and through ``topk_dot``'s plain version with
  ``PIO_INDEX_KERNEL=on``) gives the JAX scorer's ids and scores within
  1e-5, with and without ``excludeSeen``, ``num`` over the catalog, the
  pad never returned; sessions of more than 64 distinct seen items
  exclude every one of them.
- Model: a pickled JAX ``SessionRecModel`` loads on the port and its
  ``predict``/``batch_predict`` answer as the JAX algorithm's do.
"""

import contextlib
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models import sessionrec as jax_models
from predictionio_tpu.ops import sessionrec as jax_sr
from predictionio_torch.models import sessionrec as models
from predictionio_torch.ops import sessionrec as sr
from predictionio_torch.ops.topk import NEG_INF
from predictionio_torch.workflow.deploy import load_blob

torch.set_num_threads(2)


def _cyclic_events(n_users=64, n_items=12, hist=24, seed=0):
    """Every user walks the item cycle from a random offset."""
    rng = np.random.default_rng(seed)
    users, items, times = [], [], []
    for u in range(n_users):
        start = rng.integers(0, n_items)
        for t in range(hist):
            users.append(u)
            items.append((start + t) % n_items)
            times.append(t)
    return np.array(users), np.array(items), np.array(times, np.float64)


def _port_cfg(cfg) -> sr.SessionRecConfig:
    return sr.SessionRecConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seqs(B, L, n_items, seed):
    rng = np.random.default_rng(seed)
    seq = np.zeros((B, L), np.int32)
    for b in range(B):
        n = int(rng.integers(1, L + 1))
        seq[b, :n] = rng.integers(1, n_items + 1, n)
    return seq


# -- sequences and weights ------------------------------------------------------

def test_build_sequences_is_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    n = 700
    u = rng.integers(0, 50, n)
    i = rng.integers(0, 30, n)
    t = rng.integers(0, 40, n).astype(np.float64)   # ties in time
    for max_len in (4, 8, 64):
        got = sr.build_sequences(u, i, t, 53, max_len)
        want = jax_sr.build_sequences(u, i, t, 53, max_len)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    empty = np.zeros(0, np.int64)
    assert np.array_equal(
        sr.build_sequences(empty, empty, empty.astype(float), 3, 4),
        jax_sr.build_sequences(empty, empty, empty.astype(float), 3, 4))


_JITTED_INITS = {}


@contextlib.contextmanager
def jitted_flax_init():
    """The JAX trainer's ``SessionEncoder.init`` under ``jax.jit``, one
    compile a parameter shape (eager flax init compiles op by op: seconds
    on the CPU). The parameters it gives are where both packages start,
    not a result the tests hold."""
    init = jax_sr.SessionEncoder.init

    def jitted(self, key, probe, **kwargs):
        c = self.cfg
        shape = (self.n_items, c.dim, c.heads, c.layers, c.ffn_mult,
                 c.max_len)
        if shape not in _JITTED_INITS:
            _JITTED_INITS[shape] = jax.jit(
                lambda k, p: init(self, k, p, **kwargs))
        return _JITTED_INITS[shape](key, probe)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sr.SessionEncoder, "init", jitted)
        yield


def _jax_params(n_items, cfg, seed=3):
    """(encoder, its init params as numpy), the init jitted (eager flax
    init compiles op by op: seconds on the CPU)."""
    enc = jax_sr.SessionEncoder(n_items, cfg)
    probe = jnp.zeros((1, cfg.max_len), jnp.int32)
    init = jax.jit(lambda key: enc.init(key, probe, deterministic=True))
    return enc, _np_tree(init(jax.random.PRNGKey(seed)))


def _jax_apply(enc, params, seq):
    fn = jax.jit(lambda p, s: enc.apply(p, s, deterministic=True))
    return np.asarray(fn(params, jnp.asarray(seq)))


def test_params_round_trip_through_the_flax_layout():
    cfg = jax_sr.SessionRecConfig(dim=24, heads=3, layers=2, max_len=8)
    _, params = _jax_params(20, cfg)
    enc = sr.SessionEncoder(20, _port_cfg(cfg))
    enc.load_state_dict(sr.params_from_flax(params))
    back = sr.params_to_flax(enc)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape and np.array_equal(a, b),
        back, params))
    # and the port's own init lays out the same tree
    own = sr.SessionEncoder(20, _port_cfg(cfg))
    sr.init_encoder(own, torch.Generator().manual_seed(0))
    tree = sr.params_to_flax(own)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: a.shape == b.shape, tree, params))
    p = tree["params"]
    assert np.all(p["block_0"]["LayerNorm_0"]["scale"] == 1.0)
    assert np.all(p["block_1"]["Dense_0"]["bias"] == 0.0)
    assert 0.01 < p["pos_embed"].std() < 0.03


@pytest.mark.parametrize("dim,heads,max_len,block", [
    (16, 2, 8, 0), (32, 4, 32, 0), (32, 2, 32, 8), (16, 2, 16, 16)])
def test_encoder_matches_flax_apply_with_carried_weights(dim, heads, max_len,
                                                         block):
    cfg = jax_sr.SessionRecConfig(dim=dim, heads=heads, layers=2,
                                  max_len=max_len, attn_block=block)
    enc = sr.SessionEncoder(40, _port_cfg(cfg))
    sr.init_encoder(enc, torch.Generator().manual_seed(dim + max_len))
    seq = _seqs(6, max_len, 40, seed=max_len)
    want = _jax_apply(jax_sr.SessionEncoder(40, cfg),
                      sr.params_to_flax(enc), seq)
    with torch.no_grad():
        got = enc(torch.from_numpy(seq)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[seq == 0] == 0.0)


# -- training -------------------------------------------------------------------

#: one shape for every JAX trainer here and in
#: ``test_torch_sessionrec_train.py``, so XLA's compile caches serve them
#: all after the first (batch 20: 48 and 50 rows wrap a tail batch)
JAX_CFG = jax_sr.SessionRecConfig(dim=16, heads=2, layers=2, max_len=8,
                                  dropout=0.0, batch_size=20,
                                  learning_rate=1e-3)


def test_seq_axis_raises_naming_its_roadmap_item():
    users, items, times = _cyclic_events(n_users=4, n_items=5, hist=3)
    cfg = sr.SessionRecConfig(dim=8, heads=2, layers=1, max_len=4,
                              seq_axis="seq")
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        sr.SessionRecTrainer((users, items, times), 4, 5, cfg, device="cpu")
    algo = models.SessionRecAlgorithm(models.SessionRecParams(seq_axis="seq"))
    from predictionio_torch.parallel.context import DeviceContext

    from predictionio_torch.data.bimap import BiMap

    pd = models.PreparedSequences(BiMap.string_int(map(str, range(4))),
                                  BiMap.string_int(map(str, range(5))),
                                  users, items, times)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        algo.train(DeviceContext("cpu"), pd)


# -- serving --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    users, items, times = _cyclic_events(n_users=32, n_items=12, hist=10,
                                         seed=3)
    cfg = dataclasses.replace(JAX_CFG, epochs=3)
    with jitted_flax_init():
        tr = jax_sr.SessionRecTrainer((users, items, times), 32, 12, cfg)
    return tr.state(tr.run())


def _kept_jax(scores, idx):
    return [(int(i), float(s)) for s, i in zip(scores, idx)
            if i >= 0 and np.isfinite(s)]


def _kept_port(scores, idx):
    return [(int(i), float(s)) for s, i in zip(scores, idx)
            if i >= 0 and s > NEG_INF]


def _same(got, want, what):
    assert [i for i, _ in got] == [i for i, _ in want], what
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5, err_msg=what)


@pytest.mark.parametrize("kernel", ["auto", "on"])
def test_scorer_matches_the_jax_scorer(monkeypatch, jax_state, kernel):
    monkeypatch.setenv("PIO_INDEX_KERNEL", kernel)
    jax_scorer = jax_sr.SessionScorer(jax_state)
    scorer = sr.SessionScorer(jax_state, device="cpu")
    assert scorer.index.kernel_plan["engaged"] == (kernel == "on")
    rows = jax_state.sequences[:6]
    for exclude in (False, True):
        for k in (1, 5, 12, 40):
            js, ji = jax_scorer.top_k(rows, k, exclude_seen=exclude)
            ps, pi = scorer.top_k(rows, k, exclude_seen=exclude)
            assert ps.shape == (6, min(k, 12))
            for b in range(6):
                got, want = _kept_port(ps[b], pi[b]), _kept_jax(js[b], ji[b])
                _same(got, want, f"row {b} k={k} exclude={exclude}")
                assert all(0 <= i < 12 for i, _ in got)   # never the pad
                if exclude:
                    seen = set(rows[b][rows[b] > 0] - 1)
                    assert not seen & {i for i, _ in got}


def test_more_seen_items_than_the_kernel_excludes_are_all_excluded(
        monkeypatch):
    monkeypatch.setenv("PIO_INDEX_KERNEL", "on")
    users, items, times = _cyclic_events(n_users=4, n_items=100, hist=90,
                                         seed=4)
    cfg = jax_sr.SessionRecConfig(dim=16, heads=2, layers=1, max_len=80,
                                  dropout=0.0)
    _, params = _jax_params(100, cfg)
    seqs = jax_sr.build_sequences(users, items, times, 4, cfg.max_len)
    state = jax_sr.SessionRecModelState(params=params,
                                        sequences=seqs[:, 1:], n_items=100,
                                        cfg=cfg, losses=[])
    rows = state.sequences
    assert min(len(np.unique(r[r > 0])) for r in rows) > 64
    js, ji = jax_sr.SessionScorer(state).top_k(rows, 30, exclude_seen=True)
    ps, pi = sr.SessionScorer(state, device="cpu").top_k(rows, 30,
                                                         exclude_seen=True)
    for b in range(len(rows)):
        got, want = _kept_port(ps[b], pi[b]), _kept_jax(js[b], ji[b])
        _same(got, want, f"row {b}")
        assert len(got) == 20    # 100 items less 80 seen
        assert not set(rows[b][rows[b] > 0] - 1) & {i for i, _ in got}


def test_the_seq_axis_state_serves_blockwise_like_jax(jax_state):
    state = dataclasses.replace(
        jax_state, cfg=dataclasses.replace(jax_state.cfg, seq_axis="seq"))
    port_state = dataclasses.replace(
        state, cfg=_port_cfg(state.cfg))
    scorer = sr.SessionScorer(port_state, device="cpu")
    assert scorer._cfg.attn_block == 8 and scorer._cfg.seq_axis is None
    js, ji = jax_sr.SessionScorer(state).top_k(state.sequences[:4], 5)
    ps, pi = scorer.top_k(state.sequences[:4], 5)
    assert np.array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, atol=1e-5)


def test_a_pickled_jax_model_answers_like_the_jax_algorithm(monkeypatch,
                                                             jax_state):
    monkeypatch.setenv("PIO_INDEX_KERNEL", "on")
    users = JaxBiMap.string_int(f"u{j}" for j in range(32))
    items = JaxBiMap.string_int(f"i{j}" for j in range(12))
    jax_model = jax_models.SessionRecModel(jax_state, users, items)
    jax_algo = jax_models.SessionRecAlgorithm(jax_models.SessionRecParams())
    model = load_blob(pickle.dumps(jax_model)).to("cpu")
    assert type(model) is models.SessionRecModel
    assert type(model.state) is sr.SessionRecModelState
    algo = models.SessionRecAlgorithm(models.SessionRecParams())
    queries = [{"user": "u0", "num": 4}, {"user": "u1", "num": 30},
               {"user": "u2", "num": 5, "excludeSeen": True},
               {"user": "u3", "num": 30, "excludeSeen": True},
               {"items": ["i1", "i2", "zz"], "num": 3},
               {"items": ["i5"], "num": 4, "excludeSeen": True},
               {"user": "nobody", "num": 3}, {"items": ["zz"], "num": 3}]
    for q in queries:
        got = algo.predict(model, q)["itemScores"]
        want = jax_algo.predict(jax_model, q)["itemScores"]
        assert [e["item"] for e in got] == [e["item"] for e in want], q
        np.testing.assert_allclose([e["score"] for e in got],
                                   [e["score"] for e in want], atol=1e-5)
    indexed = list(enumerate(queries))
    got = dict(algo.batch_predict(model, indexed))
    want = dict(jax_algo.batch_predict(jax_model, indexed))
    assert sorted(got) == sorted(want) == list(range(len(queries)))
    for j in got:
        assert ([e["item"] for e in got[j]["itemScores"]]
                == [e["item"] for e in want[j]["itemScores"]]), queries[j]
    # the port model pickles without its device state and reloads
    again = pickle.loads(pickle.dumps(model))
    assert again.device is None and again._scorer is None
    assert model.retrieval_stats()["kernel"]["engaged"]
