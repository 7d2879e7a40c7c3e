"""The port's model-quality plane against the JAX package's
(``predictionio_torch/obs/quality.py``).

``compare_answers`` and ``canary_verdict`` must give equal results on
the same seeded answer pairs and latency observations, and
``drift_report`` must be equal between a port ALS model and a JAX ALS
model that carry the same factors (both drifted the same way from the
same shadow snapshot). Each test is named after the JAX test it mirrors
in ``tests/test_quality.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from predictionio_torch.data.bimap import BiMap as PortBiMap
from predictionio_torch.models.als import ALSModel as PortALSModel
from predictionio_torch.obs import metrics as port_metrics
from predictionio_torch.obs import quality as port_quality
from predictionio_tpu.data.bimap import BiMap as JaxBiMap
from predictionio_tpu.models.als import ALSModel as JaxALSModel
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import quality as jax_quality
from predictionio_tpu.ops.als import ALSFactors

from tests.torch_operator_fixtures import port_operator_state  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_jax_quality_state():
    jax_quality.STATE.clear()
    yield
    jax_quality.STATE.clear()


def _ranked(rng, pool, n, jitter=0.0, base=None):
    ids = list(rng.choice(pool, size=n, replace=False))
    if base is not None:
        # keep some of the baseline's ids, in a shuffled order
        keep = [i for i, _ in base if rng.random() < 0.6]
        ids = (keep + [i for i in ids if i not in keep])[:n]
    scores = np.sort(rng.normal(size=n))[::-1]
    if jitter:
        scores = scores + rng.normal(scale=jitter, size=n)
    return [(str(i), float(s)) for i, s in zip(ids, scores)]


def _answer_pairs(seed, n_pairs=30):
    rng = np.random.default_rng(seed)
    pool = [f"i{j}" for j in range(60)]
    pairs = []
    for j in range(n_pairs):
        kind = j % 5
        base = _ranked(rng, pool, 12)
        if kind == 0:
            cand = base
        elif kind == 1:
            cand = [(i, s + float(rng.normal(scale=1e-3))) for i, s in base]
        elif kind == 2:
            cand = _ranked(rng, pool, 12, jitter=0.1, base=base)
        elif kind == 3:
            cand = _ranked(rng, pool, int(rng.integers(0, 6)))
        else:
            b = float(rng.normal())
            pairs.append(({"result": b}, {"result": b if rng.random() < 0.5
                                          else b + 1.0}))
            continue
        pairs.append((
            {"itemScores": [{"item": i, "score": s} for i, s in base]},
            {"itemScores": [{"item": i, "score": s} for i, s in cand]}))
    return pairs


class TestCompareAnswers:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("k", [None, 3, 10])
    def test_ranked_overlap_and_score_delta(self, seed, k):
        for base, cand in _answer_pairs(seed):
            assert (port_quality.compare_answers(base, cand, k=k)
                    == jax_quality.compare_answers(base, cand, k=k))
            assert (port_quality.ranked_items(cand)
                    == jax_quality.ranked_items(cand))

    def test_scalar_answers_compare_by_value(self):
        for base, cand in (({"result": 6.0}, {"result": 6.0}),
                           ({"result": 6.0}, {"result": 8.0}),
                           ({"label": "a"}, {"label": "a"}),
                           ({"itemScores": []},
                            {"itemScores": [{"item": "a", "score": 1.0}]}),
                           (None, {"result": 1})):
            assert (port_quality.compare_answers(base, cand)
                    == jax_quality.compare_answers(base, cand))


def _verdict(mod, metrics_mod, pairs, latencies, lane_of):
    """Feed one package's state: paired diffs from its own differ and
    the per-lane latency observations; return its verdict and report."""
    state = mod.QualityState()
    state.canary_begin("r2", "base-inst", "cand-inst")
    for base, cand in pairs:
        if cand is None:
            state.add_paired(None, error="canary answered 500")
        else:
            state.add_paired(mod.compare_answers(base, cand))
    for j, seconds in enumerate(latencies):
        mod.CANARY_SECONDS.labels(lane_of(j)).observe(seconds)
    report = state.report()
    report["canary"].pop("started_unix")
    state.canary_end("rolled_back" if report["canary"]["verdict"][
        "verdict"] == "rollback" else "promoted")
    ended = state.canary()
    ended.pop("started_unix")
    ended.pop("finished_unix")
    return state.canary_verdict(), report, ended


class TestCanaryVerdict:
    @pytest.mark.parametrize("seed", [0, 5, 9])
    @pytest.mark.parametrize("slow_canary", [False, True])
    def test_latency_burn_rolls_back_via_slo_math(self, seed, slow_canary,
                                                  monkeypatch):
        monkeypatch.setenv("PIO_CANARY_MIN_PAIRS", "8")
        rng = np.random.default_rng(seed)
        pairs = _answer_pairs(seed, n_pairs=24)
        # a few canary-side errors among the pairs
        pairs = [(b, None if rng.random() < 0.05 else c) for b, c in pairs]
        latencies = list(rng.gamma(2.0, 0.02, size=200))
        canary_lane = set(rng.choice(200, size=40, replace=False).tolist())
        if slow_canary:
            latencies = [s + (0.25 if j in canary_lane else 0.0)
                         for j, s in enumerate(latencies)]

        def lane_of(j):
            return "canary" if j in canary_lane else "baseline"

        port = _verdict(port_quality, port_metrics, pairs, latencies,
                        lane_of)
        jax = _verdict(jax_quality, jax_metrics, pairs, latencies, lane_of)
        assert port == jax
        assert port[0]["verdict"] in ("promote", "rollback")
        if slow_canary:
            assert port[0]["verdict"] == "rollback"

    def test_undecided_until_min_pairs(self, monkeypatch):
        monkeypatch.setenv("PIO_CANARY_MIN_PAIRS", "50")
        pairs = _answer_pairs(3, n_pairs=10)
        port = _verdict(port_quality, port_metrics, pairs, [0.01] * 20,
                        lambda j: "canary" if j % 2 else "baseline")
        jax = _verdict(jax_quality, jax_metrics, pairs, [0.01] * 20,
                       lambda j: "canary" if j % 2 else "baseline")
        assert port == jax and port[0]["verdict"] == "undecided"

    def test_paired_errors_roll_back(self, monkeypatch):
        monkeypatch.setenv("PIO_CANARY_MIN_PAIRS", "5")
        pairs = [({"result": 1.0}, None)] * 6
        got = [_verdict(mod, m, pairs, [], lambda j: "canary")
               for mod, m in ((port_quality, port_metrics),
                              (jax_quality, jax_metrics))]
        assert got[0] == got[1] and got[0][0]["verdict"] == "rollback"


def _als_pair(seed, n_users=24, n_items=40, rank=6):
    """A port and a JAX ALS model over the same factors and ids, the
    port's serving on the CPU."""
    rng = np.random.default_rng(seed)
    uf = rng.normal(size=(n_users, rank)).astype(np.float32)
    itf = rng.normal(size=(n_items, rank)).astype(np.float32)
    users = [f"u{i}" for i in range(n_users)]
    items = [f"i{i}" for i in range(n_items)]
    port = PortALSModel(uf, itf, PortBiMap.from_vocab(users),
                        PortBiMap.from_vocab(items)).to("cpu")
    jax = JaxALSModel(ALSFactors(uf.copy(), itf.copy()),
                      JaxBiMap.from_vocab(users), JaxBiMap.from_vocab(items))
    return port, jax


def _drift(model, shadow_mod, drift, seed):
    shadow = shadow_mod.ShadowRef(model, "inst")
    rng = np.random.default_rng(seed)
    if drift == "scaled":
        model.user_factors = model.user_factors * 3.0
    elif drift == "corrupted":
        model.user_factors = model.user_factors * 7.0 + 3.0
        model.item_factors = model.item_factors[:, ::-1].copy()
    elif drift == "folded":
        noise = rng.normal(scale=0.05, size=model.item_factors.shape)
        model.upsert_rows(item_rows=[
            (f"i{j}", model.item_factors[j] + noise[j].astype(np.float32))
            for j in range(0, 40, 3)])
    return shadow_mod.drift_report(model, shadow, sample=16, k=5,
                                   seed=seed)


class TestDriftReport:
    @pytest.mark.parametrize("drift", ["none", "scaled", "corrupted",
                                       "folded"])
    @pytest.mark.parametrize("seed", [0, 4])
    def test_corruption_breaches_every_metric(self, drift, seed):
        port_model, jax_model = _als_pair(seed)
        port = _drift(port_model, port_quality, drift, seed)
        jax = _drift(jax_model, jax_quality, drift, seed)
        assert port == jax
        assert (port_quality.breached_metrics(port)
                == jax_quality.breached_metrics(jax))
        if drift == "none":
            assert port["recall_vs_retrain"] == 1.0
        if drift == "corrupted":
            assert set(port_quality.breached_metrics(port)) == {
                "recall_vs_retrain", "rmse_drift", "factor_drift"}

    @pytest.mark.parametrize("device", ["cpu", "cuda"])
    def test_failing_index_stays_on_its_device(self, device):
        """A model whose index cannot build: on the CPU the probe falls
        back to brute force and reports as the JAX probe does; on a
        card the failure raises instead of moving the top-k to the
        host."""
        import torch

        port_model, jax_model = _als_pair(2)
        shadow = port_quality.ShadowRef(port_model, "inst")

        def no_index():
            raise RuntimeError("CUDA out of memory building the index")

        port_model.retrieval_index = no_index
        port_model.device = torch.device(device)
        if device == "cuda":
            with pytest.raises(RuntimeError, match="out of memory"):
                port_quality.drift_report(port_model, shadow, sample=16,
                                          k=5, seed=2)
            return
        port = port_quality.drift_report(port_model, shadow, sample=16,
                                         k=5, seed=2)
        jax = jax_quality.drift_report(
            jax_model, jax_quality.ShadowRef(jax_model, "inst"), sample=16,
            k=5, seed=2)
        assert port == jax and port["recall_vs_retrain"] == 1.0
