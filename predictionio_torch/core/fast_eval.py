"""FastEval: prefix-memoized evaluation across EngineParams candidates.

Behavior contract from the reference's FastEvalEngine
(controller/FastEvalEngine.scala:38-330): during tuning, consecutive
EngineParams often share a prefix of the DASE pipeline (same DataSource
params, same Preparator params, ...). FastEval caches each pipeline
stage's result keyed by the params prefix so shared work runs once:

  read_eval      keyed by (data_source_params)
  prepare        keyed by (data_source_params, preparator_params)
  trained models keyed by (+ one algorithm's params)          [per algo]
  batch predict  keyed by the same                            [per algo]
  serving        computed per full params (cheap, not cached)

The reference structures this as workflow objects with pluggable
caches; here it is one wrapper with dict caches, keyed by
params-JSON strings. Counterpart of ``predictionio_tpu/core/fast_eval.py``
on a ``DeviceContext``; ``prefetch_grid`` trains a grid of candidates
through ``Algorithm.grid_train`` (ALS: ``ops.als.als_grid_train``, the
candidates folded into the batch dimension on the card).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, List

from predictionio_torch.core.engine import Engine
from predictionio_torch.core.params import EngineParams, params_to_dict
from predictionio_torch.parallel.context import DeviceContext

log = logging.getLogger(__name__)


def _key(*parts) -> str:
    return json.dumps(parts, sort_keys=True, default=str)


def _slot_key(slot) -> Any:
    name, params = slot
    return [name, params_to_dict(params)]


class FastEvalEngineWorkflow:
    """ref: FastEvalEngineWorkflow (FastEvalEngine.scala:38,273)."""

    def __init__(self, engine: Engine, ctx: DeviceContext):
        self.engine = engine
        self.ctx = ctx
        self.eval_data_cache: Dict[str, Any] = {}
        self.prepared_cache: Dict[str, Any] = {}
        self.model_cache: Dict[str, Any] = {}
        self.predict_cache: Dict[str, Any] = {}
        # instrumentation for tests + cache-hit logging
        self.counts = {"read": 0, "prepare": 0, "train": 0, "predict": 0,
                       "grid_dispatches": 0}

    # -- stages -------------------------------------------------------------
    def _eval_data(self, ep: EngineParams):
        key = _key(_slot_key(ep.data_source_params))
        if key not in self.eval_data_cache:
            self.counts["read"] += 1
            ds = self.engine.make_data_source(ep)
            self.eval_data_cache[key] = ds.read_eval(self.ctx)
        return self.eval_data_cache[key]

    def _prepared(self, ep: EngineParams):
        key = _key(_slot_key(ep.data_source_params), _slot_key(ep.preparator_params))
        if key not in self.prepared_cache:
            self.counts["prepare"] += 1
            preparator = self.engine.make_preparator(ep)
            folds = self._eval_data(ep)
            self.prepared_cache[key] = [
                (preparator.prepare(self.ctx, td), ei, qa) for td, ei, qa in folds
            ]
        return self.prepared_cache[key]

    def _models(self, ep: EngineParams, algo_slot) -> List[Any]:
        """One model per fold for one algorithm params slot."""
        key = _key(
            _slot_key(ep.data_source_params),
            _slot_key(ep.preparator_params),
            _slot_key(algo_slot),
        )
        if key not in self.model_cache:
            self.counts["train"] += 1
            name, params = algo_slot
            algo = self.engine.algorithm_classes[name].create(params)
            self.model_cache[key] = [
                algo.train(self.ctx, pd) for pd, _ei, _qa in self._prepared(ep)
            ]
        return self.model_cache[key]

    def _predictions(self, ep: EngineParams, algo_slot) -> List[Dict[int, Any]]:
        """Per fold: {query_idx: prediction} for one algorithm."""
        key = _key(
            _slot_key(ep.data_source_params),
            _slot_key(ep.preparator_params),
            _slot_key(algo_slot),
            "predict",
        )
        if key not in self.predict_cache:
            self.counts["predict"] += 1
            name, params = algo_slot
            algo = self.engine.algorithm_classes[name].create(params)
            models = self._models(ep, algo_slot)
            folds = self._prepared(ep)
            per_fold = []
            for model, (_pd, _ei, qa) in zip(models, folds):
                indexed = [(i, q) for i, (q, _a) in enumerate(qa)]
                per_fold.append(dict(algo.batch_predict(model, indexed)))
            self.predict_cache[key] = per_fold
        return self.predict_cache[key]

    def prefetch_grid(self, engine_params_list) -> int:
        """Grid tuning (ref role: MetricEvaluator over engineParamsList,
        MetricEvaluator.scala:177): when every candidate shares the DASE
        prefix and differs only inside ONE algorithm slot whose class
        offers ``grid_train`` (e.g. ALS reg sweeps), all candidates'
        models are trained in one grid run per fold and seeded into the
        model cache — the per-candidate eval path then scores them
        without ever calling train. Returns the number of candidates
        grid-trained (0 = shape did not apply; the sequential path runs
        as before). Leaderboard, ranking and best.json are unchanged
        either way."""
        eps = list(engine_params_list)
        if len(eps) < 2:
            return 0
        base = eps[0]
        prefix = _key(_slot_key(base.data_source_params),
                      _slot_key(base.preparator_params),
                      _slot_key(base.serving_params))
        for ep in eps:
            if (_key(_slot_key(ep.data_source_params),
                     _slot_key(ep.preparator_params),
                     _slot_key(ep.serving_params)) != prefix
                    or len(ep.algorithm_params_list) != 1
                    or ep.algorithm_params_list[0][0]
                    != base.algorithm_params_list[0][0]):
                return 0
        name = base.algorithm_params_list[0][0]
        hook = getattr(self.engine.algorithm_classes[name], "grid_train", None)
        if hook is None:
            return 0
        params_list = [ep.algorithm_params_list[0][1] for ep in eps]
        folds = self._prepared(base)
        per_fold_models = []
        for pd, _ei, _qa in folds:
            models = hook(self.ctx, pd, params_list)
            if models is None:
                return 0  # shape inapplicable (params differ beyond the
                # grid scalars): sequential path
            self.counts["grid_dispatches"] += 1
            per_fold_models.append(models)
        for ci, ep in enumerate(eps):
            key = _key(
                _slot_key(ep.data_source_params),
                _slot_key(ep.preparator_params),
                _slot_key(ep.algorithm_params_list[0]),
            )
            self.model_cache[key] = [fold[ci] for fold in per_fold_models]
        log.info(
            "grid tuning: %d candidates trained in %d grid run(s) "
            "(instead of %d sequential trains)",
            len(eps), self.counts["grid_dispatches"],
            len(eps) * len(folds))
        return len(eps)

    # -- public -------------------------------------------------------------
    def eval(self, ep: EngineParams):
        """Same result shape as Engine.eval, with memoized prefixes."""
        serving = self.engine.make_serving(ep)
        folds = self._prepared(ep)
        per_algo = [self._predictions(ep, slot) for slot in ep.algorithm_params_list]
        results = []
        for fold_idx, (_pd, ei, qa) in enumerate(folds):
            qpa = []
            for i, (q, a) in enumerate(qa):
                preds = [algo_preds[fold_idx][i] for algo_preds in per_algo]
                qpa.append((q, serving.serve(q, preds), a))
            results.append((ei, qpa))
        return results


class FastEvalEngine(Engine):
    """Engine whose eval path memoizes across candidates
    (ref: FastEvalEngine.scala:297). Create once, call ``eval`` with
    each candidate EngineParams."""

    def __init__(self, data_source_classes, preparator_classes, algorithm_classes,
                 serving_classes):
        super().__init__(
            data_source_classes, preparator_classes, algorithm_classes, serving_classes
        )
        self._workflow: FastEvalEngineWorkflow = None

    def eval(self, ctx: DeviceContext, engine_params: EngineParams, workflow_params=None):
        if self._workflow is None or self._workflow.ctx is not ctx:
            self._workflow = FastEvalEngineWorkflow(self, ctx)
        return self._workflow.eval(engine_params)
