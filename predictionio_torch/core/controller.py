"""DASE component base classes.

Counterpart of ``predictionio_tpu/core/controller.py``: every signature
that took a ``MeshContext`` takes a ``DeviceContext``. Behavior
contracts from the reference controller layer:

  - DataSource  (ref: controller/PDataSource.scala:34, LDataSource.scala:35)
  - Preparator  (ref: controller/PPreparator.scala:30, IdentityPreparator.scala:31)
  - Algorithm   (ref: controller/PAlgorithm.scala:45, P2LAlgorithm.scala:42,
                 LAlgorithm.scala:41 — collapsed into one class)
  - Serving     (ref: controller/LServing.scala:26 + LFirstServing/LAverageServing)
  - SanityCheck (ref: controller/SanityCheck.scala:24)
"""

from __future__ import annotations

import abc
import inspect
from typing import Any, List, Optional, Sequence, Tuple

from predictionio_torch.core.params import EmptyParams, Params
from predictionio_torch.parallel.context import DeviceContext


class Doer:
    """Base for components instantiated with their Params
    (ref: core/AbstractDoer.scala:24)."""

    params: Params

    def __init__(self, params: Optional[Params] = None):
        self.params = params if params is not None else EmptyParams()

    @classmethod
    def create(cls, params: Optional[Params] = None) -> "Doer":
        """Instantiate with params if the ctor accepts them, else bare
        (Doer.apply's two-ctor protocol)."""
        sig = inspect.signature(cls.__init__)
        if len(sig.parameters) > 1:  # beyond self
            return cls(params)
        inst = cls()
        if params is not None and not isinstance(params, EmptyParams):
            inst.params = params
        return inst


class SanityCheck(abc.ABC):
    """Opt-in hook: training data, prepared data and models implementing
    this are checked after each pipeline stage (ref: SanityCheck.scala:24,
    called from Engine.scala:610-666)."""

    @abc.abstractmethod
    def sanity_check(self) -> None:
        """Raise on inconsistent data."""


class DataSource(Doer):
    """Reads training and evaluation data from the event store."""

    @abc.abstractmethod
    def read_training(self, ctx: DeviceContext) -> Any:
        """ref: PDataSource.readTraining"""

    def read_eval(self, ctx: DeviceContext
                  ) -> List[Tuple[Any, Any, List[Tuple[Any, Any]]]]:
        """k folds of (training data, eval info, (query, actual) pairs).

        ref: PDataSource.readEval — default: no eval data."""
        return []


class Preparator(Doer):
    @abc.abstractmethod
    def prepare(self, ctx: DeviceContext, training_data: Any) -> Any:
        """ref: PPreparator.prepare"""


class IdentityPreparator(Preparator):
    """Pass-through (ref: IdentityPreparator.scala:31)."""

    def prepare(self, ctx: DeviceContext, training_data):
        return training_data


class Algorithm(Doer):
    """One trainable + servable algorithm: ``predict`` answers one query
    at serve time, ``batch_predict`` scores many at once."""

    @abc.abstractmethod
    def train(self, ctx: DeviceContext, prepared_data: Any) -> Any:
        ...

    @abc.abstractmethod
    def predict(self, model: Any, query: Any) -> Any:
        ...

    def batch_predict(self, model: Any, queries: Sequence[Tuple[int, Any]],
                      ) -> List[Tuple[int, Any]]:
        """ref: P2LAlgorithm.batchPredict default — mapValues(predict)."""
        return [(i, self.predict(model, q)) for i, q in queries]

    def make_persistent_model(self, model: Any) -> Any:
        """The trained model -> its persisted form (ref:
        PAlgorithm.makePersistentModel:98). Default: the model itself,
        pickled into the Models repo; a ``PersistentModel``
        (``core/persistent_model.py``) saves itself instead and leaves a
        manifest there."""
        return model

    def load_persistent_model(self, persisted: Any, ctx: DeviceContext) -> Any:
        """The persisted model -> the model that serves, at deploy time."""
        return persisted

    def warmup(self, model: Any, ctx: DeviceContext) -> None:
        """Drive the serve path's standard shapes once before the
        deployment goes live, so the first query pays no first-touch
        cost (kernel build and load, allocator growth). Default: no-op."""

    def apply_patch(self, model: Any, patch: dict) -> bool:
        """Apply a streaming model patch to the live model in place;
        False (the default) when this algorithm does not support it."""
        return False


class Serving(Doer):
    """Combines the per-algorithm predictions into one response."""

    @abc.abstractmethod
    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        """ref: LServing.serve"""


class FirstServing(Serving):
    """Head of the predictions (ref: LFirstServing.scala:25)."""

    def serve(self, query, predictions):
        return predictions[0]


class AverageServing(Serving):
    """Arithmetic mean of numeric predictions (ref: LAverageServing.scala:25)."""

    def serve(self, query, predictions):
        return sum(predictions) / len(predictions)
