"""Deterministic toy DASE components for the port's pipeline-wiring
tests: the twin of ``tests/sample_engine.py`` on ``predictionio_torch``
(it imports nothing of the JAX package).

Equivalent of the reference's keystone test asset SampleEngine.scala
(core/src/test/.../controller/SampleEngine.scala, 463 LoC): every
component tags its output with its id so tests can assert the exact
wiring of train/eval/serve paths. Class names and fields are those of
``tests/sample_engine.py``, so both packages' results print alike.
"""

from __future__ import annotations

from dataclasses import dataclass

from predictionio_torch.core import (
    Algorithm,
    DataSource,
    Preparator,
    SanityCheck,
    Serving,
)
from predictionio_torch.core.params import Params
from predictionio_torch.core.persistent_model import LocalFileSystemPersistentModel


@dataclass
class IdParams(Params):
    id: int = 0
    fail_sanity: bool = False


# -- data types tagged with their producers ---------------------------------

@dataclass
class TD(SanityCheck):
    ds_id: int
    fail_sanity: bool = False

    def sanity_check(self):
        if self.fail_sanity:
            raise ValueError(f"TD sanity failure (ds {self.ds_id})")


@dataclass
class EI:
    ds_id: int
    fold: int


@dataclass
class PD(SanityCheck):
    prep_id: int
    td: TD
    fail_sanity: bool = False

    def sanity_check(self):
        if self.fail_sanity:
            raise ValueError(f"PD sanity failure (prep {self.prep_id})")


@dataclass
class Model:
    algo_id: int
    pd: PD


@dataclass
class Query:
    q: int


@dataclass
class Prediction:
    algo_id: int
    q: int


@dataclass
class Actual:
    q: int


# -- components --------------------------------------------------------------

class DataSource0(DataSource):
    """Returns TD tagged with its id; k-fold eval data (2 folds, 2 queries)."""

    def __init__(self, params: IdParams):
        super().__init__(params)

    def read_training(self, ctx) -> TD:
        return TD(ds_id=self.params.id, fail_sanity=self.params.fail_sanity)

    def read_eval(self, ctx):
        folds = []
        for fold in range(2):
            td = TD(ds_id=self.params.id)
            ei = EI(ds_id=self.params.id, fold=fold)
            qa = [(Query(q=10 * fold + j), Actual(q=10 * fold + j)) for j in range(2)]
            folds.append((td, ei, qa))
        return folds


class Preparator0(Preparator):
    def __init__(self, params: IdParams):
        super().__init__(params)

    def prepare(self, ctx, td: TD) -> PD:
        return PD(prep_id=self.params.id, td=td, fail_sanity=self.params.fail_sanity)


class Algo0(Algorithm):
    def __init__(self, params: IdParams):
        super().__init__(params)

    def train(self, ctx, pd: PD) -> Model:
        return Model(algo_id=self.params.id, pd=pd)

    def predict(self, model: Model, query: Query) -> Prediction:
        return Prediction(algo_id=model.algo_id, q=query.q)


class AlgoNoParams(Algorithm):
    """Zero-arg ctor — exercises Doer.create's two-ctor protocol."""

    def train(self, ctx, pd: PD) -> Model:
        return Model(algo_id=-1, pd=pd)

    def predict(self, model: Model, query: Query) -> Prediction:
        return Prediction(algo_id=-1, q=query.q)


@dataclass
class PersistentModel0(LocalFileSystemPersistentModel):
    algo_id: int = 0


class AlgoPersistent(Algorithm):
    """Model persists itself via the PersistentModel path."""

    def __init__(self, params: IdParams):
        super().__init__(params)

    def train(self, ctx, pd: PD) -> PersistentModel0:
        return PersistentModel0(algo_id=self.params.id)

    def predict(self, model: PersistentModel0, query: Query) -> Prediction:
        return Prediction(algo_id=model.algo_id, q=query.q)


class Serving0(Serving):
    def __init__(self, params: IdParams):
        super().__init__(params)

    def serve(self, query: Query, predictions) -> Prediction:
        # tag-combining: sum of algo ids proves all algorithms were consulted
        return Prediction(
            algo_id=sum(p.algo_id for p in predictions), q=query.q
        )
