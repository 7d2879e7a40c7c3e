"""Vanilla engine template — the minimal skeleton users start from.

Counterpart of ``predictionio_tpu/templates/vanilla.py`` (ref: the
template gallery's "vanilla" starting point, the `pio template get`
scaffold; tools/.../console/Template.scala + the SimpleEngine sugar,
controller/EngineParams.scala:98): a trivial DataSource, identity
Preparator, an Algorithm that multiplies the query's ``q``,
FirstServing. Users replace each piece. Nothing here touches a device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

from predictionio_torch.core import (Algorithm, DataSource, Engine,
                                     FirstServing, IdentityPreparator)
from predictionio_torch.core.params import EngineParams, Params
from predictionio_torch.parallel.context import DeviceContext


@dataclass
class VanillaDSParams(Params):
    app_name: str = ""


class VanillaDataSource(DataSource):
    def __init__(self, params: VanillaDSParams):
        super().__init__(params)

    def read_training(self, ctx: DeviceContext) -> Dict[str, Any]:
        return {"app_name": self.params.app_name}


@dataclass
class VanillaAlgoParams(Params):
    mult: int = 1


class VanillaAlgorithm(Algorithm):
    """Multiplies the query attribute ``q`` — the scaffold's toy logic."""

    def __init__(self, params: VanillaAlgoParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: Dict[str, Any]) -> Dict[str, Any]:
        return {"mult": self.params.mult}

    def predict(self, model: Dict[str, Any],
                query: Dict[str, Any]) -> Dict[str, Any]:
        return {"p": float(query.get("q", 0)) * model["mult"]}


def vanilla_engine() -> Engine:
    return Engine(data_source_classes=VanillaDataSource,
                  preparator_classes=IdentityPreparator,
                  algorithm_classes={"algo": VanillaAlgorithm},
                  serving_classes=FirstServing)


def default_engine_params(app_name: str = "", mult: int = 1) -> EngineParams:
    return EngineParams(
        data_source_params=("", VanillaDSParams(app_name=app_name)),
        algorithm_params_list=[("algo", VanillaAlgoParams(mult=mult))])
