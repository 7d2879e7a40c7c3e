"""Component parameters + engine-level parameter bundles.

Copy of ``predictionio_tpu/core/params.py``: an engine instance stores
its params as JSON, written by ``pio train`` and read by deploy, in the
JAX package's form.

Behavior contract from the reference (controller/Params.scala:23,
controller/EngineParams.scala:31): every DASE component takes a typed
`Params` value; an `EngineParams` names which component variant fills
each DASE slot together with its params — the unit of hyperparameter
search. Params are Python dataclasses; JSON params blocks from
engine.json variants are materialized into them by field name
(the analogue of WorkflowUtils.extractParams:129 reflection).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Type


class Params:
    """Marker base for component params (ref: Params.scala:23).

    Subclasses should be @dataclass es. Params must be JSON-round-trippable.
    """


@dataclass(frozen=True)
class EmptyParams(Params):
    """ref: Params.scala:29 EmptyParams."""


def params_to_dict(p: Optional[Params]) -> dict:
    if p is None:
        return {}
    if dataclasses.is_dataclass(p):
        return dataclasses.asdict(p)
    if isinstance(p, dict):
        return dict(p)
    raise TypeError(f"params must be a dataclass or dict, got {type(p)}")


def params_from_dict(cls: Optional[Type[Params]], d: Optional[dict]) -> Params:
    """Materialize a params dataclass from a JSON dict by field name.

    ref: WorkflowUtils.extractParams:129 — unknown keys are rejected so
    typos in engine.json fail fast (the reference fails on extraction
    errors too).
    """
    d = d or {}
    if cls is None or cls is EmptyParams:
        if d:
            raise ValueError(f"component takes no params but got {sorted(d)}")
        return EmptyParams()
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"params class {cls} must be a dataclass")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"unknown params {sorted(unknown)} for {cls.__name__} "
            f"(valid: {sorted(names)})"
        )
    return cls(**d)


@dataclass
class EngineParams:
    """Named component choice + params per DASE slot (ref: EngineParams.scala:31).

    ``algorithm_params_list`` holds (name, params) per algorithm — one
    engine may train several algorithms whose predictions the Serving
    layer combines (the most distinctive DASE behavior, SURVEY.md §7).
    """

    data_source_params: Tuple[str, Params] = ("", EmptyParams())
    preparator_params: Tuple[str, Params] = ("", EmptyParams())
    algorithm_params_list: List[Tuple[str, Params]] = field(default_factory=list)
    serving_params: Tuple[str, Params] = ("", EmptyParams())

    def __post_init__(self):
        self.data_source_params = _normalize(self.data_source_params)
        self.preparator_params = _normalize(self.preparator_params)
        self.serving_params = _normalize(self.serving_params)
        self.algorithm_params_list = [_normalize(x) for x in self.algorithm_params_list]

    def to_json_dict(self) -> dict:
        return {
            "dataSourceParams": _slot_json(self.data_source_params),
            "preparatorParams": _slot_json(self.preparator_params),
            "algorithmParamsList": [
                {"name": n, "params": params_to_dict(p)}
                for n, p in self.algorithm_params_list
            ],
            "servingParams": _slot_json(self.serving_params),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)


def _normalize(slot) -> Tuple[str, Params]:
    """Accept bare Params (name defaults to "") for SimpleEngine-style use."""
    if isinstance(slot, tuple):
        name, p = slot
        return (name, p if p is not None else EmptyParams())
    return ("", slot if slot is not None else EmptyParams())


def _slot_json(slot: Tuple[str, Params]) -> dict:
    name, p = slot
    return {"name": name, "params": params_to_dict(p)}
