"""Metadata records: engine instances and model blobs.

Copy of ``predictionio_tpu/data/metadata.py`` trimmed to the two
records ``pio deploy`` reads (ref: EngineInstances.scala:34,
Models.scala:30). The field names and the JSON form
(``record_to_dict`` / ``dict_to_record``) are the storage format both
packages share, so the port reads what ``pio train`` wrote.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import asdict, dataclass, field
from typing import Any, Dict

UTC = _dt.timezone.utc


@dataclass
class EngineInstance:
    """One training run + full params snapshot (ref: EngineInstances.scala:34)."""
    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    runtime_conf: Dict[str, str] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclass
class Model:
    """Serialized model blob for one engine instance (ref: Models.scala:30)."""
    id: str
    models: bytes


def record_to_dict(obj: Any) -> dict:
    d = asdict(obj)
    for k, v in d.items():
        if isinstance(v, _dt.datetime):
            d[k] = v.astimezone(UTC).isoformat()
    return d


def dict_to_record(cls, d: Dict[str, Any]):
    kwargs = dict(d)
    for k, v in kwargs.items():
        if k in ("start_time", "end_time") and isinstance(v, str):
            kwargs[k] = _dt.datetime.fromisoformat(v)
    return cls(**kwargs)
