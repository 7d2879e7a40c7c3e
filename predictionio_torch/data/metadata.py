"""Metadata records: apps, channels, engine and evaluation instances
and model blobs.

Copy of ``predictionio_tpu/data/metadata.py`` trimmed to the records
the event server, the app and access-key commands, ``pio build``,
``pio train``, ``pio deploy`` and ``pio eval`` use (ref: Apps.scala:27,
AccessKeys.scala:27, Channels.scala:27, EngineManifests.scala:33,
EngineInstances.scala:34,
EvaluationInstances.scala:38, Models.scala:30). The
field names and the JSON form (``record_to_dict`` / ``dict_to_record``)
are the storage format both packages share, so each reads what the
other wrote.
"""

from __future__ import annotations

import datetime as _dt
import re
import secrets
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

UTC = _dt.timezone.utc

#: ref: Channels.scala nameConstraint
CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")


@dataclass
class App:
    """ref: Apps.scala:27"""
    id: int
    name: str
    description: Optional[str] = None


@dataclass
class AccessKey:
    """ref: AccessKeys.scala:27 — key, owning app, allowed-event
    whitelist (empty: every event is allowed)."""
    key: str
    appid: int
    events: List[str] = field(default_factory=list)

    @staticmethod
    def generate(appid: int,
                 events: Optional[List[str]] = None) -> "AccessKey":
        # ref: AccessKeys.scala generateKey — 64-char url-safe random key
        return AccessKey(key=secrets.token_urlsafe(48)[:64], appid=appid,
                         events=list(events or []))


@dataclass
class Channel:
    """ref: Channels.scala:27"""
    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(CHANNEL_NAME_RE.match(name))


@dataclass
class EngineManifest:
    """ref: EngineManifests.scala:33 — a registered engine build."""
    id: str
    version: str
    name: str
    description: Optional[str] = None
    files: List[str] = field(default_factory=list)
    engine_factory: str = ""


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
class EvaluationInstance:
    """One evaluation run (ref: EvaluationInstances.scala:38)."""
    id: str
    status: str  # INIT | EVALUATING | EVALCOMPLETED | FAILED
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


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
