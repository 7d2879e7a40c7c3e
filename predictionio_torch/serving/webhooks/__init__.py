"""Webhook connector framework.

Copy of ``predictionio_tpu/serving/webhooks/``: the port imports
nothing of the JAX package.

Behavior contract from the reference (data/.../webhooks/JsonConnector.scala:29,
FormConnector.scala:30, api/WebhooksConnectors.scala:24): a connector
translates a third-party payload (JSON body or form fields) into the
event-server Event JSON; the registry maps URL path segments
(``/webhooks/<name>.json`` for JSON, ``/webhooks/<name>`` for form)
to connectors. Built-ins: segmentio (JSON), mailchimp (form).
"""

from __future__ import annotations

import abc
from typing import Dict, Mapping


class ConnectorError(ValueError):
    """Payload cannot be translated (-> HTTP 400)."""


class JsonConnector(abc.ABC):
    """ref: JsonConnector.scala:29."""

    @abc.abstractmethod
    def to_event_json(self, payload: dict) -> dict:
        """3rd-party JSON -> Event JSON dict."""


class FormConnector(abc.ABC):
    """ref: FormConnector.scala:30."""

    @abc.abstractmethod
    def to_event_json(self, fields: Mapping[str, str]) -> dict:
        """3rd-party form fields -> Event JSON dict."""


_JSON_CONNECTORS: Dict[str, JsonConnector] = {}
_FORM_CONNECTORS: Dict[str, FormConnector] = {}


def register_json_connector(name: str, connector: JsonConnector) -> None:
    _JSON_CONNECTORS[name] = connector


def register_form_connector(name: str, connector: FormConnector) -> None:
    _FORM_CONNECTORS[name] = connector


def json_connector(name: str) -> JsonConnector:
    _load_builtins()
    if name not in _JSON_CONNECTORS:
        raise KeyError(name)
    return _JSON_CONNECTORS[name]


def form_connector(name: str) -> FormConnector:
    _load_builtins()
    if name not in _FORM_CONNECTORS:
        raise KeyError(name)
    return _FORM_CONNECTORS[name]


def _load_builtins() -> None:
    # registration side effects (ref: WebhooksConnectors.scala:24)
    from predictionio_torch.serving.webhooks import mailchimp, segmentio  # noqa: F401
