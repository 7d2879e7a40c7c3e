"""Segment.io JSON webhook connector.

Behavior contract from the reference
(data/.../webhooks/segmentio/SegmentIOConnector.scala:25): requires the
common fields ``type`` + ``timestamp``; supports the ``identify`` call,
mapping it to an event named after the type on a ``user`` entity with
context/traits folded into properties. Unknown types are a connector
error (HTTP 400), matching the reference's ConnectorException.
"""

from __future__ import annotations

from predictionio_torch.serving.webhooks import (ConnectorError,
                                                 JsonConnector,
                                                 register_json_connector)


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, payload: dict) -> dict:
        for field in ("type", "timestamp"):
            if field not in payload:
                raise ConnectorError(
                    f"Cannot extract common field {field!r} from segmentio payload."
                )
        kind = payload["type"]
        if kind != "identify":
            raise ConnectorError(f"Cannot convert unknown type {kind} to event JSON.")
        if "userId" not in payload:
            raise ConnectorError("identify requires userId.")
        properties = {}
        if payload.get("context") is not None:
            properties["context"] = payload["context"]
        if payload.get("traits") is not None:
            properties["traits"] = payload["traits"]
        return {
            "event": kind,
            "entityType": "user",
            "entityId": payload["userId"],
            "eventTime": payload["timestamp"],
            "properties": properties,
        }


register_json_connector("segmentio", SegmentIOConnector())
