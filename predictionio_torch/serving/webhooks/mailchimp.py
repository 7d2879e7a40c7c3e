"""MailChimp form webhook connector.

Behavior contract from the reference
(data/.../webhooks/mailchimp/MailChimpConnector.scala:29): handles the
``subscribe`` form payload, mapping it to a ``subscribe`` event from
user ``data[id]`` to list ``data[list_id]`` with email/merge fields as
properties; ``fired_at`` ("yyyy-MM-dd HH:mm:ss", UTC) becomes the event
time. Missing ``type`` or an unknown type is a connector error.
"""

from __future__ import annotations

import datetime as _dt
from typing import Mapping

from predictionio_torch.serving.webhooks import (ConnectorError,
                                                 FormConnector,
                                                 register_form_connector)

UTC = _dt.timezone.utc


def _parse_mailchimp_time(s: str) -> str:
    try:
        t = _dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=UTC)
    except ValueError as e:
        raise ConnectorError(f"Cannot parse fired_at {s!r}: {e}")
    return t.isoformat()


class MailChimpConnector(FormConnector):
    def to_event_json(self, fields: Mapping[str, str]) -> dict:
        kind = fields.get("type")
        if kind is None:
            raise ConnectorError("The field 'type' is required for MailChimp data.")
        if kind != "subscribe":
            raise ConnectorError(
                f"Cannot convert unknown MailChimp data type {kind} to event JSON"
            )
        try:
            properties = {
                "email": fields["data[email]"],
                "email_type": fields["data[email_type]"],
                "merges": {
                    "EMAIL": fields["data[merges][EMAIL]"],
                    "FNAME": fields["data[merges][FNAME]"],
                    "LNAME": fields["data[merges][LNAME]"],
                },
                "ip_opt": fields["data[ip_opt]"],
                "ip_signup": fields["data[ip_signup]"],
            }
            interests = fields.get("data[merges][INTERESTS]")
            if interests is not None:
                properties["merges"]["INTERESTS"] = interests
            return {
                "event": "subscribe",
                "entityType": "user",
                "entityId": fields["data[id]"],
                "targetEntityType": "list",
                "targetEntityId": fields["data[list_id]"],
                "eventTime": _parse_mailchimp_time(fields["fired_at"]),
                "properties": properties,
            }
        except KeyError as e:
            raise ConnectorError(f"MailChimp subscribe payload missing field {e.args[0]}")


register_form_connector("mailchimp", MailChimpConnector())
