"""Experimental admin REST API.

Counterpart of ``predictionio_tpu/tools/admin.py`` (ref:
tools/.../admin/AdminAPI.scala:64-101 + CommandClient.scala):

  GET    /                      -> {"status": "alive"}
  GET    /cmd/app               -> list apps with access keys
  POST   /cmd/app {name, description?} -> create app (+ key)
  DELETE /cmd/app/<name>        -> delete app
  DELETE /cmd/app/<name>/data   -> wipe the app's event data

and ``GET /healthz`` from serving/http.py. The JAX server's shared
diagnostics surface (``/readyz``, ``/metrics``, ``/admin/*``) is not
ported yet.
"""

from __future__ import annotations

import json
import logging
from typing import Optional
from urllib.parse import urlparse

from predictionio_torch.data.storage import Storage, get_storage
from predictionio_torch.serving.http import HTTPServerBase, JSONRequestHandler
from predictionio_torch.tools import commands
from predictionio_torch.tools.commands import CommandError

log = logging.getLogger(__name__)

DEFAULT_PORT = 7071


def _app_json(info: commands.AppInfo) -> dict:
    return {
        "name": info.app.name,
        "id": info.app.id,
        "description": info.app.description or "",
        "accessKeys": [
            {"key": k.key, "events": list(k.events)} for k in info.access_keys
        ],
        "channels": [{"name": c.name, "id": c.id} for c in info.channels],
    }


class _AdminRequestHandler(JSONRequestHandler):
    server_version = "PIOAdminServer/0.1"

    @property
    def storage(self) -> Storage:
        return self.server_ref.storage

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/":
            self._send(200, {"status": "alive"})
        elif path == "/cmd/app":
            self._send(200, {
                "status": 1,
                "apps": [_app_json(i) for i in commands.app_list(self.storage)],
            })
        else:
            self._send(404, {"message": "Not Found"})

    def do_POST(self):
        path = urlparse(self.path).path
        if path != "/cmd/app":
            self._send(404, {"message": "Not Found"})
            return
        try:
            payload = self._read_json()
        except json.JSONDecodeError as e:
            self._send(400, {"message": f"invalid JSON: {e}"})
            return
        if not isinstance(payload, dict) or not payload.get("name"):
            self._send(400, {"message": "app name is required"})
            return
        try:
            info = commands.app_new(
                payload["name"], payload.get("description"), self.storage
            )
        except CommandError as e:
            self._send(409, {"message": str(e)})
            return
        self._send(200, {"status": 1, **_app_json(info)})

    def do_DELETE(self):
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        try:
            if len(parts) == 3 and parts[:2] == ["cmd", "app"]:
                commands.app_delete(parts[2], self.storage)
                self._send(200, {"status": 1, "message": f"App deleted: {parts[2]}"})
            elif len(parts) == 4 and parts[:2] == ["cmd", "app"] and parts[3] == "data":
                commands.app_data_delete(parts[2], storage=self.storage)
                self._send(200, {"status": 1, "message": f"App data deleted: {parts[2]}"})
            else:
                self._send(404, {"message": "Not Found"})
        except CommandError as e:
            self._send(404, {"message": str(e)})


class AdminServer(HTTPServerBase):
    """ref: AdminServer.createAdminServer (AdminAPI.scala:113)."""

    def __init__(
        self,
        storage: Optional[Storage] = None,
        host: str = "0.0.0.0",
        port: int = DEFAULT_PORT,
    ):
        self.storage = storage or get_storage()
        super().__init__(host, port, _AdminRequestHandler)


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="PredictionIO admin API server")
    parser.add_argument("--ip", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = AdminServer(host=args.ip, port=args.port)
    log.info("admin server running on %s:%s", args.ip, server.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
