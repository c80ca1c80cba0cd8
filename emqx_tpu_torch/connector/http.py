"""HTTP connector — the ``emqx_connector_http`` (ehttpc) analogue,
on stdlib ``http.client`` with per-query connections (the pooling the
reference gets from ehttpc workers maps onto the buffer worker's
batching here; a keep-alive pool is a later optimization).

Query shape: ``{"method", "path", "headers", "body"}`` — the bridge
layer renders rule-engine templates into these fields.
"""

from __future__ import annotations

import http.client
import socket
from typing import Any
from urllib.parse import urlparse

from emqx_tpu_torch.resource.resource import Resource


class HttpConnector(Resource):
    def __init__(self, base_url: str, *, timeout_s: float = 5.0,
                 headers: dict | None = None) -> None:
        u = urlparse(base_url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme {u.scheme!r}")
        self.scheme = u.scheme
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.base_path = u.path.rstrip("/")
        self.timeout_s = timeout_s
        self.headers = headers or {}

    def _conn(self) -> http.client.HTTPConnection:
        cls = (http.client.HTTPSConnection if self.scheme == "https"
               else http.client.HTTPConnection)
        return cls(self.host, self.port, timeout=self.timeout_s)

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(
                f"http service {self.host}:{self.port} unreachable")

    def on_query(self, req: Any) -> Any:
        method = (req.get("method") or "POST").upper()
        path = self.base_path + (req.get("path") or "/")
        body = req.get("body")
        if isinstance(body, str):
            body = body.encode()
        conn = self._conn()
        try:
            conn.request(method, path, body=body,
                         headers={**self.headers,
                                  **(req.get("headers") or {})})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 500:
                raise ConnectionError(f"http {resp.status}")
            return {"status": resp.status, "body": data}
        finally:
            conn.close()

    def on_health_check(self) -> bool:
        try:
            with socket.create_connection(
                    (self.host, self.port), timeout=self.timeout_s):
                return True
        except OSError:
            return False
