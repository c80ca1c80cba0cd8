"""GCP PubSub connector — the ``emqx_ee_connector_gcp_pubsub`` analogue.

Auth follows the reference exactly: a **self-signed service-account
JWT** used directly as the bearer token (no OAuth token exchange) with
``aud = "https://pubsub.googleapis.com/"``, ``iss = sub =
client_email``, ``kid`` from the service-account JSON, RS256, 1-hour
expiry, refreshed ahead of expiry by the connector (the reference runs
a jwt_worker process per resource —
emqx_ee_connector_gcp_pubsub.erl:255-300,
emqx_connector_jwt_worker.erl).

Publish is ``POST /v1/projects/{project}/topics/{topic}:publish`` with
``{"messages": [{"data": base64, "attributes": ..., "orderingKey":
...}]}`` (publish_path/1, encode_payload/2 — data is base64 of the
rendered payload template).

``MiniPubSub`` is the in-repo miniature endpoint for tests: verifies
the RS256 bearer JWT (signature, aud, iss, exp) against the service
account's public key and records published messages per topic.
"""

from __future__ import annotations

import base64
import http.server
import json
import threading
import time
from typing import Any, Optional

from emqx_tpu_torch.access.authn import _b64url, _unb64url
from emqx_tpu_torch.resource.resource import Resource

PUBSUB_AUD = "https://pubsub.googleapis.com/"
_TOKEN_TTL_S = 3600
_REFRESH_AHEAD_S = 300


class PubSubError(Exception):
    pass


def rs256_sign(claims: dict, private_key_pem: bytes,
               kid: Optional[str] = None) -> str:
    """Mint an RS256 JWT (the service-account self-signed token)."""
    from cryptography.hazmat.primitives.asymmetric import padding
    from cryptography.hazmat.primitives.hashes import SHA256
    from cryptography.hazmat.primitives.serialization import (
        load_pem_private_key)

    header: dict[str, Any] = {"alg": "RS256", "typ": "JWT"}
    if kid:
        header["kid"] = kid
    signing_input = (_b64url(json.dumps(header).encode()) + b"." +
                     _b64url(json.dumps(claims).encode()))
    key = load_pem_private_key(private_key_pem, password=None)
    sig = key.sign(signing_input, padding.PKCS1v15(), SHA256())
    return (signing_input + b"." + _b64url(sig)).decode()


class GcpPubSubConnector(Resource):
    """service_account_json: the GCP key-file dict — needs project_id,
    client_email, private_key (PEM), private_key_id. ``base_url``
    overrides the endpoint (tests point it at MiniPubSub)."""

    def __init__(self, service_account_json: dict, pubsub_topic: str,
                 base_url: str = "https://pubsub.googleapis.com",
                 timeout_s: float = 5.0) -> None:
        for field in ("project_id", "client_email", "private_key"):
            if not service_account_json.get(field):
                raise PubSubError(f"service_account_json missing {field}")
        self.sa = service_account_json
        self.pubsub_topic = pubsub_topic
        self.timeout_s = timeout_s
        from emqx_tpu_torch.connector.http import HttpConnector
        self.http = HttpConnector(base_url, timeout_s=timeout_s)
        self._token: Optional[str] = None
        self._token_exp = 0.0
        self._lock = threading.Lock()

    # -- token lifecycle ---------------------------------------------------

    def _bearer(self) -> str:
        with self._lock:
            now = time.time()
            if self._token is None or now > self._token_exp - _REFRESH_AHEAD_S:
                claims = {
                    "iss": self.sa["client_email"],
                    "sub": self.sa["client_email"],
                    "aud": PUBSUB_AUD,
                    "iat": int(now),
                    "exp": int(now) + _TOKEN_TTL_S,
                }
                self._token = rs256_sign(
                    claims, self.sa["private_key"].encode(),
                    kid=self.sa.get("private_key_id"))
                self._token_exp = now + _TOKEN_TTL_S
            return self._token

    @property
    def publish_path(self) -> str:
        return (f"/v1/projects/{self.sa['project_id']}"
                f"/topics/{self.pubsub_topic}:publish")

    # -- resource callbacks ------------------------------------------------

    def on_start(self, conf: dict) -> None:
        if not self.on_health_check():
            raise ConnectionError(
                f"pubsub endpoint {self.http.host}:{self.http.port} "
                "unreachable")

    def on_stop(self) -> None:
        self._token = None

    def _publish(self, messages: list[dict]) -> list[str]:
        resp = self.http.on_query({
            "method": "post",
            "path": self.publish_path,
            "headers": {"Authorization": f"Bearer {self._bearer()}",
                        "Content-Type": "application/json"},
            "body": json.dumps({"messages": messages}),
        })
        if resp["status"] == 401:
            # expired/revoked token: re-mint once and retry
            with self._lock:
                self._token = None
            resp = self.http.on_query({
                "method": "post",
                "path": self.publish_path,
                "headers": {"Authorization": f"Bearer {self._bearer()}",
                            "Content-Type": "application/json"},
                "body": json.dumps({"messages": messages}),
            })
        if resp["status"] != 200:
            raise PubSubError(
                f"publish failed {resp['status']}: "
                f"{resp['body'][:200]!r}")
        return json.loads(resp["body"]).get("messageIds", [])

    def on_query(self, req: Any) -> Any:
        msgs = req["messages"] if isinstance(req, dict) and "messages" in req \
            else [req]
        return self._publish(msgs)

    def on_batch_query(self, reqs: list) -> list:
        """One :publish call for the whole flushed batch."""
        flat: list[dict] = []
        counts = []
        for r in reqs:
            ms = r["messages"] if isinstance(r, dict) and "messages" in r \
                else [r]
            flat.extend(ms)
            counts.append(len(ms))
        ids = self._publish(flat)
        out, k = [], 0
        for n in counts:
            out.append(ids[k:k + n])
            k += n
        return out

    def on_health_check(self) -> bool:
        return self.http.on_health_check()


# ---------------------------------------------------------------------------
# in-repo miniature endpoint (test backend)


class MiniPubSub:
    """Verifies the self-signed bearer JWT and records messages.

    Construct with the service account's *public* key PEM (tests derive
    it from the private key they generate)."""

    def __init__(self, public_key_pem: bytes, project_id: str = "proj",
                 host: str = "127.0.0.1", port: int = 0) -> None:
        from cryptography.hazmat.primitives.serialization import (
            load_pem_public_key)

        self.public_key = load_pem_public_key(public_key_pem)
        self.project_id = project_id
        self.topics: dict[str, list[dict]] = {}
        self.auth_failures = 0
        mini = self

        class _H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):       # quiet
                pass

            def do_POST(self):
                ln = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(ln)
                status, reply = mini._handle(self.path, self.headers, body)
                data = json.dumps(reply).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        class _S(http.server.ThreadingHTTPServer):
            daemon_threads = True

        self._server = _S((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    # -- request handling --------------------------------------------------

    def _check_jwt(self, headers) -> Optional[str]:
        """-> error string, or None if the bearer token verifies."""
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric import padding
        from cryptography.hazmat.primitives.hashes import SHA256

        auth = headers.get("Authorization") or ""
        if not auth.startswith("Bearer "):
            return "missing bearer"
        token = auth[7:]
        try:
            h, b, s = token.split(".")
            sig = _unb64url(s)
            self.public_key.verify(
                sig, f"{h}.{b}".encode(), padding.PKCS1v15(), SHA256())
            claims = json.loads(_unb64url(b))
        except (ValueError, InvalidSignature):
            return "bad signature"
        if claims.get("aud") != PUBSUB_AUD:
            return "bad aud"
        if claims.get("exp", 0) < time.time():
            return "expired"
        return None

    def _handle(self, path: str, headers, body: bytes):
        err = self._check_jwt(headers)
        if err:
            self.auth_failures += 1
            return 401, {"error": {"code": 401, "message": err}}
        prefix = f"/v1/projects/{self.project_id}/topics/"
        if not (path.startswith(prefix) and path.endswith(":publish")):
            return 404, {"error": {"code": 404, "message": "not found"}}
        topic = path[len(prefix):-len(":publish")]
        try:
            msgs = json.loads(body)["messages"]
            store = self.topics.setdefault(topic, [])
            ids = []
            for m in msgs:
                store.append({
                    "data": base64.b64decode(m.get("data", "")),
                    "attributes": m.get("attributes") or {},
                    "orderingKey": m.get("orderingKey"),
                })
                ids.append(str(len(store)))
            return 200, {"messageIds": ids}
        except (KeyError, ValueError) as e:
            return 400, {"error": {"code": 400, "message": str(e)}}

    def start(self) -> "MiniPubSub":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mini-pubsub")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def make_test_service_account(project_id: str = "proj") -> tuple[dict, bytes]:
    """Generate an RSA service-account JSON + its public key PEM (for
    MiniPubSub) — test/tooling helper."""
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.hazmat.primitives.serialization import (
        Encoding, NoEncryption, PrivateFormat, PublicFormat)

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    priv = key.private_bytes(Encoding.PEM, PrivateFormat.PKCS8,
                             NoEncryption()).decode()
    pub = key.public_key().public_bytes(Encoding.PEM,
                                        PublicFormat.SubjectPublicKeyInfo)
    sa = {"type": "service_account", "project_id": project_id,
          "private_key_id": "kid-1", "private_key": priv,
          "client_email": f"svc@{project_id}.iam.gserviceaccount.com"}
    return sa, pub
