"""Redis-backed authn provider + authz source — the
``emqx_authn_redis.erl`` / ``emqx_authz_redis.erl`` analogues, over the
in-repo RESP client (emqx_tpu_torch/connector/redis.py).

Authn: a command template (reference default
``HGETALL mqtt_user:${username}``) yields fields
``password_hash`` / ``salt`` / ``is_superuser``; the password check uses
the same HashSpec machinery as the built-in DB.

Authz: ``HGETALL mqtt_acl:${username}`` yields {topic-filter: action}
rows, folded as allow-on-match / ignore otherwise (redis ACL sources in
the reference can only *allow*; deny comes from the chain's no_match).
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.access.authn import Credential, Provider
from emqx_tpu_torch.access.authz import ClientInfo, Source, _topic_match
from emqx_tpu_torch.access.hashing import HashSpec, check_password
from emqx_tpu_torch.connector.redis import RedisClient, RedisError


def render_cmd(template: list[str], cred: dict) -> list[str]:
    """``${username}``/``${clientid}``/... placeholder substitution."""
    binds = {}
    for key in ("username", "clientid", "password"):
        v = cred.get(key)
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        binds[key] = v or ""
    # peerhost derives from the credential's peername "ip:port"
    peer = cred.get("peerhost") or str(cred.get("peername") or "")
    binds["peerhost"] = peer.rsplit(":", 1)[0]   # IPv6-safe
    out = []
    for part in template:
        for key, val in binds.items():
            part = part.replace("${" + key + "}", val)
        out.append(part)
    return out


def _pairs_to_dict(flat: Optional[list]) -> dict[str, str]:
    d: dict[str, str] = {}
    if flat:
        for i in range(0, len(flat) - 1, 2):
            k = flat[i].decode() if isinstance(flat[i], bytes) else flat[i]
            v = (flat[i + 1].decode()
                 if isinstance(flat[i + 1], bytes) else flat[i + 1])
            d[k] = v
    return d


class RedisAuthnProvider(Provider):
    id = "password_based:redis"

    def __init__(self, client: RedisClient,
                 cmd: Optional[list[str]] = None,
                 hash_spec: Optional[HashSpec] = None) -> None:
        self.client = client
        self.cmd = cmd or ["HGETALL", "mqtt_user:${username}"]
        self.hash_spec = hash_spec or HashSpec(name="plain")

    def authenticate(self, cred: Credential):
        try:
            flat = self.client.command(render_cmd(self.cmd, cred))
        except (OSError, ConnectionError, RedisError):
            return "ignore"       # backend down → next provider in chain
        row = _pairs_to_dict(flat)
        if not row or "password_hash" not in row:
            return "ignore"
        password = cred.get("password") or b""
        if isinstance(password, str):
            password = password.encode()
        salt = row.get("salt", "").encode()
        if check_password(self.hash_spec, salt,
                          row["password_hash"].encode(), password):
            return ("ok", {
                "is_superuser": row.get("is_superuser") in
                ("true", "1", "True")})
        return ("error", "bad_username_or_password")


class RedisAclSource(Source):
    type = "redis"

    def __init__(self, client: RedisClient,
                 cmd: Optional[list[str]] = None) -> None:
        self.client = client
        self.cmd = cmd or ["HGETALL", "mqtt_acl:${username}"]

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        try:
            flat = self.client.command(render_cmd(self.cmd, ci))
        except (OSError, ConnectionError, RedisError):
            return "ignore"
        rules = _pairs_to_dict(flat)
        for filt, allowed in rules.items():
            # placeholder-expanding match (devices/${clientid}/# rows),
            # same _feed substitution as the built-in ACL source
            if allowed in (action, "all") and _topic_match(filt, topic, ci):
                return "allow"
        return "ignore"
