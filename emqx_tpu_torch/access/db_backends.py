"""SQL (MySQL/PostgreSQL) and MongoDB authn providers + authz sources —
the ``emqx_authn_mysql/pgsql/mongodb.erl`` and
``emqx_authz_mysql/pgsql/mongodb.erl`` analogues over the in-repo wire
clients (connector/mysql.py, connector/pgsql.py, connector/mongodb.py).

Authn (SQL): the reference's default query shape
``SELECT password_hash, salt, is_superuser FROM mqtt_user WHERE
username = ${username} LIMIT 1`` — columns are positional by NAME from
the resultset; the password check shares the built-in DB's HashSpec.

Authz (SQL): ``SELECT permission, action, topic FROM mqtt_acl WHERE
username = ${username}`` rows fold allow/deny per action with
placeholder-expanding topic match, exactly the source semantics of
emqx_authz.erl:106-115.

Mongo: same data model over collections (``mqtt_user`` docs with
password_hash/salt/is_superuser; ``mqtt_acl`` docs with
permission/action/topics[]).

Backend-down behaviour is uniformly "ignore" — the chain moves on, the
fold's no_match applies (reference: resource unavailable ⇒ ignore).
"""

from __future__ import annotations

from typing import Any, Optional

from emqx_tpu_torch.access.authn import Credential, Provider
from emqx_tpu_torch.access.authz import ClientInfo, Source, _topic_match
from emqx_tpu_torch.access.hashing import HashSpec, check_password

_TRUE = (True, "true", "1", "True", 1)


def _binds(cred: dict) -> dict:
    out = {}
    for key in ("username", "clientid"):
        v = cred.get(key)
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        out[key] = v or ""
    peer = cred.get("peerhost") or str(cred.get("peername") or "")
    out["peerhost"] = peer.rsplit(":", 1)[0]
    return out


class SqlAuthnProvider(Provider):
    """One provider for both SQL backends — they differ only in client.
    ``client`` needs ``query(sql) -> (cols, rows)``."""

    def __init__(self, client, query: Optional[str] = None,
                 hash_spec: Optional[HashSpec] = None,
                 backend: str = "mysql") -> None:
        self.id = f"password_based:{backend}"
        self.client = client
        self.query = query or (
            "SELECT password_hash, salt, is_superuser FROM mqtt_user "
            "WHERE username = ${username} LIMIT 1")
        self.hash_spec = hash_spec or HashSpec(name="plain")

    def authenticate(self, cred: Credential):
        from emqx_tpu_torch.connector.pgsql import render_sql

        try:
            cols, rows = self.client.query(
                render_sql(self.query, _binds(cred)))
        except Exception:     # noqa: BLE001 — backend down ⇒ ignore
            return "ignore"
        if not rows:
            return "ignore"
        row = dict(zip(cols, rows[0]))
        if "password_hash" not in row or row["password_hash"] is None:
            return "ignore"
        password = cred.get("password") or b""
        if isinstance(password, str):
            password = password.encode()
        salt = (row.get("salt") or "").encode()
        if check_password(self.hash_spec, salt,
                          str(row["password_hash"]).encode(), password):
            return ("ok", {
                "is_superuser": row.get("is_superuser") in _TRUE})
        return ("error", "bad_username_or_password")


class SqlAclSource(Source):
    def __init__(self, client, query: Optional[str] = None,
                 backend: str = "mysql") -> None:
        self.type = backend
        self.client = client
        self.query = query or (
            "SELECT permission, action, topic FROM mqtt_acl "
            "WHERE username = ${username}")

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        from emqx_tpu_torch.connector.pgsql import render_sql

        try:
            cols, rows = self.client.query(
                render_sql(self.query, _binds(ci)))
        except Exception:     # noqa: BLE001
            return "ignore"
        for r in rows:
            row = dict(zip(cols, r))
            act = str(row.get("action", "all"))
            if act not in (action, "all"):
                continue
            if _topic_match(str(row.get("topic", "")), topic, ci):
                return ("allow"
                        if str(row.get("permission")) == "allow"
                        else "deny")
        return "ignore"


class MongoAuthnProvider(Provider):
    id = "password_based:mongodb"

    def __init__(self, client, collection: str = "mqtt_user",
                 filter_: Optional[dict] = None,
                 hash_spec: Optional[HashSpec] = None) -> None:
        self.client = client
        self.collection = collection
        self.filter = filter_ or {"username": "${username}"}
        self.hash_spec = hash_spec or HashSpec(name="plain")

    def _render_filter(self, cred: dict) -> dict:
        binds = _binds(cred)

        def sub(v: Any) -> Any:
            if isinstance(v, str) and v.startswith("${") and v.endswith("}"):
                return binds.get(v[2:-1], "")
            return v
        return {k: sub(v) for k, v in self.filter.items()}

    def authenticate(self, cred: Credential):
        try:
            docs = self.client.find(self.collection,
                                    self._render_filter(cred))
        except Exception:     # noqa: BLE001
            return "ignore"
        if not docs or "password_hash" not in docs[0]:
            return "ignore"
        doc = docs[0]
        password = cred.get("password") or b""
        if isinstance(password, str):
            password = password.encode()
        salt = str(doc.get("salt") or "").encode()
        if check_password(self.hash_spec, salt,
                          str(doc["password_hash"]).encode(), password):
            return ("ok", {"is_superuser": doc.get("is_superuser") in _TRUE})
        return ("error", "bad_username_or_password")


class MongoAclSource(Source):
    type = "mongodb"

    def __init__(self, client, collection: str = "mqtt_acl",
                 filter_: Optional[dict] = None) -> None:
        self.client = client
        self.collection = collection
        self.filter = filter_ or {"username": "${username}"}

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        try:
            docs = self.client.find(
                self.collection,
                MongoAuthnProvider._render_filter(self, ci))
        except Exception:     # noqa: BLE001
            return "ignore"
        for doc in docs:
            act = str(doc.get("action", "all"))
            if act not in (action, "all"):
                continue
            topics = doc.get("topics") or (
                [doc["topic"]] if doc.get("topic") else [])
            for filt in topics:
                if _topic_match(str(filt), topic, ci):
                    return ("allow"
                            if str(doc.get("permission")) == "allow"
                            else "deny")
        return "ignore"
