"""LDAP authn provider + authz source over the in-repo LDAPv3 client
(connector/ldap.py).

The reference ships LDAP as a pooled connector
(emqx_connector_ldap.erl:102-118 `{search, Base, Filter, Attributes}`);
the auth data model here follows its classic LDAP auth scheme
(emqx_auth_ldap's mqttUser objectClass): look the user's entry up by
filter, verify the password by **re-binding as the entry's DN** (never
reading the hash), and read ACL rules from `mqttPublishTopic` /
`mqttSubscriptionTopic` / `mqttPubSubTopic` attributes.

Backend-down behaviour is uniformly "ignore", matching the other DB
backends (db_backends.py).
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.access.authn import Credential, Provider
from emqx_tpu_torch.access.authz import ClientInfo, Source, _topic_match

_TRUE = ("true", "1", "TRUE", "True")


def _render(template: str, cred: dict) -> str:
    from emqx_tpu_torch.connector.ldap import ldap_escape

    out = template
    for key in ("username", "clientid"):
        v = cred.get(key) or ""
        if isinstance(v, bytes):
            v = v.decode("utf-8", "replace")
        # RFC 4515-escape: a username like "bo*" must match the literal
        # entry, not act as a wildcard over the directory
        out = out.replace("${" + key + "}", ldap_escape(v))
    return out


class LdapAuthnProvider(Provider):
    id = "password_based:ldap"

    def __init__(self, client, base_dn: str = "dc=emqx,dc=io",
                 filter_: Optional[str] = None) -> None:
        self.client = client
        self.base_dn = base_dn
        self.filter = filter_ or "(&(objectClass=mqttUser)(uid=${username}))"

    def authenticate(self, cred: Credential):
        try:
            entries = self.client.search(
                self.base_dn, _render(self.filter, cred),
                ("isSuperuser",))
        except Exception:     # noqa: BLE001 — backend down ⇒ ignore
            return "ignore"
        if not entries:
            return "ignore"
        dn, attrs = entries[0]
        password = cred.get("password") or b""
        if isinstance(password, bytes):
            password = password.decode("utf-8", "replace")
        # RFC 4513 §5.1.2: simple bind with a name but empty password is
        # an *unauthenticated* bind — many directories accept it, which
        # would turn "no password" into a login as any known user
        if not password:
            return ("error", "bad_username_or_password")
        try:
            ok = self.client.check_bind(dn, password)
        except Exception:     # noqa: BLE001
            return "ignore"
        if ok:
            supers = attrs.get("isSuperuser") or attrs.get("issuperuser") or []
            return ("ok", {"is_superuser": any(s in _TRUE for s in supers)})
        return ("error", "bad_username_or_password")


class LdapAclSource(Source):
    type = "ldap"

    _ATTRS = {"publish": ("mqttPublishTopic", "mqttPubSubTopic"),
              "subscribe": ("mqttSubscriptionTopic", "mqttPubSubTopic")}

    def __init__(self, client, base_dn: str = "dc=emqx,dc=io",
                 filter_: Optional[str] = None) -> None:
        self.client = client
        self.base_dn = base_dn
        self.filter = filter_ or "(&(objectClass=mqttUser)(uid=${username}))"

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        try:
            entries = self.client.search(
                self.base_dn, _render(self.filter, ci),
                ("mqttPublishTopic", "mqttSubscriptionTopic",
                 "mqttPubSubTopic"))
        except Exception:     # noqa: BLE001
            return "ignore"
        for _dn, attrs in entries:
            low = {k.lower(): v for k, v in attrs.items()}
            for name in self._ATTRS.get(action, ()):
                for filt in low.get(name.lower(), []):
                    if _topic_match(filt, topic, ci):
                        return "allow"
        # an entry existed but granted nothing ⇒ this source denies
        return "deny" if entries else "ignore"
