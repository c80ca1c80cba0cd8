"""Access-control front — parity with
``apps/emqx/src/emqx_access_control.erl``.

Binds the security services onto the channel's hookpoints:

- ``client.connect``       → banned check (emqx_channel checks
                             emqx_banned before authn)
- ``client.authenticate``  → authn chain; stashes extras
                             (is_superuser / acl claim) per clientid
- ``client.authorize``     → cache → authz source chain
- ``client.disconnected``  → flapping bookkeeping + state cleanup

The channel's hook folds (emqx_tpu_torch/broker/channel.py) carry plain dicts;
this module owns per-client authn extras so the authorize path sees
``is_superuser``/``acl`` even though the channel rebuilds its clientinfo
dict per call.
"""

from __future__ import annotations

import time
from typing import Optional

from emqx_tpu_torch.access.authn import AuthnChain
from emqx_tpu_torch.access.authz import Authz, AuthzCache, ClientAclSource
from emqx_tpu_torch.access.banned import Banned
from emqx_tpu_torch.access.flapping import Flapping
from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.mqtt import packet as P


class AccessControl:
    def __init__(self, authn: Optional[AuthnChain] = None,
                 authz: Optional[Authz] = None,
                 banned: Optional[Banned] = None,
                 flapping_enable: bool = False,
                 cache_enable: bool = True,
                 cache_max: int = 32, cache_ttl_ms: int = 60_000,
                 **flapping_opts) -> None:
        self.authn = authn or AuthnChain()
        self.authz = authz or Authz()
        # client_info source is always first: JWT-supplied ACLs take
        # precedence (the reference registers it at highest priority)
        if not any(s.type == "client_info" for s in self.authz.sources):
            self.authz.add_source(ClientAclSource(), front=True)
        self.banned = banned or Banned()
        self.flapping = (Flapping(self.banned, **flapping_opts)
                         if flapping_enable else None)
        self.cache_enable = cache_enable
        self.cache_max = cache_max
        self.cache_ttl_ms = cache_ttl_ms
        self._extras: dict[str, dict] = {}       # clientid → authn extras
        self._caches: dict[str, AuthzCache] = {}

    # -- hook wiring --------------------------------------------------------

    def attach(self, hooks: Hooks) -> None:
        hooks.put("client.connect", self._on_connect, priority=1000)
        hooks.put("client.authenticate", self._on_authenticate,
                  priority=1000)
        hooks.put("client.authorize", self._on_authorize, priority=1000)
        hooks.put("client.disconnected", self._on_disconnected,
                  priority=1000)

    # -- hook callbacks -----------------------------------------------------

    def _on_connect(self, conninfo: dict, acc=None):
        if self.banned.check(conninfo):
            return (Hooks.STOP, P.RC_BANNED)
        return None

    def _on_authenticate(self, cred: dict, acc: dict):
        ret = self.authn.authenticate(cred)
        if ret[0] == "ok":
            extras = ret[1]
            cid = cred.get("clientid")
            if cid:
                self._extras[cid] = extras
            return (Hooks.OK, {"result": "ok", **extras})
        reason = ret[1]
        rc = (P.RC_BAD_USER_NAME_OR_PASSWORD
              if reason == "bad_username_or_password"
              else P.RC_NOT_AUTHORIZED)
        return (Hooks.STOP, {"result": "error", "reason": reason, "rc": rc})

    def _on_authorize(self, ci: dict, action: str, topic: str, acc: str):
        cid = ci.get("clientid") or ""
        extras = self._extras.get(cid)
        if extras:
            expire_at = extras.get("expire_at")
            if expire_at is not None and time.time() >= expire_at:
                # JWT expired mid-session → deny until re-auth
                return (Hooks.STOP, "deny")
            ci = {**ci, **extras}
        cache = self._cache_for(cid) if self.cache_enable else None
        if cache is not None:
            hit = cache.get(action, topic)
            if hit is not None:
                return (Hooks.STOP, hit)
        verdict = self.authz.authorize(ci, action, topic)
        if cache is not None:
            cache.put(action, topic, verdict)
        return (Hooks.STOP, verdict)

    def _on_disconnected(self, conninfo, reason: str):
        cid = getattr(conninfo, "clientid", None) or (
            conninfo.get("clientid") if isinstance(conninfo, dict) else None)
        if not cid:
            return
        if self.flapping is not None and reason != "normal":
            self.flapping.on_disconnect(cid)
        self._extras.pop(cid, None)
        self._caches.pop(cid, None)

    # -- helpers ------------------------------------------------------------

    def _cache_for(self, clientid: str) -> AuthzCache:
        cache = self._caches.get(clientid)
        if cache is None:
            cache = self._caches[clientid] = AuthzCache(
                self.cache_max, self.cache_ttl_ms)
        return cache

    def clean_authz_cache(self, clientid: str) -> None:
        self._caches.pop(clientid, None)
