"""Authorization — parity with ``apps/emqx_authz``.

A source chain folded allow/deny/ignore per request
(emqx_authz.erl:106-115,297+): each source inspects
(clientinfo, action, topic) and answers

- ``"allow"`` / ``"deny"`` → final verdict, stop
- ``"ignore"``             → next source

falling through to the configurable ``no_match`` default. Verdicts are
memoised per connection in an LRU+TTL cache (emqx_authz_cache.erl).

Rule model (the acl.conf shape, apps/emqx_authz/src/emqx_authz_file.erl):
    Rule = (permission, who, action, topics)
      permission : allow | deny
      who        : all | ("user", name) | ("clientid", id)
                 | ("ipaddr", "10.0.0.0/8") | ("and"|"or", [who...])
      action     : publish | subscribe | all
      topics     : list of filters; "eq topic/1" pins a literal (no
                   wildcard expansion); ${clientid}/${username}
                   (and %c/%u) placeholders are substituted.
"""

from __future__ import annotations

import ipaddress
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, Optional

from emqx_tpu_torch.core import topic as T

ClientInfo = dict


# -- rules ----------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    permission: str                    # allow | deny
    who: object = "all"
    action: str = "all"                # publish | subscribe | all
    topics: tuple = ("#",)


def _who_match(who, ci: ClientInfo) -> bool:
    if who == "all":
        return True
    if isinstance(who, tuple):
        tag = who[0]
        if tag == "user":
            return ci.get("username") == who[1]
        if tag == "clientid":
            return ci.get("clientid") == who[1]
        if tag == "ipaddr":
            peer = (ci.get("peername") or "").rsplit(":", 1)[0]
            try:
                return ipaddress.ip_address(peer) in ipaddress.ip_network(
                    who[1], strict=False)
            except ValueError:
                return False
        if tag == "and":
            return all(_who_match(w, ci) for w in who[1])
        if tag == "or":
            return any(_who_match(w, ci) for w in who[1])
    return False


def _feed(topic_spec: str, ci: ClientInfo) -> str:
    return (topic_spec
            .replace("${clientid}", ci.get("clientid") or "")
            .replace("${username}", ci.get("username") or "")
            .replace("%c", ci.get("clientid") or "")
            .replace("%u", ci.get("username") or ""))


def _topic_match(spec: str, topic: str, ci: ClientInfo) -> bool:
    if spec.startswith("eq "):
        return topic == _feed(spec[3:], ci)
    return T.match(topic, _feed(spec, ci))


def match_rule(rule: Rule, ci: ClientInfo, action: str,
               topic: str) -> Optional[str]:
    if rule.action not in ("all", action):
        return None
    if not _who_match(rule.who, ci):
        return None
    if any(_topic_match(spec, topic, ci) for spec in rule.topics):
        return rule.permission
    return None


# -- sources --------------------------------------------------------------


class Source:
    """Source behaviour: authorize → allow | deny | ignore."""

    type: str = "source"
    enable: bool = True

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        raise NotImplementedError


class FileSource(Source):
    """Static rule list = acl.conf (emqx_authz_file.erl)."""

    type = "file"

    def __init__(self, rules: Iterable[Rule]) -> None:
        self.rules = list(rules)

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        for rule in self.rules:
            verdict = match_rule(rule, ci, action, topic)
            if verdict is not None:
                return verdict
        return "ignore"

    @classmethod
    def parse(cls, text: str) -> "FileSource":
        """Parse the acl file DSL, one rule per line:
        ``allow|deny  all|user=U|clientid=C|ipaddr=CIDR
        publish|subscribe|all  topic[,topic...]``; '#' comments."""
        rules = []
        for ln in text.splitlines():
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split(None, 3)
            if len(parts) != 4:
                raise ValueError(f"bad acl line: {ln!r}")
            perm, who_s, action, topics_s = parts
            if perm not in ("allow", "deny"):
                raise ValueError(f"bad permission in: {ln!r}")
            if who_s == "all":
                who = "all"
            elif "=" in who_s:
                tag, val = who_s.split("=", 1)
                if tag not in ("user", "clientid", "ipaddr"):
                    raise ValueError(f"bad who in: {ln!r}")
                who = (tag, val)
            else:
                raise ValueError(f"bad who in: {ln!r}")
            topics = tuple(t.strip() for t in topics_s.split(",") if t.strip())
            rules.append(Rule(perm, who, action, topics))
        return cls(rules)


class BuiltinSource(Source):
    """Per-client / per-user / all rule store
    (emqx_authz_mnesia.erl)."""

    type = "built_in_database"

    def __init__(self) -> None:
        self._by_clientid: dict[str, list[Rule]] = {}
        self._by_username: dict[str, list[Rule]] = {}
        self._all: list[Rule] = []

    def set_rules(self, who: object, rules: list[Rule]) -> None:
        if who == "all":
            self._all = list(rules)
        elif isinstance(who, tuple) and who[0] == "clientid":
            self._by_clientid[who[1]] = list(rules)
        elif isinstance(who, tuple) and who[0] == "user":
            self._by_username[who[1]] = list(rules)
        else:
            raise ValueError(f"bad who {who!r}")

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        chains = (
            self._by_clientid.get(ci.get("clientid") or "", ()),
            self._by_username.get(ci.get("username") or "", ()),
            self._all,
        )
        for rules in chains:
            for rule in rules:
                verdict = match_rule(rule, ci, action, topic)
                if verdict is not None:
                    return verdict
        return "ignore"


class ClientAclSource(Source):
    """Rules attached to the client at authentication time (the JWT
    ``acl`` claim path, emqx_authz_client_info.erl): reads
    ``ci["acl"] = {"pub": [...], "sub": [...], "all": [...]}``."""

    type = "client_info"

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        acl = ci.get("acl")
        if not acl:
            return "ignore"
        key = {"publish": "pub", "subscribe": "sub"}[action]
        specs = list(acl.get(key, ())) + list(acl.get("all", ()))
        if not specs:
            return "ignore"
        for spec in specs:
            if _topic_match(spec, topic, ci):
                return "allow"
        return "deny"                           # acl present but no grant


class HttpAclSource(Source):
    """External HTTP authorizer (emqx_authz_http.erl), transport
    injected like ``HttpProvider``."""

    type = "http"

    def __init__(self, request_fn) -> None:
        self.request_fn = request_fn

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        try:
            resp = self.request_fn({
                "clientid": ci.get("clientid"),
                "username": ci.get("username"),
                "action": action, "topic": topic,
            })
        except Exception:
            return "ignore"
        if resp is None:
            return "ignore"
        return {"allow": "allow", "deny": "deny"}.get(
            resp.get("result"), "ignore")


# -- cache ----------------------------------------------------------------


class AuthzCache:
    """Per-connection verdict cache: LRU with TTL
    (emqx_authz_cache.erl; reference defaults 32 entries / 1 min)."""

    def __init__(self, max_size: int = 32, ttl_ms: int = 60_000) -> None:
        self.max_size = max_size
        self.ttl_ms = ttl_ms
        self._d: OrderedDict[tuple, tuple[str, float]] = OrderedDict()

    def get(self, action: str, topic: str) -> Optional[str]:
        key = (action, topic)
        hit = self._d.get(key)
        if hit is None:
            return None
        verdict, at = hit
        if (time.time() - at) * 1000 > self.ttl_ms:
            del self._d[key]
            return None
        self._d.move_to_end(key)
        return verdict

    def put(self, action: str, topic: str, verdict: str) -> None:
        self._d[(action, topic)] = (verdict, time.time())
        self._d.move_to_end((action, topic))
        while len(self._d) > self.max_size:
            self._d.popitem(last=False)

    def drain(self) -> None:
        self._d.clear()


# -- the chain ------------------------------------------------------------


class Authz:
    """Source chain + defaults (emqx_authz.erl):
    ``no_match`` = allow|deny, superuser bypass before any source."""

    def __init__(self, sources: Optional[list[Source]] = None,
                 no_match: str = "allow") -> None:
        self.sources: list[Source] = list(sources or [])
        self.no_match = no_match

    def add_source(self, src: Source, front: bool = False) -> None:
        if front:
            self.sources.insert(0, src)
        else:
            self.sources.append(src)

    def authorize(self, ci: ClientInfo, action: str, topic: str) -> str:
        if ci.get("is_superuser"):
            return "allow"
        for src in self.sources:
            if not src.enable:
                continue
            verdict = src.authorize(ci, action, topic)
            if verdict in ("allow", "deny"):
                return verdict
        return self.no_match
