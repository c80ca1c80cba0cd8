"""Topic rewrite — ``apps/emqx_modules/src/emqx_rewrite.erl`` analogue.

Rules: ``{action: publish|subscribe|all, source_topic: <filter>,
re: <regex>, dest_topic: <template>}``. A topic that matches the source
filter AND the regex is rewritten to dest with ``$1..$N`` regex captures
plus ``%c``/``%u`` client binds (emqx_rewrite.erl:146-175). First
matching rule wins; no re-chaining.

Hooks: ``client.subscribe`` / ``client.unsubscribe`` folds over the
topic-filter list, ``message.publish`` fold over the message.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass
from typing import Optional

from emqx_tpu_torch.core import topic as T


@dataclass
class RewriteRule:
    action: str            # publish | subscribe | all
    source_topic: str      # topic filter gating the rule
    re: str                # regex with capture groups
    dest_topic: str        # template with $1..$N, %c, %u
    _compiled: Optional[_re.Pattern] = None

    def compiled(self) -> _re.Pattern:
        if self._compiled is None:
            self._compiled = _re.compile(self.re)
        return self._compiled


class TopicRewrite:
    def __init__(self, rules: Optional[list[dict]] = None) -> None:
        self.pub_rules: list[RewriteRule] = []
        self.sub_rules: list[RewriteRule] = []
        # fired after add_rule/clear — the native host flushes its
        # publish permits so a new pub rewrite applies to topics that
        # were already fast-pathing (broker/native_server.py)
        self.on_topology_change: list = []
        for spec in rules or []:
            self.add_rule(**spec)

    def add_rule(self, action: str, source_topic: str, re: str,
                 dest_topic: str) -> None:
        rule = RewriteRule(action, source_topic, re, dest_topic)
        rule.compiled()                       # surface bad regexes early
        if action in ("publish", "all"):
            self.pub_rules.append(rule)
            # only pub rewrites affect publish permits; a subscribe-only
            # rule must not flush every publisher broker-wide
            for cb in self.on_topology_change:
                cb()
        if action in ("subscribe", "all"):
            self.sub_rules.append(rule)

    def clear(self) -> None:
        had_pub = bool(self.pub_rules)
        self.pub_rules.clear()
        self.sub_rules.clear()
        if had_pub:
            for cb in self.on_topology_change:
                cb()

    def replace(self, pub_rules: list, sub_rules: list) -> None:
        """Atomic swap-in of a validated rule set (the REST PUT path)
        — fires the topology callbacks the way add_rule/clear do."""
        changed = bool(self.pub_rules) or bool(pub_rules)
        self.pub_rules = pub_rules
        self.sub_rules = sub_rules
        if changed:
            for cb in self.on_topology_change:
                cb()

    # -- core ----------------------------------------------------------------

    @staticmethod
    def _rewrite(topic: str, rules: list[RewriteRule],
                 binds: dict[str, str]) -> str:
        for rule in rules:
            if not T.match(topic, rule.source_topic):
                continue
            m = rule.compiled().search(topic)
            if m is None:
                return topic              # filter hit, regex miss → as-is
            dest = rule.dest_topic
            for key, val in binds.items():
                dest = dest.replace(key, val or "")
            for i, cap in enumerate(m.groups(), start=1):
                dest = dest.replace(f"${i}", cap or "")
            return dest
        return topic

    @staticmethod
    def _binds(clientid: str, username: Optional[str]) -> dict[str, str]:
        return {"%c": clientid or "", "%u": username or ""}

    # -- hook callbacks ------------------------------------------------------

    def attach(self, hooks) -> None:
        hooks.add("message.publish", self._on_publish, priority=1000)
        hooks.add("client.subscribe", self._on_subscribe, priority=1000)
        hooks.add("client.unsubscribe", self._on_unsubscribe, priority=1000)

    def _on_publish(self, msg):
        if msg.sys or not self.pub_rules:
            return None
        binds = self._binds(msg.from_,
                            (msg.headers or {}).get("username"))
        new_topic = self._rewrite(msg.topic, self.pub_rules, binds)
        if new_topic != msg.topic:
            from dataclasses import replace
            return replace(msg, topic=new_topic)
        return None

    def _on_subscribe(self, ci: dict, props: dict, tfs):
        if not self.sub_rules:
            return None
        binds = self._binds(ci.get("clientid", ""), ci.get("username"))
        return [(self._rewrite(t, self.sub_rules, binds), opts)
                for t, opts in tfs]

    def _on_unsubscribe(self, ci: dict, props: dict, tfs):
        if not self.sub_rules:
            return None
        binds = self._binds(ci.get("clientid", ""), ci.get("username"))
        return [self._rewrite(t, self.sub_rules, binds) for t in tfs]

    def list(self) -> list[dict]:
        seen, out = set(), []
        for rule in self.pub_rules + self.sub_rules:
            key = id(rule)
            if key not in seen:
                seen.add(key)
                out.append({"action": rule.action,
                            "source_topic": rule.source_topic,
                            "re": rule.re, "dest_topic": rule.dest_topic})
        return out
