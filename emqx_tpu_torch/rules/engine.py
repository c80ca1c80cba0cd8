"""Rule engine — parity with
``apps/emqx_rule_engine/src/emqx_rule_engine.erl`` +
``emqx_rule_actions.erl``.

Rules = SQL + ordered actions, keyed by id. FROM topics split into the
message.publish path (topic-filter matched per publish,
emqx_rule_engine.erl:198-205's topic index) and $events/* hookpoints.
Actions: ``republish`` (topic/payload/qos templates with ``${var}``
placeholders — emqx_plugin_libs_rule's preproc_tmpl), ``console``, and
registered custom functions (the bridge seam). Per-rule counters ride a
MetricsWorker ('matched'/'passed'/'failed'/'actions.success'/...).
"""

from __future__ import annotations

import logging
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.observe.metrics import MetricsWorker
from emqx_tpu_torch.router.trie import Trie
from emqx_tpu_torch.rules import events as EV
from emqx_tpu_torch.rules import funcs as rule_funcs
from emqx_tpu_torch.rules.runtime import apply_select, eval_expr
from emqx_tpu_torch.rules.sqlparser import Select, parse

log = logging.getLogger("emqx_tpu_torch.rules")

_TMPL = re.compile(r"\$\{([^}]+)\}")

RULE_COUNTERS = ["matched", "passed", "failed", "failed.exception",
                 "failed.no_result", "actions.total", "actions.success",
                 "actions.failed"]

# message-plane event topics: their hookpoints (message.delivered/acked/
# dropped) fire per-delivery on the Python path only — a subscribed rule
# is incompatible with native fast-path delivery for ANY topic
MESSAGE_EVENT_TOPICS = frozenset((
    "$events/message_delivered", "$events/message_acked",
    "$events/message_dropped"))


def render_template(tmpl: str, columns: dict) -> str:
    """${a.b} placeholder substitution (preproc_tmpl/proc_tmpl)."""
    from emqx_tpu_torch.rules.funcs import _str

    def sub(m):
        val = eval_expr(("var", m.group(1).split(".")), columns)
        if isinstance(val, (dict, list)):
            import json
            return json.dumps(val, separators=(",", ":"))
        return _str(val)

    return _TMPL.sub(sub, tmpl)


@dataclass
class Rule:
    id: str
    sql: str
    select: Select
    actions: list = field(default_factory=list)
    enabled: bool = True
    description: str = ""
    # split FROM list
    publish_topics: list[str] = field(default_factory=list)
    event_topics: list[str] = field(default_factory=list)


class RuleEngine:
    def __init__(self, node: str = "node1",
                 publish_fn: Optional[Callable[[Message], None]] = None
                 ) -> None:
        self.node = node
        self.publish_fn = publish_fn
        self.rules: dict[str, Rule] = {}
        self.metrics = MetricsWorker()
        self._action_types: dict[str, Callable] = {
            "republish": self._act_republish,
            "console": self._act_console,
        }
        self._console_out: list[dict] = []       # console sink (tests/CLI)
        self._hooked: Optional[Hooks] = None
        # fired after every create/delete — the native host flushes its
        # publish permits here so a new rule is seen by topics that were
        # already fast-pathing (broker/native_server.py)
        self.on_topology_change: list = []
        # topic index over rule FROM filters: per-publish rule lookup is
        # O(matched filters), not O(rules) — the emqx_rule_engine.erl
        # :198-205 topic-index semantics (host side); with a RouterModel
        # attached the same filters also co-batch into the device trie
        # (BASELINE config 5) and arrive pre-matched via on_matched
        self._pub_trie = Trie()
        self._filter_rules: dict[str, set[str]] = {}   # filter → rule ids
        # guards the trie + filter index: create/delete arrive on REST
        # threads while rules_for_topic runs on every publish (broker
        # poll thread / pipeline flusher) — an unguarded trie walk over
        # a mutating dict tree can raise mid-match
        self._index_lock = threading.RLock()
        self._model = None                             # RouterModel | None
        # device co-batch gate: while the broker folds a device batch's
        # message.publish hooks ON THIS THREAD, _on_publish defers to
        # on_matched. Thread-local state (not a message header): a header
        # would leak into copies other hooks store (e.g. the delayed
        # queue) and silently suppress rules on their later republish
        self._gate = threading.local()

    # -- rule CRUD (emqx_rule_engine API) -----------------------------------

    def create_rule(self, id: str, sql: str, actions: list,
                    enabled: bool = True, description: str = "") -> Rule:
        select = parse(sql)
        publish_topics, event_topics = [], []
        for t in select.topics:
            if t in EV.EVENT_TOPICS:
                event_topics.append(t)
            elif t.startswith("$events/"):
                raise ValueError(f"unknown event topic {t!r}")
            else:
                if not T.validate_filter(t):
                    # reject BEFORE any state mutates — a late failure in
                    # _index (device aux_register) would leave a
                    # half-registered rule
                    raise ValueError(f"invalid topic filter {t!r}")
                publish_topics.append(t)
        rule = Rule(id=id, sql=sql, select=select, actions=list(actions),
                    enabled=enabled, description=description,
                    publish_topics=publish_topics,
                    event_topics=event_topics)
        with self._index_lock:
            # replacement is atomic under the lock: a publish matching
            # between unindex(old) and index(new) would otherwise see
            # NO rule for a filter both versions share
            if id in self.rules:
                self._unindex(self.rules[id])
            self.rules[id] = rule
            self._index(rule)
        self.metrics.create_metrics(id, RULE_COUNTERS)
        for cb in self.on_topology_change:
            cb()
        return rule

    def delete_rule(self, id: str) -> bool:
        self.metrics.clear_metrics(id)
        rule_funcs.drop_rule_store(id)
        with self._index_lock:
            rule = self.rules.pop(id, None)
            if rule is not None:
                self._unindex(rule)
        if rule is not None:
            for cb in self.on_topology_change:
                cb()
        return rule is not None

    def _index(self, rule: Rule) -> None:
        with self._index_lock:
            for f in rule.publish_topics:
                rids = self._filter_rules.setdefault(f, set())
                if not rids:
                    self._pub_trie.insert(f)
                    if self._model is not None:
                        self._model.aux_register(f)
                rids.add(rule.id)

    def _unindex(self, rule: Rule) -> None:
        with self._index_lock:
            for f in rule.publish_topics:
                rids = self._filter_rules.get(f)
                if rids is None:
                    continue
                rids.discard(rule.id)
                if not rids:
                    del self._filter_rules[f]
                    self._pub_trie.delete(f)
                    if self._model is not None:
                        self._model.aux_release(f)

    def attach_model(self, model) -> None:
        """Co-batch rule FROM filters into the device router's trie
        (publish_batch then reports rule matches alongside fan-out —
        BASELINE config 5)."""
        with self._index_lock:        # uniform guard for _filter_rules
            self._model = model
            for f in self._filter_rules:
                model.aux_register(f)

    def get_rule(self, id: str) -> Optional[Rule]:
        return self.rules.get(id)

    def list_rules(self) -> list[Rule]:
        return list(self.rules.values())

    def register_action(self, name: str, fn: Callable) -> None:
        """Custom action type (the bridge seam): fn(columns, args)."""
        self._action_types[name] = fn

    def unregister_action(self, name: str) -> None:
        self._action_types.pop(name, None)

    # -- hook wiring --------------------------------------------------------

    def attach(self, hooks: Hooks) -> None:
        self._hooked = hooks
        hooks.add("message.publish", self._on_publish, priority=-50)
        for event_topic, hookpoint in EV.EVENT_TOPICS.items():
            if hookpoint == "message.publish":
                continue
            hooks.add(hookpoint, self._make_event_cb(event_topic),
                      priority=-50)

    def _make_event_cb(self, event_topic: str):
        hookpoint = EV.EVENT_TOPICS[event_topic]

        def cb(*args):
            with self._index_lock:    # snapshot: REST threads mutate
                rules = list(self.rules.values())
            for rule in rules:
                if rule.enabled and event_topic in rule.event_topics:
                    cols = EV.event_columns(hookpoint, args, self.node)
                    self._apply_rule(rule, cols)
            return None
        return cb

    # -- the publish path ----------------------------------------------------

    def publish_filters(self) -> list[str]:
        """Every live FROM topic filter (enabled and disabled rules
        alike — enablement is re-checked at fire time). The native
        server mirrors these into the C++ table as rule-tap entries
        (broker/native_server._sync_rule_taps)."""
        with self._index_lock:
            return list(self._filter_rules.keys())

    def watches_message_events(self) -> bool:
        """True while any enabled rule consumes message-plane events
        ($events/message_delivered / _acked / _dropped). Those
        hookpoints fire only on the Python delivery path, so the native
        fast path must not carry ANY topic while such a rule exists —
        its deliveries/acks/drops would silently never reach the rule
        (broker/native_server._slow_consumers_watch). A live scan, not
        a cached count: callers (and tests) flip rule.enabled in place,
        which _make_event_cb honours dynamically — the permit gate must
        see the same state. The grant loop hoists this call out of its
        per-topic work, so O(rules) runs once per grant cycle."""
        with self._index_lock:
            return any(r.enabled
                       and any(t in MESSAGE_EVENT_TOPICS
                               for t in r.event_topics)
                       for r in self.rules.values())

    def rules_for_topic(self, topic: str) -> list[Rule]:
        """Trie-indexed lookup: O(matched filters), not O(rules)
        (emqx_rule_engine.erl:198-205 get_rules_for_topic)."""
        with self._index_lock:
            return self._rules_of(self._pub_trie.match(topic))

    def _rules_of(self, filters) -> list[Rule]:
        out: list[Rule] = []
        seen: set[str] = set()
        for f in filters:
            for rid in self._filter_rules.get(f, ()):
                if rid not in seen:
                    seen.add(rid)
                    rule = self.rules.get(rid)
                    if rule is not None and rule.enabled:
                        out.append(rule)
        return out

    def ingest(self, msg: Message) -> None:
        """Feed a non-broker message into rule matching — the bridge
        ingress hook-topic path ('$bridges/...', emqx_rule_events.erl:145)
        where rules fire without a broker publish."""
        self._on_publish(msg)

    def publish_gate(self, on: bool) -> None:
        """broker.publish_batch brackets its hook fold with this so the
        kernel (not the hook) does the matching for batched messages."""
        self._gate.on = on

    def _on_publish(self, msg: Message, *rest):
        if msg.topic.startswith("$SYS/"):
            return None
        if self._model is not None and getattr(self._gate, "on", False):
            # device batch in flight: the kernel matches this topic
            # against the co-batched rule filters; the broker hands the
            # result to on_matched — no second trie walk here
            return None
        self._fire(msg, self.rules_for_topic(msg.topic))
        return None

    def on_matched(self, msg: Message, matched_filters) -> None:
        """Device co-batch sink (broker.rules_matched_fn): the kernel
        already matched ``msg.topic`` against the shared trie;
        ``matched_filters`` maps to rules with dict lookups only.
        ``None`` means the topic took the host-oracle fallback — match
        on the host trie instead."""
        if msg.topic.startswith("$SYS/"):
            return
        if matched_filters is None:
            rules = self.rules_for_topic(msg.topic)
        else:
            rules = self._rules_of(matched_filters)
        self._fire(msg, rules)

    def _fire(self, msg: Message, rules: list[Rule]) -> None:
        if not rules:
            return
        cols = EV.message_columns(msg, self.node)
        loop_guard = msg.headers.get("republish_by")
        for rule in rules:
            if rule.id == loop_guard:
                continue          # a rule never re-fires on its own
            self._apply_rule(rule, cols)

    # -- evaluation (emqx_rule_runtime:apply_rules) --------------------------

    def _apply_rule(self, rule: Rule, columns: dict) -> None:
        self.metrics.inc(rule.id, "matched")
        # kv_store_*/proc_dict_* funcs are scoped per rule (reference:
        # the rule worker's process dictionary); the contextvar tells
        # them whose store is active
        ctx_token = rule_funcs.set_rule_context(rule.id)
        try:
            try:
                results = apply_select(rule.select, columns)
            except Exception:
                log.exception("rule %s SQL failed", rule.id)
                self.metrics.inc(rule.id, "failed")
                self.metrics.inc(rule.id, "failed.exception")
                return
            if results is None:
                self.metrics.inc(rule.id, "failed")
                self.metrics.inc(rule.id, "failed.no_result")
                return
            self.metrics.inc(rule.id, "passed")
            for res in results:
                for action in rule.actions:
                    self._run_action(rule, action, res)
        finally:
            rule_funcs.reset_rule_context(ctx_token)

    def _run_action(self, rule: Rule, action: dict, columns: dict) -> None:
        self.metrics.inc(rule.id, "actions.total")
        fn = self._action_types.get(action.get("function", "console"))
        try:
            if fn is None:
                raise ValueError(
                    f"unknown action {action.get('function')!r}")
            fn({**columns, "__rule_id": rule.id},
               action.get("args") or {})
            self.metrics.inc(rule.id, "actions.success")
        except Exception:
            log.exception("rule %s action failed", rule.id)
            self.metrics.inc(rule.id, "actions.failed")

    # -- builtin actions ----------------------------------------------------

    def _act_republish(self, columns: dict, args: dict) -> None:
        if self.publish_fn is None:
            raise RuntimeError("republish: no publish_fn wired")
        topic = render_template(args.get("topic", "${topic}"), columns)
        payload = render_template(
            args.get("payload", "${payload}"), columns)
        qos_t = args.get("qos", 0)
        qos = (int(render_template(str(qos_t), columns))
               if isinstance(qos_t, str) else int(qos_t))
        retain = bool(args.get("retain", False))
        self.publish_fn(Message(
            topic=topic, payload=payload.encode(), qos=qos,
            from_=str(columns.get("clientid") or "rule_engine"),
            flags={"retain": retain},
            headers={"republish_by": columns.get("__rule_id"),
                     "properties": {}},
        ))

    def _act_console(self, columns: dict, args: dict) -> None:
        out = {k: v for k, v in columns.items() if not k.startswith("__")}
        self._console_out.append(out)
        del self._console_out[:-200]
        log.info("rule %s console: %s", columns.get("__rule_id"), out)

    # -- SQL test API (emqx_rule_sqltester) ---------------------------------

    def test_sql(self, sql: str, context: dict) -> Optional[list[dict]]:
        """Dry-run a SQL statement against a sample context (the
        dashboard's rule tester)."""
        sel = parse(sql)
        return apply_select(sel, context)
