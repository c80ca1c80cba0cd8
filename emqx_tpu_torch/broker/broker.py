"""The pub/sub fabric — parity with ``apps/emqx/src/emqx_broker.erl``.

Node-local subscription tables + the publish pipeline:

- ``suboption``   {(sid, topic) → SubOpts}   (emqx_broker.erl:105-118)
- ``subscription`` {sid → set(topic)}
- ``subscriber``   {topic → set(sid)}
- publish pipeline: 'message.publish' hook fold → route match → dispatch
  (:218-232, :284-300), remote routes handed to the cluster plane
- subscriber slots: every local subscriber id (session) gets a bitmap
  slot so the device fan-out can address it; slots are recycled on
  subscriber_down (the emqx_broker_helper shard-assignment analogue)

Two read paths share one source of truth (the Router's trie):

- ``publish``        host path, one message (the oracle walk)
- ``publish_batch``  device path, a topic batch through RouterModel —
  the {active,N}-style coalescing surface the connection host feeds

Delivery is returned, not performed: ``{sid: [(sub_topic, Message)]}`` —
the channel/connection layer owns sockets (process boundary in the
reference, function boundary here).
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Message, SubOpts
from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.observe import trace as _tracing
from emqx_tpu_torch.router.router import Router

Sid = str  # subscriber id (session/clientid)


def _on_card(model) -> bool:
    """Whether ``model`` runs its step on a CUDA card.  A model on the card
    never hands a batch to the host oracle in its place: a step that raises
    there (a kernel that does not build or launch, a lost card) reaches the
    caller, and the pipeline's knee defaults to 0 over it."""
    return getattr(getattr(model, "device", None), "type", None) == "cuda"


class SlotRegistry:
    """sid ↔ bitmap-slot allocation over a FIXED shard space.

    The emqx_broker_helper.erl:55,82-92 discipline, device-shaped: while
    unique slots remain, each sid owns one (exact decode, no false
    positives); past capacity, new sids hash into the same [0, capacity)
    space and a slot becomes a subscriber *shard* — the broker keeps a
    matched filter's subscribers whose slot the step delivers to.
    Capacity never grows, so the device-side structures are fixed-size
    at 10M subscribers and no capacity-doubling rebuild stall exists."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._slot_of: dict[Sid, int] = {}
        self._sids_of: dict[int, set[Sid]] = {}
        self._free: list[int] = []
        self._next = 0

    @staticmethod
    def _hash(sid: Sid) -> int:
        # stable across processes (phash2 analogue); Python's hash() is
        # salted per-process and would break cluster-symmetric decode
        import zlib
        return zlib.crc32(sid.encode() if isinstance(sid, str) else sid)

    def get_or_assign(self, sid: Sid) -> int:
        slot = self._slot_of.get(sid)
        if slot is not None:
            return slot
        if self._free:
            slot = self._free.pop()
        elif self._next < self.capacity:
            slot = self._next
            self._next += 1
        else:
            slot = self._hash(sid) % self.capacity
        self._slot_of[sid] = slot
        self._sids_of.setdefault(slot, set()).add(sid)
        return slot

    def lookup_sids(self, slot: int):
        """All sids sharing the slot (1 in the unique regime)."""
        return self._sids_of.get(slot, ())

    def lookup_slot(self, sid: Sid) -> Optional[int]:
        return self._slot_of.get(sid)

    def release(self, sid: Sid) -> Optional[int]:
        slot = self._slot_of.pop(sid, None)
        if slot is not None:
            sids = self._sids_of.get(slot)
            if sids is not None:
                sids.discard(sid)
                if not sids:
                    del self._sids_of[slot]
                    self._free.append(slot)
        return slot

    def slot_count(self) -> int:
        return self._next


class ExclusiveLocked(Exception):
    """$exclusive/... topic already held by another subscriber."""

    def __init__(self, topic: str, holder: Sid) -> None:
        super().__init__(f"{topic} exclusively held by {holder}")
        self.topic, self.holder = topic, holder


class Broker:
    """Single-node pub/sub core; the cluster plane plugs in via
    ``forward_fn`` (gen_rpc analogue) for remote-node routes."""

    def __init__(
        self,
        node: str = "node1",
        hooks: Optional[Hooks] = None,
        router: Optional[Router] = None,
        router_model=None,       # emqx_tpu_torch.models.RouterModel (device path)
        forward_fn=None,         # fn(node, delivery) for remote routes
        shared_dispatch=None,    # fn(group, topic, msg) -> [(sid, sub_topic)]
        metrics=None,            # observe.metrics.Metrics (shared node-wide)
    ) -> None:
        self.node = node
        self.hooks = hooks or Hooks()
        self.router = router or Router()
        if self.router.home is None:
            # the away index: the walk after a device step then covers
            # only the routes that are not this node's own
            self.router.set_home(node)
        self.model = router_model
        self.forward_fn = forward_fn
        self.shared_dispatch = shared_dispatch
        # batched variant (app._shared_dispatch_batch → SharedSub.
        # dispatch_batch): one lock hold for ALL of a publish batch's
        # shared legs instead of a dispatch per message
        self.shared_dispatch_batch = None
        # device co-batching sink for the rule engine (config 5): called
        # with (msg, matched_filters) after the kernel, or (msg, None)
        # for fallback topics the kernel couldn't cover; rules_gate_fn
        # brackets the batch's hook fold (RuleEngine.publish_gate)
        self.rules_matched_fn = None
        self.rules_gate_fn = None
        # degradation ledger (set by the app): device-loss
        # failovers record a structured reason event next to the
        # messages.device_failover counter
        self.ledger = None
        self.slots = SlotRegistry(
            capacity=router_model.n_sub_slots
            if router_model is not None else 8192)
        self._lock = threading.RLock()
        self.suboption: dict[tuple[Sid, str], SubOpts] = {}
        self.subscription: dict[Sid, set[str]] = {}
        self.subscriber: dict[str, set[Sid]] = {}
        # $exclusive/... topics: one subscriber at a time
        # (emqx_exclusive_subscription.erl — a mnesia transaction there).
        # This map covers LOCAL holders; cluster-wide exclusivity is the
        # exclusive_try_fn/exclusive_release_fn seam that ClusterNode
        # wires to a peer-confirmed acquire (cluster/node.py), mirroring
        # the reference's cluster-wide try_subscribe txn.  Standalone
        # (fn unset) the lock is node-local.
        # Gated by the mqtt.exclusive_subscription cap (emqx_mqtt_caps).
        self.exclusive: dict[str, Sid] = {}
        self.exclusive_enabled = True
        # mqtt.max_qos_allowed zone cap (emqx_mqtt_caps): <2 is
        # advertised in CONNACK Maximum-QoS and enforced on PUBLISH
        # ([MQTT-3.2.2-11]) and will qos ([MQTT-3.2.2-12])
        self.max_qos_allowed = 2
        self.exclusive_try_fn = None      # fn(topic, sid) -> Optional[holder]
        self.exclusive_release_fn = None  # fn(topic, sid)
        if metrics is None:
            from emqx_tpu_torch.observe.metrics import Metrics
            metrics = Metrics()
        self.metrics = metrics
        # subscription observers: fn(op, sid, topic, opts) with op in
        # {"add", "del"}, fired on EVERY table change including
        # restore=True resumes (unlike the 'session.subscribed' hook) —
        # the native host mirrors the table through this seam
        # (broker/native_server.py), so a missed event would make its
        # fast path silently skip a subscriber
        self.sub_observers: list = []

    def _inc(self, key: str, n: int = 1) -> None:
        self.metrics.inc(key, n)

    # -- subscribe / unsubscribe (emqx_broker.erl:134-173) ------------------

    def subscribe(self, sid: Sid, topic: str, opts: Optional[SubOpts] = None,
                  restore: bool = False) -> None:
        """``restore=True`` rebuilds tables/routes for a resumed session
        without firing 'session.subscribed' — a resume is not a SUBSCRIBE,
        so retained messages must not re-dispatch (MQTT5 3.8.3.1)."""
        opts = opts or SubOpts()
        group, real_topic = T.parse_share(topic)
        if group:
            opts = SubOpts(**{**opts.__dict__, "share": group})
        cluster_claimed = False
        if (not group and getattr(opts, "exclusive", False)
                and self.exclusive_try_fn is not None):
            # Cluster-wide acquire BEFORE the broker lock: the try fn does
            # peer RPC and must not run under self._lock (a peer acquiring
            # concurrently would deadlock on the crossed handler calls).
            remote_holder = self.exclusive_try_fn(topic, sid)
            if remote_holder is not None:
                raise ExclusiveLocked(topic, remote_holder)
            cluster_claimed = True
        try:
            is_new = self._subscribe_locked(sid, topic, opts, group,
                                            real_topic)
        except BaseException:
            # ANY failure after the cluster claim (a local holder beat us,
            # an invalid filter, a model slot error) must roll the claim
            # back or it leaks cluster-wide forever (excl.sync would keep
            # re-asserting it); release runs OUTSIDE the broker lock (the
            # broadcast does peer IO)
            if cluster_claimed and self.exclusive_release_fn is not None:
                self.exclusive_release_fn(topic, sid)
            raise
        for obs in self.sub_observers:
            obs("add", sid, topic, opts)
        # is_new lets rh=1 (send-retained-if-new) distinguish resubscribes
        if not restore:
            self.hooks.run("session.subscribed", (sid, topic, opts, is_new))

    def _subscribe_locked(self, sid: Sid, topic: str, opts: SubOpts,
                          group, real_topic: str) -> bool:
        with self._lock:
            if not group and getattr(opts, "exclusive", False):
                # subscription already carries the real (stripped) topic;
                # exclusivity is a lock keyed by it (try_subscribe txn,
                # emqx_exclusive_subscription.erl)
                holder = self.exclusive.get(topic)
                if holder is not None and holder != sid:
                    raise ExclusiveLocked(topic, holder)
                self.exclusive[topic] = sid
            key = (sid, topic)
            is_new = key not in self.suboption
            self.suboption[key] = opts
            self.subscription.setdefault(sid, set()).add(topic)
            if is_new:
                subs_key = real_topic if not group else topic
                subs = self.subscriber.setdefault(subs_key, set())
                first_local = not subs
                subs.add(sid)
                if group:
                    # shared subs route as {group, node}
                    # (emqx_shared_sub.erl:420); one route per group+topic
                    if first_local:
                        self.router.add_route(real_topic, (group, self.node))
                else:
                    # one (topic, node) route per topic regardless of local
                    # subscriber count (emqx_broker.erl route aggregation)
                    if first_local:
                        self.router.add_route(real_topic, self.node)
                    if self.model is not None:
                        slot = self.slots.get_or_assign(sid)
                        self.model.subscribe(real_topic, slot)
            return is_new

    def unsubscribe(self, sid: Sid, topic: str) -> bool:
        group, real_topic = T.parse_share(topic)
        release_exclusive = False
        with self._lock:
            opts = self.suboption.pop((sid, topic), None)
            if opts is None:
                return False
            if (getattr(opts, "exclusive", False)
                    and self.exclusive.get(topic) == sid):
                del self.exclusive[topic]
                # the cluster release broadcast does peer IO — deferred
                # to after the lock (a slow peer must not stall every
                # subscribe/unsubscribe on the node)
                release_exclusive = self.exclusive_release_fn is not None
            self.subscription.get(sid, set()).discard(topic)
            subs_key = real_topic if not group else topic
            subs = self.subscriber.get(subs_key)
            last_local = False
            if subs is not None:
                subs.discard(sid)
                if not subs:
                    del self.subscriber[subs_key]
                    last_local = True
            if group:
                if last_local:
                    self.router.delete_route(real_topic, (group, self.node))
            else:
                if last_local:
                    self.router.delete_route(real_topic, self.node)
                if self.model is not None:
                    # read-only lookup: a teardown path must never mint a
                    # fresh slot for an already-released sid
                    slot = self.slots.lookup_slot(sid)
                    if slot is not None:
                        self.model.unsubscribe(real_topic, slot)
        if release_exclusive:
            self.exclusive_release_fn(topic, sid)
        for obs in self.sub_observers:
            obs("del", sid, topic, opts)
        self.hooks.run("session.unsubscribed", (sid, topic))
        return True

    def subscriber_down(self, sid: Sid) -> int:
        """Batch-clean a dead subscriber (emqx_broker.erl:361-383).
        Snapshot-then-unsubscribe: each unsubscribe takes the lock itself
        so the exclusive release / hook legs run outside it.  The final
        teardown is conditional — a concurrent re-subscribe for the same
        sid (reconnect racing the old session's expiry) must keep its
        fresh subscription set and slot."""
        with self._lock:
            topics = list(self.subscription.get(sid, ()))
        for topic in topics:
            self.unsubscribe(sid, topic)
        with self._lock:
            remaining = self.subscription.get(sid)
            if remaining is not None and not remaining:
                self.subscription.pop(sid, None)
            if not self.subscription.get(sid):
                self.slots.release(sid)
        return len(topics)

    def subscriptions(self, sid: Sid) -> list[tuple[str, SubOpts]]:
        with self._lock:
            return [
                (t, self.suboption[(sid, t)])
                for t in self.subscription.get(sid, ())
            ]

    # -- publish (emqx_broker.erl:218-232) ----------------------------------

    def publish(self, msg: Message) -> dict[Sid, list[tuple[str, Message]]]:
        """Host-path publish of one message. Returns local deliveries
        {sid: [(sub_topic, msg)]}; remote routes are forwarded."""
        msg = self.hooks.run_fold("message.publish", (), msg)
        if msg is None or msg.headers.get("allow_publish") is False:
            self._inc("messages.dropped")
            return {}
        self._inc("messages.publish")
        return self._route(msg.topic, msg)

    def publish_batch(
        self, msgs: Sequence[Message]
    ) -> list[dict[Sid, list[tuple[str, Message]]]]:
        """Device-path publish: one kernel launch for the whole batch
        (falls back to the host oracle per overflow/too-long topic)."""
        return self.publish_batch_collect(self.publish_batch_submit(msgs))

    def publish_batch_submit(self, msgs: Sequence[Message],
                             force_host: bool = False, trace=None):
        """Stage 1: run the publish hooks and dispatch the routing
        kernel; returns an opaque token for ``publish_batch_collect``.
        The pipeline overlaps the in-flight device step with the next
        batch's hooks (double-buffering).

        ``force_host=True`` answers from the host oracle without a
        device launch — the pipeline's small-batch latency bypass
        (below the RTT knee the oracle walk is faster than the
        dispatch). Rules then match in the
        message.publish hook as on the plain host path.

        ``trace``: the batch's ``BatchTrace`` (or False / None, see
        ``observe.trace.BatchTrace``); a traced batch gets the
        ``broker.fold`` span (the ``message.publish`` hook fold and the
        dropped-message check, up to the model's submit), and the
        model's spans."""
        if trace:
            t_fold = _tracing.now_ns()
        cobatch = (not force_host
                   and self.rules_matched_fn is not None
                   and self.rules_gate_fn is not None
                   and self.model is not None)
        if cobatch:
            # the rule engine defers to the kernel's matches (delivered
            # via rules_matched_fn below) instead of matching in the
            # message.publish hook — one trie walk for fan-out AND rules.
            # Gated via thread-local state, NOT a message header: hooks
            # may store copies (delayed queue, retainer) that a header
            # would poison past this batch.
            self.rules_gate_fn(True)
        try:
            msgs = [
                self.hooks.run_fold("message.publish", (), m) for m in msgs
            ]
        finally:
            if cobatch:
                self.rules_gate_fn(False)
        live = []
        for i, m in enumerate(msgs):
            if m is None or m.headers.get("allow_publish") is False:
                self._inc("messages.dropped")     # same as publish()
                if cobatch and m is not None:
                    # host-path hook order runs rules BEFORE the deny
                    # (rules prio -50, retainer -100): a denied-but-real
                    # message still rule-matches (host trie)
                    self.rules_matched_fn(m, None)
            else:
                live.append((i, m))
        out: list[dict[Sid, list[tuple[str, Message]]]] = [{} for _ in msgs]
        if trace:
            trace.span("broker.fold", t_fold, _tracing.now_ns(), len(msgs))
        if not live:
            return (msgs, live, cobatch, out, None)
        if self.model is None or force_host:
            return (msgs, live, cobatch, out, None)
        try:
            pending = self.model.publish_batch_submit(
                [m.topic for _, m in live], trace=trace)
        except Exception:  # noqa: BLE001 — device loss / reset / OOM
            if _on_card(self.model):
                raise
            # device-loss failover: the host oracle serves the batch
            # (pending=None token) instead of dropping it; matching is
            # replicated on the host, so only latency degrades
            self._device_failover("submit")
            return (msgs, live, cobatch, out, None)
        return (msgs, live, cobatch, out, pending)

    def _device_failover(self, stage: str) -> None:
        import logging

        self._inc("messages.device_failover")
        if self.ledger is not None:
            self.ledger.record("device_failover", 1, detail=stage)
        logging.getLogger("emqx_tpu_torch.broker").exception(
            "device router %s failed; batch served by the host oracle",
            stage)

    def publish_batch_collect(
        self, token, trace=None
    ) -> list[dict[Sid, list[tuple[str, Message]]]]:
        """Stage 2: collect a submitted batch's routing results and
        build the per-session delivery map.

        A traced batch (``trace``, its ``BatchTrace``) gets the
        ``broker.collect`` span over the whole stage, and over the rows
        the step matched the counters ``expand_ns`` / ``expand_probes``
        / ``deliveries`` (the filter-first expansion: the matched
        filters' subscribers checked against the row's slots, and the
        deliveries they gave) and ``route_walk_ns`` /
        ``route_walks`` / ``route_walk_hits`` (the host route walk for
        shared and remote legs, and the walks that found one),
        ``route_walk_away`` (the walks over the router's away index
        alone) and ``away_routes`` (that index's routes)."""
        if not trace:
            return self._collect_batch(token, False)
        t0 = _tracing.now_ns()
        try:
            return self._collect_batch(token, trace)
        finally:
            trace.span("broker.collect", t0, _tracing.now_ns(),
                       len(token[0]))

    def _collect_batch(self, token, trace):
        msgs, live, cobatch, out, pending = token
        if not live:
            return out
        if pending is None:                    # host-oracle path
            for i, m in live:
                self._inc("messages.publish")
                if cobatch:
                    # cobatch with no device result = submit-side device
                    # failover: the rules deferred to the kernel, so they
                    # must re-match on the host trie here
                    self.rules_matched_fn(m, None)
                out[i] = self._route(m.topic, m)
            return out
        if isinstance(pending, tuple) and len(pending) == 2 \
                and pending[0] == "host":
            # cpu host-matcher served this batch instead of the kernel:
            # count it in its fixed slot and on the degradation ledger,
            # next to device_failover — same seam, softer reason
            self._inc("messages.kernel.hostmatch")
            if self.ledger is not None:
                self.ledger.record("kernel_hostmatch", 1,
                                   detail="cpu host dispatch")
        try:
            matched, aux, slots, fallback = self.model.publish_batch_collect(
                pending)
        except Exception:  # noqa: BLE001 — device lost mid-flight
            if _on_card(self.model):
                raise
            # collect-side failover: the submitted launch died with the
            # device; re-route the whole batch on the host oracle (rules
            # re-match on the host trie when cobatched)
            self._device_failover("collect")
            for i, m in live:
                self._inc("messages.publish")
                if cobatch:
                    self.rules_matched_fn(m, None)
                out[i] = self._route(m.topic, m)
            return out
        fb = set(fallback)
        if fb:
            # rows the kernel punted (frontier/candidate overflow or
            # too-long topic) re-route on the host oracle below; record
            # the degradation with its row count so an operator sees
            # capacity pressure before it becomes a failover
            if self.ledger is not None:
                self.ledger.record(
                    "kernel_overflow", len(fb),
                    detail="device overflow; host-oracle fallback")
            else:
                self._inc("messages.ledger.kernel_overflow", len(fb))
        batch_legs: list = []    # (out index, msg, group, route topic)
        subscriber, slot_of = self.subscriber, self.slots.lookup_slot
        # the step delivered this node's own routes: where the router's
        # home is this node, walk only the routes that are not
        away = self.router.home == self.node
        walk = (self.router.match_away_routes if away
                else self.router.match_routes)
        delivered = 0
        if trace:
            expand_ns = probes = walk_ns = walks = hits = 0
        for j, (i, m) in enumerate(live):
            self._inc("messages.publish")
            if j in fb:
                if cobatch:
                    self.rules_matched_fn(m, None)  # host-match rules
                out[i] = self._route(m.topic, m)   # oracle fallback
                continue
            if cobatch:
                # aux alone suffices: every rule FROM filter is
                # aux-registered (subscriber-shared ones included)
                self.rules_matched_fn(m, aux[j])
            if trace:
                t_expand = _tracing.now_ns()
            # filter-first: each matched filter's own subscribers (a plain
            # subscription keys ``subscriber`` by the filter itself), kept
            # where the step delivers this row to their slot.  Each set is
            # copied in one C call: a concurrent subscribe or unsubscribe
            # of the filter changes it outside the lock
            deliveries: dict[Sid, list[tuple[str, Message]]] = {}
            if matched[j]:
                row_slots = set(slots[j])
                for filt in matched[j]:
                    for sid in tuple(subscriber.get(filt, ())):
                        if slot_of(sid) in row_slots:
                            deliveries.setdefault(sid, []).append((filt, m))
                            delivered += 1
            if trace:
                t_walk = _tracing.now_ns()
            # shared groups + remote nodes still come from the route
            # table; shared legs are COLLECTED here and dispatched once
            # for the whole batch below (one SharedSub lock hold)
            shared_legs, nonlocal_legs = self._collect_nonlocal(
                walk(m.topic), m)
            if trace:
                walk_ns += _tracing.now_ns() - t_walk
                expand_ns += t_walk - t_expand
                probes += sum(len(subscriber.get(f, ())) for f in matched[j])
                walks += 1
                hits += nonlocal_legs > 0
            for group, rtopic in shared_legs:
                batch_legs.append((i, m, group, rtopic))
            if not matched[j] and not nonlocal_legs:
                # hook/metric parity with the host path (_route): rules on
                # $events/message_dropped and dashboards keep working with
                # the device router enabled
                self._inc("messages.dropped.no_subscribers")
                self.hooks.run("message.dropped", (m, "no_subscribers"))
            out[i] = deliveries
        if delivered:
            self._inc("messages.delivered", delivered)
        if trace:
            trace.counters.update(
                expand_ns=expand_ns, expand_probes=probes,
                deliveries=delivered, route_walk_ns=walk_ns,
                route_walks=walks, route_walk_hits=hits,
                route_walk_away=walks if away else 0,
                away_routes=self.router.away_count)
        self._dispatch_shared_batch(batch_legs, out)
        return out

    def _collect_nonlocal(self, routes, msg: Message):
        """``routes`` (a message's matched routes; this node's own may be
        left out) -> ([(group, route_topic)], total nonlocal legs); remote
        forwards are executed inline (they are per-destination IO, not
        strategy picks)."""
        seen_groups = set()
        shared_legs = []
        legs = 0
        for route in routes:
            dest = route.dest
            if isinstance(dest, tuple):
                group = dest[0]
                if (group, route.topic) not in seen_groups:
                    seen_groups.add((group, route.topic))
                    legs += 1
                    shared_legs.append((group, route.topic))
            elif dest != self.node and self.forward_fn is not None:
                self.forward_fn(dest, route.topic, msg)
                self._inc("messages.forward")
                self._inc("messages.forward.slow")
                legs += 1
        return shared_legs, legs

    def _dispatch_shared_batch(self, batch_legs, out) -> None:
        if not batch_legs:
            return
        if self.shared_dispatch_batch is not None:
            results = self.shared_dispatch_batch(
                [(g, t, m) for (_i, m, g, t) in batch_legs])
        elif self.shared_dispatch is not None:
            results = [self.shared_dispatch(g, t, m)
                       for (_i, m, g, t) in batch_legs]
        else:
            return
        for (i, m, _g, _t), picks in zip(batch_legs, results):
            for sid, sub_topic in picks:
                out[i].setdefault(sid, []).append((sub_topic, m))
                self._inc("messages.delivered")

    # -- dispatch (emqx_broker.erl:264-337, :546-579) ------------------------

    def _route(self, topic: str, msg: Message) -> dict[Sid, list[tuple[str, Message]]]:
        deliveries: dict[Sid, list[tuple[str, Message]]] = {}
        routes = self.router.match_routes(topic)
        if not routes:
            self._inc("messages.dropped.no_subscribers")
            self.hooks.run("message.dropped", (msg, "no_subscribers"))
        seen_groups = set()
        for route in routes:
            dest = route.dest
            if isinstance(dest, tuple):        # ({group, node}) shared
                # one dispatch per {group, topic-filter} route: the same
                # group may subscribe via several matching filters with
                # disjoint membership lists
                group = dest[0]
                if (group, route.topic) in seen_groups:
                    continue
                seen_groups.add((group, route.topic))
                if self.shared_dispatch is not None:
                    for sid, sub_topic in self.shared_dispatch(
                        group, route.topic, msg
                    ):
                        deliveries.setdefault(sid, []).append((sub_topic, msg))
            elif dest == self.node:
                self._dispatch_local(route.topic, msg, deliveries)
            elif self.forward_fn is not None:
                self.forward_fn(dest, route.topic, msg)
                self._inc("messages.forward")
                # the slow half of the forward split: the Python
                # forward_fn lane, next to messages.forward.native
                # (trunked legs counted by the native server's merge)
                self._inc("messages.forward.slow")
        return deliveries

    def _dispatch_local(
        self, filt: str, msg: Message,
        deliveries: dict[Sid, list[tuple[str, Message]]],
    ) -> None:
        for sid in self.subscriber.get(filt, ()):
            deliveries.setdefault(sid, []).append((filt, msg))
            self._inc("messages.delivered")

