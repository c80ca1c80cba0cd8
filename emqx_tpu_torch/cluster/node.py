"""Cluster node — binds a BrokerApp to the cluster planes.

Responsibilities and their reference counterparts:

- **route replication** (mria rlog, ``emqx_router.erl:78-92``): every
  local route mutation appends to the Router's delta log; ``flush``
  pushes per-peer delta streams (``rlog.apply_deltas``); a trimmed log or
  fresh joiner triggers full ``rlog.bootstrap``. Each node thus holds a
  full route-table replica and match stays node-local
  (emqx_router.erl:148-153's design decision).
- **message forwarding** (gen_rpc, ``emqx_broker.erl:302-324``): routes
  whose dest is a peer node cast ``broker.dispatch`` on the peer's
  ordered lane.
- **shared subscriptions** (``emqx_shared_sub.erl``): membership
  replicates via ``rlog.shared_delta`` into the node-aware member table;
  the publishing node's strategy picks ONE member cluster-wide, remote
  members get ``shared_sub.deliver``.
- **clientid registry + takeover** (``emqx_cm_registry`` /
  ``emqx_cm_proto_v1``): connects broadcast ``rlog.registry_delta``; a
  resume finding the session on a peer calls ``cm.takeover``, which
  serializes the session (subscriptions + pending queue) and tears down
  the old owner — the 2-phase takeover of emqx_cm.erl:377-429.
- **failure detection** (``emqx_router_helper``): missed heartbeats mark
  a peer down; its routes, shared members and registry entries purge; a
  succeeding ping re-bootstraps both sides (ekka autoheal analogue).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from emqx_tpu_torch.app import BrokerApp
from emqx_tpu_torch.cluster import bpapi, codec
from emqx_tpu_torch.cluster.transport import Transport, TransportError
from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.session.session import Session


class ClusterNode:
    def __init__(self, name: str, transport: Transport,
                 app: Optional[BrokerApp] = None,
                 heartbeat_misses: int = 2,
                 role: str = "core", **app_kw: Any) -> None:
        self.name = name
        # mria core/replicant split (emqx_machine.erl:86-87): cores
        # coordinate config txns and serve bootstrap; replicants
        # forward writes and replicate
        self.role = role
        self.transport = transport
        self.app = app or BrokerApp(node=name, forward_fn=self._forward,
                                    **app_kw)
        if self.app.broker.forward_fn is None:
            self.app.broker.forward_fn = self._forward
        self.app.broker.shared_dispatch = self._shared_dispatch
        self.registry: dict[str, str] = {}        # clientid → node
        # topic → (sid, node) for $exclusive holders on OTHER nodes; local
        # holders live in broker.exclusive (emqx_exclusive_subscription's
        # cluster-wide mnesia table, split per node here)
        self.exclusive_remote: dict[str, tuple[str, str]] = {}
        # topic → sid for claims WE are acquiring or hold: registered
        # BEFORE the peer RPC so a concurrent claim from another node
        # sees it in _h_excl_try (mutual-reject, never double-grant)
        self.exclusive_local: dict[str, str] = {}
        self._excl_sync_was_nonempty = False
        self.members: dict[str, dict] = {}        # peer → {alive, missed}
        self._peer_cursor: dict[str, int] = {}    # peer → flushed seq
        self.heartbeat_misses = heartbeat_misses
        self._lock = threading.RLock()

        # per-peer negotiated rlog version (bpapi.negotiate at hello,
        # both directions); absent peer = assume v1, the frozen floor
        self.proto_rlog: dict[str, int] = {}
        self._rlog_v2_ok = 2 in bpapi.supported_versions().get("rlog", [])

        # native cluster trunk (round 9): when this node's listener is
        # a NativeBrokerServer with a trunk port, hello/ping advertise
        # it and peers' advertisements wire trunk links — cross-node
        # QoS0/1 publishes then ride the C++ plane; everything else
        # (and every non-native peer) stays on the Python lanes below
        self.native_server = None
        self._trunk_advertise_host = "127.0.0.1"

        t = self.transport
        t.register("broker.dispatch", self._h_dispatch)
        t.register("shared_sub.deliver", self._h_shared_deliver)
        t.register("cm.takeover", self._h_takeover)
        t.register("cm.kick", self._h_kick)
        t.register("cm.lookup", self._h_lookup)
        t.register("rlog.apply_deltas", self._h_apply_deltas)
        if self._rlog_v2_ok:
            # the v2 compact delta wire exists only where v2 is
            # registered (EMQX_BPAPI_RLOG_V2) — a v1 peer can never be
            # sent to it because flush() gates on the negotiated version
            t.register("rlog.apply_deltas2", self._h_apply_deltas2)
        t.register("rlog.bootstrap", self._h_bootstrap)
        t.register("rlog.shared_delta", self._h_shared_delta)
        t.register("rlog.registry_delta", self._h_registry_delta)
        t.register("excl.try", self._h_excl_try)
        t.register("excl.release", self._h_excl_release)
        t.register("excl.sync", self._h_excl_sync)
        t.register("node.hello", self._h_hello)
        t.register("node.ping", self._h_ping)
        t.register("node.bye", self._h_bye)

        # cluster-replicated config transactions (emqx_cluster_rpc)
        from emqx_tpu_torch.cluster.conf import ClusterConf
        self.conf = ClusterConf(self)
        t.register("conf.append", self.conf.h_append)
        t.register("conf.commit", self.conf.h_commit)
        t.register("conf.catchup", self.conf.h_catchup)
        t.register("conf.status", self.conf.h_status)
        config = getattr(self.app, "config", None)
        if config is not None:
            # PUT /configs (and every cluster-layer Config.put) becomes
            # a cluster-wide transaction
            config.cluster_fn = self.conf.multicall

        hooks = self.app.hooks
        hooks.add("session.subscribed", self._on_subscribed, priority=-500)
        hooks.add("session.unsubscribed", self._on_unsubscribed,
                  priority=-500)
        hooks.add("client.connected", self._on_client_connected,
                  priority=-500)
        hooks.add("session.terminated", self._on_session_gone,
                  priority=-500)
        hooks.add("session.discarded", self._on_session_gone,
                  priority=-500)
        # cluster-wide $exclusive locking seam (broker/broker.py)
        self.app.broker.exclusive_try_fn = self._exclusive_try
        self.app.broker.exclusive_release_fn = self._exclusive_release
        # cross-node session lookup/takeover seam
        self._orig_open_session = self.app.cm.open_session
        self.app.cm.open_session = self._open_session
        self.app.add_ticker(self.tick)   # heartbeat on app housekeeping

    # -- native trunk wiring ------------------------------------------------

    def attach_native(self, server, advertise_host: str = "127.0.0.1"
                      ) -> None:
        """Bind a NativeBrokerServer with a trunk listener to this
        node: hello/ping now advertise the trunk address, and peers'
        advertisements dial it. Call before join() (a later attach
        converges on the next heartbeat round)."""
        self.native_server = server
        self._trunk_advertise_host = advertise_host

    def _trunk_advert(self):
        srv = self.native_server
        if srv is None or getattr(srv, "trunk_port", None) is None:
            return None
        return [self._trunk_advertise_host, srv.trunk_port]

    def _learn_trunk(self, node: str, trunk) -> None:
        """Record a peer's advertised trunk address (idempotent for an
        unchanged address — trunk_register re-dials only on change)."""
        if self.native_server is None or not trunk:
            return
        try:
            self.native_server.trunk_register(node, trunk[0],
                                              int(trunk[1]))
        except Exception:                     # noqa: BLE001 — advisory
            # a bad advert must not poison membership: the Python
            # forward lane keeps carrying this peer's traffic
            pass

    # -- membership ---------------------------------------------------------

    def join(self, seeds: list[str]) -> None:
        """Static-seed discovery (ekka join): hello each seed, learn the
        full membership, bootstrap state from the first live seed."""
        for seed in seeds:
            if seed == self.name:
                continue
            try:
                resp = self.transport.call(
                    seed, "node.hello", node=self.name,
                    versions=bpapi.supported_versions(), role=self.role,
                    trunk=self._trunk_advert())
            except TransportError:
                continue
            # compat gate + downshift: a v2 node joining a v1 cluster
            # records 1 here and speaks the v1 dict wire to this peer
            self.proto_rlog[seed] = bpapi.negotiate(resp["versions"],
                                                    "rlog")
            self._learn_trunk(seed, resp.get("trunk"))
            self._mark_alive(seed, role=resp.get("role", "core"))
            # learned members start UNVERIFIED (alive only on direct
            # contact — a dead peer in the seed's list must not receive
            # deltas that vanish silently)
            others = [m for m in resp.get("members", [])
                      if m not in (self.name, seed)]
            with self._lock:
                for other in others:
                    self.members.setdefault(
                        other, {"alive": False, "missed": 0})
            # announce ourselves; a successful hello IS the verification
            for other in others:
                try:
                    r2 = self.transport.call(
                        other, "node.hello", node=self.name,
                        versions=bpapi.supported_versions(),
                        role=self.role, trunk=self._trunk_advert())
                    self.proto_rlog[other] = bpapi.negotiate(
                        r2["versions"], "rlog")
                    self._learn_trunk(other, r2.get("trunk"))
                    self._mark_alive(other, role=r2.get("role", "core"))
                except TransportError:
                    pass
            self._bootstrap_from(seed)
            return
        # no live seed: boot as a single-node cluster (first core)

    def leave(self) -> None:
        for peer in self.alive_peers():
            try:
                self.transport.cast(peer, "node.bye", node=self.name)
            except TransportError:
                pass

    def alive_peers(self) -> list[str]:
        with self._lock:
            return [n for n, m in self.members.items() if m.get("alive")]

    def _mark_alive(self, node: str, role: Optional[str] = None) -> None:
        with self._lock:
            was_down = (node in self.members
                        and not self.members[node]["alive"])
            kept_role = role or self.members.get(node, {}).get(
                "role", "core")
            self.members[node] = {"alive": True, "missed": 0,
                                  "role": kept_role}
            if was_down:
                self._peer_cursor[node] = 0      # full re-flush of ours
        if was_down:
            # healed partition: pull the peer's state; the peer pulls
            # ours when its own ping sees us (ekka autoheal, both sides
            # resync). RPC happens OUTSIDE the lock: the peer's handler
            # takes its own lock and may call back into us.
            try:
                self._bootstrap_from(node)
                self.flush()
            except TransportError:
                with self._lock:
                    self.members[node] = {"alive": False, "missed": 99,
                                          "role": kept_role}

    def _nodedown(self, node: str) -> None:
        """Purge everything owned by a dead peer
        (emqx_router_helper:cleanup_routes + shared/registry sweeps)."""
        with self._lock:
            self.members[node] = {
                "alive": False, "missed": 99,
                "role": self.members.get(node, {}).get("role", "core")}
            dead_cids = [c for c, n in self.registry.items() if n == node]
            for cid in dead_cids:
                del self.registry[cid]
            for t in [t for t, (_, n) in self.exclusive_remote.items()
                      if n == node]:
                del self.exclusive_remote[t]
        self._drop_peer_routes(node)
        self.app.shared.node_down(node)

    def tick(self) -> None:
        """Heartbeat + route flush (housekeeping timer)."""
        self.flush()
        self.conf.tick()          # retry stalled / pull missing config txns
        with self._lock:
            holders = [{"topic": t, "sid": s}
                       for t, s in self.exclusive_local.items()]
        # claim reconciliation: skip the broadcast while the feature is
        # idle (one final empty sync after the last claim disappears is
        # all the GC needs — steady-state O(nodes²) chatter otherwise)
        if holders or self._excl_sync_was_nonempty:
            self._broadcast("excl.sync", holders=holders)
        self._excl_sync_was_nonempty = bool(holders)
        with self._lock:
            peers = list(self.members)
        for peer in peers:
            try:
                resp = self.transport.call(peer, "node.ping",
                                           node=self.name, role=self.role,
                                           trunk=self._trunk_advert())
                if isinstance(resp, dict):
                    self._learn_trunk(peer, resp.get("trunk"))
                self._mark_alive(
                    peer, role=(resp.get("role")
                                if isinstance(resp, dict) else None))
            except TransportError:
                with self._lock:
                    m = self.members.get(peer)
                    if m is None:
                        continue
                    m["missed"] = m.get("missed", 0) + 1
                    down_now = (m["alive"]
                                and m["missed"] >= self.heartbeat_misses)
                if down_now:
                    self._nodedown(peer)

    # -- route replication --------------------------------------------------

    def _own_deltas(self, deltas) -> list[dict]:
        mine = []
        for d in deltas:
            dest = d.dest
            if dest == self.name or (
                    isinstance(dest, tuple) and dest[1] == self.name):
                mine.append({"op": d.op, "topic": d.topic, "dest": dest})
        return mine

    def flush(self) -> None:
        """Push pending route deltas to every live peer. Replication is
        a confirmed ``call`` (mria transactions are acked) — the cursor
        only advances on success, so a dropped frame is retransmitted
        next flush; the message-forwarding lane stays fire-and-forget."""
        router = self.app.broker.router
        head = router.seq
        for peer in self.alive_peers():
            with self._lock:
                cursor = self._peer_cursor.get(peer, 0)
            if cursor >= head:
                continue
            deltas = router.deltas_since(cursor)
            try:
                if deltas is None:
                    # our log no longer reaches the peer's cursor: the
                    # peer re-pulls a full snapshot (replicant bootstrap)
                    self.transport.call(peer, "rlog.apply_deltas",
                                        from_node=self.name, deltas=None)
                else:
                    mine = self._own_deltas(deltas)
                    if mine:
                        if (self._rlog_v2_ok
                                and self.proto_rlog.get(peer, 1) >= 2):
                            # negotiated v2 both ways: compact tuple wire
                            self.transport.call(
                                peer, "rlog.apply_deltas2",
                                from_node=self.name,
                                deltas=[(d["op"], d["topic"], d["dest"])
                                        for d in mine])
                        else:
                            self.transport.call(peer, "rlog.apply_deltas",
                                                from_node=self.name,
                                                deltas=mine)
                with self._lock:
                    self._peer_cursor[peer] = max(
                        self._peer_cursor.get(peer, 0), head)
            except TransportError:
                pass                              # retried next flush

    def _h_apply_deltas(self, from_node: str,
                        deltas: Optional[list]) -> None:
        router = self.app.broker.router
        if deltas is None:                        # sender asks us to re-pull
            self._drop_peer_routes(from_node)
            self._bootstrap_from(from_node)
            return
        for d in deltas:
            if d["op"] == "add":
                router.add_route(d["topic"], d["dest"])
            else:
                router.delete_route(d["topic"], d["dest"])

    def _h_apply_deltas2(self, from_node: str, deltas: list) -> None:
        """rlog v2 wire: (op, topic, dest) tuples (bpapi.RLOG_V2)."""
        router = self.app.broker.router
        for op, topic, dest in deltas:
            if op == "add":
                router.add_route(topic, dest)
            else:
                router.delete_route(topic, dest)

    def _drop_peer_routes(self, node: str) -> None:
        router = self.app.broker.router
        router.cleanup_dest(node)
        for t in list(router.topics()):
            for r in router.lookup_routes(t):
                if isinstance(r.dest, tuple) and r.dest[1] == node:
                    router.delete_route(t, r.dest)

    def _snapshot(self) -> dict:
        """Everything a joiner needs: all routes we know (ours + third
        party), shared membership, clientid registry."""
        router = self.app.broker.router
        routes = []
        for t in router.topics():
            for r in router.lookup_routes(t):
                routes.append({"topic": t, "dest": r.dest})
        shared = [
            {"group": g, "topic": tp, "sid": sid, "node": node}
            for (g, tp), ms in self.app.shared.members().items()
            for sid, node in ms
        ]
        with self._lock:
            registry = dict(self.registry)
            exclusive = [{"topic": t, "sid": s, "node": n}
                         for t, (s, n) in self.exclusive_remote.items()]
            exclusive += [{"topic": t, "sid": s, "node": self.name}
                          for t, s in self.exclusive_local.items()]
        return {"routes": routes, "shared": shared,
                "registry": registry, "exclusive": exclusive,
                "conf": self.conf.snapshot(), "node": self.name}

    def _apply_snapshot(self, snap: dict) -> None:
        router = self.app.broker.router
        for r in snap["routes"]:
            dest = r["dest"]
            if dest != self.name and not (
                    isinstance(dest, tuple) and dest[1] == self.name):
                router.add_route(r["topic"], dest)
        for s in snap["shared"]:
            if s["node"] != self.name:
                self.app.shared.join(s["group"], s["topic"], s["sid"],
                                     node=s["node"])
        with self._lock:
            for cid, node in snap["registry"].items():
                if node != self.name:
                    self.registry[cid] = node
            for e in snap.get("exclusive", ()):
                if e["node"] != self.name:
                    self.exclusive_remote.setdefault(
                        e["topic"], (e["sid"], e["node"]))
        # config-txn catch-up on join (emqx_cluster_rpc.erl:92-105)
        self.conf.apply_snapshot(snap.get("conf", {}),
                                 from_node=snap.get("node", ""))

    def _bootstrap_from(self, peer: str) -> None:
        snap = self.transport.call(peer, "rlog.bootstrap",
                                   from_node=self.name)
        self._apply_snapshot(snap)
        self._peer_cursor.setdefault(peer, 0)

    def _h_bootstrap(self, from_node: str) -> dict:
        if from_node not in self.members:
            self._mark_alive(from_node)
        return self._snapshot()

    # -- forwarding (gen_rpc lane) ------------------------------------------

    def _forward(self, dest: str, filt: str, msg: Message) -> None:
        with self._lock:
            alive = self.members.get(dest, {}).get("alive", False)
        if not alive:
            return                    # stale route; purge is in flight
        try:
            # the broker's _route counts messages.forward for this leg
            # per-topic lane keeps one topic's messages ordered while
            # different topics parallelize (gen_rpc key, emqx_rpc.erl:79)
            self.transport.cast(dest, "broker.dispatch", _key=filt,
                                filter=filt, msg=codec.msg_to_dict(msg))
        except TransportError:
            pass

    def _h_dispatch(self, filter: str, msg: dict) -> int:
        """Remote leg of emqx_broker:dispatch/2 (emqx_broker.erl:326-337)."""
        m = codec.msg_from_dict(msg)
        deliveries: dict[str, list] = {}
        self.app.broker._dispatch_local(filter, m, deliveries)
        self.app.cm.dispatch(deliveries)
        return len(deliveries)

    # -- shared subscriptions -----------------------------------------------

    def _shared_dispatch(self, group: str, topic: str, msg: Message):
        def deliver_fn(sid: str, node: str) -> bool:
            if node == self.name:
                ch = self.app.cm.lookup_channel(sid)
                return ch is not None and ch.conn_state == "connected"
            return self.members.get(node, {}).get("alive", False)

        local = []
        for sid, node, sub_topic in self.app.shared.dispatch(
                group, topic, msg, deliver_fn=deliver_fn):
            if node == self.name:
                local.append((sid, sub_topic))
            else:
                try:
                    self.transport.cast(
                        node, "shared_sub.deliver", _key=sub_topic,
                        sid=sid, sub_topic=sub_topic,
                        msg=codec.msg_to_dict(msg))
                except TransportError:
                    pass
        return local

    def _h_shared_deliver(self, sid: str, sub_topic: str, msg: dict) -> None:
        self.app.cm.dispatch(
            {sid: [(sub_topic, codec.msg_from_dict(msg))]})

    def _on_subscribed(self, sid: str, topic: str, opts,
                       is_new: bool = True) -> None:
        group, real = T.parse_share(topic)
        if group and is_new:
            self._broadcast("rlog.shared_delta", op="join", group=group,
                            topic=real, sid=sid)
        self.flush()

    def _on_unsubscribed(self, sid: str, topic: str) -> None:
        group, real = T.parse_share(topic)
        if group:
            self._broadcast("rlog.shared_delta", op="leave", group=group,
                            topic=real, sid=sid)
        self.flush()

    def _h_shared_delta(self, from_node: str, op: str, group: str,
                        topic: str, sid: str) -> None:
        if op == "join":
            self.app.shared.join(group, topic, sid, node=from_node)
        elif op == "leave":
            self.app.shared.leave(group, topic, sid, node=from_node)
        else:                                     # "down": all groups
            self.app.shared.member_down(sid)

    # -- $exclusive cluster lock --------------------------------------------
    #
    # The reference makes $exclusive cluster-wide with one mnesia
    # transaction (emqx_exclusive_subscription.erl try_subscribe).  Here
    # the acquire is peer-confirmed: every live peer must accept the
    # claim before the local subscribe proceeds.  Two nodes claiming the
    # same topic concurrently can both be rejected (each sees the
    # other's in-flight claim) — safe, never double-granted; the client
    # simply retries.  Claims are purged on release, session teardown
    # (via unsubscribe) and nodedown.

    def _exclusive_try(self, topic: str, sid: str):
        """Cluster acquire; returns the holding sid on conflict, else
        None.  Runs OUTSIDE the broker lock (broker/broker.py)."""
        with self._lock:
            mine = self.exclusive_local.get(topic)
            if mine is not None and mine != sid:
                return mine
            rh = self.exclusive_remote.get(topic)
            if rh is not None and rh[0] != sid:
                return rh[0]
            # Register the in-flight claim BEFORE any RPC: a concurrent
            # excl.try from another node must see it and reject (both
            # claimants may mutually reject — safe; never double-grant).
            self.exclusive_local[topic] = sid
        accepted: list[str] = []
        for peer in self.alive_peers():
            try:
                conflict = self.transport.call(
                    peer, "excl.try", from_node=self.name,
                    topic=topic, sid=sid)
            except TransportError:
                continue   # dead/flaky peer: its stale view of this
                #            claim reconciles via the periodic excl.sync
            if conflict is not None:
                with self._lock:
                    if self.exclusive_local.get(topic) == sid:
                        del self.exclusive_local[topic]
                for p in accepted:
                    try:
                        self.transport.cast(p, "excl.release",
                                            from_node=self.name,
                                            topic=topic, sid=sid)
                    except TransportError:
                        pass   # dangling claim on p GC'd by excl.sync
                return conflict
            accepted.append(peer)
        return None

    def _exclusive_release(self, topic: str, sid: str) -> None:
        with self._lock:
            if self.exclusive_local.get(topic) == sid:
                del self.exclusive_local[topic]
        self._broadcast("excl.release", topic=topic, sid=sid)

    def _h_excl_try(self, from_node: str, topic: str, sid: str):
        """Peer's side of the acquire: record the claim unless we know a
        different holder.  Touches only our own state — never calls back
        into the claimant (deadlock-free by construction)."""
        with self._lock:
            mine = self.exclusive_local.get(topic)
            if mine is not None and mine != sid:
                return mine
            rh = self.exclusive_remote.get(topic)
            if rh is not None and rh[0] != sid:
                return rh[0]
            self.exclusive_remote[topic] = (sid, from_node)
        return None

    def _h_excl_release(self, from_node: str, topic: str, sid: str) -> None:
        with self._lock:
            rh = self.exclusive_remote.get(topic)
            if rh is not None and rh[0] == sid:
                del self.exclusive_remote[topic]

    def _h_excl_sync(self, from_node: str, holders: list) -> None:
        """Authoritative claim set from one node: drop every claim we
        attribute to that node that it no longer asserts (GC for claims
        orphaned by lost release casts / timed-out acquires)."""
        asserted = {(h["topic"], h["sid"]) for h in holders}
        with self._lock:
            stale = [t for t, (s, n) in self.exclusive_remote.items()
                     if n == from_node and (t, s) not in asserted]
            for t in stale:
                del self.exclusive_remote[t]
            for h in holders:
                self.exclusive_remote.setdefault(
                    h["topic"], (h["sid"], from_node))

    # -- clientid registry + takeover ---------------------------------------

    def _on_client_connected(self, ci) -> None:
        cid = getattr(ci, "clientid", None)
        if cid:
            with self._lock:
                self.registry[cid] = self.name
            self._broadcast("rlog.registry_delta", op="register",
                            clientid=cid)

    def _on_session_gone(self, sid: str, *a) -> None:
        with self._lock:
            owned = self.registry.get(sid) == self.name
            if owned:
                del self.registry[sid]
        if owned:
            self._broadcast("rlog.registry_delta", op="unregister",
                            clientid=sid)
        # shared membership cleanup replicates as leaves via unsubscribe
        # hooks; a crashed channel's members go with member_down locally
        # and with registry_delta on peers
        self._broadcast("rlog.shared_delta", op="down", group="",
                        topic="", sid=sid)

    def _h_registry_delta(self, from_node: str, op: str,
                          clientid: str) -> None:
        with self._lock:
            if op == "register":
                self.registry[clientid] = from_node
            elif self.registry.get(clientid) == from_node:
                del self.registry[clientid]

    def _open_session(self, clean_start: bool, clientid: str,
                      new_channel, session_opts: Optional[dict] = None):
        """Cross-node open_session: consult the replicated registry; if
        the session lives on a peer, kick (clean start) or take it over
        (emqx_cm.erl:268-341 + cm_proto_v1)."""
        local = self.app.cm.lookup_channel(clientid)
        with self._lock:
            owner = self.registry.get(clientid)
            owner_alive = self.members.get(owner, {}).get("alive", False)
        if (local is None and owner is not None and owner != self.name
                and owner_alive):
            if clean_start:
                try:
                    self.transport.call(owner, "cm.kick",
                                        clientid=clientid)
                except TransportError:
                    pass
                return self._orig_open_session(
                    True, clientid, new_channel, session_opts)
            try:
                state = self.transport.call(owner, "cm.takeover",
                                            clientid=clientid)
            except TransportError:
                state = None
            if state is not None:
                session = Session(clientid=clientid, clean_start=False,
                                  **(session_opts or {}))
                # consume-on-ack (round 18): sessions minted OUTSIDE
                # CM.open_session must wire the settle seam too, or a
                # durable-enabled node's acks would never spend their
                # store replay markers (review finding)
                self.app.cm._wire_settle(clientid, session)
                for t, o in state["subscriptions"].items():
                    opts = codec.subopts_from_dict(o)
                    session.subscribe(t, opts)
                    self.app.broker.subscribe(clientid, t, opts)
                pending = [codec.msg_from_dict(d)
                           for d in state["pending"]]
                self.app.cm.register_channel(clientid, new_channel)
                return session, True, pending
        return self._orig_open_session(clean_start, clientid, new_channel,
                                       session_opts)

    def _h_takeover(self, clientid: str) -> Optional[dict]:
        ch = self.app.cm.lookup_channel(clientid)
        if ch is None or ch.session is None:
            return None
        session, pending = ch.takeover()
        subs = {t: codec.subopts_to_dict(o)
                for t, o in session.subscriptions.items()}
        # the old owner's broker footprint migrates with the session
        self.app.broker.subscriber_down(clientid)
        self.app.cm.unregister_channel(clientid)
        with self._lock:
            if self.registry.get(clientid) == self.name:
                del self.registry[clientid]
        self.flush()
        return {"subscriptions": subs,
                "pending": [codec.msg_to_dict(m) for m in pending]}

    def _h_kick(self, clientid: str) -> bool:
        return self.app.cm.kick(clientid)

    def _h_lookup(self, clientid: str) -> bool:
        return self.app.cm.lookup_channel(clientid) is not None

    # -- hello/ping/bye -----------------------------------------------------

    def _h_hello(self, node: str, versions: dict,
                 role: str = "core", trunk=None) -> dict:
        # record the negotiated rlog version for the REVERSE direction
        # too: our flushes to a v1 joiner must use the v1 dict wire
        self.proto_rlog[node] = bpapi.negotiate(versions, "rlog")
        self._learn_trunk(node, trunk)
        with self._lock:
            members = list(self.members) + [self.name]
        self._mark_alive(node, role=role)
        return {"versions": bpapi.supported_versions(),
                "members": members, "role": self.role,
                "trunk": self._trunk_advert()}

    def _h_ping(self, node: str, role: Optional[str] = None,
                trunk=None) -> dict:
        with self._lock:
            known_down = (node in self.members
                          and not self.members[node]["alive"])
            if node not in self.members:
                self.members[node] = {"alive": True, "missed": 0,
                                      "role": role or "core"}
            elif role is not None:
                self.members[node]["role"] = role
        if known_down:
            self._mark_alive(node, role=role)
        self._learn_trunk(node, trunk)
        # role rides the pong so a peer that learned us indirectly (seed
        # member list, no hello) still classifies us correctly — a
        # replicant misread as core could be elected coordinator; the
        # trunk advert rides it too so a late attach_native converges
        # on the next heartbeat round
        return {"pong": True, "role": self.role,
                "trunk": self._trunk_advert()}

    def _h_bye(self, node: str) -> None:
        with self._lock:
            known = node in self.members
        if known:
            if self.native_server is not None:
                # the node LEFT (not a partition): drop its trunk link
                # and replay ring for good; routes purge below
                self.native_server.trunk_unregister(node, forget=True)
            self._nodedown(node)
            with self._lock:
                self.members.pop(node, None)

    def _broadcast(self, method: str, **kwargs: Any) -> None:
        for peer in self.alive_peers():
            try:
                self.transport.cast(peer, method,
                                    from_node=self.name, **kwargs)
            except TransportError:
                pass
