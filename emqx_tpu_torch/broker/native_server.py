"""Broker listener on the native (C++ epoll) connection host.

The C++ side (``emqx_tpu_torch/native/src/host.cc``) owns sockets, framing
and — since round 4 — the PUBLISH fast path (round 6 extended it from
QoS0/1 to the full QoS0/1/2 ack plane): parse → match → fan-out →
ack exchange runs entirely in C++ against a mirror of the broker
tables, and only the frames that *need* Python (CONNECT/SUBSCRIBE,
retained, $-topics, shared subscriptions, unpermitted topics) come up
to this driver, which runs the same ``Channel`` FSM the asyncio server
uses. This is SURVEY.md §7's "host side in C++" design: the reference
runs its hot loop in per-connection BEAM processes
(emqx_connection.erl:403-440 → emqx_broker.erl:218-232); the GIL makes
that shape a ~14k msg/s ceiling in Python (BENCH_r03), so the hot loop
moves below the GIL instead.

Correctness seams (all of them fail toward the slow path, which is
always correct):

- **table mirror** — every ``broker.subscribe/unsubscribe`` (including
  session resumes) fires ``broker.sub_observers``; subscriptions that
  cannot be natively served (shared groups, persistent sessions,
  subscription ids, subscribers on other transports) are installed as
  *punt markers*: one marker in a publish's match set forwards the
  whole frame to Python, so native fan-out only runs when complete;
- **permits** — a (conn, topic) publish permit is the authz-cache
  analogue (emqx_authz cache): granted only after a first publish
  ran the full Python path and the topic matches no rules, no traces,
  no topic-metrics pattern, and authorization allows it; granted only
  once the pipeline is idle so a fast message can never overtake a
  still-queued slow one on the same topic; flushed on rule changes and
  on a TTL cadence (the authz cache TTL analogue);
- **packet ids** — native QoS1/2 deliveries use pids >= 32768
  (host.cc kNativePidBase), Python sessions stay below
  (session/session.py PKT_ID_SPACE), so subscriber acks route
  unambiguously; publisher-side QoS2 ids route by *awaiting-rel
  ownership*: the plane that accepted the PUBLISH holds the id in its
  awaiting-rel set and completes its PUBREL, so the planes can never
  double-publish one id;
- **batched ack records** (round 6) — the C++ host owns the whole
  elevated-qos window (pid allocation, inflight bitmaps, window-full →
  pending queue) and reports ONE kind-7 record per poll cycle;
  ``_on_ack_batch`` folds it into metrics, reconciles sessions
  (``session.native_ack_sync``) and re-divides the receive-maximum
  budget between the planes (caps always sum <= budget);
- **clustered nodes** — remote routes mirror into the C++ table as
  punt markers via ``router.route_observers`` (fired under the router
  lock, in table order), so a publish with any remote audience takes
  the Python path, which forwards it over the cluster plane;
- **device match lane** (round 5) — with ``device_lane`` on, permitted
  publishes park in C++ while their topics batch through the
  RouterModel kernel; the response names each message's matched filter
  strings and C++ fans out via exact per-filter lookup
  (``router.h MatchFilter``), so the wildcard walk runs on the DEVICE
  at scale while delivery semantics (qos, no-local, shared rotation,
  punt markers) stay in C++. Every failure mode — soft cap, per-topic
  flood, pump death, stale responses — falls back to the per-message
  walk or the Python path, both always correct. Punt markers are
  double-checked against a punt-only trie because the device model
  cannot see remote-route markers.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import struct
import threading
import time
import zlib
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from emqx_tpu_torch import native
from emqx_tpu_torch.broker.broker import Broker, _on_card
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.broker.cm import CM
from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import now_ms
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import FrameError, parse_one, serialize
from emqx_tpu_torch.observe.metrics import DegradationLedger
from emqx_tpu_torch.observe.trace import SpanCollector

log = logging.getLogger("emqx_tpu_torch.native_server")

HOUSEKEEP_INTERVAL = 5.0
PERMIT_TTL_S = 60.0          # authz-cache TTL analogue: periodic re-earn
MAX_PERMITS_PER_CONN = 4096  # mirrors host.cc's per-conn permit cap
# device-lane auto policy (hysteresis): the crossover bench shows the
# per-message C++ walk beating the batched device matcher on small
# tables — the lane only pays once the wildcard table is big
LANE_AUTO_ON_FILTERS = 50_000
LANE_AUTO_OFF_FILTERS = 25_000
LANE_MAX_BATCH = 16_384
LANE_PIPE_DEPTH = 2          # submitted-but-uncollected device batches
LANE_STALE_BACKOFF_S = 30.0  # sit-out after a C++ stale trip
TRUNK_RETRY_S = 1.0          # redial cadence for a down trunk peer
TRUNK_RETRY_CAP_S = 30.0     # exponential-backoff ceiling
# ±25% redial jitter (round 15): a healed partition must not wake every
# peer's redial on the same capped boundary (full-mesh thundering herd)
TRUNK_RETRY_JITTER = 0.25
# Dynamic inflight-cap policy (re-derived for the sharded plane —
# README "Multi-core native plane" carries the full derivation). The
# policy is PER-CONN, and a conn lives on exactly one shard, so it is
# per-shard by construction; the constants are shard-count-invariant:
# - CAP_HEADROOM x occupancy covers demand that doubles within one
#   kind-7 reporting cycle. Reporting stays per-shard-cycle under
#   shards; the only new lag is the N poll threads' folds serializing
#   behind the GIL, measured < 15% cycle stretch at N=2 on the 2-core
#   container — far inside the 2x headroom.
# - the deadband (budget/CAP_DEADBAND_DIV, floored at
#   CAP_DEADBAND_MIN) must exceed per-cycle occupancy jitter, which
#   scales with cycle LENGTH, not shard count: per-shard cycles are
#   unchanged, so 1/8 stands. Re-dividing every wiggle taxed the data
#   plane measurably when tuned (round 6) — the cap op is an
#   enqueue+wake the owner shard must apply before its next read.
CAP_HEADROOM = 2
CAP_DEADBAND_DIV = 8
CAP_DEADBAND_MIN = 8


class _NativeConn:
    __slots__ = ("conn_id", "channel", "server", "fast", "sn", "coap",
                 "recv_budget", "native_cap", "native_ka")

    def __init__(self, server: "NativeBrokerServer", conn_id: int, peer: str):
        self.server = server
        self.conn_id = conn_id
        self.fast = False
        # MQTT-SN datagram conns (peer "sn:..."): their frames arrive
        # pre-translated to MQTT by the C++ gateway; the housekeep
        # keepalive feed covers them even when not fast (UDP peers
        # never deliver a socket-close signal)
        self.sn = peer.startswith("sn:")
        # CoAP datagram conns (peer "coap:..."): same shape — frames
        # arrive pre-translated to MQTT by the C++ gateway
        self.coap = peer.startswith("coap:")
        self.recv_budget = 0     # receive-maximum budget split across planes
        self.native_cap = 0      # the native plane's current share
        # keepalive lives on the C++ timer wheel (armed post-CONNACK):
        # the Python housekeep stops scanning this conn's idle clock
        self.native_ka = False
        pipeline = server.pipeline
        self.channel = Channel(
            server.broker, server.cm,
            mountpoint=server.mountpoint,
            send=self._send_packets,
            publish_sink=pipeline.submit if pipeline is not None else None,
            session_opts=server.session_opts,
        )
        self.channel.conninfo.peername = peer

    def _send_packets(self, pkts) -> None:
        data = b"".join(
            serialize(p, self.channel.conninfo.proto_ver) for p in pkts)
        if data:
            # Python-plane egress implies possible session timer work
            # (retry / awaiting-rel expiry): re-enter the housekeep
            # scan set; the scan drops the conn again once idle
            self.server._scan_watch(self)
            self.server.host.send(self.conn_id, data)


class _ShardedHost:
    """The ``NativeHost`` control surface over N shard hosts (round 12).

    One instance per sharded server; routes each call to the right
    place so every existing call site works unchanged:

    - **per-conn ops** (send/close/fast flags/permits/traces/caps/
      retained delivery/idle probe) go to the shard whose prefix the
      conn id carries (``native.shard_of``) — conn ids are minted with
      bits 56-58 = shard, so the owner is always derivable;
    - **table ops** (sub/shared/durable entries, retained mirror, SN
      predefined ids, lane/qos/telemetry switches, permit flushes,
      trunk ROUTES) broadcast to every shard: the match table is
      replicated, each shard applies ops in its own ApplyPending;
    - **trunk LINK ops** (connect/disconnect) go to the peer's OWNER
      shard — peer P's dialer, replay ring, and authoritative state
      live on shard ``P % N`` (round 15; links used to pin to shard
      0). Every shard's trunk listener shares one port via
      SO_REUSEPORT; non-owner shards ring-forward remote legs to the
      owner (host.cc XShip → kTrunkOwnerBase target);
    - **aggregates** (stats, lane backlog) sum across shards.
    """

    def __init__(self, hosts: list):
        self.hosts = hosts
        self.port = hosts[0].port

    # a wedged poll thread leaks EVERY shard host (any of the N poll
    # threads may still be inside emqx_host_poll) — and the ring group,
    # whose doorbells a leaked host's producers may still write
    @property
    def leaked(self) -> bool:
        return any(h.leaked for h in self.hosts)

    @leaked.setter
    def leaked(self, v: bool) -> None:
        for h in self.hosts:
            h.leaked = v

    # ports resolved by the per-shard listen calls in __init__
    @property
    def ws_port(self) -> int:
        return self.hosts[0].ws_port

    @property
    def trunk_port(self) -> int:
        return self.hosts[0].trunk_port

    @property
    def sn_port(self) -> int:
        return self.hosts[0].sn_port

    @property
    def coap_port(self) -> int:
        return self.hosts[0].coap_port

    def _of(self, conn: int):
        return self.hosts[native.shard_of(conn) % len(self.hosts)]

    # -- per-conn ops (routed by the conn id's shard prefix) -----------------

    def send(self, conn, data):
        self._of(conn).send(conn, data)

    def close_conn(self, conn):
        self._of(conn).close_conn(conn)

    def enable_fast(self, conn, proto_ver, max_inflight=0, clientid=""):
        self._of(conn).enable_fast(conn, proto_ver, max_inflight,
                                   clientid)

    def disable_fast(self, conn):
        self._of(conn).disable_fast(conn)

    def permit(self, conn, topic):
        self._of(conn).permit(conn, topic)

    def set_trace(self, conn, on):
        self._of(conn).set_trace(conn, on)

    def set_inflight_cap(self, conn, cap):
        self._of(conn).set_inflight_cap(conn, cap)

    def set_keepalive(self, conn, deadline_ms):
        self._of(conn).set_keepalive(conn, deadline_ms)

    def retain_deliver(self, conn, filter_, max_qos=0):
        self._of(conn).retain_deliver(conn, filter_, max_qos)

    def conn_idle_ms(self, conn):
        # poll-thread-only on the OWNING shard (the per-shard housekeep
        # scan runs on that shard's thread; C++ refuses -2 otherwise)
        return self._of(conn).conn_idle_ms(conn)

    # -- table ops (broadcast: the match table is replicated) ----------------

    def sub_add(self, owner, filter_, qos=0, flags=0):
        for h in self.hosts:
            h.sub_add(owner, filter_, qos, flags)

    def sub_del(self, owner, filter_):
        for h in self.hosts:
            h.sub_del(owner, filter_)

    def shared_add(self, token, conn, filter_, qos=0, flags=0):
        # the member entry replicates everywhere; a match on a foreign
        # shard ships the delivery to the member's shard over the ring
        for h in self.hosts:
            h.shared_add(token, conn, filter_, qos, flags)

    def shared_del(self, token, conn, filter_):
        for h in self.hosts:
            h.shared_del(token, conn, filter_)

    def durable_add(self, token, filter_, qos=0):
        for h in self.hosts:
            h.durable_add(token, filter_, qos)

    def durable_del(self, token, filter_):
        for h in self.hosts:
            h.durable_del(token, filter_)

    def trunk_route_add(self, peer_id, filter_):
        # remote ENTRIES replicate (any shard can match a publish);
        # the legs converge on shard 0's links over the ring
        for h in self.hosts:
            h.trunk_route_add(peer_id, filter_)

    def trunk_route_del(self, peer_id, filter_):
        for h in self.hosts:
            h.trunk_route_del(peer_id, filter_)

    def coap_send(self, conn, data):
        self._of(conn).coap_send(conn, data)

    def coap_retain_state(self, complete):
        for h in self.hosts:
            h.coap_retain_state(complete)

    def set_coap_ack_timeout(self, ms):
        for h in self.hosts:
            h.set_coap_ack_timeout(ms)

    def sn_predefined(self, topic_id, topic):
        for h in self.hosts:
            h.sn_predefined(topic_id, topic)

    def set_retained(self, topic, payload, qos, deadline_ms=0):
        for h in self.hosts:
            h.set_retained(topic, payload, qos, deadline_ms)

    def retain_del(self, topic):
        for h in self.hosts:
            h.retain_del(topic)

    def permits_flush(self):
        for h in self.hosts:
            h.permits_flush()

    def set_lane(self, enabled):
        for h in self.hosts:
            h.set_lane(enabled)

    def set_max_qos(self, max_qos):
        for h in self.hosts:
            h.set_max_qos(max_qos)

    def set_telemetry(self, enabled, slow_ack_ms=500.0):
        for h in self.hosts:
            h.set_telemetry(enabled, slow_ack_ms)

    def set_telemetry_shift(self, shift):
        for h in self.hosts:
            h.set_telemetry_shift(shift)

    def set_park(self, enabled=True, park_after_ms=0, accept_burst=0,
                 mem_budget_bytes=0):
        for h in self.hosts:
            h.set_park(enabled, park_after_ms, accept_burst,
                       mem_budget_bytes)

    def attach_store(self, store):
        # one shared store: appends batch per flush, its single internal
        # mutex serializes the (rare) concurrent flushes across shards
        for h in self.hosts:
            h.attach_store(store)

    # -- trunk link plane (links SPREAD across shards, round 15) -------------
    # peer P's dialer, replay ring, and authoritative up/down state live
    # on shard P % n (host.cc OwnsTrunkPeer mirrors this rule); every
    # shard's trunk listener shares one port via SO_REUSEPORT so inbound
    # links hash across shards too — the shard-0 hotspot an N-node mesh
    # would otherwise measure is gone.

    def trunk_listen(self, host="127.0.0.1", port=0):
        p = self.hosts[0].trunk_listen(host, port, reuseport=True)
        for h in self.hosts[1:]:
            h.trunk_listen(host, p, reuseport=True)
        return p

    def trunk_connect(self, peer_id, host, port):
        self.hosts[peer_id % len(self.hosts)].trunk_connect(
            peer_id, host, port)

    def trunk_ident(self, peer_id, name):
        # the persisted-ring key lives on the peer's OWNER shard
        self.hosts[peer_id % len(self.hosts)].trunk_ident(peer_id, name)

    def trunk_disconnect(self, peer_id, forget=False):
        self.hosts[peer_id % len(self.hosts)].trunk_disconnect(
            peer_id, forget)

    def set_trunk_ack_timeout(self, ms):
        for h in self.hosts:
            h.set_trunk_ack_timeout(ms)

    # -- faultline (round 15) ------------------------------------------------

    _STORE_SITES = ("store_msync", "store_seg_open")

    def fault_arm(self, site, mode="errno", n_or_prob=0.0, seed=1,
                  key=0):
        # store sites live in the ONE shared store: arm once via shard 0
        # (broadcasting would reset the firing schedule N times)
        if site in self._STORE_SITES:
            self.hosts[0].fault_arm(site, mode, n_or_prob, seed, key)
            return
        # a KEY-scoped conn/trunk arm has exactly one owner shard (the
        # conn id's prefix / peer % n — the round-15 spread rule):
        # route it there so a count-limited arm fires exactly n times,
        # not n per shard (review finding). Unscoped arms (and ring
        # sites, whose key names the DESTINATION while any shard can
        # be the firing producer) broadcast: their counts/schedules
        # are PER SHARD by construction.
        if key:
            if site.startswith("conn_"):
                self._of(key).fault_arm(site, mode, n_or_prob, seed,
                                        key)
                return
            if site.startswith("trunk_"):
                self.hosts[key % len(self.hosts)].fault_arm(
                    site, mode, n_or_prob, seed, key)
                return
        for h in self.hosts:
            h.fault_arm(site, mode, n_or_prob, seed, key)

    def fault_disarm(self, site):
        if site in self._STORE_SITES:
            self.hosts[0].fault_disarm(site)
            return
        for h in self.hosts:
            h.fault_disarm(site)

    def fault_fired(self, site):
        if site in self._STORE_SITES:
            # one shared injector: summing N hosts would count aliases
            return self.hosts[0].fault_fired(site)
        return sum(h.fault_fired(site) for h in self.hosts)

    # -- aggregates ----------------------------------------------------------

    def stats(self):
        out = dict.fromkeys(native.STAT_NAMES, 0)
        for h in self.hosts:
            for k, v in h.stats().items():
                out[k] += v
        return out

    def lane_backlog(self):
        return sum(h.lane_backlog() for h in self.hosts)

    def destroy(self):
        if self.leaked:
            return
        for h in self.hosts:
            h.destroy()

    def __del__(self):  # pragma: no cover
        try:
            self.destroy()
        except Exception:
            pass


class NativeBrokerServer:
    """Same surface as ``BrokerServer`` but socket IO and the QoS0/1
    publish hot path live in C++."""

    def __init__(
        self,
        broker: Optional[Broker] = None,
        cm: Optional[CM] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_packet_size: int = 1 << 20,
        max_connections: int = 1_000_000,
        mountpoint: str = "",
        app=None,
        fast_path: bool = True,
        device_lane: str = "auto",
        session_opts: Optional[dict] = None,
        ws_port: Optional[int] = None,
        ws_path: str = "/mqtt",
        ws_host: Optional[str] = None,
        telemetry: Optional[bool] = None,
        tracing: Optional[bool] = None,
        trace_sample_shift: Optional[int] = None,
        trunk_port: Optional[int] = None,
        trunk_host: Optional[str] = None,
        durable: Optional[bool] = None,
        durable_dir: Optional[str] = None,
        durable_fsync: Optional[str] = None,
        durable_segment_bytes: Optional[int] = None,
        sn_port: Optional[int] = None,
        sn_host: Optional[str] = None,
        sn_gateway_id: int = 1,
        sn_predefined: Optional[dict] = None,
        coap_port: Optional[int] = None,
        coap_host: Optional[str] = None,
        coap_oracle=None,
        shards: int = 1,
        park: Optional[bool] = None,
        park_after_ms: int = 0,
        accept_burst: int = 0,
        conn_mem_budget: int = 0,
    ):
        if not native.available():
            raise RuntimeError(
                f"native host unavailable: {native.build_error()}")
        if app is None and broker is None:
            from emqx_tpu_torch.app import BrokerApp

            app = BrokerApp()
        self.app = app
        self.broker = broker or app.broker
        self.cm = cm or (app.cm if app else CM())
        self.mountpoint = mountpoint
        self.fast_path = fast_path and not mountpoint
        # zone session knobs (mqtt.max_inflight & co) reach every channel
        if session_opts is None and app is not None:
            session_opts = getattr(app, "session_defaults", dict)()
        self.session_opts = dict(session_opts or {})
        # -- multi-core shards (round 12) -----------------------------------
        # shards=N runs N independent epoll hosts, each with its own
        # poll thread, sharing one port via SO_REUSEPORT accept
        # sharding. The match table replicates (every table op
        # broadcasts); cross-shard delivery rides the lock-free SPSC
        # rings of a NativeShardGroup. shards=1 (the default) keeps the
        # exact unsharded host — no group, zero ring overhead.
        self.shards = max(1, min(int(shards), native.MAX_SHARDS))
        self._shard_group: Optional[native.NativeShardGroup] = None
        if self.shards > 1:
            self._shard_group = native.NativeShardGroup(self.shards)
            # shard 0 may bind an ephemeral port; the others join it.
            # EVERY listener sets SO_REUSEPORT (the kernel requires the
            # flag on all members of a reuseport group, first included)
            h0 = native.NativeHost(
                host=host, port=port, max_size=max_packet_size,
                max_conns=max_connections, reuseport=True)
            self.hosts = [h0] + [
                native.NativeHost(
                    host=host, port=h0.port, max_size=max_packet_size,
                    max_conns=max_connections, reuseport=True)
                for _ in range(1, self.shards)]
            for i, h in enumerate(self.hosts):
                h.join_group(self._shard_group, i)
            self.host = _ShardedHost(self.hosts)
        else:
            self.host = native.NativeHost(
                host=host, port=port,
                max_size=max_packet_size, max_conns=max_connections)
            self.hosts = [self.host]
        self.port = self.host.port
        # WebSocket plane (round 7): a second C++ listener runs the
        # RFC6455 handshake + frame codec below the GIL; its conns ride
        # the SAME fast path (permits, lanes, taps, QoS0/1/2 ack plane)
        # as TCP — only the transport framing differs. ws_port=None
        # keeps it off; 0 binds an ephemeral port. broker/ws.py stays
        # the asyncio slow-plane oracle (and serves non-/mqtt paths).
        self.ws_port: Optional[int] = None
        if ws_port is not None:
            # ws_host defaults to the TCP bind host but stays
            # independently configurable (e.g. loopback-only WS next to
            # an all-interfaces TCP listener); with shards every host
            # listens on one port (SO_REUSEPORT, shard 0 resolves it)
            self.ws_port = self.hosts[0].listen_ws(
                ws_host or host, ws_port, ws_path,
                reuseport=self.shards > 1)
            for h in self.hosts[1:]:
                h.listen_ws(ws_host or host, self.ws_port, ws_path,
                            reuseport=True)
        # -- cluster trunk (round 9) ----------------------------------------
        # Cross-node publish forwarding on the C++ plane: peers with a
        # registered trunk get REMOTE entries instead of punt markers
        # for their plain routes, so a cross-node QoS0/1 publish never
        # touches either node's Python plane. Degradation ladder:
        # trunk (up) → punt marker behavior (down/qos2/ring-full) →
        # Python forward_fn (the oracle lane, unchanged).
        self.trunk_port: Optional[int] = None
        if trunk_port is not None:
            self.trunk_port = self.host.trunk_listen(
                trunk_host or host, trunk_port)
        # -- mqtt-sn gateway plane (round 11) -------------------------------
        # A third C++ listener speaks MQTT-SN 1.2 over UDP: the host
        # decodes datagrams with the shared sn.h codec, translates them
        # into MQTT frames, and SN clients ride the SAME permit/punt/
        # lane/tap/ack-plane machinery as TCP and WS — only the framing
        # differs. gateway/mqttsn.py stays the asyncio oracle and the
        # deployment fallback when this listener is off (sn_port=None).
        self.sn_port: Optional[int] = None
        if sn_port is not None:
            # UDP SO_REUSEPORT source-hashes each SN peer onto ONE
            # shard's socket, so a datagram conversation never splits
            # across poll threads
            self.sn_port = self.hosts[0].listen_sn(
                sn_host or host, sn_port, sn_gateway_id,
                reuseport=self.shards > 1)
            for h in self.hosts[1:]:
                h.listen_sn(sn_host or host, self.sn_port, sn_gateway_id,
                            reuseport=True)
            for tid, t in (sn_predefined or {}).items():
                self.host.sn_predefined(int(tid), t)
        # -- coap gateway plane (round 19) ----------------------------------
        # A fourth C++ listener speaks CoAP (RFC 7252) over UDP: the
        # host decodes datagrams with the shared coap.h codec, the /ps
        # pub-sub surface translates into MQTT frames riding the SAME
        # permit/punt/lane/tap/ack-plane machinery as TCP/WS/SN, and
        # observe notifications resolve host-side on the delivery seam.
        # gateway/coap.py stays the asyncio oracle, the deployment
        # fallback (coap_port=None), AND the serving plane for punted
        # exchanges (kind 13: block-wise transfers, props-carrying
        # retained reads, non-/ps paths — ``coap_oracle`` swaps the
        # punt channel class, e.g. the LwM2M channel over /rd).
        self.coap_port: Optional[int] = None
        self._coap_oracle: dict = {}  # conn id → channel @guards(_coap_lock)
        # RLock: an oracle channel's uplink publish can dispatch into
        # ANOTHER oracle channel's handle_deliver on the same thread
        self._coap_lock = threading.RLock()
        self._coap_retain_ok = True
        if coap_port is not None:
            if self.app is None:
                raise ValueError("coap_port requires an app")
            self.coap_port = self.hosts[0].listen_coap(
                coap_host or host, coap_port, reuseport=self.shards > 1)
            for h in self.hosts[1:]:
                h.listen_coap(coap_host or host, self.coap_port,
                              reuseport=True)
            from emqx_tpu_torch.gateway import coap as _coap_mod
            from emqx_tpu_torch.gateway.ctx import GwContext as _GwContext

            self._coap_frame = _coap_mod.Frame()
            srv = self

            class _OracleCtx(_GwContext):
                """The punt seam's broker surface: identical to the
                asyncio gateway's context, except open_session never
                discards a channel belonging to one of THIS server's
                native conns — a device that publishes natively under
                the same clientid keeps its session; the oracle only
                serves the exchanges the native vocabulary excludes."""

                def open_session(self, clientid, channel):
                    old = self.app.cm.lookup_channel(clientid)
                    if old is not None and old is not channel:
                        for conn in list(srv.conns.values()):
                            if conn.channel is old:
                                return
                    super().open_session(clientid, channel)

                def close_session(self, clientid, channel=None,
                                  reason="closed"):
                    # the mirror guard: an oracle channel that never
                    # owned the CM slot (a native conn holds the
                    # identity) must not strip the LIVE session's
                    # subscriptions on its teardown (review finding —
                    # subscriber_down is unconditional in the base)
                    if self.app.cm.lookup_channel(clientid) is not channel:
                        return
                    super().close_session(clientid, channel, reason)

            self._coap_ctx = _OracleCtx(self.app, "coap-native")
            self._coap_factory = coap_oracle or (
                lambda ctx: _coap_mod.Channel(ctx))
        # -- conn-scale plane (round 16) ------------------------------------
        # Hibernation of idle conns + accept-storm governance live in
        # C++ (park.h / wheel.h); this just forwards the knobs. Parking
        # is ON by default (EMQX_NATIVE_PARK=0 is the escape hatch) —
        # it is invisible on the wire: the first byte re-inflates.
        if park is None:
            park = os.environ.get("EMQX_NATIVE_PARK", "1") != "0"
        self.park = bool(park)
        if not self.park or park_after_ms or accept_burst \
                or conn_mem_budget:
            self.host.set_park(self.park, park_after_ms, accept_burst,
                               conn_mem_budget)
        # conns whose Python session may hold timer work (retry /
        # awaiting-rel expiry) — the housekeep scans ONLY these; conns
        # with a native keepalive and an idle session leave the set.
        self._scan_conns: dict = {}      # @guards(_scan_lock)
        self._scan_lock = threading.Lock()
        # node name → {"id", "addr", "port", "up", } under _mirror_lock
        self._trunk_peers: dict[str, dict] = {}  # @guards(_mirror_lock)
        self._trunk_id_nodes: dict[int, str] = {}   # peer id → node name
        self._trunk_id_next = 1
        self._trunk_routes: set[tuple[str, str]] = set()  # (node, topic)
        self._trunk_retry_at = float("inf")         # next redial stamp
        # redial jitter source (round 15): process-seeded; only the
        # ±25% SHAPE matters, never a specific draw
        self._redial_rng = random.Random()
        # faultline (round 15): per-site injected-fault counters seen
        # at the last housekeep fold (faults.* metric slots + the
        # store-site ledger fold ride the deltas)
        self._faults_seen: dict[str, int] = {
            s: 0 for s in native.FAULT_SITES}
        # -- native telemetry plane (round 8) ------------------------------
        # In-host latency histograms + per-conn flight recorders, shipped
        # as batched kind-8 records and folded here into histogram-aware
        # Metrics (observe/metrics.py), prometheus, $SYS, and slow_subs.
        # EMQX_NATIVE_TELEMETRY=0 is the product escape hatch (bench.py's
        # observe_overhead section proves the on-cost < 2%).
        if telemetry is None:
            telemetry = os.environ.get("EMQX_NATIVE_TELEMETRY", "1") != "0"
        self.telemetry = bool(telemetry)
        self._hists = {}                      # @guards(_tele_lock)
        for stage in native.HIST_STAGES:
            self._hists[stage] = self.broker.metrics.register_hist(
                f"latency.native.{stage}")
        # per-shard stage breakdown (the bench's shards section reads
        # it via shard_latency_summary): registered only when sharded,
        # so the unsharded metric surface is byte-identical to round 11
        self._shard_hists: dict[int, dict] = {}
        if self.shards > 1:
            for i in range(self.shards):
                self._shard_hists[i] = {
                    stage: self.broker.metrics.register_hist(
                        f"latency.native.shard{i}.{stage}")
                    for stage in native.HIST_STAGES}
        # kind-7/8/10 records now arrive from N concurrent poll threads
        # (each record carries its shard in the id slot): the folds
        # below mutate shared server state, so each takes its lock
        self._tele_lock = threading.Lock()
        self._ack_lock = threading.Lock()
        self._durable_lock = threading.Lock()
        # serializes the _closed_conns capped insert+evict: EV_CLOSED
        # fires on every shard's poll thread, and two threads evicting
        # the same oldest key would KeyError mid-poll-batch
        self._closed_lock = threading.Lock()
        slow_ms = (self.app.slow_subs.threshold_ms
                   if self.app is not None else 500)
        self.host.set_telemetry(self.telemetry, slow_ack_ms=slow_ms)
        self._slow_ack_ms = slow_ms
        # per-message stage sampling override for bench runs (README
        # "Observability": default 1-in-8, hist deltas flush ~100ms)
        shift = os.environ.get("EMQX_NATIVE_TELEMETRY_SHIFT", "")
        if shift.isdigit():
            self.host.set_telemetry_shift(int(shift))
        # recent flight-recorder dumps: (conn_id, reason, entries)
        self.flight_records: deque = deque(maxlen=64)
        # conns currently trace-punted in C++ (clientid-filter traces);
        # _trace_lock serializes the poll thread's add (enable-fast on
        # a pre-traced clientid) / discard (conn close) against
        # _sync_traces' read-modify-write from management threads — an
        # unsynchronized replace could lose the poll thread's add and
        # strand the conn trace-punted in C++ after the trace stops
        self._traced_conns: set[int] = set()  # @guards(_trace_lock)
        self._trace_lock = threading.Lock()
        # -- native distributed tracing (round 13) --------------------------
        # A deterministic 1-in-2^shift publish sampler tags fast-path
        # publishes with 64-bit trace ids that propagate through every
        # native seam (ring entries, trunk wire v1, durable store); the
        # planes emit kind-12 span events folded here into a bounded
        # SpanCollector, the trace log (mode="native" clientid traces),
        # and prometheus exemplars. The degradation ledger rides the
        # same records: every ladder decision becomes a structured
        # reason event in app.ledger. EMQX_NATIVE_TRACING=0 (or
        # tracing=False) turns the sampler off; telemetry=False gates
        # everything anyway.
        if tracing is None:
            tracing = os.environ.get("EMQX_NATIVE_TRACING", "1") != "0"
        self.tracing = bool(tracing) and self.telemetry
        if trace_sample_shift is None:
            shift_env = os.environ.get("EMQX_NATIVE_TRACE_SHIFT", "")
            trace_sample_shift = (int(shift_env) if shift_env.isdigit()
                                  else 6)   # 1-in-64 default
        self.trace_sample_shift = int(trace_sample_shift)
        self.spans = SpanCollector()
        self.ledger = (app.ledger if app is not None
                       and getattr(app, "ledger", None) is not None
                       else DegradationLedger(self.broker.metrics))
        # per-shard trace-id seeds: node bits keep two-node traces
        # disjoint, shard bits keep concurrent samplers disjoint, bit
        # 63 keeps every seed (and so every id) nonzero
        node_bits = zlib.crc32(self.broker.node.encode()) & 0x3FFF
        for i, h in enumerate(self.hosts):
            h.set_tracing(self.tracing, self.trace_sample_shift,
                          (1 << 63) | (node_bits << 48) | (i << 44))
        # trace ids whose publisher has a running native-mode trace ->
        # that clientid (SPAN lines land on its trace log; the
        # publisher resolves from the ingress span's aux = conn id)
        self._trace_log_ids: OrderedDict = OrderedDict()  # @guards(_tele_lock)
        self._native_traced: set = set()
        if self.app is not None:
            self.app.native_stats_fn = self.fast_stats
            self.app.native_spans_fn = self.spans_recent
            if self.shards > 1:
                self.app.native_shard_stats_fn = self.shard_stats
        # -- durable-session plane (round 10) ------------------------------
        # A persistent session's filter used to become a punt marker —
        # one durable subscriber collapsed every matching publish onto
        # the Python plane. Now it becomes a kSubDurable entry: the C++
        # host appends matching publishes to a host-side message store
        # (native/src/store.h, mmap segments + CRC framing) below the
        # GIL and ships ONE batched kind-10 record per flush; this
        # server reconciles markers (live delivery to the connected
        # session + consumption) and clean_start=false resume replays
        # the pending set through the native delivery machinery.
        # Requires the app's PersistentSessions service (the marker/
        # resume authority); EMQX_DURABLE_STORE=0 is the escape hatch
        # back to punt-everything.
        self._durable_store = None
        self._durable_tokens: dict[str, int] = {}      # sid -> token
        # post-restart settle fast path (round 18): sid -> token
        # resolved by a store lookup when the primary cache is cold;
        # GIL-atomic get/set only, popped on discard (see
        # _durable_consume for why it avoids _mirror_lock)
        self._durable_tok_cache: dict[str, int] = {}
        self._durable_sids: dict[int, str] = {}  # token -> sid @guards(_durable_lock)
        # sid -> filters with a live C++ durable entry (session discard
        # must tear them down, or a dead token keeps accumulating
        # never-consumed markers forever)
        self._durable_filters: dict[str, set] = {}
        # tokens whose session was discarded: durable_del is an async op
        # (applied at the next ApplyPending), so a publish matched in
        # that window still appends a marker AFTER discard's consume
        # sweep — _on_durable consumes those orphans on sight instead of
        # letting them pin segments forever / replay post-wipe
        self._durable_dead: set[int] = set()  # @guards(_durable_lock)
        # sid -> highest guid a resume drain replayed: when a CONNECT
        # and the publish it raced land in the SAME poll batch, the
        # drain (CONNECT handling) replays the message before the
        # queued kind-10 event is folded — _on_durable must not deliver
        # those guids a second time
        self._durable_drain_mark: dict[str, int] = {}  # @guards(_durable_lock)
        self._store_degraded_seen = 0
        # one-shot loud warning for the punt-everything fallback of
        # persistent sessions on a persistence-less app (round 18)
        self._durable_punt_warned = False
        conf = getattr(app, "config", None) if app is not None else None
        if durable is None:
            durable = os.environ.get("EMQX_DURABLE_STORE", "1") != "0"
        if (durable and self.fast_path and app is not None
                and app.persistent is not None):
            conf_on = conf is not None and conf.get("durable.enable")
            if durable_dir is None and conf_on:
                # <base>/store for the native message log, next to the
                # Python session store at <base>/sessions (app.py)
                base = (conf.get("durable.store_dir")
                        or os.path.join(conf.get("node.data_dir", "data"),
                                        "durable"))
                durable_dir = os.path.join(base, "store")
            if durable_fsync is None:
                durable_fsync = (conf.get("durable.fsync") if conf_on
                                 else "batch")
            if durable_segment_bytes is None:
                durable_segment_bytes = (
                    int(conf.get("durable.segment_bytes")) if conf_on
                    else 4 << 20)
            try:
                # ONE recovery path (round 18): when the app's
                # persistence backend is already native-store-backed
                # (session/persistent.py NativeDurableStore), attach to
                # the SAME store instance — sessions, subscriptions,
                # Python-plane messages, fast-path messages and the
                # trunk replay ring all share one segment walk. Two
                # stores on one dir would double-mmap the segments.
                shared = getattr(app.persistent.store, "native", None)
                if shared is not None:
                    self._durable_store = shared
                    self._durable_store_owned = False
                else:
                    # dir "" = anonymous segments: the durable PLANE
                    # (fast path preserved + live kind-10 delivery +
                    # in-process replay) without restart survival
                    self._durable_store = native.NativeStore(
                        durable_dir or "",
                        durable_segment_bytes or 4 << 20,
                        durable_fsync or "batch")
                    self._durable_store_owned = True
                self.host.attach_store(self._durable_store)
                app.persistent.native_drain = self._durable_drain
                app.persistent.native_discard = self._durable_discard
                app.persistent.native_ack = self._durable_consume
                app.native_store_stats_fn = self._durable_store.stats
            except OSError as e:  # pragma: no cover — unwritable dir
                log.warning("durable store unavailable (%s); persistent "
                            "sessions stay on the punt path", e)
                self._durable_store = None
        # -- retained snapshot (round 11) -----------------------------------
        # services/retainer.py stays the authoritative store + oracle;
        # its observer stream mirrors every store/delete/expire into a
        # host-side read-only snapshot so SUBSCRIBE-triggered retained
        # delivery (TCP, WS, SN alike) resolves and writes below the
        # GIL. Messages carrying v5 properties cannot be encoded by the
        # fast path — ANY unmirrorable topic degrades the whole seam to
        # the Python lookup (always correct, never a partial set).
        self._retain_unmirrorable: set = set()
        self._retain_mirrored = False
        # per-poll-thread context (N threads when sharded): the conn
        # whose frame is being handled and which shard host the thread
        # drives (poll-thread-only seams route through these)
        self._tls = threading.local()
        self._poll_idents: set[int] = set()
        self.conns: dict[int, _NativeConn] = {}
        self._stop = threading.Event()
        if self.fast_path and app is not None:
            # replay-then-attach under the store lock: no mutation can
            # slip between the boot snapshot and observer registration
            app.retainer.mirror_attach(self._on_retained_event)
            app.native_retain_fn = self._native_retained
            self._retain_mirrored = True
        self._thread: Optional[threading.Thread] = None
        self._shard_threads: list[threading.Thread] = []
        self._last_housekeep = time.monotonic()
        self._tick_running = threading.Event()
        # device serving path: one poll step's PUBLISHes coalesce into
        # one kernel launch (the epoll batch IS the {active,N} batch)
        self.pipeline = getattr(app, "pipeline", None)
        # -- device match lane (the device router ON the C++ data
        # plane). "on"/"off"/"auto": auto flips with table
        # size (LANE_AUTO_* hysteresis, judged each housekeep) because
        # the per-message C++ walk wins below the crossover point.
        self.device_lane = device_lane if fast_path else "off"
        self._lane_on = False
        self._lane_q: queue.SimpleQueue = queue.SimpleQueue()
        self._lane_stop = threading.Event()
        self._lane_thread: Optional[threading.Thread] = None
        self._lane_stale_seen = 0
        self._lane_retry_at = 0.0    # monotonic backoff after stale trip
        # D5: the exception of a step on the card that raised in the
        # pump; stop() re-raises it, and no pump starts again before
        self.lane_error: Optional[BaseException] = None
        # recently closed conns: (clientid, proto_ver, username,
        # peername) kept so a lane frame punted — or a rule tap emitted
        # — AFTER its publisher disconnected can still be honoured; on
        # the walk path both are synchronous so this window cannot occur
        self._closed_conns: dict[int, tuple] = {}  # @guards(_closed_lock)
        # -- rule taps (no broad-rule permit cliff) ---------------------------
        # rule FROM filters mirror into the C++ table as NON-delivering
        # tap entries; matched frames copy here and a worker runs the
        # rule engine against them while native fan-out proceeds. The
        # queue is bounded: under sustained rule-eval overload frames
        # are counted into tap_dropped instead of stalling the plane.
        self._rule_taps: dict[str, int] = {}          # filter -> token
        # entries are BATCH records (~≤192KB each): 128 bounds worst-
        # case buffering at ~24MB / a few hundred thousand messages
        self._tap_q: queue.Queue = queue.Queue(maxsize=128)
        self.tap_dropped = 0      # @guards(_tap_lock): N shard threads
        # serializes the tap_dropped read-modify-write: queue.Full is
        # decided per shard poll thread, and two threads folding the
        # drop count with bare += lose updates (nativecheck pyfold
        # finding, round 14)
        self._tap_lock = threading.Lock()
        self._tap_thread: Optional[threading.Thread] = None
        # the mqtt.max_qos_allowed cap must hold on the fast path too:
        # over-cap publishes fall through to the channel's DISCONNECT
        max_qos = getattr(self.broker, "max_qos_allowed", 2)
        if max_qos < 2:
            self.host.set_max_qos(max_qos)
        # one long-lived worker for app.tick() — spawning a thread per
        # housekeep cycle would churn an OS thread every few seconds
        self._tick_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="emqx-native-tick")
        # -- fast-path state ------------------------------------------------
        # punt-marker owner tokens live far above any conn id so the C++
        # table can hold both in one owner space
        self._punt_token_next = 1 << 48
        self._punt_tokens: dict[str, int] = {}          # sid -> token
        # (sid, sub key) -> (owner, real filter, kind) for removal;
        # several sub keys can share one punt (token, real) C++ entry
        # ($share/g1/t + $share/g2/t), so punt entries are refcounted
        self._mirror: dict[tuple[str, str], tuple[int, str, str]] = {}  # @guards(_mirror_lock)
        self._punt_refs: dict[tuple[int, str], int] = {}
        self._token_refs: dict[str, int] = {}           # sid -> live punts
        # serializes the refcounted punt bookkeeping AND the _mirror
        # read-modify-write itself: sub events arrive on broker
        # threads, route events on cluster threads, and the
        # demote/promote re-mirror loops on the poll thread.
        # REENTRANT because _on_sub_event holds it across _add_entry /
        # _del_entry / _token, which acquire it for the punt refcounts
        # (nativecheck pyfold finding, round 14: the unlocked mirror
        # get/set/pop raced the poll-thread loops' snapshot+re-add)
        self._mirror_lock = threading.RLock()
        self._route_punts: set[tuple[str, str]] = set()
        self._fast_conn_of: dict[str, int] = {}         # clientid -> conn
        self._granted: dict[int, set[str]] = {}         # conn -> topics
        self._permit_lock = threading.Lock()
        self._permit_queue: list[tuple[_NativeConn, str]] = []
        self._last_permit_flush = time.monotonic()
        self._stats_seen = {k: 0 for k in native.STAT_NAMES}
        # drained ack-record totals (observability + the windowed-qos1
        # smoke test's "inflight never exceeds receive-maximum" probe)
        self.ack_plane = {"acked": 0, "rel": 0,  # @guards(_ack_lock)
                          "batches": 0,
                          "max_inflight_seen": 0}
        # (group, real filter) -> {"members": {sid: opts},
        #                          "installed": None | "punt" | {sid: conn}}
        # guarded by _shared_lock: subscribe events arrive on broker
        # threads while strategy changes arrive on the config thread,
        # and an interleaved reconcile would desync "installed" from
        # the C++ table
        self._shared_state: dict[tuple[str, str], dict] = {}  # @guards(_shared_lock)
        self._sid_groups: dict[str, set[tuple[str, str]]] = {}
        self._shared_lock = threading.Lock()
        if app is not None:
            if not hasattr(app, "on_shared_strategy_change"):
                app.on_shared_strategy_change = []
            app.on_shared_strategy_change.append(self.reeval_shared_groups)
        self.broker.sub_observers.append(self._on_sub_event)
        self.broker.router.route_observers.append(self._on_route_event)
        # mirror subscriptions that existed before this server started
        # (resumed persistent sessions, other transports on the same app)
        for (sid, topic), opts in list(self.broker.suboption.items()):
            self._on_sub_event("add", sid, topic, opts)
        # restart gap (review finding): sessions recovered from the
        # persistent store have NO broker-table subs until they resume,
        # so the loop above cannot install their entries — a fast
        # publish in that window would bypass BOTH stores and be
        # acked-but-lost. Install durable entries for every stored
        # session's plain filters at boot; the resume's re-fired sub
        # events upsert them idempotently.
        if self._durable_store is not None:
            for sid, rec in self.app.persistent.store.all_sessions():
                for filt, od in (rec.get("subs") or {}).items():
                    grp, real = T.parse_share(filt)
                    if grp is None:
                        tok = self._durable_token(sid)
                        self.host.durable_add(
                            tok, real, int((od or {}).get("qos", 0) or 0))
                        self._durable_filters.setdefault(
                            sid, set()).add(real)
        # ...and pre-existing remote routes (a node joining a live
        # cluster replays the route snapshot before listeners start)
        for topic, dest in self.broker.router.dump():
            self._on_route_event("add", topic, dest)
        # eager permit flushes: a new rule/bridge/trace/metric/rewrite/
        # exhook watcher must see already-fast topics immediately, not
        # after the TTL. (app.exhook is None until configured; a server
        # built before exhook config falls back to the TTL for it.)
        for comp in ("bridges", "trace", "topic_metrics",
                     "rewrite", "exhook"):
            obj = getattr(app, comp, None) if app is not None else None
            if hasattr(obj, "on_topology_change"):
                # traces get a richer callback: clientid traces also
                # punt their conns at the C++ seam (emqx_host_set_trace)
                # so the hook fold sees every publish immediately — the
                # permit flush alone leaves the subscriber-side and any
                # already-granted permit window open
                obj.on_topology_change.append(
                    self._on_trace_change if comp == "trace"
                    else self.flush_permits)
        # rules get a richer callback: tap entries sync FIRST (ops apply
        # FIFO on the poll thread, so post-flush grants see the taps),
        # then the permit flush
        if app is not None and hasattr(app.rules, "on_topology_change"):
            app.rules.on_topology_change.append(self._on_rules_change)
            if self.fast_path:
                self._sync_rule_taps()
        # native-mode traces running BEFORE this server existed must
        # feed the span log from the first sampled publish
        self._native_traced = self._native_trace_clientids()

    # -- fast-path control --------------------------------------------------

    def _on_rules_change(self) -> None:
        self._sync_rule_taps()
        self.flush_permits()

    # -- trace punt (observability) -----------------------------------------
    # A clientid trace must capture publishes from connections already
    # on the native fast path. Closing the blind spot needs BOTH seams:
    # set_trace marks the conn in C++ (its PUBLISHes punt to the Python
    # plane, where the TraceManager hook sees them, and its flight-
    # recorder tail dumps onto the trace log) and flush_permits revokes
    # the topic grants so nothing else on those topics overtakes the
    # punted frames.

    def _traced_clientids(self) -> set:
        """Clientids whose traces PUNT their conns (mode="punt", the
        full-fidelity fallback). mode="native" traces never punt: their
        clients stay on the fast path and the trace log receives the
        sampled span timelines instead (_on_spans)."""
        if self.app is None:
            return set()
        return {t.filter_value for t in self.app.trace.running()
                if t.filter_type == "clientid"
                and getattr(t, "mode", "punt") != "native"}

    def _native_trace_clientids(self) -> set:
        if self.app is None:
            return set()
        return {t.filter_value for t in self.app.trace.running()
                if t.filter_type == "clientid"
                and getattr(t, "mode", "punt") == "native"}

    def _sync_traces(self) -> None:
        """Reconcile the C++ per-conn trace flags with the running
        clientid traces. Thread-safe: set_trace enqueues onto the poll
        thread; _fast_conn_of reads are GIL-atomic snapshots; the
        bookkeeping set updates under _trace_lock (see its comment)."""
        with self._trace_lock:
            want = set()
            for cid in self._traced_clientids():
                conn_id = self._fast_conn_of.get(cid)
                if conn_id is not None:
                    want.add(conn_id)
            for conn_id in want - self._traced_conns:
                self.host.set_trace(conn_id, True)
            for conn_id in self._traced_conns - want:
                self.host.set_trace(conn_id, False)
            self._traced_conns = want

    def _on_trace_change(self) -> None:
        self._sync_traces()
        # refresh the native-mode set the span fold consults (a plain
        # replace: reads are GIL-atomic snapshots)
        self._native_traced = self._native_trace_clientids()
        self.flush_permits()

    def _sync_rule_taps(self) -> None:
        """Reconcile the C++ rule-tap entries with the live FROM
        filters. Thread-safe (sub_add/del enqueue onto the poll
        thread); _mirror_lock serializes concurrent topology events."""
        if not self.fast_path or self.app is None:
            return
        want = set(self.app.rules.publish_filters())
        with self._mirror_lock:
            cur = self._rule_taps
            for f in want - cur.keys():
                tok = self._punt_token_next
                self._punt_token_next += 1
                cur[f] = tok
                self.host.sub_add(tok, f, 0, native.SUB_RULE_TAP)
            for f in list(cur.keys() - want):
                self.host.sub_del(cur.pop(f), f)

    def flush_permits(self) -> None:
        """Topology changed (rule created, authz update, trace started):
        every publisher re-earns its permits through the full path.
        Mutually exclusive with _grant_permits — a flush from a
        management thread landing mid-grant must not leave a stale
        permit for the freshly watched topic (the grant loop would
        otherwise add to an orphaned set and install a C++ permit the
        flush can no longer see)."""
        with self._permit_lock:
            self.host.permits_flush()
            self._granted.clear()

    def fast_stats(self) -> dict[str, int]:
        return self.host.stats()

    # -- retained snapshot (round 11) ---------------------------------------

    def _on_retained_event(self, op: str, topic: str, msg,
                           deadline_ms: int) -> None:
        """Retainer observer: mirror one store/delete into the host
        snapshot. Fired under the retainer lock from any thread —
        host ops enqueue + wake, never block."""
        if self._stop.is_set():
            return
        if op == "del":
            self._retain_unmirrorable.discard(topic)
            self.host.retain_del(topic)
            self._coap_retain_sync()
            return
        props = (msg.headers or {}).get("properties") or {}
        # the native encode carries no v5 property section (fast-path
        # contract); a message with properties (Message-Expiry included
        # — Python forwards the REMAINING interval on delivery) would
        # lose them on the native wire, so those stay Python-served
        if props:
            self._retain_unmirrorable.add(topic)
            self.host.retain_del(topic)
            self._coap_retain_sync()
            return
        self._retain_unmirrorable.discard(topic)
        self.host.set_retained(topic, bytes(msg.payload or b""),
                               int(msg.qos or 0), deadline_ms)
        self._coap_retain_sync()

    def _native_retained(self, sid: str, topic: str, real: str,
                         opts) -> bool:
        """app.native_retain_fn seam (called inside the
        session.subscribed hook): serve this subscription's retained
        set below the GIL when the subscriber is THIS server's live
        fast conn. Degradation ladder: any unmirrorable message, a
        non-fast/foreign subscriber, or an off-poll-thread call falls
        back to the Python retainer lookup (always correct)."""
        if self._retain_unmirrorable or self._stop.is_set():
            return False
        if threading.get_ident() not in self._poll_idents:
            return False          # another server/transport owns this sub
        # the conn whose frame this thread is handling (thread-local:
        # each shard's poll thread serves its own conns)
        conn = getattr(self._tls, "frame_conn", None)
        if (conn is None or not conn.fast
                or conn.channel.clientid != sid
                or conn.channel.conn_state != "connected"):
            return False
        self.host.retain_deliver(conn.conn_id, real,
                                 int(getattr(opts, "qos", 0) or 0))
        return True

    def _coap_retain_sync(self) -> None:
        """Keep the host's plain-GET gate aligned with the mirror:
        ANY props-carrying retained topic makes the snapshot
        incomplete, and native CoAP reads degrade whole to the
        oracle's lookup (never a partial answer)."""
        if self.coap_port is None:
            return
        complete = not self._retain_unmirrorable
        if complete != self._coap_retain_ok:
            self._coap_retain_ok = complete
            self.host.coap_retain_state(complete)

    # -- coap oracle seam (round 19) ----------------------------------------
    # Exchanges the native CoAP vocabulary excludes (block-wise
    # transfers, props-carrying retained reads, non-/ps paths — the
    # LwM2M registration surface) arrive as kind-13 events carrying the
    # raw datagram; a per-peer gateway/coap.py channel (or the
    # configured ``coap_oracle`` class) serves them WHOLE and answers
    # back through the native datagram socket. The channel's ``send``
    # binding also carries broker deliveries (LwM2M downlink commands)
    # to the device over the native transport.

    # @locked(_coap_lock)
    def _coap_channel(self, conn_id: int):
        ch = self._coap_oracle.get(conn_id)
        if ch is None:
            ch = self._coap_factory(self._coap_ctx)
            ch.send = (lambda frames, _cid=conn_id:
                       self._coap_reply(_cid, frames))
            # broker deliveries (cm.dispatch) call handle_deliver from
            # whatever thread published: serialize with the poll
            # thread's handle_in under the (reentrant) channel lock
            orig_hd = ch.handle_deliver

            def _hd(items, _o=orig_hd):
                with self._coap_lock:
                    return _o(items)

            ch.handle_deliver = _hd
            self._coap_oracle[conn_id] = ch
        return ch

    def _coap_reply(self, conn_id: int, frames) -> None:
        """Serialize + ship oracle-channel responses to the peer (the
        channel's ``send`` binding; Frame.serialize is stateless and
        coap_send is a thread-safe op enqueue)."""
        for f in frames or ():
            self.host.coap_send(conn_id, self._coap_frame.serialize(f))

    def _on_coap(self, conn_id: int, dgram: bytes) -> None:
        """Kind-13 fold: one exchange degraded WHOLE to the oracle."""
        with self._coap_lock:
            try:
                ch = self._coap_channel(conn_id)
                msgs, _ = self._coap_frame.parse(dgram, None)
                out = []
                for m in msgs:
                    out.extend(ch.handle_in(m) or [])
            except Exception:
                log.exception("coap oracle channel error (conn %#x)",
                              conn_id)
                return
        self._coap_reply(conn_id, out)

    def _coap_housekeep(self) -> None:
        """Oracle-channel tick: CON retransmits and give-ups (LwM2M
        downlink commands) — the asyncio listener's housekeep twin."""
        with self._coap_lock:
            for conn_id, ch in list(self._coap_oracle.items()):
                hk = getattr(ch, "housekeep", None)
                if hk is None:
                    continue
                try:
                    out = hk()
                except Exception:
                    continue
                self._coap_reply(conn_id, out)

    # -- device match lane --------------------------------------------------
    # Permitted PUBLISHes park in C++ while their topics ride batched
    # RouterModel launches; the response names each message's matched
    # filter strings and C++ fans out by exact per-filter lookup
    # (router.h MatchFilter). The per-message walk remains the correct
    # fallback at every seam: soft cap, pump failure, stale drain.

    def _lane_model(self):
        return getattr(self.broker, "model", None)

    def _set_lane(self, on: bool) -> None:
        if on == self._lane_on:
            return
        if on:
            if self._lane_model() is None or self.lane_error is not None:
                return
            self._lane_stop.clear()
            if self._lane_thread is None or not self._lane_thread.is_alive():
                self._lane_thread = threading.Thread(
                    target=self._lane_pump, name="emqx-lane-pump",
                    daemon=True)
                self._lane_thread.start()
            log.info("device lane ON (filters=%s)", self._lane_filters())
        else:
            log.info("device lane OFF")
        self._lane_on = on
        self.host.set_lane(on)   # off drains parked frames to Python

    def _lane_filters(self) -> int:
        model = self._lane_model()
        if model is None:
            return 0
        index = model.index
        live = getattr(index, "live_count", None)
        if callable(live):
            return int(live())
        return sum(f is not None for f in index.filters)

    def _lane_auto(self) -> None:
        """Housekeep-cadence lane policy: stale-trip resync first (the
        C++ side turns itself off when the pump stops answering — the
        Python flag must follow or no re-enable can ever happen), then
        the device_lane=auto size hysteresis."""
        stale = self.fast_stats()["lane_stale"]
        if stale > self._lane_stale_seen:
            self._lane_stale_seen = stale
            if self._lane_on:
                log.warning("device lane stale-tripped in C++; resyncing "
                            "(retry in %ss)", LANE_STALE_BACKOFF_S)
                self._lane_on = False   # C++ already drained + disabled
                # a wedged device would re-trip every few seconds: the
                # walk/Python paths are always correct, so sit out the
                # backoff before trusting the pump again
                self._lane_retry_at = (time.monotonic()
                                       + LANE_STALE_BACKOFF_S)
        if not self._lane_on and time.monotonic() < self._lane_retry_at:
            return
        if self.device_lane == "on":
            self._set_lane(True)
            return
        if self.device_lane != "auto" or self._lane_model() is None:
            return
        n = self._lane_filters()
        if not self._lane_on and n >= LANE_AUTO_ON_FILTERS:
            self._set_lane(True)
        elif self._lane_on and n < LANE_AUTO_OFF_FILTERS:
            self._set_lane(False)

    def _lane_pump(self) -> None:
        """Pump thread: drain lane topics, submit batched device
        launches (up to LANE_PIPE_DEPTH in flight — the double-buffering
        that hides the device round trip), and answer C++ with the
        matched filter strings. Over a CPU model every failure answers
        'punt' so the frames take the always-correct Python path, as the
        reference does.  Over a model on the card (D5) any exception in
        the pump (a submit or collect that raises, or the merge and
        answer after a collect) stops the pump's steps: the exception is
        kept for stop() to re-raise, and every frame the lane holds or
        parks until then is answered with no audience instead of being
        served from the host."""
        model = self._lane_model()
        on_card = _on_card(model)
        pending: deque = deque()   # submitted, uncollected device batches
        inbox: deque = deque()     # (seq, topic) awaiting submission
        held: list = []            # a collected batch not yet answered
        try:
            while not self._lane_stop.is_set():
                try:
                    items = self._lane_q.get(
                        timeout=0.0005 if (pending or inbox) else 0.05)
                except queue.Empty:
                    items = None
                if items:
                    inbox.extend(items)
                    while True:     # coalesce everything already queued
                        try:
                            inbox.extend(self._lane_q.get_nowait())
                        except queue.Empty:
                            break
                # submission is depth-gated: a burst must not fan into
                # an unbounded launch queue whose tail waits past the
                # C++ stale deadline — excess stays in the inbox and
                # rides the next (larger) batch instead
                while inbox and len(pending) < LANE_PIPE_DEPTH:
                    n = min(len(inbox), LANE_MAX_BATCH)
                    chunk = [inbox.popleft() for _ in range(n)]
                    # items are (shard host, seq, topic): one device
                    # batch may mix shards, the response splits per host
                    seqs = [(h, s) for h, s, _ in chunk]
                    topics = [t for _, _, t in chunk]
                    try:
                        pending.append(
                            (model.publish_batch_submit(topics), seqs))
                    except Exception as e:
                        if on_card:
                            self._lane_fail(e, "submit", seqs, pending,
                                            inbox)
                            self._lane_refuse()
                            return
                        log.exception("lane submit failed; punting")
                        self._lane_respond_punt(seqs)
                if pending and (len(pending) >= LANE_PIPE_DEPTH
                                or (items is None and not inbox)):
                    handle, seqs = pending.popleft()
                    held = seqs
                    try:
                        matched, aux, _slots, fallback = \
                            model.publish_batch_collect(handle)
                    except Exception as e:
                        if on_card:
                            self._lane_fail(e, "collect", seqs, pending,
                                            inbox)
                            self._lane_refuse()
                            return
                        log.exception("lane collect failed; punting")
                        self._lane_respond_punt(seqs)
                        continue
                    if aux and any(aux):
                        # aux = co-batched rule FROM filters: they map
                        # to the C++ RULE-TAP entries, so the response
                        # must name them or lane traffic would bypass
                        # the rules. Deduped: a filter both subscribed
                        # AND ruled appears in m and a, and naming it
                        # twice would double-deliver to its subscribers
                        # (MatchFilter appends per name)
                        matched = [
                            m + [x for x in a if x not in m] if a else m
                            for m, a in zip(matched, aux)]
                    self._lane_respond(seqs, matched, fallback)
                    held = []
        except Exception as e:
            if not on_card:
                log.exception("lane pump died; lane off")
            else:
                self._lane_fail(e, "pump", held, pending, inbox)
                self._lane_refuse()
        finally:
            for handle, seqs in pending:
                # collect (not just punt): publish_batch_submit opened
                # an inflight window on the index — skipping the
                # collect would quarantine freed filter ids forever
                try:
                    model.publish_batch_collect(handle)
                except Exception:
                    pass
                self._lane_respond_punt(seqs)
            if inbox:
                self._lane_respond_punt([(h, s) for h, s, _ in inbox])
            if self._lane_on and self.lane_error is None:
                self._lane_on = False
                self.host.set_lane(False)

    def _lane_fail(self, exc: BaseException, stage: str, seqs,
                   pending: deque, inbox: deque) -> None:
        """D5: a step on the card raised at ``stage``.  Keep the
        exception, answer every frame the pump holds (``seqs``, the
        batches still in flight, the inbox) with no audience, and clear
        ``pending`` and ``inbox`` so the pump's exit punts nothing.  The
        C++ lane stays on (turning it off would drain the frames parked
        meanwhile to the host path); ``_lane_refuse`` answers them."""
        log.error("lane %s failed on the card; the lane pump stops "
                  "(stop() re-raises)", stage, exc_info=exc)
        self.lane_error = exc
        model = self._lane_model()
        held = list(seqs)
        for handle, s in pending:
            try:
                model.publish_batch_collect(handle)
            except Exception:  # noqa: BLE001 — the first error is kept
                pass
            held += s
        held += [(h, s) for h, s, _ in inbox]
        pending.clear()
        inbox.clear()
        self._lane_respond(held, [[] for _ in held], ())

    def _lane_refuse(self) -> None:
        """D5, after ``_lane_fail``: until stop(), answer each frame that
        parks on the lane with no audience, so none is served from the
        host and none stale-trips."""
        while not self._lane_stop.is_set():
            try:
                items = self._lane_q.get(timeout=0.05)
            except queue.Empty:
                continue
            held = [(h, s) for h, s, _ in items]
            self._lane_respond(held, [[] for _ in held], ())

    def _lane_respond(self, seqs, matched, fallback) -> None:
        """``seqs`` are (shard host, seq) pairs: lane sequence numbers
        are per-host counters, so each response blob goes back to the
        host whose poll loop parked the frame."""
        fb = set(fallback or ())
        pack = struct.pack
        per: dict = {}
        for i, (h, seq) in enumerate(seqs):
            per.setdefault(h, []).append((i, seq))
        for h, items in per.items():
            parts = [pack("<I", len(items))]
            for i, seq in items:
                if i in fb:
                    # tokenizer reject / K-cap overflow: the kernel
                    # result is incomplete — Python re-matches it
                    parts.append(pack("<QBH", seq, 1, 0))
                    continue
                fs = matched[i]
                parts.append(pack("<QBH", seq, 0, len(fs)))
                for f in fs:
                    b = f.encode()
                    parts.append(pack("<H", len(b)))
                    parts.append(b)
            h.lane_deliver(b"".join(parts))

    def _lane_respond_punt(self, seqs) -> None:
        per: dict = {}
        for h, seq in seqs:
            per.setdefault(h, []).append(seq)
        for h, ss in per.items():
            parts = [struct.pack("<I", len(ss))]
            for seq in ss:
                parts.append(struct.pack("<QBH", seq, 1, 0))
            h.lane_deliver(b"".join(parts))

    def _fast_global(self) -> bool:
        # clustered nodes stay eligible: remote routes mirror into the
        # C++ table as punt markers via router.route_observers, so a
        # publish with any remote audience takes the Python path (which
        # forwards it over the cluster plane)
        return self.fast_path

    def _token(self, sid: str) -> int:
        # keys are NAMESPACED ("c:" clientids, "g:" share groups,
        # "n:" remote nodes) so a hostile clientid like "n:node2" can
        # never collide with an infrastructure token.
        # under _mirror_lock: concurrent first-use from a broker thread
        # and a cluster route thread must not mint two tokens
        with self._mirror_lock:
            tok = self._punt_tokens.get(sid)
            if tok is None:
                tok = self._punt_token_next
                self._punt_token_next += 1
                self._punt_tokens[sid] = tok
            return tok

    def _add_entry(self, sid: str, owner: int, real: str, kind: str,
                   qos: int, flags: int) -> None:
        if kind == "punt":
            with self._mirror_lock:
                key = (owner, real)
                self._punt_refs[key] = self._punt_refs.get(key, 0) + 1
                if self._punt_refs[key] == 1:
                    self._token_refs[sid] = self._token_refs.get(sid, 0) + 1
                    self.host.sub_add(owner, real, 0, native.SUB_PUNT)
        elif kind == "durable":
            # idempotent in C++ (SubTable Upsert keys on owner+filter),
            # so resume re-fires need no refcounting
            self.host.durable_add(owner, real, qos)
            with self._durable_lock:
                dsid = self._durable_sids.get(owner)
                if dsid is not None:
                    self._durable_filters.setdefault(dsid, set()).add(real)
        else:
            self.host.sub_add(owner, real, qos, flags)

    def _del_entry(self, sid: str, owner: int, real: str,
                   kind: str) -> None:
        if kind == "durable":
            self.host.durable_del(owner, real)
            with self._durable_lock:
                dsid = self._durable_sids.get(owner)
                if dsid is not None:
                    filters = self._durable_filters.get(dsid)
                    if filters is not None:
                        filters.discard(real)
                        if not filters:
                            del self._durable_filters[dsid]
            return
        if kind == "punt":
            with self._mirror_lock:
                key = (owner, real)
                n = self._punt_refs.get(key, 0) - 1
                if n > 0:
                    self._punt_refs[key] = n
                    return             # another sub key still needs it
                self._punt_refs.pop(key, None)
                left = self._token_refs.get(sid, 1) - 1
                if left <= 0:
                    # last punt for this sid: free its token so clientid
                    # churn doesn't leak dict entries forever
                    self._token_refs.pop(sid, None)
                    self._punt_tokens.pop(sid, None)
                else:
                    self._token_refs[sid] = left
                self.host.sub_del(owner, real)
                return
        self.host.sub_del(owner, real)

    # -- cluster routes ------------------------------------------------------
    # A remote-node route means subscribers this node cannot see in its
    # broker tables: mirror it as a punt marker so the fast path punts
    # matching publishes to Python, whose _route forwards them over the
    # cluster plane. This replaces the round-4-initial design of
    # disabling the fast path entirely on clustered nodes.

    def _on_route_event(self, op: str, topic: str, dest) -> None:
        node = None
        shared = isinstance(dest, tuple)
        if shared:
            node = dest[1]       # ({group}, node) shared route
        elif isinstance(dest, str):
            node = dest
        if node in (None, "local", self.broker.node):
            return               # local routes come via sub_observers
        # plain routes to a trunk-registered peer become REMOTE entries
        # (the third entry kind) instead of punt markers; shared routes
        # ALWAYS stay punt markers — the publishing node's Python picks
        # the group member cluster-wide (emqx_shared_sub semantics), so
        # the message must reach Python's shared_dispatch
        if not shared and self._trunk_route_event(op, node, topic):
            return
        sid = f"n:{node}"
        key = (sid, topic)
        # the router fires each (topic, dest) add/del exactly once in
        # table order; this set makes the bootstrap dump() replay
        # idempotent against events that raced in before the snapshot
        if op == "add":
            if key in self._route_punts:
                return
            self._route_punts.add(key)
            self._add_entry(sid, self._token(sid), topic, "punt", 0, 0)
        else:
            if key not in self._route_punts:
                return
            self._route_punts.discard(key)
            self._del_entry(sid, self._token(sid), topic, "punt")

    # -- cluster trunk -------------------------------------------------------

    def _trunk_route_event(self, op: str, node: str, topic: str) -> bool:
        """Install/remove a remote entry for a trunk-registered peer.
        Returns False when the peer has no trunk (punt-marker path) or
        when a delete targets a route that predates the registration."""
        with self._mirror_lock:
            peer = self._trunk_peers.get(node)
            key = (node, topic)
            if op == "add":
                if peer is None:
                    return False
                if key not in self._trunk_routes:
                    self._trunk_routes.add(key)
                    self.host.trunk_route_add(peer["id"], topic)
                return True
            if key not in self._trunk_routes:
                return False     # installed as a punt marker pre-register
            self._trunk_routes.discard(key)
            if peer is not None:
                self.host.trunk_route_del(peer["id"], topic)
            return True

    def trunk_register(self, node: str, host: str, port: int) -> None:
        """Wire a peer node's trunk: dial its listener and convert its
        existing plain-route punt markers into remote entries. Install-
        first ordering (ops apply FIFO on the poll thread): the remote
        entry lands BEFORE the punt marker goes, and an overlap punts —
        never a gap, never a double-delivery."""
        if self._stop.is_set():
            # a late hello/bye from the cluster plane must not reach a
            # destroyed host
            return
        with self._mirror_lock:
            peer = self._trunk_peers.get(node)
            if peer is not None and (peer["addr"], peer["port"]) == (host,
                                                                     port):
                # unchanged address: hello/ping re-learn this every
                # heartbeat — a re-dial here would tear down the
                # healthy link every ~5s (dropping in-flight qos0 and
                # re-replaying the qos1 ring); only a DOWN link dials
                pid = peer["id"]
                dial = not peer["up"]
            else:
                dial = True
                if peer is None:
                    pid = self._trunk_id_next
                    self._trunk_id_next += 1
                    peer = self._trunk_peers[node] = {
                        "id": pid, "addr": host, "port": port,
                        "up": False, "backoff": TRUNK_RETRY_S,
                        "retry_at": 0.0}
                    self._trunk_id_nodes[pid] = node
                else:            # address moved: re-dial below
                    pid = peer["id"]
                    peer.update(addr=host, port=port, up=False,
                                backoff=TRUNK_RETRY_S, retry_at=0.0)
        # bind the peer id to its stable NODE NAME BEFORE any remote
        # entry exists (ops apply FIFO on the poll thread): a qos1
        # publish matching a freshly converted route could otherwise
        # seal + journal a trunk batch under the per-process fallback
        # key in the cycle before the ident applied, stranding that
        # record AND skipping the previous life's ring merge (review
        # finding). Idempotent — the C++ side loads once per peer life.
        self.host.trunk_ident(pid, node)
        sid = f"n:{node}"
        # list() snapshot: route observers on other threads mutate the
        # set, and a bare comprehension can die mid-iteration
        converts = [t for (s, t) in list(self._route_punts) if s == sid]
        for topic in converts:
            with self._mirror_lock:
                if (node, topic) in self._trunk_routes:
                    continue
                self._trunk_routes.add((node, topic))
                self.host.trunk_route_add(pid, topic)
            self._route_punts.discard((sid, topic))
            self._del_entry(sid, self._token(sid), topic, "punt")
        # a route delete racing the snapshot above went through the
        # punt path (its key was in neither set at that instant) and
        # the convert re-installed it: re-check the authoritative
        # router table and drop conversions whose route vanished
        for topic in converts:
            if not any(r.dest == node for r in
                       self.broker.router.lookup_routes(topic)):
                self._trunk_route_event("del", node, topic)
        if dial:
            self.host.trunk_connect(pid, host, port)
            self._trunk_retry_at = min(self._trunk_retry_at,
                                       time.monotonic() + TRUNK_RETRY_S)

    def trunk_unregister(self, node: str, forget: bool = True) -> None:
        """Reverse of trunk_register: every remote entry flips back to
        a punt marker (punt-first, same no-gap reasoning) and the link
        drops."""
        if self._stop.is_set():
            return
        with self._mirror_lock:
            peer = self._trunk_peers.pop(node, None)
            if peer is None:
                return
            self._trunk_id_nodes.pop(peer["id"], None)
        sid = f"n:{node}"
        reverts = [t for (n, t) in list(self._trunk_routes) if n == node]
        for topic in reverts:
            self._route_punts.add((sid, topic))
            self._add_entry(sid, self._token(sid), topic, "punt", 0, 0)
            with self._mirror_lock:
                self._trunk_routes.discard((node, topic))
            self.host.trunk_route_del(peer["id"], topic)
        self.host.trunk_disconnect(peer["id"], forget=forget)

    def trunk_peer_status(self) -> dict[str, bool]:
        with self._mirror_lock:
            return {n: p["up"] for n, p in self._trunk_peers.items()}

    # -- faultline (round 15) ------------------------------------------------
    # Deterministic fault injection at the native plane's syscall seams
    # (native/src/fault.h). The server surface is a passthrough: the
    # host routes store sites to the attached durable store and, when
    # sharded, link-scoped sites to every shard. Every fired fault
    # counts a faults.<site> metric and lands in the degradation
    # ledger (reason "fault", aux = the site index) — chaos observable
    # through the same seams as organic degradation.

    def fault_arm(self, site: str, mode: str = "errno",
                  n_or_prob: float = 0.0, seed: int = 1,
                  key: int = 0) -> None:
        """Key-scoped conn/trunk arms land on the one shard that owns
        the object, so counted arms fire exactly n times; UNSCOPED
        arms on a sharded server broadcast — their counts and PRNG
        schedules are per shard."""
        self.host.fault_arm(site, mode, n_or_prob, seed, key)

    def fault_disarm(self, site: str) -> None:
        self.host.fault_disarm(site)

    def fault_fired(self, site: str) -> int:
        return self.host.fault_fired(site)

    def set_trunk_ack_timeout(self, ms: int) -> None:
        """Tighten/relax the silent-link watchdog (host.cc
        TrunkAckScan); the mesh soak drops it to milliseconds so a
        blackholed link resolves into a replay quickly."""
        self.host.set_trunk_ack_timeout(ms)

    def _on_trunk_event(self, peer_id: int, payload: bytes) -> None:
        if not payload:
            return
        sub = payload[0]
        if sub == native.TRUNK_PUNT:
            # receiver-side punts: trunk entries whose local match set
            # needs Python (persistent sessions, other transports, a
            # group flip raced with replication). Local dispatch only —
            # forwarding them again would loop the cluster.
            for _origin, qos, dup, topic, body in native.parse_trunk_punts(
                    payload):
                self._trunk_punt_dispatch(qos, dup, topic, body)
            return
        node = self._trunk_id_nodes.get(peer_id)
        # mirror the link state onto every NON-OWNER shard BEFORE the
        # permit flush below: their TrunkEligible oracle must flip
        # before publishers re-earn permits (the punt→trunk ordering
        # guard, extended across shards). The owner shard (peer % n,
        # round 15) ignores its own mirror entry — OwnsTrunkPeer routes
        # it to the authoritative peer state. Conservative while it
        # lags — a lagging mirror punts, never misroutes.
        for h in self.hosts:
            h.trunk_peer_state(peer_id, sub == native.TRUNK_UP)
        with self._mirror_lock:
            peer = self._trunk_peers.get(node) if node else None
            if peer is not None:
                peer["up"] = sub == native.TRUNK_UP
                if sub == native.TRUNK_UP:
                    peer["backoff"] = TRUNK_RETRY_S
                else:
                    # exponential backoff (capped) with ±25% jitter: a
                    # partitioned peer must not be re-dialed — and
                    # warned about — every second for the partition's
                    # whole duration, and a HEALED partition must not
                    # wake every peer's redial on the same capped
                    # boundary (thundering-herd reconnect in a full
                    # mesh — the round-15 satellite)
                    backoff = peer.get("backoff", TRUNK_RETRY_S)
                    peer["retry_at"] = time.monotonic() + (
                        backoff * self._redial_rng.uniform(
                            1 - TRUNK_RETRY_JITTER,
                            1 + TRUNK_RETRY_JITTER))
                    peer["backoff"] = min(backoff * 2, TRUNK_RETRY_CAP_S)
        if sub == native.TRUNK_UP:
            log.info("trunk up: peer %s (replay done)", node)
            # ordering guard for the punt→trunk flip: every publisher
            # re-earns permits once the pipeline is idle, so a trunked
            # fast message can never overtake a same-topic frame still
            # queued in the Python forward lane
            self.flush_permits()
        else:
            reason = payload[1:].decode("ascii", "replace")
            log.warning("trunk down: peer %s (%s); remote entries degrade "
                        "to punt markers until reconnect", node, reason)
            if peer is not None:
                self._trunk_retry_at = min(self._trunk_retry_at,
                                           peer["retry_at"])

    def _trunk_punt_dispatch(self, qos: int, dup: bool, topic: str,
                             body: bytes) -> None:
        """The receiving half of the Python forward lane, fed from a
        trunk punt record: dispatch to LOCAL subscribers exactly like
        cluster/node.py _h_dispatch does for broker.dispatch casts."""
        from emqx_tpu_torch.core.message import Message

        m = Message(topic=topic, payload=body, qos=qos, from_="$trunk",
                    flags={"retain": False, "dup": dup},
                    headers={"properties": {}, "protocol": "mqtt"})
        deliveries: dict[str, list] = {}
        for route in self.broker.router.match_routes(topic):
            if route.dest == self.broker.node:
                self.broker._dispatch_local(route.topic, m, deliveries)
        if deliveries:
            self.cm.dispatch(deliveries)

    def _trunk_redial(self) -> None:
        now = time.monotonic()
        dial = []
        nxt = float("inf")
        with self._mirror_lock:
            for p in self._trunk_peers.values():
                if p["up"]:
                    continue
                at = p.get("retry_at", 0.0)
                if now >= at:
                    # schedule the NEXT attempt at this peer's backoff
                    # (±25% jitter — see _on_trunk_event); the C++ side
                    # ignores a dial while one is already in flight, so
                    # a slow connect is never torn down
                    p["retry_at"] = now + (
                        p.get("backoff", TRUNK_RETRY_S)
                        * self._redial_rng.uniform(
                            1 - TRUNK_RETRY_JITTER,
                            1 + TRUNK_RETRY_JITTER))
                    dial.append((p["id"], p["addr"], p["port"]))
                    nxt = min(nxt, p["retry_at"])
                else:
                    nxt = min(nxt, at)
        for pid, addr, port in dial:
            self.host.trunk_connect(pid, addr, port)
        self._trunk_retry_at = nxt

    # -- shared groups -------------------------------------------------------
    # A $share group is natively served only while EVERY member is a
    # fast native connection AND the node strategy is round_robin (the
    # only strategy the C++ dispatcher implements — the rest stay on
    # the Python SharedSub). Any other shape installs one punt marker
    # per (group, real filter), owned by a group token.

    def _group_token(self, group: str, real: str) -> int:
        return self._token(f"g:{group}/{real}")   # namespaced token pool

    def _shared_native_ok(self, sid: str, opts) -> bool:
        return (self._fast_global()
                and sid in self._fast_conn_of
                and getattr(opts, "subid", None) is None
                and getattr(self.app, "shared", None) is not None
                and self.app.shared.strategy == "round_robin")

    def _on_shared_event(self, op: str, sid: str, group: str,
                         real: str, opts) -> None:
        with self._shared_lock:
            st = self._shared_state.setdefault(
                (group, real), {"members": {}, "installed": None})
            if op == "add":
                st["members"][sid] = opts
                self._sid_groups.setdefault(sid, set()).add((group, real))
            else:
                st["members"].pop(sid, None)
                grps = self._sid_groups.get(sid)
                if grps is not None:
                    grps.discard((group, real))
                    if not grps:
                        del self._sid_groups[sid]
            self._reconcile_shared(group, real)

    # @locked(_shared_lock)
    def _reconcile_shared(self, group: str, real: str) -> None:
        """Idempotent: diff the desired serving shape for one group
        against what is installed in C++ and apply the delta.
        Caller holds _shared_lock."""
        gkey = (group, real)
        st = self._shared_state.get(gkey)
        if st is None:
            return
        token = self._group_token(group, real)
        members = st["members"]
        installed = st["installed"]
        if not members:
            if installed == "punt":
                self.host.sub_del(token, real)
            elif isinstance(installed, dict):
                for conn in installed.values():
                    self.host.shared_del(token, conn, real)
            self._shared_state.pop(gkey, None)
            with self._mirror_lock:
                self._punt_tokens.pop(f"g:{group}/{real}", None)
            return
        # _fast_conn_of is mutated by the poll thread outside this
        # lock: snapshot with .get and demote to punt on any miss
        # instead of racing into a KeyError
        new_map = ({s: self._fast_conn_of.get(s) for s in members}
                   if all(self._shared_native_ok(s, o)
                          for s, o in members.items()) else None)
        if new_map is not None and None not in new_map.values():
            # install-first ordering: the ops queue applies in FIFO, so
            # adding the group entries BEFORE deleting the punt marker
            # leaves no window where the group is served by neither
            # (overlap is safe — TryFast checks punt markers before any
            # group dispatch, so a punt+group overlap can't
            # double-deliver)
            old = installed if isinstance(installed, dict) else {}
            for s, conn in new_map.items():
                o = members[s]
                # upsert: refreshes qos/nl for existing members too
                self.host.shared_add(
                    token, conn, real, getattr(o, "qos", 0),
                    native.SUB_NO_LOCAL if getattr(o, "nl", 0) else 0)
            if installed == "punt":
                self.host.sub_del(token, real)
            for s, conn in old.items():
                if new_map.get(s) != conn:
                    self.host.shared_del(token, conn, real)
            st["installed"] = new_map
        else:
            # punt-first for the reverse flip, same no-gap reasoning
            if installed != "punt":
                self.host.sub_add(token, real, 0, native.SUB_PUNT)
            if isinstance(installed, dict):
                for conn in installed.values():
                    self.host.shared_del(token, conn, real)
            st["installed"] = "punt"

    def reeval_shared_groups(self) -> None:
        """Strategy change / membership-eligibility change: re-decide
        every group's serving mode (app.on_shared_strategy_change)."""
        with self._shared_lock:
            for group, real in list(self._shared_state):
                self._reconcile_shared(group, real)

    def _reconcile_sid_groups(self, sid: str) -> None:
        """Re-decide only the groups this client belongs to — O(own
        groups), not O(all groups), per connection event."""
        with self._shared_lock:
            for group, real in list(self._sid_groups.get(sid, ())):
                self._reconcile_shared(group, real)

    def _on_sub_event(self, op: str, sid: str, topic: str, opts) -> None:
        """Mirror one broker-table change into the C++ sub table.
        Thread-safe: host.sub_add/del enqueue onto the poll thread."""
        group, real = T.parse_share(topic)
        if group:
            self._on_shared_event(op, sid, group, real, opts)
            return
        # the whole get → add/del → set sequence under _mirror_lock
        # (reentrant: _token/_add_entry re-acquire it for the punt
        # refcounts): a broker-thread unsubscribe used to race the
        # poll thread's demote/promote re-mirror loops through the
        # unlocked read-modify-write (nativecheck pyfold finding,
        # round 14). Never holds across _on_shared_event — group subs
        # returned above and are never _mirror keys.
        with self._mirror_lock:
            self._on_sub_event_locked(op, sid, topic, real, opts)

    # @locked(_mirror_lock)
    def _on_sub_event_locked(self, op: str, sid: str, topic: str,
                             real: str, opts) -> None:
        if op == "add":
            conn_id = self._fast_conn_of.get(sid)
            # group subs never reach here (_on_sub_event routed them)
            if (conn_id is not None
                    and getattr(opts, "subid", None) is None):
                owner, kind = conn_id, "real"
                qos = getattr(opts, "qos", 0)
                flags = native.SUB_NO_LOCAL if getattr(opts, "nl", 0) else 0
            elif self._durable_ok(sid):
                # persistent session with the durable plane up: a
                # kSubDurable entry instead of a punt marker — the
                # publisher and every fast subscriber stay native while
                # the C++ host persists matching publishes for this
                # session (kind-10 reconciliation delivers/consumes)
                owner, kind = self._durable_token(sid), "durable"
                qos = getattr(opts, "qos", 0)
                flags = 0
            else:
                # shared group / non-durable persistent session /
                # subscription id on a fastless conn / subscriber
                # living on another transport: punt marker
                owner, kind = self._token("c:" + sid), "punt"
                qos = flags = 0
                self._warn_durable_punt(sid, topic)
            old = self._mirror.get((sid, topic))
            if old is not None and (old[0], old[1], old[2]) != (
                    owner, real, kind):
                # resubscribe flipped eligibility (e.g. a subscription
                # id appeared): the previously installed entry must go,
                # or it would keep delivering after UNSUBSCRIBE
                self._del_entry("c:" + sid, old[0], old[1], old[2])
            elif old is not None and kind == "punt":
                # duplicate 'add' for the same punt shape (resubscribe,
                # persistent-session resume re-firing every restored
                # sub): the mirror key holds EXACTLY one ref — a second
                # _add_entry would leave the refcount at 2 and the
                # single 'del' at unsubscribe would strand the punt
                # marker (topic slow-pathed forever) and leak tokens
                return
            self._add_entry("c:" + sid, owner, real, kind, qos, flags)
            self._mirror[(sid, topic)] = (owner, real, kind)
        else:
            ent = self._mirror.pop((sid, topic), None)
            if ent is not None:
                self._del_entry("c:" + sid, ent[0], ent[1], ent[2])

    # -- durable-session plane (round 10) -----------------------------------

    # Native store guids live far above Python message-id space so the
    # takeover dedup ({m.id for m in pending}) can never false-match a
    # Python-plane message against a store replay.
    DURABLE_GUID_BASE = 1 << 60

    def _durable_ok(self, sid: str) -> bool:
        return (self._durable_store is not None
                and self.app is not None
                and self.app.persistent is not None
                and self.app.persistent.is_persistent(sid))

    def _warn_durable_punt(self, sid: str, topic: str) -> None:
        """Carried edge (round 18): a persistence-less app used to
        degrade a persistent session's filters to punt-everything
        SILENTLY. Name the fallback once, loudly — the operator is one
        config knob away from the one-recovery-path durable plane."""
        if self._durable_punt_warned or self._durable_store is not None:
            return
        ch = self.cm.lookup_channel(sid)
        ci = getattr(ch, "conninfo", None)
        if ci is None or (ci.clean_start
                          and not ci.expiry_interval_ms):
            return    # clean session: the punt is not a durability story
        self._durable_punt_warned = True
        log.warning(
            "durable filter %r from persistent session %r has no "
            "persistence backing (app.persistent=%s, durable store "
            "off): falling back to PUNT-EVERYTHING — matching "
            "publishes take the Python slow path and queued messages "
            "will NOT survive a broker restart. Set durable.enable "
            "(or attach a persistent store) for the one-recovery-path "
            "durable plane.",
            topic, sid,
            "missing" if (self.app is None or self.app.persistent
                          is None) else "present")

    def _durable_token(self, sid: str) -> int:
        """sid -> store token (stable across restarts: the store
        journals REGISTER records and recovery replays them).

        Two locks: the token mint under _mirror_lock, then the reverse
        map + dead-set bookkeeping under _durable_lock — the kind-10
        fold reads _durable_sids under _durable_lock on the poll
        thread, and writing it under a DIFFERENT lock was no mutual
        exclusion at all (nativecheck pyfold finding, round 14).

        LOCK ORDER: _on_sub_event calls this while holding the
        reentrant _mirror_lock, so _durable_lock nests UNDER
        _mirror_lock here — that is the global order
        (_shared_lock -> _mirror_lock -> _durable_lock); never acquire
        _mirror_lock while holding _durable_lock."""
        with self._mirror_lock:
            tok = self._durable_tokens.get(sid)
            if tok is None:
                tok = self._durable_store.register(sid)
                self._durable_tokens[sid] = tok
        with self._durable_lock:
            self._durable_sids[tok] = sid
            # the store reuses a sid's journaled token across discard/
            # re-register, so a fresh persistent life revives it
            self._durable_dead.discard(tok)
        return tok

    def _durable_consume(self, sid: str, guids: list) -> None:
        """Spend store markers for ``sid`` — also the
        ``PersistentSessions.native_ack`` settle seam (round 18): the
        session calls here when a delivery of a store-backed message
        SETTLES (subscriber ack / qos0 write / final drop). Lookup
        falls back to the store: after a restart the token cache is
        empty but the registration survived."""
        if self._durable_store is None:
            return
        tok = (self._durable_tokens.get(sid)
               or self._durable_tok_cache.get(sid))
        if not tok:
            tok = self._durable_store.lookup(sid)
            if tok:
                # GIL-atomic write, deliberately NOT under _mirror_lock
                # (this runs with _durable_lock held from the kind-10
                # fold, and _mirror_lock must never nest under it):
                # sid→tok is stable within a token life, and a lost
                # race just repeats one lookup. _durable_discard pops
                # it with the primary cache.
                self._durable_tok_cache[sid] = tok
        if tok:
            n = self._durable_store.consume(tok, guids)
            if n:
                self.broker.metrics.inc("messages.durable.settled", n)

    def _on_durable(self, payload: bytes) -> None:
        """Fold ONE batched kind-10 durable record: per entry, deliver
        to each target persistent session's channel (live on ANY local
        transport — the cm holds disconnected channels too, whose
        session mqueue buffers) and consume the store marker when it
        reached a CONNECTED session, mirroring cm.dispatch's
        mark_delivered discipline. No channel at all (restart recovery
        state) leaves the marker for the resume replay.

        With shards, kind-10 records arrive from N poll threads
        concurrently (publishers on two shards can match one durable
        session); _durable_lock serializes the fold against itself and
        against a resume drain on another shard — the drain-watermark
        dedup is only exact when fetch/consume/fold can't interleave."""
        from emqx_tpu_torch.core.message import Message

        with self._durable_lock:
            self._on_durable_locked(payload, Message)

    # @locked(_durable_lock)
    def _on_durable_locked(self, payload: bytes, Message) -> None:
        base, ts, entries = native.parse_durable(payload)
        pers = self.app.persistent if self.app is not None else None
        metrics = self.broker.metrics
        begin = now_ms()
        # consumes BATCH per record: each store.consume call journals a
        # record and pays the policy fsync — per-entry calls turned a
        # 120k-msg blast into 120k msyncs on the poll thread (measured:
        # the plane wedged for >30s draining them)
        consumed: dict[str, list] = {}
        dead: dict[int, list] = {}
        # consume-on-ack (round 18): a marker is spent only when the
        # delivery SETTLES. Effective-qos0 deliveries settle inside
        # handle_deliver (collected through a per-call settle sink so
        # this fold keeps its batched consume); qos1/2 deliveries keep
        # their marker until the subscriber's PUBACK/PUBCOMP reaches
        # the session's settle seam — a conn death between the socket
        # write and the ack keeps the marker, so a restart resume
        # RETRANSMITS instead of losing the message.
        for i, (origin, flags, toks, topic, body,
                _trace, cid) in enumerate(entries):
            guid = base + i
            sids, seen = [], set()
            for tok in toks:
                if tok in self._durable_dead:
                    # discard raced the async durable_del: the entry was
                    # still installed when this batch flushed, but the
                    # session is gone — spend the orphan marker now
                    dead.setdefault(tok, []).append(guid)
                    continue
                sid = self._durable_sids.get(tok)
                if sid is not None and sid not in seen:
                    seen.add(sid)
                    sids.append(sid)
            if not sids:
                continue
            metrics.inc("messages.durable.stored", len(sids))
            # resolve live channels BEFORE building the Message / trie
            # match: the common durable workload is a DISCONNECTED
            # persistent subscriber, and a 100k msg/s blast must not pay
            # a Python payload copy + trie match per entry on the poll
            # thread just to hit the marker-stays continue
            live = []
            for sid in sids:
                if guid <= self._durable_drain_mark.get(sid, 0):
                    # a resume drain in this same event window already
                    # fetched+consumed this guid and replayed it through
                    # the session — delivering again would duplicate
                    # (guids are monotonic and the drain fetches the
                    # whole pending set, so the watermark is exact)
                    continue
                ch = self.cm.lookup_channel(sid)
                if ch is None or ch.session is None:
                    continue       # marker stays: restart-resume replays
                live.append((sid, ch))
            if not live:
                continue
            info = self._conninfo_for(origin)
            msg = Message(
                topic=topic, payload=body, qos=(flags >> 1) & 3,
                # the persisted origin clientid wins (it also survives
                # a restart, where conninfo cannot)
                from_=cid or (info[0] if info else "$durable"),
                id=self.DURABLE_GUID_BASE + guid,
                flags={"retain": False, "dup": bool(flags & 8)},
                headers={"properties": {}, "protocol": "mqtt"},
                timestamp=ts,
            )
            # one trie match per entry, not per target sid — the dict is
            # already keyed by sid
            matches = (pers.router.match_filters(topic)
                       if pers is not None else {})
            for sid, ch in live:
                filt = matches.get(sid, topic)
                msg.extra["deliver_begin_at"] = begin
                sess = ch.session
                # the sink is a FILTER, not a replacement: another
                # thread (a PUBACK handled on a different shard's poll
                # thread, or the asyncio transport) can fire the
                # session's settle_fn concurrently with this fold —
                # its settle must still reach the persistence seam, or
                # an acked message's marker would replay forever; only
                # THIS entry's id collects locally (review finding)
                settled_here: list = []
                old_fn = getattr(sess, "settle_fn", None)
                if sess is not None:
                    this_id = msg.id

                    def sink(mid, _prev=old_fn, _cur=this_id,
                             _out=settled_here):
                        if mid == _cur:
                            _out.append(mid)
                        elif _prev is not None:
                            _prev(mid)

                    sess.settle_fn = sink
                try:
                    ch.send(ch.handle_deliver([(filt, msg)]))
                finally:
                    if sess is not None:
                        sess.settle_fn = old_fn
                if settled_here and ch.conn_state == "connected":
                    # the delivery settled synchronously (effective
                    # qos0 / final drop): the replay marker is spent.
                    # qos1/2 entries keep it until the ack settles
                    # through the session's own settle_fn.
                    consumed.setdefault(sid, []).append(guid)
        for sid, guids in consumed.items():
            self._durable_consume(sid, guids)
        for tok, guids in dead.items():
            self._durable_store.consume(tok, guids)

    def _durable_drain(self, sid: str) -> list:
        """PersistentSessions.native_drain seam: fetch + consume the
        native store's pending set for a resuming session. On the
        native server this runs on the poll thread (CONNECT handling),
        so the replay rides the native delivery machinery — the
        session.deliver packets go straight out through host.send —
        and the drain cost lands on the replay_drain telemetry stage."""
        store = self._durable_store
        if store is None:
            return []
        t0 = time.perf_counter_ns()
        # lookup, never register: a resuming session that never had a
        # durable entry must not mint-and-journal a token per resume
        tok = self._durable_tokens.get(sid) or store.lookup(sid)
        if not tok:
            return []
        # under _durable_lock: a kind-10 fold on ANOTHER shard's poll
        # thread must see fetch + watermark + consume as one step, or
        # the drained-guid dedup stops being exact
        with self._durable_lock:
            rows = self._durable_drain_locked(sid, store, tok)
        # poll-thread-only stamp, routed to THIS thread's shard host; a
        # drain driven from another server's thread (asyncio resume
        # sharing this app) is refused with -2
        host = getattr(self._tls, "host", None) or self.hosts[0]
        host.note_stage("replay_drain", time.perf_counter_ns() - t0)
        return rows

    def _durable_drain_locked(self, sid: str, store, tok: int) -> list:
        from emqx_tpu_torch.core.message import Message

        rows = store.fetch(tok)
        pers = self.app.persistent
        # this process's python ids for Python-plane-persisted copies
        # (the unified store): a takeover mqueue copy carries the
        # python id, so the replay copy must dedup under the SAME id.
        # take_pyid spends one session's share of the translation —
        # this drain consumes the markers, so each translation retires
        # with its last session's lookup (map hygiene)
        pyid_of = getattr(pers.store, "take_pyid", None) \
            if pers is not None else None
        out, guids = [], []
        for guid, origin, ts, qos, dup, topic, body, trace, cid in rows:
            guids.append(guid)
            if trace:
                # the persisted trace id re-joins its timeline: the
                # replay span marks resume delivery of a sampled
                # publish (poll-thread context, CLOCK_MONOTONIC like
                # the C++ spans)
                self.spans.record(trace, "replay",
                                  time.monotonic_ns(), aux=guid,
                                  node=self.broker.node)
            # the sub_topic header names the MATCHED FILTER: without it
            # a wildcard subscription's replay would miss the session's
            # SubOpts lookup and be dropped as 'late delivery' AFTER
            # its markers were consumed (review finding) — the same
            # contract the Python store replay keeps in persistent.py
            filt = pers.router.match_filters(topic).get(sid, topic)
            pyid = pyid_of(guid) if pyid_of is not None else None
            out.append(Message(
                # the persisted origin clientid keeps no-local honest
                # across the restart (round 18)
                topic=topic, payload=body, qos=qos,
                from_=cid or "$durable",
                id=(pyid if pyid is not None
                    else self.DURABLE_GUID_BASE + guid),
                flags={"retain": False, "dup": dup},
                headers={"properties": {}, "protocol": "mqtt",
                         "sub_topic": filt},
                timestamp=ts,
            ))
        if guids:
            # watermark BEFORE consuming: _on_durable skips delivery of
            # drained guids, and marking first keeps the skip engaged
            # even if a kind-10 fold interleaves with the consume
            self._durable_drain_mark[sid] = max(
                self._durable_drain_mark.get(sid, 0), max(guids))
            store.consume(tok, guids)
            self.broker.metrics.inc("messages.durable.replayed",
                                    len(guids))
        return out

    def _durable_discard(self, sid: str) -> None:
        """PersistentSessions.native_discard seam (clean-start wipe /
        session expiry): drop the session's native markers."""
        store = self._durable_store
        if store is None:
            return
        # lookup, never register: clean-start wipes of sessions that
        # never had durable state must not journal REGISTER records
        # (with session churn that grows the token map without bound)
        tok = self._durable_tokens.get(sid) or store.lookup(sid)
        if not tok:
            return
        # tear down the session's live durable entries too: a dead
        # token left matching would accumulate never-consumed markers
        # (and store segments) forever. durable_del applies at the NEXT
        # ApplyPending, so mark the token dead FIRST — a batch flushed
        # in the gap reaches _on_durable, which consumes the orphans
        with self._durable_lock:
            # the dead-set and filter-map writes hold the SAME lock the
            # kind-10 fold and _del_entry read them under — an unlocked
            # wipe raced _del_entry's filters.discard/del sequence
            # (code-review finding, round 14)
            self._durable_dead.add(tok)
            filters = self._durable_filters.pop(sid, ())
        for filt in filters:
            self.host.durable_del(tok, filt)
        with self._durable_lock:
            # the wipe must not interleave with a concurrent kind-10
            # fold on another shard's poll thread (fetch + consume is
            # one step, same reasoning as the resume drain)
            guids = [row[0] for row in store.fetch(tok)]
            if guids:
                store.consume(tok, guids)
        # retire the REGISTER/SESSION records too (round 18, the
        # session-expiry GC contract): a discarded session's metadata
        # must stop pinning segments. The store mints a FRESH token on
        # re-registration, so the per-sid cache must drop the old one —
        # a stale cached token would persist markers resume can no
        # longer find (acked-but-lost).
        store.unregister(sid)
        self._durable_tok_cache.pop(sid, None)
        with self._mirror_lock:
            self._durable_tokens.pop(sid, None)

    # -- live plane handoff (round 10) --------------------------------------

    def _on_handoff(self, conn_id: int, payload: bytes) -> None:
        """Drain one kind-11 demotion record: the C++ AckState becomes
        Python session state. Awaiting-rel ids adopt into the session's
        qos2 dedup set (a DUP retransmit straddling the demotion now
        answers PUBREC without re-delivering), unacked native
        deliveries adopt as window entries the client's acks retire,
        and window-full pending frames re-enqueue into the mqueue —
        which also makes them resume-replayable (take_pending), the
        retransmit-on-reconnect story the ROADMAP tracked."""
        conn = self.conns.get(conn_id)
        if conn is None:
            return      # demotion raced the close; teardown owns cleanup
        ho = native.parse_handoff(payload)
        ch = conn.channel
        sess = getattr(ch, "session", None)
        if conn.fast:
            self._demote_python_side(conn)
        if sess is None:
            return
        if conn.recv_budget:
            # the whole receive-maximum budget returns to the session
            sess.inflight.max_size = conn.recv_budget
            conn.native_cap = 0
        pending = []
        if ho["pending"]:
            from emqx_tpu_torch.core.message import Message

            for frame in ho["pending"]:
                try:
                    pkt = parse_one(frame, ch.conninfo.proto_ver)
                except Exception:  # noqa: BLE001 — defensive
                    continue
                filt = self._match_sub(sess, pkt.topic)
                if filt is None:
                    continue
                pending.append((filt, Message(
                    topic=pkt.topic, payload=pkt.payload, qos=pkt.qos,
                    from_="$native",
                    flags={"retain": False, "dup": False},
                    headers={"properties": {}, "protocol": "mqtt"})))
        pkts = sess.adopt_native_window(
            ho["awaiting"], ho["inflight"], pending)
        if pkts:
            conn._send_packets(pkts)

    @staticmethod
    def _match_sub(sess, topic: str):
        if topic in sess.subscriptions:
            return topic
        for filt in sess.subscriptions:
            if T.match(topic, filt):
                return filt
        return None

    def _demote_python_side(self, conn: _NativeConn) -> None:
        """Python-side inverse of _maybe_enable_fast, driven by the
        kind-11 record so a bare host.disable_fast also reconciles:
        permits/grants drop, the clientid leaves the fast map, and the
        client's REAL entries re-mirror as punt/durable shapes so
        post-demotion deliveries run on the plane that owns the window."""
        ch = conn.channel
        cid = ch.clientid
        conn.fast = False
        with self._permit_lock:
            self._granted.pop(conn.conn_id, None)
        if self._fast_conn_of.get(cid) == conn.conn_id:
            del self._fast_conn_of[cid]
        # snapshot under the lock, iterate outside it: _on_sub_event
        # re-acquires it per key, and holding across the loop would
        # also order _mirror_lock under whatever the re-adds take
        with self._mirror_lock:
            mirror_items = list(self._mirror.items())
        for (sid, topic), (owner, real, kind) in mirror_items:
            if sid == cid and kind == "real":
                opts = self.broker.suboption.get((sid, topic))
                if opts is not None:
                    self._on_sub_event("add", sid, topic, opts)
        self._reconcile_sid_groups(cid)

    def promote(self, clientid: str) -> bool:
        """Re-enable the fast plane for a live clean-session conn after
        a demotion — the symmetric half of the kind-11 handoff. Nothing
        moves back into C++: every exchange the Python session holds
        stays Python-owned by construction (low pids route to it, and
        a PUBREL/DUP for an id the native awaiting-rel set doesn't own
        forwards), so promotion is a budget re-split plus fresh native
        state. Returns True when the conn re-qualified."""
        for conn in list(self.conns.values()):
            if (conn.channel.clientid == clientid and not conn.fast
                    and conn.channel.conn_state == "connected"):
                self._maybe_enable_fast(conn)
                return conn.fast
        return False

    def _maybe_enable_fast(self, conn: _NativeConn) -> None:
        """Post-CONNACK: clean sessions with no expiry get the fast
        path; persistent sessions keep every message in Python so their
        mqueue/inflight state stays authoritative."""
        ch = conn.channel
        ci = ch.conninfo
        if not self._fast_global():
            return
        if not ci.clean_start or ci.expiry_interval_ms:
            return
        conn.fast = True
        max_inflight = 0
        sess = getattr(ch, "session", None)
        if sess is not None and getattr(sess, "max_inflight", 0):
            # the client's Receive Maximum bounds ALL unacked QoS1/2
            # deliveries; native and Python deliver independently on the
            # same wire, so the budget is split between the planes. The
            # split starts half/half and is then re-divided every
            # batched ack cycle (_on_ack_batch): the busy plane grows,
            # the idle one shrinks, and the two caps always sum to the
            # budget so the client's window is never violated.
            budget = min(int(sess.max_inflight), 32766)
            max_inflight = max(1, budget // 2)
            sess.inflight.max_size = max(1, budget - max_inflight)
            conn.recv_budget = budget
            conn.native_cap = max_inflight
        # the clientid rides along (round 18): durable appends stamp it
        # into persisted entries so no-local / from_ survive a restart
        self.host.enable_fast(conn.conn_id, ci.proto_ver, max_inflight,
                              ch.clientid or "")
        self._fast_conn_of[ch.clientid] = conn.conn_id
        if ch.clientid in self._traced_clientids():
            # a running clientid trace predates this connection: punt
            # its publishes from the first frame, not the next sync
            with self._trace_lock:
                self.host.set_trace(conn.conn_id, True)
                self._traced_conns.add(conn.conn_id)
        # an earlier mirror pass may have installed this client's subs
        # as punt markers (it wasn't fast yet); re-mirror them as real
        # (_on_sub_event handles removal of the old entry on the flip);
        # snapshot under the lock, re-add outside (the demote shape).
        # D6: the snapshot holds the client's own entries, looked up by
        # its broker subscriptions; the reference copies and scans every
        # entry of the node here, O(all subscriptions) a CONNECT
        # (ROADMAP.md R14)
        cid = ch.clientid
        with self._mirror_lock:
            mirror_items = [((cid, t), self._mirror[(cid, t)])
                            for t in list(self.broker.subscription.get(
                                cid, ()))
                            if (cid, t) in self._mirror]
        for (sid, topic), (owner, real, kind) in mirror_items:
            if sid == ch.clientid and owner != conn.conn_id:
                opts = self.broker.suboption.get((sid, topic))
                if opts is not None:
                    self._on_sub_event("add", sid, topic, opts)
        # shared groups this client belongs to may now be fully native
        self._reconcile_sid_groups(ch.clientid)

    def _slow_consumers_watch(self, ch, topic: str, *,
                              msg_events: bool | None = None) -> bool:
        """True when ANY message-plane consumer needs to see every
        publish on ``topic`` — the complete enumeration of everything
        the slow path's 'message.publish' fold can do with a live,
        non-retained, non-$ message. A topic a consumer watches never
        earns a permit; every consumer fires an eager flush hook on
        change (rules, bridges, traces, topic metrics, pub rewrites,
        exhook providers), with the permit TTL as the backstop."""
        app = self.app
        if app.rules.rules_for_topic(topic) and not self._rule_taps:
            # rules must see every message. With the tap mirror active
            # (fast_path servers sync it at startup and on every rule
            # change) the matched frames COPY to the rule runtime from
            # the fast path itself, so rules no longer veto permits —
            # the FROM '#' cliff (130x collapse to the Python plane) is
            # gone. _rule_taps empty means taps aren't mirrored (e.g.
            # rules exist but the sync hasn't run): keep the veto.
            return True
        if (msg_events if msg_events is not None
                else app.rules.watches_message_events()):
            # a $events/message_delivered|acked|dropped rule consumes
            # per-delivery events that only the Python plane fires —
            # native deliveries/acks/drops would silently bypass it, so
            # NO topic may hold a permit while one exists (create_rule's
            # on_topology_change flush revokes existing permits eagerly;
            # the grant loop precomputes msg_events once per cycle)
            return True
        if any(t.matches(ch.clientid, topic, str(ch.conninfo.peername))
                for t in app.trace.running()    # locked snapshot
                if getattr(t, "mode", "punt") != "native"):
            return True                 # traced topics stay observable
            # (native-mode traces deliberately do NOT veto the permit:
            # they observe via the sampled span plane, keeping the
            # traced workload on the fast path)
        if any(T.match(topic, f) for f in app.topic_metrics.topics()):
            return True
        rw = getattr(app, "rewrite", None)
        if rw is not None and any(
                r.action in ("publish", "all")
                and T.match(topic, r.source_topic)
                for r in rw.pub_rules):
            return True                 # topic rewrite redirects these
        br = getattr(app, "bridges", None)
        if br is not None:
            for b in br.bridges.values():
                local = ((b.conf.get("egress") or {}).get("local") or {})
                filt = local.get("topic")
                if filt and T.match(topic, filt):
                    return True         # direct egress forwards these
        ex = getattr(app, "exhook", None)
        if ex is not None:
            try:
                watchers = list(ex.servers.values())
            except RuntimeError:        # REST thread resizing the dict
                return True             # conservative: treat as watched
            if any(h.startswith("message.")
                   for s in watchers for h in s.hooks_wanted):
                return True             # providers watch the message plane
        return False

    def _grant_permits(self, queued=None) -> None:
        """Runs after pipeline.flush() in _step: every queued slow-path
        publish already delivered, so granting now preserves per-topic
        ordering across the slow→fast transition. Holds _permit_lock so
        a concurrent flush_permits (trace started on a REST thread)
        cannot interleave: grants re-check the consumer list under the
        lock, so they either complete before the flush (which then
        clears them) or start after it (and see the new watcher).
        ``queued`` is the pre-flush snapshot _step took (None = drain
        the live queue, the pre-shard call shape)."""
        with self._permit_lock:
            self._grant_permits_locked(queued)

    def _grant_permits_locked(self, queued=None) -> None:
        if queued is None:
            queued, self._permit_queue = self._permit_queue, []
        if not queued:
            return
        # topic-independent veto, hoisted so its O(rules) scan runs once
        # per grant cycle, not once per queued topic; the result feeds
        # _slow_consumers_watch below so the per-topic path skips it too
        msg_events = (self.app is not None
                      and self.app.rules.watches_message_events())
        if msg_events:
            return
        for conn, topic in queued:
            ch = conn.channel
            if (not conn.fast or ch.conn_state != "connected"
                    or not self._fast_global()):
                continue
            granted = self._granted.setdefault(conn.conn_id, set())
            if topic in granted or len(granted) >= MAX_PERMITS_PER_CONN:
                continue
            app = self.app
            if app is not None and self._slow_consumers_watch(
                    ch, topic, msg_events=msg_events):
                continue
            verdict = ch.hooks.run_fold(
                "client.authorize",
                (dict(clientid=ch.clientid,
                      username=ch.conninfo.username,
                      peername=ch.conninfo.peername),
                 "publish", topic),
                "allow")
            if verdict != "allow":
                continue
            granted.add(topic)
            self.host.permit(conn.conn_id, topic)

    # -- event loop ---------------------------------------------------------

    def _step_host(self, host, timeout_ms: int = 100) -> None:
        """Drain one poll cycle of ONE shard host. Runs concurrently on
        N poll threads when sharded: per-conn work is naturally
        shard-local (a conn id names its owner shard), the shared folds
        (acks/telemetry/durable) take their locks inside."""
        lane_buf = None
        for kind, conn_id, payload in host.poll(timeout_ms):
            if kind == native.EV_OPEN:
                conn = _NativeConn(
                    self, conn_id, payload.decode("ascii", "replace"))
                self.conns[conn_id] = conn
                # scanned until a native keepalive is armed and the
                # session proves idle (the housekeep drops it then)
                with self._scan_lock:
                    self._scan_conns[conn_id] = conn
            elif kind == native.EV_FRAME:
                conn = self.conns.get(conn_id)
                if conn is not None:
                    self._on_frame(conn, payload)
                else:
                    self._orphan_frame(conn_id, payload)
            elif kind == native.EV_LANE:
                # conn field carries the lane sequence number; the item
                # remembers its host so the pump answers the right shard
                # (lane seqs are per-host counters)
                if lane_buf is None:
                    lane_buf = []
                lane_buf.append(
                    (host, conn_id, payload.decode("utf-8", "replace")))
            elif kind == native.EV_TAP:
                self._on_tap(conn_id, payload)
            elif kind == native.EV_ACKS:
                # the id slot carries the producing shard (round 12);
                # conn ids inside the record are globally unique
                self._on_ack_batch(payload)
            elif kind == native.EV_TELEMETRY:
                self._on_telemetry(payload, conn_id)
            elif kind == native.EV_SPANS:
                # the id slot carries the producing shard (like 7/8/10)
                self._on_spans(payload, conn_id)
            elif kind == native.EV_TRUNK:
                self._on_trunk_event(conn_id, payload)
            elif kind == native.EV_DURABLE:
                self._on_durable(payload)
            elif kind == native.EV_HANDOFF:
                self._on_handoff(conn_id, payload)
            elif kind == native.EV_COAP:
                self._on_coap(conn_id, payload)
            elif kind == native.EV_CLOSED:
                with self._trace_lock:
                    self._traced_conns.discard(conn_id)
                with self._scan_lock:
                    self._scan_conns.pop(conn_id, None)
                with self._coap_lock:
                    och = self._coap_oracle.pop(conn_id, None)
                    if och is not None:
                        try:
                            och.terminate(payload.decode(
                                "ascii", "replace"))
                        except Exception:
                            pass
                conn = self.conns.pop(conn_id, None)
                if conn is not None:
                    ch = conn.channel
                    if conn.fast:
                        # a lane punt / rule tap may still surface this
                        # conn's frames (up to the stale deadline)
                        with self._closed_lock:
                            self._closed_conns[conn_id] = (
                                ch.clientid, ch.conninfo.proto_ver,
                                ch.conninfo.username,
                                ch.conninfo.peername)
                            if len(self._closed_conns) > 4096:
                                self._closed_conns.pop(
                                    next(iter(self._closed_conns)))
                    self._forget_fast(conn)
                    ch.terminate(payload.decode("ascii", "replace"))
        if lane_buf:
            self._lane_q.put(lane_buf)

    def _step(self, timeout_ms: int = 100) -> None:
        """One shard-0 loop step plus the server-global duties (the
        pipeline flush, permit grants, trunk redial, housekeep).
        Secondary shards run bare _step_host loops (_run_shard) with
        only their own conns' keepalive scan."""
        self._step_host(self.hosts[0], timeout_ms)
        # snapshot the permit queue BEFORE the flush: entries appended
        # by any shard's poll thread had their publishes submitted
        # first (handle_in submits, _on_frame appends after), so every
        # snapshotted entry's traffic is covered by THIS flush — while
        # an entry appended mid-flush could still have a publish queued
        # in the pipeline, and granting it now would let a fast message
        # overtake a queued slow one
        pending = None
        if self._permit_queue:
            with self._permit_lock:
                pending, self._permit_queue = self._permit_queue, []
        if self.pipeline is not None:
            self.pipeline.flush()
        if pending:
            self._grant_permits(pending)
        now = time.monotonic()
        if now >= self._trunk_retry_at:
            self._trunk_redial()
        if now - self._last_housekeep >= HOUSEKEEP_INTERVAL:
            self._last_housekeep = now
            self._housekeep()

    def _on_frame(self, conn: _NativeConn, frame: bytes) -> None:
        ch = conn.channel
        # context for the native retained seam: the session.subscribed
        # hook fires INSIDE handle_in, and _native_retained must know
        # which conn's SUBSCRIBE it is serving (thread-local: each
        # shard's poll thread handles only its own conns' frames)
        self._tls.frame_conn = conn
        try:
            pkt = parse_one(frame, ch.conninfo.proto_ver)
            if pkt.type == P.CONNECT:
                ch.conninfo.proto_ver = pkt.proto_ver
            out = ch.handle_in(pkt)
        except (FrameError, IndexError) as e:
            # per-connection fault isolation: a bad frame (or a channel
            # protocol error) drops this client, never the poll thread —
            # same containment the asyncio server gets from its per-conn task
            log.info("frame error from %s: %s", ch.conninfo.peername, e)
            if ch.conninfo.proto_ver == P.MQTT_V5:
                rc = getattr(e, "rc", P.RC_MALFORMED_PACKET)
                conn._send_packets([P.Disconnect(reason_code=rc)])
            self._drop(conn, "frame_error")
            return
        except Exception:
            log.exception("channel error from %s", ch.conninfo.peername)
            self._drop(conn, "channel_error")
            return
        finally:
            self._tls.frame_conn = None
        conn._send_packets(out)
        if ch.conn_state == "disconnected":
            self._drop(conn, "normal")
            return
        if pkt.type == P.CONNECT and ch.conn_state == "connected":
            # keepalive moves onto the C++ timer wheel for EVERY conn
            # (the host's last_rx stamp covers fast, slow, and SN
            # transports alike): the Python housekeep's O(N) idle
            # sweep is gone — C++ closes as "keepalive_timeout", the
            # same reason string the old Python path used
            ka = ch.conninfo.keepalive
            self.host.set_keepalive(
                conn.conn_id, ka * 1500 if ka else 0)
            conn.native_ka = True
            self._maybe_enable_fast(conn)
        elif (conn.fast and pkt.type == P.PUBLISH
              and not pkt.retain and pkt.topic
              and not pkt.topic.startswith("$")):
            # this publish took the full path (no permit yet): queue the
            # topic for a permit decision once the pipeline is idle.
            # All QoS levels qualify since round 6: the C++ host owns
            # the QoS2 exchange (awaiting-rel dedup + PUBREC/PUBREL/
            # PUBCOMP) for permitted topics
            self._permit_queue.append((conn, pkt.topic))

    def _conninfo_for(self, conn_id: int):
        """(clientid, proto_ver, username, peername) for a live or
        recently closed conn; None when unknown."""
        conn = self.conns.get(conn_id)
        if conn is not None:
            ci = conn.channel.conninfo
            return (conn.channel.clientid, ci.proto_ver, ci.username,
                    ci.peername)
        # under _closed_lock: the capped insert+evict runs on every
        # shard's poll thread while this reads from the tap worker
        with self._closed_lock:
            return self._closed_conns.get(conn_id)

    @staticmethod
    def _tap_count(batch: bytes) -> int:
        """Entries in one tap batch (header-only walk, drop accounting).
        Entry: [u64 publisher][u8 flags][u16 tlen][topic] +
        (flags bit0 ? [u32 plen][payload] : payload of previous entry);
        flags bits 1-2 = qos, bit 3 = publisher DUP."""
        n = pos = 0
        blen = len(batch)
        while pos + 11 <= blen:
            flags = batch[pos + 8]
            tlen = int.from_bytes(batch[pos + 9:pos + 11], "little")
            pos += 11 + tlen
            if flags & 1:
                if pos + 4 > blen:
                    break
                pos += 4 + int.from_bytes(batch[pos:pos + 4], "little")
            n += 1
        return n

    def _on_tap(self, _conn_id: int, batch: bytes) -> None:
        """Natively-delivered publishes that matched rule-tap entries,
        BATCHED into one record per C++ poll cycle and PRE-PARSED
        (host.cc EmitTap: topic/qos fields + payload-deduped bytes, the
        round-7 copy elision). The poll thread does ONE queue put per
        batch — decoding and conninfo resolution happen on the worker
        (per-message work here measurably throttled the data plane).
        Bounded: under sustained rule-eval overload whole batches drop,
        message-counted into tap_dropped."""
        try:
            self._tap_q.put_nowait(batch)
        except queue.Full:
            # under _tap_lock: += is a read-modify-write, and N shard
            # poll threads hitting Full together lost drop counts
            with self._tap_lock:
                self.tap_dropped += self._tap_count(batch)

    def _tap_worker(self) -> None:
        """Evaluate rules against tapped publishes off the poll thread.
        They were already natively delivered; only the rule engine sees
        them here (app.rules.ingest → same _fire path the hook fold
        uses). The entries arrive pre-parsed from C++, so no MQTT
        re-parse runs here — with full-frame copies + parse_one this
        worker's GIL hold was a chunk of the rule-tap tax on the data
        plane (BENCH_r05 rule_tap_vs_free=0.59). The rest is GIL
        latency: rule evaluation is ~20µs/message of pure Python, so
        without explicit releases the poll thread waits up to the 5 ms
        switch interval per GIL acquisition. Discipline: sleep(0)
        every 8 messages (~160 µs of work) hands the GIL over promptly
        — rule evaluation is elastic, the data plane is not. (No
        thread-priority drop: see the inline note at the yield.)
        conninfo lookups read self.conns cross-thread: GIL-safe, and a
        conn closed mid-read falls back to the recently-closed map (or
        is skipped)."""
        from emqx_tpu_torch.core.message import Message

        ingest = self.app.rules.ingest
        done_since_yield = 0
        while not self._stop.is_set():
            try:
                batch = self._tap_q.get(timeout=0.2)
            except queue.Empty:
                continue
            pos, blen = 0, len(batch)
            payload = b""           # dedup carry (within one batch only)
            while pos + 11 <= blen:
                publisher = int.from_bytes(batch[pos:pos + 8], "little")
                flags = batch[pos + 8]
                tlen = int.from_bytes(batch[pos + 9:pos + 11], "little")
                pos += 11
                topic = batch[pos:pos + tlen].decode("utf-8", "replace")
                pos += tlen
                if flags & 1:
                    if pos + 4 > blen:
                        break       # truncated batch: defensive stop
                    plen = int.from_bytes(batch[pos:pos + 4], "little")
                    pos += 4
                    payload = batch[pos:pos + plen]
                    pos += plen
                info = self._conninfo_for(publisher)
                if info is None:
                    continue
                clientid, _proto_ver, username, peername = info
                try:
                    # fast-path publishes carry no v5 properties (the
                    # permit requires an empty property section), so
                    # the Message builds straight from the tap fields
                    msg = Message(
                        topic=topic, payload=payload,
                        qos=(flags >> 1) & 3, from_=clientid,
                        flags={"retain": False, "dup": bool(flags & 8)},
                        headers={"properties": {},
                                 "username": username,
                                 "peername": peername,
                                 "protocol": "mqtt"},
                    )
                    ingest(msg)
                except Exception:  # noqa: BLE001 — one bad entry/rule
                    log.exception("rule tap evaluation failed")
                done_since_yield += 1
                if done_since_yield >= 8:
                    # release the GIL mid-batch: the C++ plane only
                    # runs while a thread sits inside emqx_host_poll,
                    # so every ms the poll thread spends WAITING for
                    # the GIL is a stalled data plane. ~160µs stints
                    # bound that wait; the sleep(0) costs ~1µs per 8
                    # messages of ~20µs each. (Deliberately NOT paired
                    # with a lower thread priority: a deprioritized
                    # holder parked mid-stint is a priority inversion
                    # on the GIL.)
                    done_since_yield = 0
                    time.sleep(0)

    def _on_ack_batch(self, batch: bytes) -> None:
        """Drain ONE batched ack record (host.cc kind 7) — the per-poll
        cycle summary of every native window event: slots freed by
        PUBACK/PUBCOMP, publisher PUBREL completions, and the live
        inflight/pending depths per connection.

        Three jobs, all cycle-rate instead of message-rate:
        - fold the deltas into the node metrics (the slow path counts
          these inline per packet);
        - reconcile each session: gauges + mqueue handoff for
          natively-freed window slots (session.native_ack_sync);
        - re-divide the receive-maximum budget between the planes: the
          native cap tracks observed native demand, Python keeps the
          rest. Caps always sum to <= the budget and the cap op applies
          on the poll thread BEFORE the next socket read, so the
          client's Receive Maximum holds at every instant."""
        if len(batch) < 4:
            return
        n = int.from_bytes(batch[:4], "little")
        pos = 4
        tot_acked = tot_rel = max_seen = 0
        for _ in range(n):
            if pos + 24 > len(batch):
                break
            cid = int.from_bytes(batch[pos:pos + 8], "little")
            acked = int.from_bytes(batch[pos + 8:pos + 12], "little")
            rel = int.from_bytes(batch[pos + 12:pos + 16], "little")
            inflight_now = int.from_bytes(batch[pos + 16:pos + 20],
                                          "little")
            pending_now = int.from_bytes(batch[pos + 20:pos + 24],
                                         "little")
            pos += 24
            tot_acked += acked
            tot_rel += rel
            if inflight_now > max_seen:
                max_seen = inflight_now
            conn = self.conns.get(cid)
            if conn is None or not conn.fast:
                continue
            sess = getattr(conn.channel, "session", None)
            if sess is None:
                continue
            pkts = sess.native_ack_sync(inflight_now, pending_now, acked)
            if pkts:
                conn._send_packets(pkts)
            budget = conn.recv_budget
            if budget:
                # native demand estimate: current occupancy doubled
                # (headroom for the next cycle) or occupancy + queued
                # backlog, floored at the half split; Python retains at
                # least its live occupancy + one slot. Hysteresis: a
                # per-cycle cap op for every occupancy wiggle measurably
                # taxed the data plane — only re-divide on a real shift
                reserve = max(len(sess.inflight), 1)
                want = max(budget // 2, CAP_HEADROOM * inflight_now,
                           min(inflight_now + pending_now, budget))
                cap = max(1, min(want, budget - reserve))
                if abs(cap - conn.native_cap) >= max(CAP_DEADBAND_MIN,
                                                     budget
                                                     // CAP_DEADBAND_DIV):
                    conn.native_cap = cap
                    self.host.set_inflight_cap(cid, cap)
                    sess.inflight.max_size = max(1, budget - cap)
        # kind-7 records arrive from N poll threads when sharded: the
        # shared totals fold under _ack_lock (each conn's session sync
        # above is shard-local — a conn lives on exactly one shard)
        with self._ack_lock:
            ap = self.ack_plane
            ap["acked"] += tot_acked
            ap["rel"] += tot_rel
            ap["batches"] += 1
            if max_seen > ap["max_inflight_seen"]:
                ap["max_inflight_seen"] = max_seen
        m = self.broker.metrics
        if tot_acked:
            m.inc("messages.acked", tot_acked)
            m.inc("messages.native.acked", tot_acked)

    def _on_telemetry(self, payload: bytes, shard: int = 0) -> None:
        """Fold ONE batched kind-8 telemetry record (host.cc): per-cycle
        histogram deltas into the node metrics' LatencyHistograms,
        slow-ack samples into slow_subs (the native plane's entry into
        the slow-subscriber ranking), and flight-recorder dumps into
        the recent-dumps ring + any matching clientid trace log.
        Runs on the poll thread: cycle-rate, small records, no I/O.
        ``shard`` is the record's id-slot field (round 12): N poll
        threads fold concurrently under _tele_lock, and the deltas
        land in both the global and the per-shard histograms."""
        stages = native.HIST_STAGES
        shard_hists = self._shard_hists.get(shard)
        for rec in native.parse_telemetry(payload):
            kind = rec[0]
            if kind == "hist":
                _, stage_i, cnt, sum_ns, buckets = rec
                if stage_i < len(stages):
                    with self._tele_lock:
                        self._hists[stages[stage_i]].observe_delta(
                            cnt, sum_ns, buckets)
                        if shard_hists is not None:
                            shard_hists[stages[stage_i]].observe_delta(
                                cnt, sum_ns, buckets)
            elif kind == "slow_ack":
                _, conn_id, rtt_us, _qos, topic = rec
                info = self._conninfo_for(conn_id)
                if info is not None and self.app is not None:
                    # rank the SUBSCRIBER whose ack lagged, like the
                    # delivery.completed hook does on the Python plane
                    self.app.slow_subs.record(
                        info[0], topic, rtt_us // 1000, plane="native")
            else:  # flight-recorder dump
                _, conn_id, reason, entries = rec
                self.flight_records.append((conn_id, reason, entries))
                info = self._conninfo_for(conn_id)
                if info is None or self.app is None:
                    continue
                why = native.FR_REASON_NAMES.get(reason, str(reason))
                detail = (f"conn={conn_id} reason={why} "
                          + "; ".join(native.format_flight(entries)))
                self.app.trace.log_for_client(info[0], "FLIGHT", detail)
                if reason != 3:  # abnormal close / protocol error
                    log.debug("flight recorder dump (%s) for %s: %s",
                              why, info[0], detail)

    def _on_spans(self, payload: bytes, shard: int = 0) -> None:
        """Fold ONE batched kind-12 trace record: span points into the
        SpanCollector (+ the trace log for native-mode clientid traces
        + prometheus exemplars), ledger entries into the degradation
        ledger (fixed messages.ledger.* slots + the bounded event
        ring). Cycle-rate and sampled — runs on the poll thread under
        _tele_lock (N producers when sharded)."""
        stages = native.SPAN_STAGES
        reasons = native.LEDGER_REASONS
        node = self.broker.node
        with self._tele_lock:
            for rec in native.parse_spans(payload):
                if rec[0] == "span":
                    _, tid, stage_i, t_ns, aux = rec
                    stage = (stages[stage_i] if stage_i < len(stages)
                             else f"stage{stage_i}")
                    self.spans.record(tid, stage, t_ns, shard=shard,
                                      aux=aux, node=node)
                    if stage == "ingress" and self._native_traced:
                        info = self._conninfo_for(aux)
                        if (info is not None
                                and info[0] in self._native_traced):
                            self._trace_log_ids[tid] = info[0]
                            while len(self._trace_log_ids) > 256:
                                self._trace_log_ids.popitem(last=False)
                    cid = self._trace_log_ids.get(tid)
                    if cid is not None and self.app is not None:
                        # only deliver_write defines bit 63 (the span
                        # cap's truncation marker) — other stages' aux
                        # passes through untouched
                        trunc = ""
                        if stage == "deliver_write" and aux >> 63:
                            trunc, aux = " truncated", aux & ~(1 << 63)
                        self.app.trace.log_for_client(
                            cid, "SPAN",
                            f"trace={tid:016x} {stage} shard={shard} "
                            f"aux={aux} t_ns={t_ns}{trunc}")
                    # exemplars: hang the trace id off the stage
                    # histograms its timeline measures
                    if stage == "route":
                        self._exemplar(tid, "ingress", t_ns,
                                       "ingress_route")
                    elif stage == "ack":
                        # ack aux carries the delivery qos in bits
                        # 60-61 (host.cc TeleAckRtt) so a qos2
                        # exchange's exemplar lands on qos2_rtt
                        qos = (aux >> 60) & 3
                        self._exemplar(tid, "deliver_write", t_ns,
                                       "qos2_rtt" if qos == 2
                                       else "qos1_rtt")
                else:
                    _, reason_i, count, tid, aux, _t_ns = rec
                    name = (reasons[reason_i - 1]
                            if 1 <= reason_i <= len(reasons)
                            else f"reason{reason_i}")
                    self.ledger.record(name, count, shard=shard,
                                       trace_id=tid, aux=aux)

    # @locked(_tele_lock)
    def _exemplar(self, tid: int, from_stage: str, t_ns: int,
                  hist: str) -> None:
        """Attach ``t_ns - t(from_stage)`` of trace ``tid`` as an
        OpenMetrics exemplar on ``hist`` (caller holds _tele_lock)."""
        for t0, stage, _sh, _n, _aux in self.spans.trace(tid):
            if stage == from_stage:
                if t_ns > t0:
                    self._hists[hist].put_exemplar(tid, t_ns - t0)
                return

    def spans_recent(self, limit: int = 32) -> list[dict]:
        """Assembled recent traces, JSON-shaped (the mgmt surface)."""
        out = []
        for tid, spans in self.spans.recent(limit):
            # deliver_write aux bit 63 = the 8-per-publish span cap
            # clipped this fan-out (host.cc kSpanTruncBit): surface it
            # so a stitched timeline never silently reads as the full
            # audience. Only deliver_write defines the bit — other
            # stages' aux passes through unmasked (ack already packs
            # qos into bits 60-61).
            out.append({
                "trace_id": f"{tid:016x}",
                "spans": [{"t_ns": t, "stage": s, "shard": sh,
                           "node": n,
                           "aux": (a & ~(1 << 63)
                                   if s == "deliver_write" else a),
                           "truncated": (s == "deliver_write"
                                         and bool(a >> 63))}
                          for t, s, sh, n, a in spans],
            })
        return out

    def latency_summary(self) -> dict[str, dict]:
        """Broker-side stage percentiles (p50/p99/p999 in µs + counts)
        for every stage with observations — the bench.py artifact
        surface next to the loadgen-side numbers."""
        return {stage: h.summary()
                for stage, h in self._hists.items() if h.count > 0}

    def shard_latency_summary(self) -> dict[int, dict]:
        """Per-shard stage percentiles (bench surface for the shards
        section); empty on an unsharded server."""
        return {shard: {stage: h.summary()
                        for stage, h in hists.items() if h.count > 0}
                for shard, hists in self._shard_hists.items()}

    def shard_stats(self) -> list[dict[str, int]]:
        """Raw per-shard host counters in shard order (the aggregate is
        ``fast_stats``)."""
        return [h.stats() for h in self.hosts]

    def _orphan_frame(self, conn_id: int, frame: bytes) -> None:
        """A frame surfaced for a conn we already tore down — in
        practice a lane punt replaying a parked PUBLISH after its
        publisher disconnected. The message was accepted while the
        connection was live (permit = authorization already ran), so it
        must still be published; only QoS<=1 non-retained plain-name
        frames can ever park on the lane, and the publisher being gone
        means no ack is owed."""
        info = self._closed_conns.get(conn_id)
        if info is None:
            return                     # unknown conn: nothing to honour
        clientid, proto_ver, _username, _peername = info
        try:
            pkt = parse_one(frame, proto_ver)
        except Exception:  # noqa: BLE001 — defensive: drop, don't crash
            return
        if pkt.type != P.PUBLISH or pkt.qos > 1 or pkt.retain \
                or not pkt.topic or pkt.topic.startswith("$"):
            return
        from emqx_tpu_torch.core.message import Message

        props = dict(pkt.properties or {})
        props.pop("Topic-Alias", None)  # connection-scoped
        msg = Message(
            topic=pkt.topic, payload=pkt.payload, qos=pkt.qos,
            from_=clientid,
            flags={"retain": False, "dup": pkt.dup},
            headers={"properties": props, "protocol": "mqtt"},
        )
        if self.pipeline is not None:
            self.pipeline.submit(msg)
        else:
            self.cm.dispatch(self.broker.publish(msg))

    def _forget_fast(self, conn: _NativeConn) -> None:
        cid = conn.channel.clientid
        with self._trace_lock:
            self._traced_conns.discard(conn.conn_id)
        if self._fast_conn_of.get(cid) == conn.conn_id:
            del self._fast_conn_of[cid]
        if conn.fast:
            conn.fast = False
            # no-op when the conn is already closing; clears native
            # permits/inflight if a future caller revokes eligibility
            # on a live connection
            self.host.disable_fast(conn.conn_id)
        self._granted.pop(conn.conn_id, None)
        # groups this client served natively fall back to punt until the
        # session teardown removes the membership (or a reconnect
        # re-qualifies it)
        self._reconcile_sid_groups(cid)

    def _scan_watch(self, conn: _NativeConn) -> None:
        """(Re-)enter a conn into the housekeep scan set — called on
        every Python-plane packet egress, so a session that regrows
        retry/awaiting state is scanned again until it drains."""
        with self._scan_lock:
            self._scan_conns[conn.conn_id] = conn

    def _drop(self, conn: _NativeConn, reason: str) -> None:
        with self._scan_lock:
            self._scan_conns.pop(conn.conn_id, None)
        self.conns.pop(conn.conn_id, None)
        self._forget_fast(conn)
        conn.channel.terminate(reason)
        self.host.close_conn(conn.conn_id)

    def _housekeep(self) -> None:
        # app.tick() can block on bridge reconnects / disk-queue flushes;
        # run it off the poll thread (the asyncio server offloads it with
        # asyncio.to_thread for the same reason) so frame processing and
        # keepalive handling never stall behind it.  _tick_running keeps
        # at most one tick in flight.
        if (self.app is not None and not self._tick_running.is_set()
                and not self._stop.is_set()):
            self._tick_running.set()

            def _tick():
                try:
                    self.app.tick()
                except Exception:  # pragma: no cover - defensive
                    log.exception("app.tick failed")
                finally:
                    self._tick_running.clear()

            try:
                self._tick_pool.submit(_tick)
            except RuntimeError:  # pragma: no cover — stop() raced this
                # housekeep between the _stop check and the submit;
                # the pool is gone, the poll loop exits on its next
                # _stop check. Silence beats "poll step failed" noise.
                self._tick_running.clear()
        self._merge_fast_metrics()
        self._lane_auto()
        if self._durable_store is not None:
            # unlink all-consumed store segments / compact thin tails
            self._durable_store.gc()
            degraded = self._durable_store.stats()["degraded"]
            if degraded > self._store_degraded_seen:
                # mid-run segment-open/mmap failure (disk full?): the
                # store fell back to anonymous segments — qos1 PUBACKs
                # keep flowing but restart survival is GONE for the
                # degraded stretch; say so loudly, once per incident
                delta = degraded - self._store_degraded_seen
                self._store_degraded_seen = degraded
                self.ledger.record("store_degraded", delta,
                                   detail=self._durable_store.dir)
                log.error(
                    "durable store degraded to in-memory segments "
                    "(%d incidents): acked messages in this stretch "
                    "will NOT survive a restart — check disk space at "
                    "%r", degraded, self._durable_store.dir)
        if self.app is not None and self.telemetry:
            # follow a live slow_subs.threshold change (config update)
            # down to the C++ slow-ack report floor
            thr = self.app.slow_subs.threshold_ms
            if thr != self._slow_ack_ms:
                self._slow_ack_ms = thr
                self.host.set_telemetry(True, slow_ack_ms=thr)
        if time.monotonic() - self._last_permit_flush >= PERMIT_TTL_S:
            # the authz-cache TTL analogue: permits re-earn periodically
            # so an authz/banned change can't be outrun forever
            self._last_permit_flush = time.monotonic()
            if self._granted:
                self.flush_permits()
        if self.coap_port is not None:
            self._coap_housekeep()
        self._housekeep_conns(0)

    def _housekeep_conns(self, shard: int) -> None:
        """Session-timer scan for ONE shard's ACTIVE conns. Must run
        on that shard's poll thread: conn_idle_ms walks poll-thread-
        owned C++ state, and channel timeouts must not race the thread
        handling the conn's frames. Shard 0's scan rides the global
        housekeep.

        Round 16: the full-conn keepalive sweep is GONE — keepalive
        deadlines live on the C++ timer wheel (set_keepalive at
        CONNACK), so this loop walks only the scan set: conns whose
        Python session may hold retry/awaiting-rel work. A conn leaves
        the set once its session drains (and re-enters through
        _scan_watch on any Python-plane egress), so housekeep cost
        tracks ACTIVE sessions, not the parked million."""
        sharded = self.shards > 1
        with self._scan_lock:
            scan = list(self._scan_conns.values())
        for conn in scan:
            if sharded and native.shard_of(conn.conn_id) != shard:
                continue
            if conn.conn_id not in self.conns:   # raced a teardown
                with self._scan_lock:
                    self._scan_conns.pop(conn.conn_id, None)
                continue
            ch = conn.channel
            if not conn.native_ka:
                # pre-CONNACK (or legacy-armed) conns: the old path —
                # feed the idle clock for transports whose frames never
                # reach the channel, enforce keepalive in Python
                if conn.fast or conn.sn or conn.coap:
                    idle = self.host.conn_idle_ms(conn.conn_id)
                    if idle >= 0:
                        ch.last_packet_at = max(
                            ch.last_packet_at, now_ms() - idle)
                if ch.keepalive_expired():
                    self._drop(conn, "keepalive_timeout")
                    continue
            conn._send_packets(ch.handle_timeout("retry"))
            ch.handle_timeout("expire_awaiting_rel")
            if conn.native_ka:
                sess = getattr(ch, "session", None)
                # idle-check and pop under ONE lock hold: a concurrent
                # delivery grows the session BEFORE its _scan_watch
                # re-add, so evaluating idleness inside the lock means
                # either we see the growth (no pop) or the re-add
                # serializes after our pop (conn stays scanned) — never
                # a popped conn with live retry state
                with self._scan_lock:
                    if sess is None or (sess.inflight.is_empty()
                                        and not sess.awaiting_rel):
                        # no session timer work left: leave the scan
                        # until the next egress re-enters us
                        self._scan_conns.pop(conn.conn_id, None)

    def _merge_fast_metrics(self) -> None:
        """Fold the C++ counters into the node metrics so $SYS /
        Prometheus see fast-path traffic (the slow path increments these
        inline; the fast path batches them per housekeep)."""
        stats = self.host.stats()
        m = self.broker.metrics
        seen = self._stats_seen
        d_in = stats["fast_in"] - seen["fast_in"]
        d_out = stats["fast_out"] - seen["fast_out"]
        d_q1 = stats["qos1_in"] - seen["qos1_in"]
        d_q2 = stats["qos2_in"] - seen["qos2_in"]
        d_lto = stats["lane_topic_overflow"] - seen["lane_topic_overflow"]
        d_drop = (stats["drops_backpressure"] + stats["drops_inflight"]
                  - seen["drops_backpressure"] - seen["drops_inflight"]
                  + d_lto)
        if d_in:
            m.inc("messages.received", d_in)
            m.inc("messages.publish", d_in)
            m.inc("messages.native.received", d_in)
            # per-qos splits (the slow path counts these per packet)
            if d_q1:
                m.inc("messages.qos1.received", d_q1)
                m.inc("messages.native.qos1.received", d_q1)
            if d_q2:
                m.inc("messages.qos2.received", d_q2)
                m.inc("messages.native.qos2.received", d_q2)
            d_q0 = d_in - d_q1 - d_q2
            if d_q0 > 0:
                m.inc("messages.qos0.received", d_q0)
        if d_lto:
            # distinct from delivery backpressure: INBOUND per-topic
            # lane flood (host.cc kLaneTopicMax) — logged loud so
            # operators can tell the two overload shapes apart
            m.inc("messages.native.lane_topic_overflow", d_lto)
            log.warning(
                "device-lane per-topic overload: dropped %d publishes "
                "beyond the in-flight cap (lane_topic_overflow=%d total)",
                d_lto, stats["lane_topic_overflow"])
        if d_out:
            m.inc("messages.sent", d_out)
            m.inc("messages.delivered", d_out)
        if d_drop:
            m.inc("messages.dropped", d_drop)
        # faultline (round 15): per-site injected-fault counters fold
        # into the fixed faults.* metric slots. Host-plane fires are
        # already ledger-visible below the GIL (kind-12, reason
        # "fault"); STORE-site fires happen under the store mutex on
        # arbitrary threads, so their ledger entries fold here instead.
        for i, site in enumerate(native.FAULT_SITES):
            fired = self.host.fault_fired(site)
            d_f = fired - self._faults_seen[site]
            if d_f:
                self._faults_seen[site] = fired
                m.inc(f"faults.{site}", d_f)
                if site in ("store_msync", "store_seg_open"):
                    self.ledger.record("fault", d_f, aux=i, detail=site)
        # conn-scale plane (round 16): hibernation + accept-shed
        # counters fold into the fixed conns.* slots (accept_shed
        # LEDGER entries arrive separately through the kind-12 fold)
        for slot, name in (("conns_parked", "conns.parked"),
                           ("conns_inflated", "conns.inflated"),
                           ("conns_shed", "conns.shed")):
            d_c = stats[slot] - seen[slot]
            if d_c:
                m.inc(name, d_c)
        d_fwd = stats["trunk_out"] - seen["trunk_out"]
        if d_fwd:
            # the native half of the messages.forward split: trunked
            # legs next to the Python forward lane's
            # messages.forward.slow — both fixed slots render at zero
            m.inc("messages.forward", d_fwd)
            m.inc("messages.forward.native", d_fwd)
        self._stats_seen = stats

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Run the poll loop on a background thread."""
        if self.device_lane == "on":
            self._set_lane(True)
        if self.fast_path and self.app is not None:
            self._tap_thread = threading.Thread(
                target=self._tap_worker, name="emqx-rule-tap",
                daemon=True)
            self._tap_thread.start()
        self._thread = threading.Thread(
            target=self._run, name="emqx-native-host", daemon=True)
        self._thread.start()
        # shards 1..N-1 (round 12): one poll thread per shard host,
        # each driving its own epoll loop + its own conns' keepalive;
        # server-global duties stay on shard 0's thread
        for i in range(1, self.shards):
            t = threading.Thread(
                target=self._run_shard, args=(i,),
                name=f"emqx-native-host-s{i}", daemon=True)
            t.start()
            self._shard_threads.append(t)

    def _register_poll_thread(self, host) -> None:
        self._tls.host = host
        self._poll_idents.add(threading.get_ident())

    def _run(self) -> None:
        self._register_poll_thread(self.hosts[0])
        while not self._stop.is_set():
            try:
                self._step(timeout_ms=50)
            except Exception:  # noqa: BLE001 — the poll thread IS the
                # broker: one bad housekeep/grant cycle (e.g. a raising
                # authorize hook) must log, not stop serving every conn
                log.exception("native poll step failed; continuing")

    def _run_shard(self, idx: int) -> None:
        host = self.hosts[idx]
        self._register_poll_thread(host)
        last_hk = time.monotonic()
        while not self._stop.is_set():
            try:
                self._step_host(host, timeout_ms=50)
                now = time.monotonic()
                if now - last_hk >= HOUSEKEEP_INTERVAL:
                    last_hk = now
                    self._housekeep_conns(idx)
            except Exception:  # noqa: BLE001 — same containment as _run
                log.exception("native shard %d poll step failed; "
                              "continuing", idx)

    def stop(self) -> None:
        """Stop every worker and free the hosts; then re-raise the
        exception of a step on the card that failed in the lane pump
        (D5), if one did."""
        self._stop_workers()
        if self.lane_error is not None:
            raise self.lane_error

    def _stop_workers(self) -> None:
        # Signal EVERY worker before joining any: the old order
        # signalled the poll thread only after a lane join, and a poll
        # step stuck in a cold-compile
        # pipeline.flush could outlive the 5s join — the executor
        # shutdown below then raced the still-running _housekeep into
        # "cannot schedule new futures after shutdown" (and worse, the
        # host destroy raced the poll itself).
        if getattr(self, "_leaked", False):
            return  # a wedged poll thread owns the host forever
        self._stop.set()
        self._lane_stop.set()
        if self._lane_thread is not None:
            self._lane_thread.join(timeout=30)
            self._lane_thread = None
        if self._tap_thread is not None:
            self._tap_thread.join(timeout=5)
            self._tap_thread = None
        poll_dead = True
        if self._thread is not None:
            # a first-flush XLA compile can hold one step for seconds;
            # wait generously — the executor/host teardown below is only
            # safe once the poll thread is provably done stepping
            self._thread.join(timeout=30)
            poll_dead = not self._thread.is_alive()
            self._thread = None
        for t in self._shard_threads:
            # EVERY shard's poll thread must be provably done before
            # any host (or the ring group) can be torn down: a live
            # producer shard writes into the group the destroy frees
            t.join(timeout=30)
            if t.is_alive():
                poll_dead = False
        self._shard_threads = []
        try:
            self.broker.sub_observers.remove(self._on_sub_event)
        except ValueError:
            pass
        if self._retain_mirrored and self.app is not None:
            try:
                self.app.retainer.observers.remove(self._on_retained_event)
            except ValueError:
                pass
            if self.app.native_retain_fn == self._native_retained:
                self.app.native_retain_fn = None
        try:
            self.broker.router.route_observers.remove(self._on_route_event)
        except ValueError:
            pass
        for comp in ("bridges", "trace", "topic_metrics",
                     "rewrite", "exhook"):
            obj = getattr(self.app, comp, None) if self.app else None
            if hasattr(obj, "on_topology_change"):
                try:
                    obj.on_topology_change.remove(
                        self._on_trace_change if comp == "trace"
                        else self.flush_permits)
                except ValueError:
                    pass
        if (self.app is not None
                and self.app.native_stats_fn == self.fast_stats):
            self.app.native_stats_fn = None
        if (self.app is not None
                and self.app.native_spans_fn == self.spans_recent):
            self.app.native_spans_fn = None
        if (self.app is not None
                and self.app.native_shard_stats_fn == self.shard_stats):
            self.app.native_shard_stats_fn = None
        if self.app is not None and hasattr(self.app.rules,
                                            "on_topology_change"):
            try:
                self.app.rules.on_topology_change.remove(
                    self._on_rules_change)
            except ValueError:
                pass
        if self.app is not None and hasattr(self.app,
                                            "on_shared_strategy_change"):
            try:
                self.app.on_shared_strategy_change.remove(
                    self.reeval_shared_groups)
            except ValueError:
                pass
        for conn in list(self.conns.values()):
            conn.channel.terminate("server_shutdown")
        self.conns.clear()
        if (self.app is not None and self.app.persistent is not None
                and self.app.persistent.native_drain
                == self._durable_drain):
            self.app.persistent.native_drain = None
            self.app.persistent.native_discard = None
            self.app.persistent.native_ack = None
        if poll_dead:
            self._tick_pool.shutdown(wait=False)
            self.host.destroy()
            if self._shard_group is not None:
                # hosts first, THEN the group: the group owns the
                # doorbell fds a dying host's producers may still ring
                self._shard_group.destroy()
                self._shard_group = None
            if self._durable_store is not None:
                # the host borrowed the store pointer; with the host
                # destroyed (poll thread provably done) it can close —
                # unless the app's persistence backend owns it (the
                # shared one-recovery-path store outlives this server)
                if getattr(self, "_durable_store_owned", True):
                    self._durable_store.close()
                self._durable_store = None
        else:  # pragma: no cover — pathological wedge
            # STICKY: a wedged poll thread may still be inside
            # emqx_host_poll — nothing may ever free these hosts or the
            # ring group (not a second stop(), not __del__ at gc time)
            self._leaked = True
            self.host.leaked = True
            if self._shard_group is not None:
                self._shard_group.leaked = True
            log.warning("native poll thread still alive after 30s; "
                        "leaking host/executor to avoid a use-after-free")
