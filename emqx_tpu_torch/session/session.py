"""Session state machine — parity with ``apps/emqx/src/emqx_session.erl``.

Holds the per-client messaging state: subscriptions, the QoS1/2 outbound
inflight window, the backlog mqueue, and the incoming-QoS2 awaiting_rel
set (emqx_session.erl:108-146). Pure state + explicit clock: methods
return the packets to emit, the connection layer does IO — the same
separation as channel/session in the reference.

Reference behaviors implemented:
- deliver with inflight backpressure → mqueue (:542-589)
- enqueue with drop policy (:594-607)
- incoming QoS2 dedup via awaiting_rel + receive-maximum quota (:379-399)
- puback/pubrec/pubrel/pubcomp lifecycle (:432-530)
- retry (redeliver with dup) and await_rel expiry timers
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

from emqx_tpu_torch.core.message import Message, SubOpts, now_ms
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.session.inflight import Inflight
from emqx_tpu_torch.session.mqueue import MQueue, MQueueOpts


@dataclass
class InflightEntry:
    packet_id: int
    msg: Message
    phase: str            # "publish" (await PUBACK/PUBREC) | "pubrel" (await PUBCOMP)
    sent_at: int
    qos: int
    subopts: "SubOpts" = None  # as-delivered opts (subid/rap survive retry)
    # the delivered message's broker id, kept past pubrec's msg=None
    # drop so the PUBCOMP settle (store marker consume-on-ack) can
    # still name it
    msg_id: int = 0


class SessionError(Exception):
    def __init__(self, rc: int):
        super().__init__(f"rc=0x{rc:02x}")
        self.rc = rc


@dataclass
class Session:
    clientid: str
    clean_start: bool = True
    max_inflight: int = 32
    max_awaiting_rel: int = 100
    retry_interval_ms: int = 30_000
    await_rel_timeout_ms: int = 300_000
    session_expiry_ms: int = 0          # 0 = ends with connection
    max_subscriptions: int = 0          # 0 = unlimited
    upgrade_qos: bool = False
    mqueue_opts: MQueueOpts = field(default_factory=MQueueOpts)
    created_at: int = field(default_factory=now_ms)

    def __post_init__(self) -> None:
        self.subscriptions: dict[str, SubOpts] = {}
        self.inflight = Inflight(self.max_inflight)
        self.mqueue = MQueue(self.mqueue_opts)
        self.awaiting_rel: dict[int, int] = {}     # packet_id -> ts
        self._next_pkt_id = 0
        # delivery-settlement observer (the one-recovery-path
        # contract): called with a message id when that delivery will
        # never need a store replay again — the subscriber ACKED it
        # (PUBACK/PUBCOMP), it went out at effective qos0 (no ack
        # exists), or it was dropped for good (no-local, expiry, late
        # unsubscribe, mqueue overflow). The persistence layer consumes
        # its replay marker HERE, not at delivery-write time: a conn
        # that drops after the socket write but before the ack keeps
        # its marker, so restart resume retransmits the message.
        self.settle_fn = None
        # native ack-plane mirror (broker/native_server.py): the C++
        # host owns the window state for pids >= 32768 and reports ONE
        # batched ack record per poll cycle; these gauges are that
        # record's session-side reflection (surfaced by info())
        self.native_inflight = 0      # native window occupancy, last cycle
        self.native_pending = 0       # native mqueue-analogue depth
        self.native_acked = 0         # cumulative natively-freed slots

    # -- packet ids --------------------------------------------------------

    # Outbound packet ids stay in [1, 32767]: the native host's fast
    # path allocates [32768, 65535] on the same wire connection
    # (native/src/host.cc kNativePidBase), so a subscriber's PUBACK
    # routes unambiguously — high pids consumed in C++, low pids here.
    # 32767 concurrent unacked deliveries is far beyond any receive-max.
    PKT_ID_SPACE = 32767

    def next_packet_id(self) -> int:
        for _ in range(self.PKT_ID_SPACE):
            self._next_pkt_id = self._next_pkt_id % self.PKT_ID_SPACE + 1
            if not self.inflight.contain(self._next_pkt_id):
                return self._next_pkt_id
        raise SessionError(P.RC_RECEIVE_MAXIMUM_EXCEEDED)

    # -- subscriptions (the broker layer mirrors these into the router) ----

    def subscribe(self, topic: str, opts: SubOpts) -> None:
        if (
            self.max_subscriptions
            and topic not in self.subscriptions
            and len(self.subscriptions) >= self.max_subscriptions
        ):
            raise SessionError(P.RC_QUOTA_EXCEEDED)
        self.subscriptions[topic] = opts

    def unsubscribe(self, topic: str) -> SubOpts:
        if topic not in self.subscriptions:
            raise SessionError(P.RC_NO_SUBSCRIPTION_EXISTED)
        return self.subscriptions.pop(topic)

    # -- incoming publish (client → broker), QoS2 dedup --------------------

    def publish_in(self, packet_id: Optional[int], msg: Message,
                   now: Optional[int] = None) -> None:
        """Track incoming QoS2 for exactly-once (emqx_session.erl:379-399).
        Raises SessionError on dup packet id or quota exceeded."""
        if msg.qos != 2:
            return
        now = now_ms() if now is None else now
        if packet_id in self.awaiting_rel:
            raise SessionError(P.RC_PACKET_IDENTIFIER_IN_USE)
        if (
            self.max_awaiting_rel
            and len(self.awaiting_rel) >= self.max_awaiting_rel
        ):
            raise SessionError(P.RC_RECEIVE_MAXIMUM_EXCEEDED)
        self.awaiting_rel[packet_id] = now

    def pubrel_in(self, packet_id: int) -> None:
        """Incoming PUBREL completes the QoS2 receive (:478-492)."""
        if packet_id not in self.awaiting_rel:
            raise SessionError(P.RC_PACKET_IDENTIFIER_NOT_FOUND)
        del self.awaiting_rel[packet_id]

    # -- outbound delivery (broker → client) -------------------------------

    def _settle(self, msg_id) -> None:
        """This delivery will never need a store replay again: tell the
        persistence layer to spend its marker (no-op when unwired or
        the message was never persisted)."""
        if self.settle_fn is not None and msg_id:
            self.settle_fn(msg_id)

    def deliver(self, deliveries: list[tuple[str, Message]],
                now: Optional[int] = None) -> list[P.Packet]:
        """Route matched messages into the window/queue; return PUBLISH
        packets ready to send (emqx_session.erl:542-589)."""
        now = now_ms() if now is None else now
        out: list[P.Packet] = []
        for sub_topic, msg in deliveries:
            opts = self.subscriptions.get(sub_topic)
            if opts is None:
                # late delivery after unsubscribe — drop (settled: the
                # subscription is gone, a replay would drop it again)
                self._settle(msg.id)
                continue
            if opts.nl and msg.from_ == self.clientid:
                self._settle(msg.id)
                continue  # MQTT5 no-local
            qos = max(opts.qos, msg.qos) if self.upgrade_qos else min(opts.qos, msg.qos)
            if msg.is_expired(now):
                self._settle(msg.id)
                continue
            if qos == 0:
                out.append(self._pub_packet(None, msg, qos, opts))
                # effective qos0 has no ack: the socket write is final
                self._settle(msg.id)
            elif self.inflight.is_full():
                # mqueue drops do NOT settle: the store is a superset —
                # resume replays what the bounded queue had to shed
                self.mqueue.insert(self._with_sub(msg, sub_topic))
            else:
                pid = self.next_packet_id()
                self.inflight.insert(
                    pid, InflightEntry(pid, msg, "publish", now, qos,
                                       opts, msg.id)
                )
                out.append(self._pub_packet(pid, msg, qos, opts))
        return out

    def _with_sub(self, msg: Message, sub_topic: str) -> Message:
        return msg.set_header("sub_topic", sub_topic)

    def _pub_packet(self, pid: Optional[int], msg: Message, qos: int,
                    opts: SubOpts) -> P.Publish:
        props = dict(msg.headers.get("properties") or {})
        if opts.subid is not None:
            props["Subscription-Identifier"] = [opts.subid]
        mei = props.get("Message-Expiry-Interval")
        if mei is not None:
            # forward the REMAINING interval (MQTT5 3.3.2-6): queue/store
            # time already consumed from the expiry budget
            elapsed_s = (now_ms() - msg.timestamp) // 1000
            props["Message-Expiry-Interval"] = max(1, int(mei) - elapsed_s)
        retain = msg.retain if opts.rap else False
        if msg.headers.get("retained"):
            retain = True  # messages replayed from the retainer keep retain=1
        return P.Publish(
            topic=msg.topic, payload=msg.payload, qos=qos,
            retain=retain, dup=False, packet_id=pid, properties=props,
        )

    def enqueue(self, sub_topic: str, msg: Message) -> None:
        """Buffer while disconnected (persistent sessions, :594-607)."""
        opts = self.subscriptions.get(sub_topic)
        if opts is None:
            self._settle(msg.id)
            return
        if opts.nl and msg.from_ == self.clientid:
            self._settle(msg.id)
            return
        # mqueue drops do NOT settle: resume replays from the store
        self.mqueue.insert(self._with_sub(msg, sub_topic))

    # -- acks --------------------------------------------------------------

    def discard_delivery(self, packet_id: int,
                         now: Optional[int] = None) -> list[P.Packet]:
        """Server-side 'as if it had completed sending' (MQTT5 3.1.2-25:
        an outgoing publish the client's Maximum-Packet-Size forbids is
        dropped): release the window slot regardless of QoS/phase and
        pull the next queued messages into it."""
        entry = self.inflight.lookup(packet_id)
        if entry is not None:
            self._settle(entry.msg_id)
        self.inflight.delete(packet_id)
        return self.dequeue(now)

    def puback(self, packet_id: int,
               now: Optional[int] = None) -> list[P.Packet]:
        entry = self.inflight.lookup(packet_id)
        if entry is None or entry.phase != "publish" or entry.qos != 1:
            raise SessionError(P.RC_PACKET_IDENTIFIER_NOT_FOUND)
        # the ack is the settlement point: only now is the
        # store's replay marker spent — a conn death between the write
        # and this PUBACK keeps it, so restart resume retransmits
        self._settle(entry.msg_id)
        self.inflight.delete(packet_id)
        return self.dequeue(now)

    def pubrec(self, packet_id: int,
               now: Optional[int] = None) -> P.PubRel:
        """QoS2 leg 1 acked → move to await-PUBCOMP, emit PUBREL (:466-476)."""
        entry = self.inflight.lookup(packet_id)
        if entry is None or entry.qos != 2 or entry.phase != "publish":
            raise SessionError(P.RC_PACKET_IDENTIFIER_NOT_FOUND)
        entry.phase = "pubrel"
        entry.sent_at = now_ms() if now is None else now
        # payload no longer needed once PUBREC is in (reference stores
        # 'pubrel' marker only)
        entry.msg = None
        return P.PubRel(packet_id=packet_id)

    def pubcomp(self, packet_id: int,
                now: Optional[int] = None) -> list[P.Packet]:
        entry = self.inflight.lookup(packet_id)
        if entry is None or entry.phase != "pubrel":
            raise SessionError(P.RC_PACKET_IDENTIFIER_NOT_FOUND)
        # qos2 settlement: PUBCOMP ends the exchange (msg_id survives
        # pubrec's msg=None drop exactly for this)
        self._settle(entry.msg_id)
        self.inflight.delete(packet_id)
        return self.dequeue(now)

    def native_ack_sync(self, inflight_now: int, pending_now: int,
                        acked: int,
                        now: Optional[int] = None) -> list[P.Packet]:
        """Reconcile one batched native ack record into the session
        (broker/native_server.py drains kind-7 events here once per
        poll cycle — the per-message PUBACK bookkeeping that capped the
        windowed QoS1 plane now arrives as one cycle-level delta).

        Returns PUBLISH packets to send when natively-freed window
        slots let Python-queued messages (punt-served deliveries that
        overflowed into the mqueue) hand off into the wire window."""
        self.native_inflight = inflight_now
        self.native_pending = pending_now
        self.native_acked += acked
        if acked and len(self.mqueue) and not self.inflight.is_full():
            return self.dequeue(now)
        return []

    def adopt_native_window(self, awaiting: list[int],
                            inflight: list[tuple[int, int, str]],
                            pending: list[tuple[str, Message]],
                            now: Optional[int] = None) -> list[P.Packet]:
        """Adopt the C++ host's AckState at live plane demotion
        (broker/native_server.py _on_handoff drains kind-11 records
        here). Three pieces, mirroring the handoff wire format:

        - ``awaiting``: publisher-side qos2 packet ids the native plane
          owned — adopted into ``awaiting_rel`` so a DUP retransmit
          straddling the demotion dedups (PACKET_IDENTIFIER_IN_USE →
          PUBREC, no re-delivery) and the client's PUBREL completes
          here;
        - ``inflight``: (pid, qos, phase) for native deliveries still
          unacked. The pids are >= 32768 (the native space — disjoint
          from ``next_packet_id``'s [1, 32767]), inserted with
          ``msg=None``: the subscriber's PUBACK/PUBREC/PUBCOMP frees
          the slot normally; the retry timer skips message-less entries
          (the written bytes were never retained in C++ — ROADMAP notes
          the edge);
        - ``pending``: (sub_topic, Message) parsed from the window-full
          queue frames — re-enqueued into the mqueue, so they survive a
          later disconnect for the retransmit-on-reconnect replay.

        Returns PUBLISH packets when freed window room lets the adopted
        pending messages start flowing immediately."""
        now = now_ms() if now is None else now
        for pid in awaiting:
            self.awaiting_rel.setdefault(pid, now)
        for pid, qos, phase in inflight:
            if not self.inflight.contain(pid):
                self.inflight.insert(
                    pid, InflightEntry(pid, None, phase, now, qos))
        for sub_topic, msg in pending:
            self.mqueue.insert(self._with_sub(msg, sub_topic))
        return self.dequeue(now) if pending else []

    def dequeue(self, now: Optional[int] = None) -> list[P.Packet]:
        """Fill freed inflight slots from the mqueue (:520-530)."""
        now = now_ms() if now is None else now
        out: list[P.Packet] = []
        while not self.inflight.is_full():
            msg = self.mqueue.pop()
            if msg is None:
                break
            sub_topic = msg.headers.get("sub_topic", msg.topic)
            opts = self.subscriptions.get(sub_topic)
            if opts is None:
                self._settle(msg.id)   # late unsubscribe: final drop
                continue
            qos = max(opts.qos, msg.qos) if self.upgrade_qos else min(opts.qos, msg.qos)
            if msg.is_expired(now):
                self._settle(msg.id)
                continue
            if qos == 0:
                out.append(self._pub_packet(None, msg, qos, opts))
                self._settle(msg.id)
            else:
                pid = self.next_packet_id()
                self.inflight.insert(
                    pid, InflightEntry(pid, msg, "publish", now, qos,
                                       opts, msg.id)
                )
                out.append(self._pub_packet(pid, msg, qos, opts))
        return out

    # -- timers ------------------------------------------------------------

    def retry(self, now: Optional[int] = None) -> list[P.Packet]:
        """Redeliver inflight entries older than retry_interval with DUP
        (the retry_delivery timer, emqx_session.erl retry logic)."""
        now = now_ms() if now is None else now
        out: list[P.Packet] = []
        for pid, entry in self.inflight.items():
            if now - entry.sent_at < self.retry_interval_ms:
                continue
            entry.sent_at = now
            if entry.phase == "pubrel":
                out.append(P.PubRel(packet_id=pid))
            elif entry.msg is not None:
                if entry.msg.is_expired(now):
                    self._settle(entry.msg_id)  # expired: final drop
                    self.inflight.delete(pid)
                    continue
                # reuse the as-delivered subopts so Subscription-Identifier
                # and retain-as-published survive the retransmission
                opts = entry.subopts or SubOpts(qos=entry.qos)
                pkt = self._pub_packet(pid, entry.msg, entry.qos, opts)
                pkt.dup = True
                out.append(pkt)
        return out

    def expire_awaiting_rel(self, now: Optional[int] = None) -> int:
        """Drop incoming-QoS2 trackers past await_rel_timeout."""
        now = now_ms() if now is None else now
        victims = [
            pid for pid, ts in self.awaiting_rel.items()
            if now - ts >= self.await_rel_timeout_ms
        ]
        for pid in victims:
            del self.awaiting_rel[pid]
        return len(victims)

    # -- takeover / resume -------------------------------------------------

    def pending_for_resume(self) -> list[Message]:
        """Messages that would replay on session resume (read-only view)."""
        out = [e.msg for e in self.inflight.values()
               if e.msg is not None]
        out.extend(self.mqueue.peek_all())
        return out

    def take_pending(self) -> list[Message]:
        """Drain publish-phase inflight + mqueue for takeover redelivery.

        The resuming channel re-delivers these through a fresh window (new
        packet ids). 'pubrel'-phase QoS2 entries stay in the inflight — the
        retry timer re-emits their PUBREL on the new connection."""
        out: list[Message] = []
        for pid, entry in self.inflight.items():
            if entry.phase == "publish" and entry.msg is not None:
                out.append(entry.msg)
                self.inflight.delete(pid)
        out.extend(self.mqueue.peek_all())
        while self.mqueue.pop() is not None:
            pass
        return out

    def info(self) -> dict[str, Any]:
        return {
            "clientid": self.clientid,
            "subscriptions_cnt": len(self.subscriptions),
            "inflight_cnt": len(self.inflight),
            "mqueue_len": len(self.mqueue),
            "mqueue_dropped": self.mqueue.dropped,
            "awaiting_rel_cnt": len(self.awaiting_rel),
            "native_inflight_cnt": self.native_inflight,
            "native_pending_len": self.native_pending,
            "native_acked_cnt": self.native_acked,
            "created_at": self.created_at,
        }
