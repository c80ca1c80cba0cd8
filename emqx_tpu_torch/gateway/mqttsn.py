"""MQTT-SN 1.2 gateway over UDP — parity with
``apps/emqx_gateway/src/mqttsn/`` (frame: emqx_sn_frame.erl, channel:
emqx_sn_channel.erl, topic-id registry: emqx_sn_registry.erl).

Topic-id spaces: normal (per-client REGISTER/auto-register on deliver),
predefined (gateway-wide table from config), short (2-char names).
QoS0/1 bridge plus the spec's QoS -1 publish-without-connect for
predefined topics.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

from emqx_tpu_torch.gateway.ctx import GatewayImpl, GwChannel, GwContext, GwFrame

# message types (MQTT-SN 1.2 §5.2.1)
ADVERTISE, SEARCHGW, GWINFO = 0x00, 0x01, 0x02
CONNECT, CONNACK = 0x04, 0x05
WILLTOPICREQ, WILLTOPIC, WILLMSGREQ, WILLMSG = 0x06, 0x07, 0x08, 0x09
REGISTER, REGACK = 0x0A, 0x0B
PUBLISH, PUBACK, PUBCOMP, PUBREC, PUBREL = 0x0C, 0x0D, 0x0E, 0x0F, 0x10
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK = 0x12, 0x13, 0x14, 0x15
PINGREQ, PINGRESP, DISCONNECT = 0x16, 0x17, 0x18

RC_ACCEPTED, RC_CONGESTION, RC_INVALID_TOPIC_ID, RC_NOT_SUPPORTED = 0, 1, 2, 3

# the long-form length prefix is a u16: no SN message may exceed 65535
# wire bytes (§5.2.1). Oversized deliveries DROP at the translation seam
# on both planes (sn.h kMaxPayload/kMaxTopic mirror these).
MAX_PAYLOAD = 0xFFFF - 9          # PUBLISH overhead: long-form 2 + 7
MAX_TOPIC = 0xFFFF - 8            # REGISTER overhead: long-form 2 + 6

# flag bits
F_DUP, F_RETAIN, F_WILL, F_CLEAN = 0x80, 0x10, 0x08, 0x04
TID_NORMAL, TID_PREDEF, TID_SHORT = 0, 1, 2


def qos_of(flags: int) -> int:
    q = (flags >> 5) & 0x3
    return -1 if q == 3 else q


def qos_flags(qos: int) -> int:
    return 0x60 if qos < 0 else (qos & 0x3) << 5


@dataclass
class SnMessage:
    type: int
    flags: int = 0
    topic_id: int = 0
    msg_id: int = 0
    topic_name: str = ""
    data: bytes = b""
    duration: int = 0
    clientid: str = ""
    rc: int = 0


class Frame(GwFrame):
    """One datagram = one message (length-prefixed, emqx_sn_frame.erl)."""

    def parse(self, data: bytes, state) -> tuple[list, None]:
        out = []
        while data:
            if data[0] == 0x01:
                if len(data) < 3:
                    break
                (ln,) = struct.unpack_from(">H", data, 1)
                if ln < 4:          # length covers the 3-byte prefix + type
                    break           # malformed: refuse, don't spin
                if ln > len(data):  # truncated: refuse (a shorter slice
                    break           # would crash the body parse below —
                                    # oracle-parity audit; the native
                                    # codec stops at the same boundary)
                body, data = data[3:ln], data[ln:]
            else:
                ln = data[0]
                if ln < 2:          # ln==0/1 would not consume any bytes
                    break
                if ln > len(data):  # truncated datagram: refuse
                    break
                body, data = data[1:ln], data[ln:]
            if body:
                out.append(self._parse_body(body))
        return out, None

    def _parse_body(self, b: bytes) -> SnMessage:
        t = b[0]
        m = SnMessage(type=t)
        if t == CONNECT:
            m.flags, _proto = b[1], b[2]
            (m.duration,) = struct.unpack_from(">H", b, 3)
            m.clientid = b[5:].decode("utf-8", "replace")
        elif t in (CONNACK, WILLTOPICREQ, WILLMSGREQ, PINGRESP):
            if len(b) > 1:
                m.rc = b[1]
        elif t == REGISTER:
            m.topic_id, m.msg_id = struct.unpack_from(">HH", b, 1)
            m.topic_name = b[5:].decode("utf-8", "replace")
        elif t == REGACK:
            m.topic_id, m.msg_id = struct.unpack_from(">HH", b, 1)
            m.rc = b[5]
        elif t == PUBLISH:
            m.flags = b[1]
            m.topic_id, m.msg_id = struct.unpack_from(">HH", b, 2)
            m.data = b[6:]
        elif t == PUBACK:
            m.topic_id, m.msg_id = struct.unpack_from(">HH", b, 1)
            m.rc = b[5]
        elif t in (PUBREC, PUBREL, PUBCOMP, UNSUBACK):
            (m.msg_id,) = struct.unpack_from(">H", b, 1)
        elif t in (SUBSCRIBE, UNSUBSCRIBE):
            m.flags = b[1]
            (m.msg_id,) = struct.unpack_from(">H", b, 2)
            rest = b[4:]
            if m.flags & 0x3 in (TID_PREDEF,):
                (m.topic_id,) = struct.unpack_from(">H", rest, 0)
            else:
                m.topic_name = rest.decode("utf-8", "replace")
        elif t == SUBACK:
            m.flags = b[1]
            m.topic_id, m.msg_id = struct.unpack_from(">HH", b, 2)
            m.rc = b[6]
        elif t == PINGREQ:
            m.clientid = b[1:].decode("utf-8", "replace")
        elif t == DISCONNECT:
            if len(b) >= 3:
                (m.duration,) = struct.unpack_from(">H", b, 1)
        elif t == SEARCHGW:
            m.rc = b[1] if len(b) > 1 else 0       # radius
        return m

    def serialize(self, m: SnMessage) -> bytes:
        t = m.type
        if t == CONNACK:
            body = bytes([t, m.rc])
        elif t == CONNECT:
            body = bytes([t, m.flags, 0x01]) + struct.pack(
                ">H", m.duration) + m.clientid.encode()
        elif t == REGISTER:
            body = bytes([t]) + struct.pack(
                ">HH", m.topic_id, m.msg_id) + m.topic_name.encode()
        elif t == REGACK:
            body = bytes([t]) + struct.pack(
                ">HH", m.topic_id, m.msg_id) + bytes([m.rc])
        elif t == PUBLISH:
            body = bytes([t, m.flags]) + struct.pack(
                ">HH", m.topic_id, m.msg_id) + m.data
        elif t == PUBACK:
            body = bytes([t]) + struct.pack(
                ">HH", m.topic_id, m.msg_id) + bytes([m.rc])
        elif t in (PUBREC, PUBREL, PUBCOMP, UNSUBACK):
            body = bytes([t]) + struct.pack(">H", m.msg_id)
        elif t in (SUBSCRIBE, UNSUBSCRIBE):
            body = bytes([t, m.flags]) + struct.pack(">H", m.msg_id)
            if m.flags & 0x3 == TID_PREDEF:
                body += struct.pack(">H", m.topic_id)
            else:
                body += m.topic_name.encode()
        elif t == SUBACK:
            body = bytes([t, m.flags]) + struct.pack(
                ">HH", m.topic_id, m.msg_id) + bytes([m.rc])
        elif t == PINGREQ:
            # a sleeping client's wake ping carries its clientid
            # (MQTT-SN §5.4.21) — the old bare serialization couldn't
            # round-trip what parse() reads (oracle-parity audit)
            body = bytes([t]) + m.clientid.encode()
        elif t == PINGRESP:
            body = bytes([t])
        elif t == DISCONNECT:
            # duration > 0 = the client announces sleep (§5.4.22); the
            # old serializer dropped it, so a real client built on this
            # codec could never ENTER sleep mode (oracle-parity audit)
            body = bytes([t])
            if m.duration:
                body += struct.pack(">H", m.duration)
        elif t == GWINFO:
            body = bytes([t, m.rc])
        elif t == ADVERTISE:
            body = bytes([t, m.rc]) + struct.pack(">H", m.duration)
        else:
            body = bytes([t])
        ln = len(body) + 1
        if ln < 256:
            return bytes([ln]) + body
        return b"\x01" + struct.pack(">H", ln + 2) + body


class Registry:
    """Gateway-wide predefined ids + per-client registered ids
    (emqx_sn_registry.erl)."""

    def __init__(self, predefined: Optional[dict[int, str]] = None) -> None:
        self.predefined = dict(predefined or {})

    def predefined_topic(self, tid: int) -> Optional[str]:
        return self.predefined.get(tid)


class Channel(GwChannel):
    def __init__(self, ctx: GwContext, registry: Registry) -> None:
        self.ctx = ctx
        self.registry = registry
        self.conn_state = "idle"
        self.clientid: Optional[str] = None
        self.topic_of_id: dict[int, str] = {}      # normal ids, per client
        self.id_of_topic: dict[str, int] = {}
        self._next_tid = 0
        self._next_mid = 0
        # publisher-side qos2 exactly-once: msg ids published but not
        # yet released (the broker-side "method B" hold, like the core
        # session's awaiting-rel set)
        self._awaiting_rel: set[int] = set()
        self.awake = True
        self._sleep_buffer: list = []   # deliveries parked during sleep
        self.max_sleep_buffer = 1000    # drop-oldest past this (mqueue-ish)
        self.sleep_until: Optional[float] = None   # wall-clock deadline

    def _alloc_tid(self, topic: str) -> int:
        tid = self.id_of_topic.get(topic)
        if tid is None:
            # wrap in 1..0xFFFE skipping ids still in use — 0x0000 AND
            # 0xFFFF are both reserved (§5.3.11); the old unbounded
            # counter overflowed struct.pack(">H") after 65535
            # registrations (oracle-parity audit: the native registry
            # wraps, this one crashed)
            for _ in range(0xFFFE):
                self._next_tid = self._next_tid % 0xFFFE + 1
                if self._next_tid not in self.topic_of_id:
                    break
            else:
                return 0            # registry full: no id assignable
            tid = self._next_tid
            self.id_of_topic[topic] = tid
            self.topic_of_id[tid] = topic
        return tid

    def _mid(self) -> int:
        self._next_mid = self._next_mid % 0xFFFF + 1
        return self._next_mid

    def _resolve(self, m: SnMessage) -> Optional[str]:
        kind = m.flags & 0x3
        if kind == TID_PREDEF:
            return self.registry.predefined_topic(m.topic_id)
        if kind == TID_SHORT:
            return struct.pack(">H", m.topic_id).decode("latin1")
        return self.topic_of_id.get(m.topic_id)

    # -- inbound -------------------------------------------------------------

    def handle_in(self, m: SnMessage) -> list[SnMessage]:
        t = m.type
        if t == SEARCHGW:
            return [SnMessage(GWINFO, rc=1)]       # gw id 1
        if t == CONNECT:
            new_cid = m.clientid or f"sn-{id(self):x}"
            # a re-CONNECT under a different clientid must release the
            # old registration first, or it leaks as a ghost session
            if getattr(self, "_session_open", False) \
                    and self.clientid != new_cid:
                self._session_open = False
                self.ctx.close_session(self.clientid, self,
                                       "reconnected")
            self.clientid = new_cid
            if not self.ctx.authenticate(self.clientid):
                # a rejected (re-)CONNECT must fully de-authenticate the
                # channel: staying "connected" would let the next
                # PUBLISH run as the DENIED identity (ban bypass). A
                # same-clientid re-CONNECT that got denied (freshly
                # banned) also releases its still-open session — it must
                # not linger as a ghost registration
                if getattr(self, "_session_open", False):
                    self._session_open = False
                    self.ctx.close_session(new_cid, self, "auth_denied")
                self.conn_state = "idle"
                self.clientid = None
                return [SnMessage(CONNACK, rc=RC_NOT_SUPPORTED)]
            self.ctx.open_session(self.clientid, self)
            self._session_open = True
            self.conn_state = "connected"
            # every (re-)CONNECT starts fresh per-session gateway state
            # — native-plane parity (a re-CONNECT there is a brand-new
            # conn): the topic-id registry, the qos2 dedup set, and
            # sleep state do not survive the session boundary. A stale
            # _awaiting_rel entry would otherwise swallow a rebooted
            # client's qos2 publish reusing the same msg id (PUBREC
            # answered, ctx.publish skipped — silent loss).
            self.id_of_topic = {}
            self.topic_of_id = {}
            self._awaiting_rel = set()
            self.awake = True
            self._sleep_buffer = []
            return [SnMessage(CONNACK, rc=RC_ACCEPTED)]
        if t == PUBLISH and qos_of(m.flags) == -1:
            # QoS -1: fire-and-forget on a predefined/short topic,
            # no connection required (MQTT-SN §6.8)
            topic = (self.registry.predefined_topic(m.topic_id)
                     if m.flags & 0x3 == TID_PREDEF else self._resolve(m))
            if topic:
                self.ctx.publish(m.clientid or "sn-anon", topic, m.data, 0,
                                 retain=bool(m.flags & F_RETAIN))
            return []
        if self.conn_state != "connected":
            return ([SnMessage(DISCONNECT)]
                    if t not in (PINGREQ, DISCONNECT) else [])
        if t == REGISTER:
            tid = self._alloc_tid(m.topic_name)
            # tid 0 is the reserved invalid id: a full registry answers
            # "rejected: congestion" (native-plane parity), never a
            # success carrying an id the client cannot publish on
            return [SnMessage(REGACK, topic_id=tid, msg_id=m.msg_id,
                              rc=RC_ACCEPTED if tid else RC_CONGESTION)]
        if t == PUBLISH:
            topic = self._resolve(m)
            qos = max(0, qos_of(m.flags))
            if topic is None:
                return ([SnMessage(PUBACK, topic_id=m.topic_id,
                                   msg_id=m.msg_id,
                                   rc=RC_INVALID_TOPIC_ID)]
                        if qos > 0 else [])
            if qos == 2:
                # exactly-once, broker "method B" (publish on PUBLISH,
                # hold the id until PUBREL): the old code answered
                # PUBACK to a qos2 publish — a spec violation (§6.13
                # mandates PUBREC) AND a double-publish on every DUP
                # retransmit (oracle-parity audit)
                if m.msg_id not in self._awaiting_rel:
                    self._awaiting_rel.add(m.msg_id)
                    self.ctx.publish(self.clientid, topic, m.data, qos,
                                     retain=bool(m.flags & F_RETAIN))
                return [SnMessage(PUBREC, msg_id=m.msg_id)]
            self.ctx.publish(self.clientid, topic, m.data, qos,
                             retain=bool(m.flags & F_RETAIN))
            if qos > 0:
                return [SnMessage(PUBACK, topic_id=m.topic_id,
                                  msg_id=m.msg_id, rc=RC_ACCEPTED)]
            return []
        if t == PUBREL:
            # release half of the qos2 exchange; a PUBREL for an id we
            # no longer hold still completes with PUBCOMP [MQTT-4.3.3]
            self._awaiting_rel.discard(m.msg_id)
            return [SnMessage(PUBCOMP, msg_id=m.msg_id)]
        if t == SUBSCRIBE:
            kind = m.flags & 0x3
            if kind == TID_PREDEF:
                topic = self.registry.predefined_topic(m.topic_id)
                tid = m.topic_id
            else:
                topic = m.topic_name
                # wildcard filters get no id (delivery registers one)
                tid = (0 if ("#" in topic or "+" in topic)
                       else self._alloc_tid(topic))
            if not topic:
                return [SnMessage(SUBACK, flags=m.flags, topic_id=0,
                                  msg_id=m.msg_id,
                                  rc=RC_INVALID_TOPIC_ID)]
            # grant what delivery can honour: handle_deliver caps every
            # outbound PUBLISH at qos1, so granting a requested qos2 was
            # a lie on the wire (oracle-parity audit — the native plane
            # grants the same cap)
            qos = min(1, max(0, qos_of(m.flags)))
            if not self.ctx.subscribe(self.clientid, topic, qos):
                return [SnMessage(SUBACK, flags=m.flags, topic_id=0,
                                  msg_id=m.msg_id, rc=RC_NOT_SUPPORTED)]
            return [SnMessage(SUBACK, flags=qos_flags(qos), topic_id=tid,
                              msg_id=m.msg_id, rc=RC_ACCEPTED)]
        if t == UNSUBSCRIBE:
            topic = (self.registry.predefined_topic(m.topic_id)
                     if m.flags & 0x3 == TID_PREDEF else m.topic_name)
            if topic:
                self.ctx.unsubscribe(self.clientid, topic)
            return [SnMessage(UNSUBACK, msg_id=m.msg_id)]
        if t == PUBACK:
            return []
        if t == PINGREQ:
            # waking from sleep flushes parked messages, then PINGRESP
            # (MQTT-SN §6.14: buffered delivery on the keepalive ping)
            self.awake = True
            self.sleep_until = None
            parked, self._sleep_buffer = self._sleep_buffer, []
            return self.handle_deliver(parked) + [SnMessage(PINGRESP)]
        if t == DISCONNECT:
            if m.duration:           # sleep mode: keep session, stop io
                self.awake = False
                import time as _time
                self.sleep_until = _time.time() + m.duration
                return [SnMessage(DISCONNECT)]
            self.conn_state = "disconnected"
            return [SnMessage(DISCONNECT)]
        return []

    # -- outbound ------------------------------------------------------------

    def handle_deliver(self, deliveries: list) -> list[SnMessage]:
        if not self.awake:
            # asleep (radio off): park until the next PINGREQ, bounded
            # drop-oldest like the session mqueue
            self._sleep_buffer.extend(deliveries)
            overflow = len(self._sleep_buffer) - self.max_sleep_buffer
            if overflow > 0:
                del self._sleep_buffer[:overflow]
            return []
        out: list[SnMessage] = []
        for _sub_topic, msg in deliveries:
            topic = self.ctx.unmount(msg.topic)
            if (len(msg.payload) > MAX_PAYLOAD
                    or len(topic.encode()) > MAX_TOPIC):
                # can't fit the u16 wire length: drop, exactly like the
                # native plane — serializing would raise mid-delivery
                continue
            tid = self.id_of_topic.get(topic)
            if tid is None:
                # auto-register so the client can decode the id
                tid = self._alloc_tid(topic)
                if not tid:
                    # registry full: nothing deliverable on this topic —
                    # drop, exactly like the native plane (SnDeliverTid
                    # returns 0 and bails); emitting the reserved id 0
                    # on the wire would be a protocol violation
                    continue
                out.append(SnMessage(REGISTER, topic_id=tid,
                                     msg_id=self._mid(),
                                     topic_name=topic))
            out.append(SnMessage(
                PUBLISH, flags=qos_flags(min(msg.qos, 1)),
                topic_id=tid,
                msg_id=self._mid() if msg.qos else 0,
                data=msg.payload))
        return out

    def terminate(self, reason: str) -> None:
        # key on an open session, not conn_state: a device-initiated
        # DISCONNECT flips conn_state before the UDP listener calls
        # terminate, which would leak the session registration
        if getattr(self, "_session_open", False):
            self._session_open = False
            self.ctx.close_session(self.clientid, self, reason)
        self.conn_state = "disconnected"


class MqttsnGateway(GatewayImpl):
    name = "mqttsn"

    def __init__(self, host: str = "127.0.0.1", port: int = 1884,
                 predefined: Optional[dict[int, str]] = None) -> None:
        self.host, self.port = host, port
        self.registry = Registry(predefined)
        self.listener = None
        self.ctx: Optional[GwContext] = None

    def on_gateway_load(self, ctx: GwContext, conf: dict) -> None:
        from emqx_tpu_torch.gateway.conn import UdpGwListener

        self.ctx = ctx
        self.host = conf.get("host", self.host)
        self.port = conf.get("port", self.port)
        for tid, topic in (conf.get("predefined") or {}).items():
            self.registry.predefined[int(tid)] = topic
        self.listener = UdpGwListener(
            lambda: Channel(self.ctx, self.registry), Frame(),
            host=self.host, port=self.port)

    async def start_listeners(self) -> None:
        await self.listener.start()
        self.port = self.listener.port

    async def stop_listeners(self) -> None:
        await self.listener.stop()
