"""MQTT wire codec: incremental parser + serializer.

Parity with ``apps/emqx/src/emqx_frame.erl``: the varint remaining-length
state machine (emqx_frame.erl:163-217), body parsing (:236+), and the
serializer, for protocol versions 3.1/3.1.1/5.0. The parser is
*incremental*: feed arbitrary byte chunks, get complete packets out plus a
resumable state — the contract the connection host needs for
``{active,N}``-style socket batching.

This is the port's copy of the JAX package's codec (``mqtt/frame.py``):
the same bytes out and the same packets in, for the port's own server,
channel and client.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.packet import FrameError

MAX_REMAINING_LEN = 0xFFFFFFF  # 268435455, 4-byte varint cap


# --------------------------------------------------------------------------
# primitive readers (over a memoryview + offset)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def u8(self) -> int:
        if self.remaining() < 1:
            raise FrameError("truncated u8")
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        if self.remaining() < 2:
            raise FrameError("truncated u16")
        v = int.from_bytes(self.buf[self.pos : self.pos + 2], "big")
        self.pos += 2
        return v

    def u32(self) -> int:
        if self.remaining() < 4:
            raise FrameError("truncated u32")
        v = int.from_bytes(self.buf[self.pos : self.pos + 4], "big")
        self.pos += 4
        return v

    def varint(self) -> int:
        mult, val = 1, 0
        for _ in range(4):
            b = self.u8()
            val += (b & 0x7F) * mult
            if not b & 0x80:
                return val
            mult *= 128
        raise FrameError("varint too long")

    def bin(self) -> bytes:
        n = self.u16()
        if self.remaining() < n:
            raise FrameError("truncated binary")
        v = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return v

    def utf8(self) -> str:
        try:
            return self.bin().decode("utf-8")
        except UnicodeDecodeError as e:
            raise FrameError(f"invalid utf8: {e}") from None

    def rest(self) -> bytes:
        v = bytes(self.buf[self.pos :])
        self.pos = len(self.buf)
        return v


def _parse_properties(r: _Reader) -> dict[str, Any]:
    n = r.varint()
    end = r.pos + n
    props: dict[str, Any] = {}
    while r.pos < end:
        pid = r.varint()
        spec = P.PROPERTIES.get(pid)
        if spec is None:
            raise FrameError(f"unknown property id 0x{pid:02x}")
        name, ty = spec
        if ty == "byte":
            val = r.u8()
        elif ty == "two":
            val = r.u16()
        elif ty == "four":
            val = r.u32()
        elif ty == "varint":
            val = r.varint()
        elif ty == "utf8":
            val = r.utf8()
        elif ty == "binary":
            val = r.bin()
        else:  # utf8pair
            val = (r.utf8(), r.utf8())
        if name == "User-Property":
            props.setdefault("User-Property", []).append(val)
        elif name == "Subscription-Identifier":
            props.setdefault("Subscription-Identifier", []).append(val)
        else:
            if name in props:
                raise FrameError(f"duplicate property {name}", P.RC_PROTOCOL_ERROR)
            props[name] = val
    if r.pos != end:
        raise FrameError("property length mismatch")
    return props


# --------------------------------------------------------------------------
# incremental parser


@dataclass(frozen=True)
class ParseState:
    """Resumable state between socket reads (emqx_frame:initial_parse_state).

    phase: 0 = awaiting fixed header byte; 1 = reading remaining-length
    varint; 2 = accumulating body.
    """

    version: int = P.MQTT_V4
    max_size: int = MAX_REMAINING_LEN
    phase: int = 0
    header: int = 0
    len_value: int = 0
    len_mult: int = 1
    need: int = 0
    acc: bytes = b""


class Parser:
    """Feed chunks → complete packets (list) + updated state."""

    def __init__(self, version: int = P.MQTT_V4, max_size: int = MAX_REMAINING_LEN):
        self.state = ParseState(version=version, max_size=max_size)

    def set_version(self, version: int) -> None:
        self.state = replace(self.state, version=version)

    def feed(self, data: bytes) -> list[P.Packet]:
        out: list[P.Packet] = []
        st = self.state
        buf = st.acc + data if st.phase == 2 else data
        # re-enter mid-varint/header phases with the raw bytes
        if st.phase != 2 and st.acc:
            buf = st.acc + data
            st = replace(st, acc=b"")
        pos = 0
        phase, header = st.phase, st.header
        len_value, len_mult, need = st.len_value, st.len_mult, st.need
        n = len(buf)
        while True:
            if phase == 0:
                if pos >= n:
                    st = replace(
                        st, phase=0, acc=b"", len_value=0, len_mult=1, need=0
                    )
                    break
                header = buf[pos]
                pos += 1
                if header >> 4 not in P.TYPE_NAMES:
                    raise FrameError(f"bad packet type {header >> 4}")
                phase, len_value, len_mult = 1, 0, 1
            elif phase == 1:
                if pos >= n:
                    st = replace(
                        st,
                        phase=1,
                        header=header,
                        len_value=len_value,
                        len_mult=len_mult,
                        acc=b"",
                    )
                    break
                b = buf[pos]
                pos += 1
                len_value += (b & 0x7F) * len_mult
                if b & 0x80:
                    len_mult *= 128
                    if len_mult > 128**3:
                        raise FrameError("remaining length varint too long")
                else:
                    if len_value > st.max_size:
                        raise FrameError(
                            "packet too large", P.RC_PACKET_TOO_LARGE
                        )
                    phase, need = 2, len_value
            else:  # phase == 2
                avail = n - pos
                if avail < need:
                    st = replace(
                        st,
                        phase=2,
                        header=header,
                        need=need,
                        acc=bytes(buf[pos:]),
                    )
                    break
                body = bytes(buf[pos : pos + need])
                pos += need
                out.append(_parse_packet(header, body, st.version))
                phase = 0
        self.state = st
        return out


def _parse_packet(header: int, body: bytes, ver: int) -> P.Packet:
    ptype = header >> 4
    flags = header & 0x0F
    r = _Reader(body)
    if ptype == P.PUBLISH:
        dup = bool(flags & 0x08)
        qos = (flags >> 1) & 0x03
        retain = bool(flags & 0x01)
        if qos == 3:
            raise FrameError("bad publish qos")
        topic = r.utf8()
        pid = r.u16() if qos > 0 else None
        props = _parse_properties(r) if ver == P.MQTT_V5 else {}
        return P.Publish(
            topic=topic, payload=r.rest(), qos=qos, retain=retain,
            dup=dup, packet_id=pid, properties=props,
        )
    if ptype == P.CONNECT:
        proto_name = r.utf8()
        proto_ver = r.u8()
        if proto_name not in ("MQTT", "MQIsdp"):
            raise FrameError(
                "bad protocol name", P.RC_UNSUPPORTED_PROTOCOL_VERSION
            )
        cf = r.u8()
        if cf & 0x01:
            raise FrameError("connect reserved flag set", P.RC_PROTOCOL_ERROR)
        clean_start = bool(cf & 0x02)
        will_flag = bool(cf & 0x04)
        will_qos = (cf >> 3) & 0x03
        will_retain = bool(cf & 0x20)
        has_password = bool(cf & 0x40)
        has_username = bool(cf & 0x80)
        keepalive = r.u16()
        props = _parse_properties(r) if proto_ver == P.MQTT_V5 else {}
        clientid = r.utf8()
        will_props: dict[str, Any] = {}
        will_topic = will_payload = None
        if will_flag:
            if proto_ver == P.MQTT_V5:
                will_props = _parse_properties(r)
            will_topic = r.utf8()
            will_payload = r.bin()
        username = r.utf8() if has_username else None
        password = r.bin() if has_password else None
        return P.Connect(
            proto_name=proto_name, proto_ver=proto_ver,
            clean_start=clean_start, keepalive=keepalive, clientid=clientid,
            username=username, password=password, will_flag=will_flag,
            will_qos=will_qos, will_retain=will_retain,
            will_topic=will_topic, will_payload=will_payload,
            will_props=will_props, properties=props,
        )
    if ptype == P.CONNACK:
        ack = r.u8()
        rc = r.u8()
        props = _parse_properties(r) if ver == P.MQTT_V5 else {}
        return P.Connack(
            session_present=bool(ack & 0x01), reason_code=rc, properties=props
        )
    if ptype in (P.PUBACK, P.PUBREC, P.PUBREL, P.PUBCOMP):
        if ptype == P.PUBREL and flags != 0x02:
            raise FrameError("bad pubrel flags")
        pid = r.u16()
        rc, props = P.RC_SUCCESS, {}
        if ver == P.MQTT_V5 and r.remaining():
            rc = r.u8()
            if r.remaining():
                props = _parse_properties(r)
        cls = {P.PUBACK: P.PubAck, P.PUBREC: P.PubRec,
               P.PUBREL: P.PubRel, P.PUBCOMP: P.PubComp}[ptype]
        return cls(packet_id=pid, reason_code=rc, properties=props)
    if ptype == P.SUBSCRIBE:
        if flags != 0x02:
            raise FrameError("bad subscribe flags")
        pid = r.u16()
        props = _parse_properties(r) if ver == P.MQTT_V5 else {}
        tfs: list[tuple[str, dict[str, int]]] = []
        while r.remaining():
            tf = r.utf8()
            opts = r.u8()
            if opts & 0xC0:
                raise FrameError("subscribe reserved bits", P.RC_PROTOCOL_ERROR)
            tfs.append((tf, {
                "qos": opts & 0x03,
                "nl": (opts >> 2) & 0x01,
                "rap": (opts >> 3) & 0x01,
                "rh": (opts >> 4) & 0x03,
            }))
        if not tfs:
            raise FrameError("empty subscribe", P.RC_PROTOCOL_ERROR)
        return P.Subscribe(packet_id=pid, topic_filters=tfs, properties=props)
    if ptype == P.SUBACK:
        pid = r.u16()
        props = _parse_properties(r) if ver == P.MQTT_V5 else {}
        return P.SubAck(
            packet_id=pid, reason_codes=list(r.rest()), properties=props
        )
    if ptype == P.UNSUBSCRIBE:
        if flags != 0x02:
            raise FrameError("bad unsubscribe flags")
        pid = r.u16()
        props = _parse_properties(r) if ver == P.MQTT_V5 else {}
        tfs2: list[str] = []
        while r.remaining():
            tfs2.append(r.utf8())
        if not tfs2:
            raise FrameError("empty unsubscribe", P.RC_PROTOCOL_ERROR)
        return P.Unsubscribe(packet_id=pid, topic_filters=tfs2, properties=props)
    if ptype == P.UNSUBACK:
        pid = r.u16()
        props = _parse_properties(r) if ver == P.MQTT_V5 else {}
        return P.UnsubAck(
            packet_id=pid, reason_codes=list(r.rest()), properties=props
        )
    if ptype == P.PINGREQ:
        return P.PingReq()
    if ptype == P.PINGRESP:
        return P.PingResp()
    if ptype == P.DISCONNECT:
        rc, props = P.RC_SUCCESS, {}
        if ver == P.MQTT_V5 and r.remaining():
            rc = r.u8()
            if r.remaining():
                props = _parse_properties(r)
        return P.Disconnect(reason_code=rc, properties=props)
    if ptype == P.AUTH:
        rc, props = P.RC_SUCCESS, {}
        if r.remaining():
            rc = r.u8()
            if r.remaining():
                props = _parse_properties(r)
        return P.Auth(reason_code=rc, properties=props)
    raise FrameError(f"unhandled packet type {ptype}")


def parse_one(frame: bytes, version: int = P.MQTT_V4) -> P.Packet:
    """Parse one *complete* wire frame (header byte + remaining-length
    varint + body, as a framer that splits the stream emits it) into a
    packet."""
    header = frame[0]
    pos = 1
    while frame[pos] & 0x80:
        pos += 1
    return _parse_packet(header, frame[pos + 1:], version)


# --------------------------------------------------------------------------
# serializer


def _w_varint(n: int) -> bytes:
    if n > MAX_REMAINING_LEN:
        raise FrameError("varint overflow")
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _w_bin(b: bytes) -> bytes:
    return len(b).to_bytes(2, "big") + b


def _w_utf8(s: str) -> bytes:
    return _w_bin(s.encode("utf-8"))


def _w_properties(props: dict[str, Any]) -> bytes:
    body = bytearray()
    for name, val in props.items():
        pid, ty = P.PROP_IDS[name]
        vals = val if name in ("User-Property", "Subscription-Identifier") else [val]
        if not isinstance(vals, list):
            vals = [vals]
        for v in vals:
            body += _w_varint(pid)
            if ty == "byte":
                body.append(v)
            elif ty == "two":
                body += int(v).to_bytes(2, "big")
            elif ty == "four":
                body += int(v).to_bytes(4, "big")
            elif ty == "varint":
                body += _w_varint(v)
            elif ty == "utf8":
                body += _w_utf8(v)
            elif ty == "binary":
                body += _w_bin(v)
            else:
                body += _w_utf8(v[0]) + _w_utf8(v[1])
    return _w_varint(len(body)) + bytes(body)


def serialize(pkt: P.Packet, version: int = P.MQTT_V4) -> bytes:
    v5 = version == P.MQTT_V5
    t = pkt.type
    flags = 0
    body = bytearray()
    if t == P.PUBLISH:
        flags = (pkt.dup << 3) | (pkt.qos << 1) | int(pkt.retain)
        body += _w_utf8(pkt.topic)
        if pkt.qos > 0:
            if pkt.packet_id is None:
                raise FrameError("publish qos>0 needs packet_id")
            body += pkt.packet_id.to_bytes(2, "big")
        if v5:
            body += _w_properties(pkt.properties)
        body += pkt.payload
    elif t == P.CONNECT:
        body += _w_utf8(pkt.proto_name)
        body.append(pkt.proto_ver)
        cf = (
            (bool(pkt.username) << 7) | (pkt.password is not None) << 6
            | (pkt.will_retain << 5) | (pkt.will_qos << 3)
            | (pkt.will_flag << 2) | (pkt.clean_start << 1)
        )
        body.append(cf)
        body += pkt.keepalive.to_bytes(2, "big")
        if pkt.proto_ver == P.MQTT_V5:
            body += _w_properties(pkt.properties)
        body += _w_utf8(pkt.clientid)
        if pkt.will_flag:
            if pkt.proto_ver == P.MQTT_V5:
                body += _w_properties(pkt.will_props)
            body += _w_utf8(pkt.will_topic or "")
            body += _w_bin(pkt.will_payload or b"")
        if pkt.username:
            body += _w_utf8(pkt.username)
        if pkt.password is not None:
            body += _w_bin(pkt.password)
    elif t == P.CONNACK:
        body.append(int(pkt.session_present))
        body.append(pkt.reason_code)
        if v5:
            body += _w_properties(pkt.properties)
    elif t in (P.PUBACK, P.PUBREC, P.PUBREL, P.PUBCOMP):
        if t == P.PUBREL:
            flags = 0x02
        body += pkt.packet_id.to_bytes(2, "big")
        if v5 and (pkt.reason_code != P.RC_SUCCESS or pkt.properties):
            body.append(pkt.reason_code)
            if pkt.properties:
                body += _w_properties(pkt.properties)
    elif t == P.SUBSCRIBE:
        flags = 0x02
        body += pkt.packet_id.to_bytes(2, "big")
        if v5:
            body += _w_properties(pkt.properties)
        for tf, opts in pkt.topic_filters:
            body += _w_utf8(tf)
            body.append(
                (opts.get("qos", 0) & 0x03)
                | (opts.get("nl", 0) << 2)
                | (opts.get("rap", 0) << 3)
                | ((opts.get("rh", 0) & 0x03) << 4)
            )
    elif t == P.SUBACK:
        body += pkt.packet_id.to_bytes(2, "big")
        if v5:
            body += _w_properties(pkt.properties)
        body += bytes(pkt.reason_codes)
    elif t == P.UNSUBSCRIBE:
        flags = 0x02
        body += pkt.packet_id.to_bytes(2, "big")
        if v5:
            body += _w_properties(pkt.properties)
        for tf in pkt.topic_filters:
            body += _w_utf8(tf)
    elif t == P.UNSUBACK:
        body += pkt.packet_id.to_bytes(2, "big")
        if v5:
            body += _w_properties(pkt.properties)
            body += bytes(pkt.reason_codes)
    elif t in (P.PINGREQ, P.PINGRESP):
        pass
    elif t == P.DISCONNECT:
        if v5 and (pkt.reason_code != P.RC_SUCCESS or pkt.properties):
            body.append(pkt.reason_code)
            if pkt.properties:
                body += _w_properties(pkt.properties)
    elif t == P.AUTH:
        if pkt.reason_code != P.RC_SUCCESS or pkt.properties:
            body.append(pkt.reason_code)
            if pkt.properties:
                body += _w_properties(pkt.properties)
    else:
        raise FrameError(f"cannot serialize type {t}")
    return bytes([(t << 4) | flags]) + _w_varint(len(body)) + bytes(body)
