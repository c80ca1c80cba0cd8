"""CoAP gateway — parity with ``apps/emqx_gateway/src/coap/``
(message codec: emqx_coap_frame.erl / RFC 7252; pub-sub resource:
emqx_coap_pubsub_handler.erl).

Codec is full RFC 7252 (options with 13/14 delta/length extensions,
tokens, all four message types). The pub/sub surface:

    PUT/POST coap://host/ps/{topic}          → publish (2.04)
    GET      .../ps/{topic} Observe:0        → subscribe (2.05 + seq)
    GET      .../ps/{topic} Observe:1        → unsubscribe (2.07-ish 2.05)
    GET      .../ps/{topic}                  → read latest retained (2.05/4.04)

Observed deliveries arrive as NON 2.05 notifications carrying the
subscribe token and a rolling Observe sequence.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

from emqx_tpu_torch.gateway.ctx import GatewayImpl, GwChannel, GwContext, GwFrame

CON, NON, ACK, RST = 0, 1, 2, 3

# method / response codes (class.detail → byte)
EMPTY = 0x00
GET, POST, PUT, DELETE = 0x01, 0x02, 0x03, 0x04
CREATED, DELETED, VALID, CHANGED, CONTENT = 0x41, 0x42, 0x43, 0x44, 0x45
BAD_REQUEST, UNAUTHORIZED, NOT_FOUND, NOT_ALLOWED = 0x80, 0x81, 0x84, 0x85

# option numbers
OPT_OBSERVE, OPT_URI_PATH, OPT_CONTENT_FORMAT, OPT_URI_QUERY = 6, 11, 12, 15
OPT_LOCATION_PATH = 8
OPT_ETAG = 4
OPT_BLOCK2, OPT_BLOCK1 = 23, 27          # RFC 7959 (emqx_coap_frame.erl
OPT_SIZE2, OPT_SIZE1 = 28, 60            # encode_option block1/block2)

CONTINUE_231 = 0x5F                      # 2.31 Continue
REQUEST_ENTITY_INCOMPLETE = 0x88         # 4.08
REQUEST_ENTITY_TOO_LARGE = 0x8D          # 4.13


def parse_block(v: bytes) -> tuple[int, int, int]:
    """Block option value → (num, more, size). RFC 7959 §2.2: 0-3 byte
    uint of NUM<<4 | M<<3 | SZX, size = 2^(SZX+4). SZX=7 is reserved
    (RFC 8323 repurposes it as BERT) — rejected, not misread as 2048."""
    u = int.from_bytes(v, "big")
    if (u & 0x07) == 7:
        raise ValueError("reserved SZX 7")
    return u >> 4, (u >> 3) & 1, 1 << ((u & 0x07) + 4)


def encode_block(num: int, more: int, size: int) -> bytes:
    szx = max(0, size.bit_length() - 5)
    u = (num << 4) | (more << 3) | szx
    n = max(1, (u.bit_length() + 7) // 8)
    return u.to_bytes(n, "big") if u else b"\x00"


@dataclass
class CoapMessage:
    type: int = CON
    code: int = EMPTY
    mid: int = 0
    token: bytes = b""
    options: list = field(default_factory=list)   # [(number, bytes)]
    payload: bytes = b""

    def opt(self, number: int) -> Optional[bytes]:
        for n, v in self.options:
            if n == number:
                return v
        return None

    def opts(self, number: int) -> list[bytes]:
        return [v for n, v in self.options if n == number]

    def uri_path(self) -> list[str]:
        return [v.decode("utf-8", "replace")
                for v in self.opts(OPT_URI_PATH)]

    def queries(self) -> dict[str, str]:
        out = {}
        for v in self.opts(OPT_URI_QUERY):
            k, _, val = v.decode("utf-8", "replace").partition("=")
            out[k] = val
        return out

    def observe(self) -> Optional[int]:
        v = self.opt(OPT_OBSERVE)
        if v is None:
            return None
        return int.from_bytes(v, "big") if v else 0


def _ext_decode(nibble: int, data: bytes, off: int) -> tuple[int, int]:
    if nibble == 13:
        return data[off] + 13, off + 1
    if nibble == 14:
        return struct.unpack_from(">H", data, off)[0] + 269, off + 2
    return nibble, off


def _ext_encode(value: int) -> tuple[int, bytes]:
    if value < 13:
        return value, b""
    if value < 269:
        return 13, bytes([value - 13])
    return 14, struct.pack(">H", value - 269)


class Frame(GwFrame):
    """One datagram = one message."""

    def parse(self, data: bytes, state) -> tuple[list, None]:
        if len(data) < 4:
            return [], None
        b0, code, mid = data[0], data[1], struct.unpack_from(">H", data, 2)[0]
        ver, typ, tkl = b0 >> 6, (b0 >> 4) & 0x3, b0 & 0xF
        if ver != 1 or tkl > 8:
            return [], None
        off = 4
        token, off = data[off:off + tkl], off + tkl
        options: list = []
        number = 0
        while off < len(data) and data[off] != 0xFF:
            d, ln = data[off] >> 4, data[off] & 0xF
            off += 1
            d, off = _ext_decode(d, data, off)
            ln, off = _ext_decode(ln, data, off)
            number += d
            options.append((number, data[off:off + ln]))
            off += ln
        payload = data[off + 1:] if off < len(data) else b""
        return [CoapMessage(typ, code, mid, token, options, payload)], None

    def serialize(self, m: CoapMessage) -> bytes:
        out = bytearray()
        out.append((1 << 6) | (m.type << 4) | len(m.token))
        out.append(m.code)
        out += struct.pack(">H", m.mid)
        out += m.token
        prev = 0
        for number, value in sorted(m.options, key=lambda o: o[0]):
            d, dext = _ext_encode(number - prev)
            ln, lext = _ext_encode(len(value))
            out.append((d << 4) | ln)
            out += dext + lext + value
            prev = number
        if m.payload:
            out.append(0xFF)
            out += m.payload
        return bytes(out)


def uri_path_opts(path: str) -> list:
    return [(OPT_URI_PATH, seg.encode())
            for seg in path.split("/") if seg]


# -- transport machine (emqx_coap_tm.erl) -----------------------------------

ACK_TIMEOUT = 2.0            # RFC 7252 §4.8
ACK_RANDOM_FACTOR = 1.5
MAX_RETRANSMIT = 4
EXCHANGE_LIFETIME = 247.0    # §4.8.2 — dedup window for CON exchanges
NON_LIFETIME = 145.0


class TransportManager:
    """Per-endpoint CoAP message-layer state (emqx_coap_tm.erl):

    - **inbound dedup**: a retransmitted CON (same mid inside
      EXCHANGE_LIFETIME) gets the CACHED response replayed instead of
      re-executing the request (publish/subscribe are not idempotent);
      duplicate NONs are dropped silently.
    - **outbound reliability**: CON messages we originate are tracked
      until ACK/RST, retransmitted with exponential backoff
      (ACK_TIMEOUT×ACK_RANDOM_FACTOR, doubling, MAX_RETRANSMIT tries);
      a give-up surfaces the mids so the channel can cancel state
      (e.g. drop a dead observer, §4.2).
    """

    def __init__(self, now_fn=None) -> None:
        import time as _time
        self.now = now_fn or _time.monotonic
        # inbound: mid → (request token, cached response frames,
        # expire_at). The token rides along because a retransmission is
        # BYTE-IDENTICAL (RFC 7252 §4.2): a fast client whose 16-bit mid
        # counter wraps inside EXCHANGE_LIFETIME reuses a mid for a NEW
        # exchange, and keying on the mid alone replayed the OLD cached
        # response at it (the parity-audit "MID-dedup window wrap" bug —
        # the request was silently swallowed). A differing token proves
        # the mid was recycled: evict, treat as fresh.
        self._seen: dict[int, tuple[bytes, list, float]] = {}
        # outbound: mid → [msg, tries, next_at, timeout]
        self._pending: dict[int, list] = {}

    # -- inbound dedup -------------------------------------------------------

    def dedup(self, m: CoapMessage):
        """None = fresh message; list = replay this cached response."""
        hit = self._seen.get(m.mid)
        if hit is None:
            return None
        token, frames, expire_at = hit
        if self.now() >= expire_at:
            del self._seen[m.mid]
            return None
        if token != m.token:
            # recycled mid (client counter wrapped): a new exchange,
            # not a retransmission — never replay the old response
            del self._seen[m.mid]
            return None
        return frames        # may be [] (duplicate NON → drop silently)

    def remember(self, m: CoapMessage, response: list) -> None:
        life = EXCHANGE_LIFETIME if m.type == CON else NON_LIFETIME
        self._seen[m.mid] = (m.token, list(response), self.now() + life)

    # -- outbound CON reliability -------------------------------------------

    def track(self, m: CoapMessage) -> CoapMessage:
        if m.type == CON:
            timeout = ACK_TIMEOUT * ACK_RANDOM_FACTOR
            self._pending[m.mid] = [m, 0, self.now() + timeout, timeout]
        return m

    def on_ack(self, mid: int) -> bool:
        return self._pending.pop(mid, None) is not None

    on_rst = on_ack

    def tick(self) -> tuple[list[CoapMessage], list[int]]:
        """(messages to retransmit now, mids given up on)."""
        now = self.now()
        retx: list[CoapMessage] = []
        gave_up: list[int] = []
        for mid, st in list(self._pending.items()):
            msg, tries, next_at, timeout = st
            if now < next_at:
                continue
            if tries >= MAX_RETRANSMIT:
                del self._pending[mid]
                gave_up.append(mid)
                continue
            st[1] = tries + 1
            st[3] = timeout * 2
            st[2] = now + st[3]
            retx.append(msg)
        # dedup-cache GC rides the same tick
        for mid, (_t, _f, exp) in list(self._seen.items()):
            if now >= exp:
                del self._seen[mid]
        return retx, gave_up

    def pending_count(self) -> int:
        return len(self._pending)


class Channel(GwChannel):
    """One CoAP endpoint (per UDP peer)."""

    PS_PREFIX = "ps"

    def __init__(self, ctx: GwContext) -> None:
        self.ctx = ctx
        self.conn_state = "connected"       # connectionless transport
        self.clientid: Optional[str] = None
        # topic → [token, qos, seq]: PER-OBSERVER 24-bit sequence
        # numbers (RFC 7641 §4.4 orders notifications per observation;
        # the old channel-wide counter also CRASHED in to_bytes(3) at
        # 2^24 — the parity-audit rollover bug). seq wraps mod 2^24.
        self.observers: dict[str, list] = {}
        self._mid = 0
        self._registered = False
        self.tm = TransportManager()
        self._con_topic: dict[int, str] = {}   # pending notify mid → topic
        # RFC 7959 block1 reassembly: uri-path → (next_num, buffer,
        # last_activity); one in-progress upload per path per endpoint
        self._block1: dict[str, tuple[int, bytearray, float]] = {}
        self.max_body = 64 * 1024              # 4.13 past this
        self.block2_size = 1024                # auto-slice threshold

    def _next_mid(self) -> int:
        self._mid = self._mid % 0xFFFF + 1
        return self._mid

    def _ensure_client(self, m: CoapMessage) -> bool:
        q = m.queries()
        want = q.get("clientid")
        if self._registered:
            if not want or want == self.clientid:
                return True
            # the peer RE-REGISTERS under a new identity (a rebooted or
            # re-provisioned device on the same 5-tuple): the old
            # session's observers must not leak into the new one — a
            # stale token the new client reuses for its own exchange
            # would mis-correlate notifications — and the new clientid
            # must be re-authenticated, not waved through (the SN
            # re-CONNECT ghost/ban-bypass analogue found in an audit)
            for topic in list(self.observers):
                self._cancel_observe(topic)
            self._con_topic.clear()
            self._block1.clear()
            self.ctx.close_session(self.clientid, self, "re-register")
            self._registered = False
        self.clientid = want or f"coap-{id(self):x}"
        if not self.ctx.authenticate(self.clientid,
                                     username=q.get("username"),
                                     password=q.get("password")):
            return False
        self.ctx.open_session(self.clientid, self)
        self._registered = True
        return True

    # -- inbound -------------------------------------------------------------

    def handle_in(self, m: CoapMessage) -> list[CoapMessage]:
        if m.code == EMPTY and m.type == CON:
            # CoAP ping (RFC 7252 §4.3): pong with RST. The client's mid
            # space is independent of ours — it must NOT settle a
            # pending notify that happens to share the number.
            return [CoapMessage(RST, EMPTY, m.mid, b"")]
        if m.type in (ACK, RST):
            # message-layer signal for a CON we originated (notify):
            # ACK settles it; RST additionally cancels the observation
            # (RFC 7641 §3.6 / emqx_coap_tm ack handling)
            if m.type == RST:
                self.tm.on_rst(m.mid)
                self._cancel_observe(self._con_topic.pop(m.mid, None))
            else:
                self.tm.on_ack(m.mid)
                self._con_topic.pop(m.mid, None)
            return []
        if m.code == EMPTY:
            return []               # NON empty: nothing to do
        cached = self.tm.dedup(m)
        if cached is not None:
            return list(cached)     # retransmitted request: replay reply
        out = self._handle_request(m)
        self.tm.remember(m, out)
        return out

    def _cancel_observe(self, topic: Optional[str]) -> None:
        if topic is not None and topic in self.observers:
            del self.observers[topic]
            self.ctx.unsubscribe(self.clientid, topic)

    def _handle_request(self, m: CoapMessage) -> list[CoapMessage]:
        reply_type = ACK if m.type == CON else NON
        path = m.uri_path()

        def reply(code: int, payload: bytes = b"", options=()) -> CoapMessage:
            return CoapMessage(reply_type, code, m.mid, m.token,
                               list(options), payload)

        if not path or path[0] != self.PS_PREFIX:
            return [reply(NOT_FOUND)]
        topic = "/".join(path[1:])
        if not topic:
            return [reply(BAD_REQUEST)]
        if not self._ensure_client(m):
            return [reply(UNAUTHORIZED)]

        if m.code in (PUT, POST):
            payload = m.payload
            b1 = m.opt(OPT_BLOCK1)
            if b1 is not None:                 # RFC 7959 block1 upload
                try:
                    num, more, size = parse_block(b1)
                except ValueError:
                    return [reply(BAD_REQUEST)]
                import time as _t
                cur = self._block1.get(topic)
                if num == 0:
                    cur = (0, bytearray(), 0.0)
                elif cur is None or cur[0] != num:
                    # out-of-order / unknown transfer: 4.08 (§2.5)
                    self._block1.pop(topic, None)
                    return [reply(REQUEST_ENTITY_INCOMPLETE,
                                  options=[(OPT_BLOCK1, b1)])]
                buf = cur[1]
                buf += m.payload
                if len(buf) > self.max_body:
                    self._block1.pop(topic, None)
                    return [reply(REQUEST_ENTITY_TOO_LARGE)]
                if more:
                    self._block1[topic] = (num + 1, buf, _t.monotonic())
                    return [reply(CONTINUE_231, options=[
                        (OPT_BLOCK1, encode_block(num, 1, size))])]
                self._block1.pop(topic, None)
                payload = bytes(buf)
            qos = int(m.queries().get("qos", 0))
            retain = m.queries().get("retain") in ("true", "1")
            self.ctx.publish(self.clientid, topic, payload, qos,
                             retain=retain)
            opts = ([(OPT_BLOCK1, b1)] if b1 is not None else [])
            return [reply(CHANGED, options=opts)]
        if m.code == GET:
            obs = m.observe()
            if obs == 0:
                qos = int(m.queries().get("qos", 0))
                self.observers[topic] = [m.token, qos, 1]
                self.ctx.subscribe(self.clientid, topic, qos=qos)
                return [reply(CONTENT, options=[
                    (OPT_OBSERVE, (1).to_bytes(3, "big"))])]
            if obs == 1:
                self._cancel_observe(topic if topic in self.observers
                                     else None)
                return [reply(CONTENT)]
            # plain read: latest retained message on the topic
            msgs = getattr(self.ctx.app, "retainer", None)
            if msgs is not None:
                found = msgs.match(self.ctx.mount(topic))
                if found:
                    body = found[-1].payload
                    b2 = m.opt(OPT_BLOCK2)
                    if b2 is None and len(body) <= self.block2_size:
                        return [reply(CONTENT, payload=body)]
                    # RFC 7959 block2 download: client-requested block
                    # (or server-initiated slicing past the threshold).
                    # Stateless: each block re-reads the retained store;
                    # the ETag (§2.4) lets the client detect a retained
                    # update between blocks instead of accepting a TORN
                    # concatenation of old and new bodies.
                    try:
                        num, _more, size = (parse_block(b2)
                                            if b2 is not None
                                            else (0, 0, self.block2_size))
                    except ValueError:
                        return [reply(BAD_REQUEST)]
                    lo = num * size
                    if lo >= len(body) and num:
                        return [reply(BAD_REQUEST)]
                    chunk = body[lo:lo + size]
                    more = 1 if lo + size < len(body) else 0
                    import zlib as _z
                    etag = _z.crc32(body).to_bytes(4, "big")
                    return [reply(CONTENT, payload=chunk, options=[
                        (OPT_ETAG, etag),
                        (OPT_BLOCK2, encode_block(num, more, size)),
                        (OPT_SIZE2, len(body).to_bytes(
                            max(1, (len(body).bit_length() + 7) // 8),
                            "big"))])]
            return [reply(NOT_FOUND)]
        if m.code == DELETE:
            return [reply(DELETED)]
        return [reply(NOT_ALLOWED)]

    # -- outbound ------------------------------------------------------------

    def handle_deliver(self, deliveries: list) -> list[CoapMessage]:
        out = []
        for sub_topic, msg in deliveries:
            plain = self.ctx.unmount(msg.topic)
            token = qos = None
            obs = None
            for obs_topic, rec in self.observers.items():
                from emqx_tpu_torch.core import topic as T
                if T.match(plain, obs_topic):
                    token, qos, obs_topic_hit = rec[0], rec[1], obs_topic
                    obs = rec
                    break
            if token is None:
                continue
            # the observation's OWN rolling sequence, wrapping mod 2^24
            # (the Observe option is a 3-byte uint — RFC 7641 §4.4; the
            # old shared counter crashed in to_bytes at the boundary)
            obs[2] = (obs[2] + 1) & 0xFFFFFF
            # QoS≥1 subscriptions notify as CON: tracked, retransmitted,
            # observation cancelled on RST or give-up (emqx_coap
            # notify_type per-subscription qos)
            mtype = CON if qos else NON
            mid = self._next_mid()
            note = CoapMessage(
                mtype, CONTENT, mid, token,
                [(OPT_OBSERVE, obs[2].to_bytes(3, "big"))],
                msg.payload)
            if mtype == CON:
                self.tm.track(note)
            # NON notifies are remembered too: a client that lost its
            # observe state answers RST, which must cancel the
            # observation for ANY notification type (RFC 7641 §3.6)
            self._con_topic[mid] = obs_topic_hit
            if len(self._con_topic) > 512:        # bound NON history —
                # but never evict a mid whose CON is still awaiting ACK
                # (losing it would orphan the give-up/RST cancel path)
                for old in list(self._con_topic):
                    if old not in self.tm._pending:
                        del self._con_topic[old]
                        break
            out.append(note)
        return out

    def housekeep(self) -> list[CoapMessage]:
        """Listener tick: retransmit due CONs; a give-up drops the dead
        observer (RFC 7641 §4.5 — stop notifying unresponsive clients)."""
        retx, gave_up = self.tm.tick()
        for mid in gave_up:
            self._cancel_observe(self._con_topic.pop(mid, None))
        # abandoned block1 uploads must not pin buffers forever: a
        # 60s idle TTL frees them; past the cap, evict the STALEST
        # (never an actively-progressing upload in insertion order)
        import time as _t
        now = _t.monotonic()
        stale = [k for k, (_n, _b, at) in self._block1.items()
                 if now - at > 60.0]
        for k in stale:
            del self._block1[k]
        while len(self._block1) > 8:
            oldest = min(self._block1, key=lambda k: self._block1[k][2])
            del self._block1[oldest]
        return retx

    def terminate(self, reason: str) -> None:
        if self._registered:
            self._registered = False
            self.ctx.close_session(self.clientid, self, reason)


class CoapGateway(GatewayImpl):
    name = "coap"

    def __init__(self, host: str = "127.0.0.1", port: int = 5683) -> None:
        self.host, self.port = host, port
        self.listener = None
        self.ctx: Optional[GwContext] = None

    def on_gateway_load(self, ctx: GwContext, conf: dict) -> None:
        from emqx_tpu_torch.gateway.conn import UdpGwListener

        self.ctx = ctx
        self.host = conf.get("host", self.host)
        self.port = conf.get("port", self.port)
        self.listener = UdpGwListener(
            lambda: Channel(self.ctx), Frame(),
            host=self.host, port=self.port)

    async def start_listeners(self) -> None:
        await self.listener.start()
        self.port = self.listener.port

    async def stop_listeners(self) -> None:
        await self.listener.stop()
