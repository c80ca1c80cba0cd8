"""MQTT over WebSocket — the ``emqx_ws_connection.erl`` analogue.

The reference rides cowboy; here RFC6455 is implemented in-repo (no
external deps): HTTP upgrade handshake with the ``mqtt`` subprotocol,
an incremental frame decoder (fragmentation, ping/pong, close,
masked-client enforcement), and a listener that feeds the *same*
``Channel`` FSM the TCP server drives — WS binary frames are just a
second byte-transport for the MQTT parser.

This is the port's copy of the JAX package's WS transport: the same
codec bytes and handshake, over the port's ``BrokerServer``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
import os
import struct
from typing import Optional

from emqx_tpu_torch.broker.server import BrokerServer, Connection

log = logging.getLogger("emqx_tpu_torch.ws")

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """One unfragmented frame (FIN=1). Servers send unmasked; clients
    must mask (RFC6455 §5.3)."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < 65536:
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


class WsError(Exception):
    def __init__(self, code: int, reason: str) -> None:
        super().__init__(reason)
        self.code = code


class FrameDecoder:
    """Incremental RFC6455 decoder: feed bytes, get (opcode, payload)
    messages (fragments reassembled, control frames passed through)."""

    def __init__(self, require_mask: bool = True,
                 max_size: int = 1 << 24) -> None:
        self.require_mask = require_mask
        self.max_size = max_size
        self._buf = b""
        self._frag_op: Optional[int] = None
        self._frag_data = b""

    def feed(self, data: bytes) -> list[tuple[int, bytes]]:
        self._buf += data
        out: list[tuple[int, bytes]] = []
        while True:
            frame = self._try_frame()
            if frame is None:
                return out
            fin, opcode, payload = frame
            if opcode in (OP_CLOSE, OP_PING, OP_PONG):
                if not fin:
                    raise WsError(1002, "fragmented control frame")
                out.append((opcode, payload))
                continue
            if opcode == OP_CONT:
                if self._frag_op is None:
                    raise WsError(1002, "continuation without start")
                self._frag_data += payload
                if len(self._frag_data) > self.max_size:
                    raise WsError(1009, "message too big")
                if fin:
                    out.append((self._frag_op, self._frag_data))
                    self._frag_op, self._frag_data = None, b""
                continue
            # data frame start
            if self._frag_op is not None:
                raise WsError(1002, "interleaved fragmented messages")
            if fin:
                out.append((opcode, payload))
            else:
                self._frag_op, self._frag_data = opcode, payload

    def _try_frame(self) -> Optional[tuple[bool, int, bytes]]:
        buf = self._buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        if b0 & 0x70:
            raise WsError(1002, "RSV bits set")
        fin = bool(b0 & 0x80)
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        if self.require_mask and not masked:
            raise WsError(1002, "client frames must be masked")
        n = b1 & 0x7F
        pos = 2
        if n == 126:
            if len(buf) < 4:
                return None
            (n,) = struct.unpack_from(">H", buf, 2)
            pos = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            (n,) = struct.unpack_from(">Q", buf, 2)
            pos = 10
        if n > self.max_size:
            raise WsError(1009, "frame too big")
        key = b""
        if masked:
            if len(buf) < pos + 4:
                return None
            key = buf[pos:pos + 4]
            pos += 4
        if len(buf) < pos + n:
            return None
        payload = buf[pos:pos + n]
        if masked:
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        self._buf = buf[pos + n:]
        return fin, opcode, payload


async def server_handshake(reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           path: str = "/mqtt") -> bool:
    """Read the HTTP upgrade request, answer 101 (subprotocol ``mqtt``)
    or reject. Returns True when upgraded."""
    try:
        request = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout=10)
    except (asyncio.IncompleteReadError, asyncio.TimeoutError,
            asyncio.LimitOverrunError):
        return False
    lines = request.decode("latin1").split("\r\n")
    parts = lines[0].split(" ")
    headers = {}
    for line in lines[1:]:
        name, sep, val = line.partition(":")
        if sep:
            headers[name.strip().lower()] = val.strip()
    ok = (
        len(parts) >= 2 and parts[0] == "GET"
        and "websocket" in headers.get("upgrade", "").lower()
        and "upgrade" in headers.get("connection", "").lower()
        and "sec-websocket-key" in headers
    )
    if not ok or (path and parts[1].split("?")[0] != path):
        writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                     b"Content-Length: 0\r\n\r\n")
        await writer.drain()
        return False
    protos = [p.strip() for p in
              headers.get("sec-websocket-protocol", "").split(",") if p]
    resp = [
        "HTTP/1.1 101 Switching Protocols",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Accept: {accept_key(headers['sec-websocket-key'])}",
    ]
    if "mqtt" in protos:
        resp.append("Sec-WebSocket-Protocol: mqtt")
    writer.write(("\r\n".join(resp) + "\r\n\r\n").encode())
    await writer.drain()
    return True


class WsConnection(Connection):
    """A WS-framed MQTT connection: identical channel path (the base
    ``_on_bytes`` stage does limits/accounting/parse/FSM), the socket
    bytes pass through the RFC6455 decoder first and replies wrap into
    binary frames via ``_transport_wrap``."""

    def __init__(self, server: "WsBrokerServer", reader, writer):
        super().__init__(server, reader, writer)
        self.ws = FrameDecoder(require_mask=True)

    # MQTT bytes out → one binary WS frame (the reference emits one WS
    # frame per serialized packet batch too)
    def _transport_wrap(self, data: bytes) -> bytes:
        return encode_frame(OP_BINARY, data)

    async def run(self) -> None:
        from emqx_tpu_torch.mqtt import packet as P
        from emqx_tpu_torch.mqtt.frame import FrameError

        try:
            while not self.closed:
                data = await self.reader.read(65536)
                if not data:
                    break
                try:
                    messages = self.ws.feed(data)
                except WsError as e:
                    self.writer.write(encode_frame(
                        OP_CLOSE, struct.pack(">H", e.code)))
                    break
                for opcode, payload in messages:
                    if opcode == OP_PING:
                        self.writer.write(encode_frame(OP_PONG, payload))
                        continue
                    if opcode == OP_CLOSE:
                        self.writer.write(encode_frame(OP_CLOSE, payload))
                        self.closed = True
                        break
                    if opcode == OP_PONG:
                        continue
                    # text frames are a protocol violation for MQTT-WS,
                    # tolerate by treating payload as bytes
                    await self._on_bytes(payload)
                await self._drain()
        except FrameError as e:
            log.info("mqtt frame error from %s: %s",
                     self.channel.conninfo.peername, e)
            if self.channel.conninfo.proto_ver == P.MQTT_V5:
                self._send_packets([P.Disconnect(reason_code=e.rc)])
                await self._drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            await self.close("sock_closed")


class WsBrokerServer(BrokerServer):
    """WS listener (ws:// — TLS termination is the LB's job here, as in
    the reference's ws vs wss listener split)."""

    def __init__(self, *args, path: str = "/mqtt", **kwargs):
        super().__init__(*args, **kwargs)
        self.path = path
        self.listener_id = kwargs.get("listener_id", "ws:default")

    async def _on_connect(self, reader, writer) -> None:
        if len(self.connections) >= self.max_connections:
            writer.close()
            return
        olp = getattr(self.app, "olp", None)
        if olp is not None and olp.backoff_new_conn():
            writer.close()
            return
        if self.limiter is not None:
            ok, _retry = self.limiter.connect(self.listener_id)
            if not ok:
                writer.close()      # conn-rate limit, same as the TCP path
                return
        if not await server_handshake(reader, writer, self.path):
            writer.close()
            return
        conn = WsConnection(self, reader, writer)
        self.connections.add(conn)
        await conn.run()
