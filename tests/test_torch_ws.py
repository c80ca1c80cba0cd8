"""The port's MQTT-over-WebSocket transport (``emqx_tpu_torch/broker/ws.py``)
against the reference's.

- the 7 cases of ``tests/test_ws.py`` over both packages (``pkg``), from the
  reference's own source with the package name pointed at the port for
  ``port``; its live listeners are each package's ``WsBrokerServer`` over
  its own ``Broker`` and ``CM``, or over the package's own ``BrokerApp``
  where the case builds one (TCP + WS over one app); that case is also
  written out below over one bare broker;
- the codec: seeded frames (every length class, masked with an injected
  mask key, fragmented, interleaved control frames) encode to the same
  bytes and decode, at every chunking, to the same messages; malformed
  frames raise ``WsError`` with the same close code and reason;
- the HTTP upgrade: the same answer to each request, byte for byte.
"""

from __future__ import annotations

import asyncio
import types

import numpy as np
import pytest

from test_torch_harness import PKGS, net, reference_case_names, \
    reference_tests, ws_client_class

CASES = reference_case_names("test_ws")
APP_CASE = "test_ws_mixed_with_tcp_same_broker"


def test_reference_case_count():
    assert len(CASES) == 7 and APP_CASE in CASES


def ws_module(pkg: str):
    """The private copy of tests/test_ws.py whose ``WsBrokerServer`` is
    the package's, over a fresh Broker and CM when no app is given."""
    mod = reference_tests("test_ws", pkg)
    n = net(pkg)

    def server(port=0, **kw):
        if kw.get("app") is None and kw.get("broker") is None:
            kw.update(broker=n.Broker(), cm=n.CM())
        return n.ws.WsBrokerServer(port=port, **kw)

    mod.WsBrokerServer = server
    return mod


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", CASES)
def test_reference_ws_case(case, pkg):
    getattr(ws_module(pkg), case)()


@pytest.mark.parametrize("pkg", PKGS)
def test_ws_mixed_with_tcp_same_broker(pkg):
    """tests/test_ws.py's two-listener case over one Broker and CM: a WS
    subscriber receives from a TCP publisher, and a TCP subscriber from a
    WS publisher."""
    n = net(pkg)
    W = ws_client_class(n)

    async def main():
        broker, cm = n.Broker(), n.CM()
        tcp = n.BrokerServer(port=0, broker=broker, cm=cm)
        ws = n.ws.WsBrokerServer(port=0, broker=broker, cm=cm)
        await tcp.start()
        await ws.start()
        try:
            wsub = W(port=ws.port, clientid="w1")
            tsub = n.MqttClient(port=tcp.port, clientid="t2", proto_ver=5)
            for c in (wsub, tsub):
                await c.connect()
                await c.subscribe("x/#", qos=1)
            tpub = n.MqttClient(port=tcp.port, clientid="t1")
            wpub = W(port=ws.port, clientid="w2", proto_ver=5)
            for c in (tpub, wpub):
                await c.connect()
            await tpub.publish("x/y", b"cross", qos=1)
            await wpub.publish("x/z", b"back", qos=1)
            for c in (wsub, tsub):
                got = sorted([(await c.recv()).payload for _ in range(2)])
                assert got == [b"back", b"cross"]
            for c in (wsub, tsub, tpub, wpub):
                await c.disconnect()
        finally:
            await ws.stop()
            await tcp.stop()

    asyncio.run(main())


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def seeded_os(seed: int):
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(urandom=lambda k: rng.integers(
        0, 256, k).astype(np.uint8).tobytes())


SIZES = [0, 1, 125, 126, 127, 65535, 65536, 70000]


def frames(pkg: str, monkeypatch) -> bytes:
    """Every length class, masked and not, a fragmented message with a
    PING between its fragments, a CLOSE: one byte stream."""
    W = net(pkg).ws
    monkeypatch.setattr(W, "os", seeded_os(3))
    rng = np.random.default_rng(5)
    out = []
    for size in SIZES:
        payload = rng.integers(0, 256, size).astype(np.uint8).tobytes()
        for mask in (False, True):
            out.append(W.encode_frame(W.OP_BINARY, payload, mask=mask))
    f1 = bytearray(W.encode_frame(W.OP_BINARY, b"hello ", mask=True))
    f1[0] &= 0x7F                                  # not FIN
    out += [bytes(f1), W.encode_frame(W.OP_PING, b"hb", mask=True),
            W.encode_frame(W.OP_CONT, b"world", mask=True),
            W.encode_frame(W.OP_TEXT, "ü".encode(), mask=True),
            W.encode_frame(W.OP_CLOSE, b"\x03\xe8", mask=True)]
    return b"".join(out)


def decode(pkg: str, data: bytes, chunks: list[int], require_mask=False):
    W = net(pkg).ws
    dec = W.FrameDecoder(require_mask=require_mask)
    out, pos = [], 0
    for c in chunks:
        out += dec.feed(data[pos:pos + c])
        pos += c
    out += dec.feed(data[pos:])
    return out


def test_codec_bytes_and_messages_equal(monkeypatch):
    data = frames("ref", monkeypatch)
    assert frames("port", monkeypatch) == data
    rng = np.random.default_rng(9)
    for chunking in ([], [1] * 300, rng.integers(
            1, 5000, 200).tolist()):
        got = {pkg: decode(pkg, data, chunking) for pkg in PKGS}
        assert got["port"] == got["ref"]
        assert len(got["ref"]) == 2 * len(SIZES) + 4


def test_accept_key_equal():
    rng = np.random.default_rng(1)
    for _ in range(20):
        key = rng.integers(0, 256, 16).astype(np.uint8).tobytes().hex()
        assert (net("port").ws.accept_key(key)
                == net("ref").ws.accept_key(key))


def _bad_frames() -> dict:
    W = net("ref").ws
    ping = bytearray(W.encode_frame(W.OP_PING, b"x", mask=True))
    ping[0] &= 0x7F
    start = bytearray(W.encode_frame(W.OP_BINARY, b"a", mask=True))
    start[0] &= 0x7F
    return {
        "unmasked": (True, W.encode_frame(W.OP_BINARY, b"x")),
        "rsv_bits": (False, bytes([0xC2, 0x00])),
        "fragmented_control": (False, bytes(ping)),
        "continuation_without_start": (
            False, W.encode_frame(W.OP_CONT, b"x", mask=True)),
        "interleaved": (False, bytes(start) + W.encode_frame(
            W.OP_BINARY, b"b", mask=True)),
        "frame_too_big": (False, bytes([0x82, 0x7F]) + (1 << 25).to_bytes(
            8, "big")),
    }


BAD = _bad_frames()


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_same_ws_error(case):
    require_mask, data = BAD[case]
    errs = {}
    for pkg in PKGS:
        W = net(pkg).ws
        with pytest.raises(W.WsError) as ei:
            W.FrameDecoder(require_mask=require_mask).feed(data)
        errs[pkg] = (ei.value.code, str(ei.value))
    assert errs["port"] == errs["ref"]


# ---------------------------------------------------------------------------
# the HTTP upgrade
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self) -> None:
        self.data = b""

    def write(self, b: bytes) -> None:
        self.data += b

    async def drain(self) -> None:
        pass


KEY = "dGhlIHNhbXBsZSBub25jZQ=="
REQUESTS = {
    "mqtt": ("/mqtt", f"GET /mqtt HTTP/1.1\r\nHost: h\r\nUpgrade: websocket"
             f"\r\nConnection: Upgrade\r\nSec-WebSocket-Key: {KEY}\r\n"
             "Sec-WebSocket-Protocol: mqtt, mqttv3.1\r\n\r\n"),
    "no_protocol": ("/mqtt", "GET /mqtt?x=1 HTTP/1.1\r\nUpgrade: WebSocket"
                    f"\r\nConnection: keep-alive, Upgrade\r\n"
                    f"Sec-WebSocket-Key: {KEY}\r\n\r\n"),
    "bad_path": ("/mqtt", "GET /nope HTTP/1.1\r\nUpgrade: websocket\r\n"
                 f"Connection: Upgrade\r\nSec-WebSocket-Key: {KEY}\r\n\r\n"),
    "any_path": ("", "GET /any HTTP/1.1\r\nUpgrade: websocket\r\n"
                 f"Connection: Upgrade\r\nSec-WebSocket-Key: {KEY}\r\n\r\n"),
    "no_key": ("/mqtt", "GET /mqtt HTTP/1.1\r\nUpgrade: websocket\r\n"
               "Connection: Upgrade\r\n\r\n"),
    "post": ("/mqtt", "POST /mqtt HTTP/1.1\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Key: {KEY}\r\n\r\n"),
    "truncated": ("/mqtt", "GET /mqtt HTTP/1.1\r\nUpgrade: websocket"),
}


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_handshake_answers_equal(case):
    path, request = REQUESTS[case]

    async def answer(pkg):
        reader = asyncio.StreamReader()
        reader.feed_data(request.encode())
        reader.feed_eof()
        w = Writer()
        ok = await net(pkg).ws.server_handshake(reader, w, path=path)
        return ok, w.data

    got = {pkg: asyncio.run(answer(pkg)) for pkg in PKGS}
    assert got["port"] == got["ref"]
    assert got["ref"][0] == (case in ("mqtt", "no_protocol", "any_path"))
