"""Generic gateway connection adapters — the
``emqx_gateway_conn.erl`` (1236 LoC) analogue: one TCP adapter and one
UDP adapter that own the socket, run the Frame codec, and drive any
GwChannel. Protocol modules supply only Frame + Channel.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Optional

from emqx_tpu_torch.gateway.ctx import GwChannel, GwFrame

log = logging.getLogger(__name__)


class TcpGwConnection:
    def __init__(self, frame: GwFrame, channel: GwChannel,
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.frame = frame
        self.channel = channel
        self.reader = reader
        self.writer = writer
        self.parse_state = frame.initial_parse_state()
        self.closed = False
        self._loop = asyncio.get_event_loop()
        channel.send = self.send_frames
        channel.request_close = self.request_close
        channel.peername = writer.get_extra_info("peername")
        ready = getattr(channel, "on_socket_ready", None)
        if ready is not None:        # channels that announce the socket
            ready()                  # to an external service (exproto)

    def send_frames(self, pkts: list) -> None:
        if self.closed or not pkts:
            return
        data = b"".join(self.frame.serialize(p) for p in pkts)
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            self.writer.write(data)
        else:
            self._loop.call_soon_threadsafe(self.writer.write, data)

    def request_close(self) -> None:
        """Thread-safe transport teardown: closing the writer unblocks the
        reader so the run loop exits and terminates the channel."""
        def do() -> None:
            self.closed = True
            try:
                self.writer.close()
            except Exception:
                pass
        self._loop.call_soon_threadsafe(do)

    async def run(self) -> None:
        try:
            while not self.closed:
                data = await self.reader.read(65536)
                if not data:
                    break
                pkts, self.parse_state = self.frame.parse(
                    data, self.parse_state)
                for pkt in pkts:
                    out = self.channel.handle_in(pkt)
                    self.send_frames(out)
                    if self.channel.conn_state == "disconnected":
                        self.closed = True
                        break
                await self.writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except Exception:
            log.exception("gateway connection crashed")
        finally:
            await self.close("sock_closed")

    async def close(self, reason: str) -> None:
        if not self.closed:
            self.closed = True
        self.channel.terminate(reason)
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass


class TcpGwListener:
    """esockd-analogue acceptor for a TCP gateway."""

    def __init__(self, make_channel: Callable[[], GwChannel],
                 frame: GwFrame, host: str = "127.0.0.1",
                 port: int = 0, tick_interval_s: float = 1.0) -> None:
        self.make_channel = make_channel
        self.frame = frame
        self.host, self.port = host, port
        self.tick_interval_s = tick_interval_s
        self._server: Optional[asyncio.AbstractServer] = None
        self._tick_task: Optional[asyncio.Task] = None
        self.connections: set[TcpGwConnection] = set()

    async def _on_connect(self, reader, writer) -> None:
        conn = TcpGwConnection(self.frame, self.make_channel(),
                               reader, writer)
        self.connections.add(conn)
        try:
            await conn.run()
        finally:
            self.connections.discard(conn)

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        # channel housekeeping (tx timeouts, retransmits) — the TCP
        # transport needs the same periodic drive UdpGwListener has
        self._tick_task = self._loop.create_task(self._tick_loop())

    async def _tick_loop(self) -> None:
        while True:
            await asyncio.sleep(self.tick_interval_s)
            for conn in list(self.connections):
                hk = getattr(conn.channel, "housekeep", None)
                if hk is None:
                    continue
                try:
                    frames = hk()
                    if frames:
                        conn.send_frames(frames)
                except Exception:
                    log.exception("gateway channel housekeep crashed")

    async def stop(self) -> None:
        if self._tick_task is not None:
            self._tick_task.cancel()
        for conn in list(self.connections):
            await conn.close("server_shutdown")
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


class UdpGwListener(asyncio.DatagramProtocol):
    """UDP gateway transport (esockd udp): one channel per peer addr,
    expired by the protocol's own keepalive."""

    def __init__(self, make_channel: Callable[[], GwChannel],
                 frame: GwFrame, host: str = "127.0.0.1",
                 port: int = 0, idle_timeout_s: float = 300.0,
                 gc_interval_s: float = 30.0,
                 tick_interval_s: float = 0.5) -> None:
        self.make_channel = make_channel
        self.frame = frame
        self.host, self.port = host, port
        self.idle_timeout_s = idle_timeout_s
        self.gc_interval_s = gc_interval_s
        self.tick_interval_s = tick_interval_s
        self.channels: dict[tuple, GwChannel] = {}
        self._last_seen: dict[tuple, float] = {}
        self.transport: Optional[asyncio.DatagramTransport] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._gc_task: Optional[asyncio.Task] = None
        self._tick_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.transport, _ = await self._loop.create_datagram_endpoint(
            lambda: self, local_addr=(self.host, self.port))
        if self.port == 0:
            self.port = self.transport.get_extra_info("sockname")[1]
        self._gc_task = self._loop.create_task(self._gc_loop())
        self._tick_task = self._loop.create_task(self._tick_loop())

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gc_interval_s)
            self.expire_idle()

    async def _tick_loop(self) -> None:
        """Sub-second channel housekeeping: protocols with their own
        transport reliability (CoAP CON retransmission) return frames
        due for (re)send from ``housekeep()``."""
        while True:
            await asyncio.sleep(self.tick_interval_s)
            self.tick_channels()

    def tick_channels(self) -> None:
        for ch in list(self.channels.values()):
            hk = getattr(ch, "housekeep", None)
            if hk is None:
                continue
            try:
                frames = hk()
                if frames:
                    ch.send(frames)
            except Exception:
                log.exception("gateway channel housekeep crashed")

    def expire_idle(self, now: Optional[float] = None) -> int:
        """Drop peers silent past idle_timeout_s — without this the
        per-addr channel map grows forever (spoofed source ports, dead
        clients that never DISCONNECT)."""
        import time as _time

        now = self._loop.time() if now is None else now
        wall = _time.time()
        dead = [
            addr for addr, t in self._last_seen.items()
            if now - t >= self.idle_timeout_s
            # a sleeping client (MQTT-SN) is expected-silent until its
            # announced wake deadline — don't GC its session away
            and not (
                (su := getattr(self.channels.get(addr), "sleep_until",
                               None)) is not None and wall < su)
        ]
        for addr in dead:
            ch = self.channels.pop(addr, None)
            self._last_seen.pop(addr, None)
            if ch is not None:
                ch.terminate("idle_timeout")
        return len(dead)

    async def stop(self) -> None:
        if self._gc_task is not None:
            self._gc_task.cancel()
        if self._tick_task is not None:
            self._tick_task.cancel()
        for ch in list(self.channels.values()):
            ch.terminate("server_shutdown")
        self.channels.clear()
        self._last_seen.clear()
        if self.transport is not None:
            self.transport.close()

    # -- DatagramProtocol ----------------------------------------------------

    def datagram_received(self, data: bytes, addr: tuple) -> None:
        ch = self.channels.get(addr)
        if ch is None:
            ch = self.make_channel()
            ch.send = self._sender(addr)
            ch.request_close = self._closer(addr)
            ch.peername = addr
            ready = getattr(ch, "on_socket_ready", None)
            if ready is not None:
                ready()
            self.channels[addr] = ch
        self._last_seen[addr] = self._loop.time()
        try:
            pkts, _ = self.frame.parse(data, None)   # UDP: whole datagrams
            for pkt in pkts:
                ch.send(ch.handle_in(pkt))
            if ch.conn_state == "disconnected":
                ch.terminate("closed")
                self.channels.pop(addr, None)
                self._last_seen.pop(addr, None)
        except Exception:
            log.exception("udp gateway datagram crashed")

    def _closer(self, addr: tuple) -> Callable[[], None]:
        def close() -> None:
            def do() -> None:
                ch = self.channels.pop(addr, None)
                self._last_seen.pop(addr, None)
                if ch is not None:
                    ch.terminate("closed")
            if self._loop is not None:
                self._loop.call_soon_threadsafe(do)
        return close

    def _sender(self, addr: tuple) -> Callable[[list], None]:
        def send(pkts: list) -> None:
            if not pkts or self.transport is None:
                return
            try:
                on_loop = asyncio.get_running_loop() is self._loop
            except RuntimeError:
                on_loop = False
            for p in pkts:                 # one datagram per message
                data = self.frame.serialize(p)
                if not data:
                    continue
                if on_loop:
                    self.transport.sendto(data, addr)
                else:
                    self._loop.call_soon_threadsafe(
                        self.transport.sendto, data, addr)
        return send
