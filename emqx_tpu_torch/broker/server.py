"""TCP connection host + listener — the ``emqx_connection.erl`` /
``emqx_listeners.erl`` analogue.

One asyncio task per connection (the BEAM's process-per-connection on an
event loop): socket reads feed the incremental parser in ``{active,N}``
style batches, parsed packets drive the channel FSM, outgoing packets
serialize back to the socket. Periodic housekeeping covers keepalive
(1.5×), retry, and awaiting-rel expiry (the channel's timer set,
emqx_channel.erl:125-132).

This is the port's copy of the JAX package's asyncio host. With an app
whose ``pipeline`` is a ``PublishPipeline`` over a ``RouterModel`` on the
card, every PUBLISH joins a batch of the routing step there; the
deliveries come back through ``CM.dispatch`` on the pipeline's flush
thread and are marshalled onto the loop that owns the socket.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.broker.cm import CM
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import FrameError, Parser, serialize

log = logging.getLogger("emqx_tpu_torch.server")

READ_CHUNK = 65536          # {active,N}-ish coalescing
HOUSEKEEP_INTERVAL = 5.0


class Connection:
    """One client socket: parser + channel + writer."""

    def __init__(self, server: "BrokerServer",
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        peer = writer.get_extra_info("peername") or ("?", 0)
        self.parser = Parser(max_size=server.max_packet_size)
        self.limiter = server.make_limiter_container()
        pipeline = getattr(server, "pipeline", None)
        self.channel = Channel(
            server.broker, server.cm,
            mountpoint=server.mountpoint,
            send=self._send_packets,
            publish_sink=pipeline.submit if pipeline is not None else None,
            session_opts=getattr(server, "session_opts", None),
        )
        self.channel.conninfo.peername = f"{peer[0]}:{peer[1]}"
        self.metrics = getattr(server.app, "metrics", None)
        self.closed = False
        self._loop = asyncio.get_event_loop()
        # TLS listeners: capture the handshake's peer certificate for
        # cert-based identity (emqx_schema peer_cert_as_username|clientid)
        self.cert_identity: dict = {}
        if server.ssl_context is not None:
            from emqx_tpu_torch.broker.tls import peer_cert_identity
            self.cert_identity = peer_cert_identity(
                writer.get_extra_info("peercert"))

    def _transport_wrap(self, data: bytes) -> bytes:
        """Frame serialized MQTT bytes for the wire (identity for raw
        TCP; the WS transport wraps into an RFC6455 binary frame)."""
        return data

    def _send_packets(self, pkts) -> None:
        if self.closed:
            return
        ver = self.channel.conninfo.proto_ver
        limit = self.channel.conninfo.max_packet_out
        chunks = []
        sent_pkts = []
        queue = list(pkts)
        while queue:
            p = queue.pop(0)
            b = serialize(p, ver)
            if limit and len(b) > limit and p.type == P.PUBLISH:
                # MQTT5 3.1.2-25: never exceed the client's announced
                # Maximum-Packet-Size — the message is dropped for THIS
                # client (acks/connacks are never oversized in practice).
                # A QoS>0 drop must also release its inflight slot ("as
                # if it had completed sending") or the window leaks and
                # retry re-drops it forever.
                if self.metrics is not None:
                    self.metrics.inc("delivery.dropped.too_large")
                session = self.channel.session
                if p.qos and p.packet_id is not None and session is not None:
                    # freed slot may pull queued messages forward; they
                    # take the channel's normal unmount/hook postprocess
                    queue.extend(self.channel._postprocess_out(
                        session.discard_delivery(p.packet_id)))
                continue
            chunks.append(b)
            sent_pkts.append(p)
        data = b"".join(chunks)
        pkts = sent_pkts
        if data:
            frame = self._transport_wrap(data)
            try:
                on_loop = asyncio.get_running_loop() is self._loop
            except RuntimeError:
                on_loop = False
            if on_loop:
                self.writer.write(frame)
            else:
                # dispatch from a foreign thread (bridge ingress, app
                # tick in to_thread): asyncio transports are not
                # thread-safe — marshal the write onto the owning loop
                self._loop.call_soon_threadsafe(self.writer.write, frame)
            if self.metrics is not None:
                self.metrics.inc("bytes.sent", len(data))
                for p in pkts:
                    self.metrics.inc_sent_packet(
                        P.TYPE_NAMES.get(p.type, "reserved").lower())
                    if p.type == P.PUBLISH:
                        self.metrics.inc_msg("sent", p.qos)

    async def _on_bytes(self, data: bytes) -> None:
        """Shared MQTT byte-stream stage: limits, accounting, parse,
        channel FSM — both raw-TCP and WS reads land here."""
        # bytes_in limit: pause the socket until tokens free up
        # (the esockd-htb backpressure, emqx_connection.erl:528-535)
        await self._limit("bytes_in", len(data))
        if self.metrics is not None:
            self.metrics.inc("bytes.received", len(data))
        gc_policy = getattr(self.server.app, "gc_policy", None)
        if gc_policy is not None:
            gc_policy.note(1, len(data),
                           getattr(self.server.app, "olp", None))
        for pkt in self.parser.feed(data):
            if pkt.type == P.PUBLISH:
                await self._limit("message_in", 1)
            if self.metrics is not None:
                self.metrics.inc_recv_packet(
                    P.TYPE_NAMES.get(pkt.type, "reserved").lower())
                if pkt.type == P.PUBLISH:
                    self.metrics.inc_msg("received", pkt.qos)
            if pkt.type == P.CONNECT:
                self.parser.set_version(pkt.proto_ver)
                self.channel.conninfo.proto_ver = pkt.proto_ver
                # TLS identity substitution happens at the listener, not
                # the FSM — the channel sees the effective identity
                # (emqx_channel.erl peer_cert_as_username handling)
                sel = self.server.peer_cert_as_username
                if sel and self.cert_identity.get(sel):
                    pkt.username = self.cert_identity[sel]
                sel = self.server.peer_cert_as_clientid
                if sel and self.cert_identity.get(sel):
                    pkt.clientid = self.cert_identity[sel]
            out = self.channel.handle_in(pkt)
            self._send_packets(out)
            if self.channel.conn_state == "disconnected":
                self.closed = True
                break

    async def run(self) -> None:
        try:
            while not self.closed:
                data = await self.reader.read(READ_CHUNK)
                if not data:
                    break
                await self._on_bytes(data)
                await self._drain()
        except FrameError as e:
            log.info("frame error from %s: %s",
                     self.channel.conninfo.peername, e)
            if self.channel.conninfo.proto_ver == P.MQTT_V5:
                self._send_packets([P.Disconnect(reason_code=e.rc)])
                await self._drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            await self.close("sock_closed")

    async def _limit(self, type_: str, n: float) -> None:
        while not self.closed:
            ok, retry = self.limiter.check(type_, n)
            if ok:
                return
            await asyncio.sleep(min(max(retry, 0.005), 1.0))

    async def _drain(self) -> None:
        try:
            await self.writer.drain()
        except ConnectionError:
            pass

    async def close(self, reason: str) -> None:
        if not self.closed:
            self.closed = True
        self.channel.terminate(reason)
        self.server.connections.discard(self)
        congestion = getattr(self.server.app, "congestion", None)
        if congestion is not None:
            congestion.forget(self.channel.conninfo.peername)
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, Exception):
            pass

    def housekeep(self) -> None:
        if self.channel.keepalive_expired():
            asyncio.ensure_future(self.close("keepalive_timeout"))
            return
        self._send_packets(self.channel.handle_timeout("retry"))
        self.channel.handle_timeout("expire_awaiting_rel")


class BrokerServer:
    """Listener lifecycle (emqx_listeners:start_listener analogue)."""

    def __init__(
        self,
        broker: Optional[Broker] = None,
        cm: Optional[CM] = None,
        host: str = "127.0.0.1",
        port: int = 1883,
        max_packet_size: int = 1 << 20,
        max_connections: int = 1_000_000,
        mountpoint: str = "",
        app=None,
        limiter=None,
        listener_id: str = "tcp:default",
        ssl_context=None,
        ssl_handshake_timeout: Optional[float] = None,
        peer_cert_as_username: Optional[str] = None,   # "cn" | "dn"
        peer_cert_as_clientid: Optional[str] = None,
        session_opts: Optional[dict] = None,
    ):
        if app is None and broker is None:
            from emqx_tpu_torch.app import BrokerApp

            app = BrokerApp()
        self.app = app
        self.broker = broker or app.broker
        self.cm = cm or (app.cm if app else CM())
        # zone session knobs (mqtt.max_inflight & co) reach every channel
        if session_opts is None and app is not None:
            session_opts = getattr(app, "session_defaults", dict)()
        self.session_opts = dict(session_opts or {})
        self.host, self.port = host, port
        self.max_packet_size = max_packet_size
        self.max_connections = max_connections
        self.mountpoint = mountpoint
        self.connections: set[Connection] = set()
        self.limiter = limiter          # LimiterServer | None
        self.listener_id = listener_id
        self.ssl_context = ssl_context  # ssl.SSLContext | None (ssl/wss)
        self.ssl_handshake_timeout = ssl_handshake_timeout
        self.peer_cert_as_username = peer_cert_as_username
        self.peer_cert_as_clientid = peer_cert_as_clientid
        # device serving path: batch publishes through the app's pipeline
        # when the router model is configured (router.device.enable)
        self.pipeline = getattr(app, "pipeline", None)
        self._server: Optional[asyncio.AbstractServer] = None
        self._housekeeper: Optional[asyncio.Task] = None
        self._flusher: Optional[asyncio.Task] = None

    def make_limiter_container(self):
        from emqx_tpu_torch.broker.limiter import LimiterContainer

        if self.limiter is None:
            return LimiterContainer()
        return self.limiter.make_container(self.listener_id)

    def kernel_summary(self) -> dict:
        """Device-router stage percentiles + counters + trie health
        (the bench harness reads this after a run); {} when the app
        has no kernel telemetry attached."""
        if self.app is None:
            return {}
        fn = getattr(self.app, "kernel_summary", None)
        return fn() if callable(fn) else {}

    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        if len(self.connections) >= self.max_connections:
            writer.close()          # esockd max-conn limiting
            return
        olp = getattr(self.app, "olp", None)
        if olp is not None and olp.backoff_new_conn():
            writer.close()          # overload shedding (emqx_olp)
            return
        if self.limiter is not None:
            ok, _retry = self.limiter.connect(self.listener_id)
            if not ok:
                writer.close()      # conn-rate limit: refuse at accept
                return
        conn = Connection(self, reader, writer)
        self.connections.add(conn)
        await conn.run()

    async def start(self) -> None:
        kw = {}
        if self.ssl_context is not None and self.ssl_handshake_timeout:
            # bound slow/stalled handshakes (esockd handshake_timeout;
            # without this asyncio's 60s default governs)
            kw["ssl_handshake_timeout"] = self.ssl_handshake_timeout
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port,
            ssl=self.ssl_context, **kw,
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._housekeeper = asyncio.create_task(self._housekeep_loop())
        if self.pipeline is not None:
            # the pipeline owns ONE flusher per loop, shared by every
            # listener on the same app (tcp + ws)
            self._flusher = self.pipeline.ensure_flusher()
        log.info("listening on %s:%d", self.host, self.port)

    async def _housekeep_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            before = loop.time()
            await asyncio.sleep(HOUSEKEEP_INTERVAL)
            # scheduling drift = our run-queue signal (emqx_olp)
            lag_ms = (loop.time() - before - HOUSEKEEP_INTERVAL) * 1000
            olp = getattr(self.app, "olp", None)
            if olp is not None:
                olp.note_lag(lag_ms)
            if self.app is not None:
                # off-loop: the tick may block (bridge reconnects, disk
                # queue flushes) and must never stall the accept loop
                await asyncio.to_thread(self.app.tick)
            congestion = getattr(self.app, "congestion", None)
            for conn in list(self.connections):
                conn.housekeep()
                if congestion is not None and not conn.closed:
                    transport = conn.writer.transport
                    congestion.check(
                        conn.channel.conninfo.peername,
                        transport.get_write_buffer_size())

    async def stop(self) -> None:
        if self._housekeeper:
            self._housekeeper.cancel()
        if self.pipeline is not None and self.pipeline.pending():
            # final drain; flush() serializes with any in-flight flusher
            # run, and the shared flusher task is NOT cancelled here —
            # other listeners on this app may still be serving
            await asyncio.to_thread(self.pipeline.flush)
        for conn in list(self.connections):
            await conn.close("server_shutdown")
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()


def main() -> None:  # pragma: no cover - CLI entry
    import argparse

    ap = argparse.ArgumentParser(description="emqx_tpu_torch broker")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=1883)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    asyncio.run(BrokerServer(host=args.host, port=args.port).serve_forever())


if __name__ == "__main__":  # pragma: no cover
    main()
