"""ExProto gateway — parity with ``apps/emqx_gateway/src/exproto/``
(emqx_exproto_gsvr.erl / _gcli.erl): the *protocol itself* lives in an
external service. The gateway owns the socket and the broker seam; every
socket event is RPC'd to the external ConnectionHandler, which answers
with a command list.

Wire: the same length-prefixed codec frames as exhook (the reference
reuses its gRPC stack for both; we reuse ours — emqx_tpu_torch/exhook/proto.py).

Handler RPCs (mirror exproto.proto ConnectionHandler):
    OnSocketCreated{conn, peername}       → commands
    OnReceivedBytes{conn, bytes_hex}      → commands
    OnReceivedMessages{conn, messages}    → commands
    OnSocketClosed{conn}

Commands (the ConnectionAdapter surface the external service drives):
    {"type": "send",        "bytes_hex": ...}
    {"type": "authenticate","clientid": ..., "username":?, "password":?}
    {"type": "publish",     "topic": ..., "payload_hex": ..., "qos":?}
    {"type": "subscribe",   "topic": ..., "qos":?}
    {"type": "unsubscribe", "topic": ...}
    {"type": "close"}
"""

from __future__ import annotations

import queue
import socket
import socketserver
import threading
from typing import Any, Optional

from emqx_tpu_torch.exhook import proto as rpc
from emqx_tpu_torch.gateway.ctx import GatewayImpl, GwChannel, GwContext, GwFrame


class RawFrame(GwFrame):
    """Pass-through: the external handler does the parsing."""

    def parse(self, data: bytes, state) -> tuple[list, Any]:
        return [data], state

    def serialize(self, pkt: bytes) -> bytes:
        return pkt


class Channel(GwChannel):
    _seq = 0

    def __init__(self, ctx: GwContext, handler_addr: tuple[str, int],
                 timeout_s: float = 5.0) -> None:
        self.ctx = ctx
        self.handler_addr = handler_addr
        self.timeout_s = timeout_s
        Channel._seq += 1
        self.conn_ref = f"conn-{Channel._seq}"
        self.conn_state = "connected"
        self.clientid: Optional[str] = None
        self._sock: Optional[socket.socket] = None
        # handler RPCs are blocking network calls and must never run on
        # the broker's event loop — a per-channel worker serializes them
        # (per-connection ordering) and pushes replies via the
        # thread-safe ``send`` the conn adapter binds
        self._queue: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(
            target=self._drain, daemon=True,
            name=f"exproto-{self.conn_ref}")
        self._worker.start()
        self._enqueue("OnSocketCreated",
                      {"conn": self.conn_ref, "peername": "tcp"})

    # -- RPC to the external handler (worker thread only) --------------------

    def _enqueue(self, rpc_name: str, args: dict) -> None:
        self._queue.put((rpc_name, args))

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                break
            frames = self._call(*item)
            if frames:
                self.send(frames)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, rpc_name: str, args: dict) -> list:
        try:
            if self._sock is None:
                self._sock = socket.create_connection(
                    self.handler_addr, timeout=self.timeout_s)
            rpc.send_frame(self._sock, {"rpc": rpc_name, "args": args})
            resp = rpc.recv_frame(self._sock)
        except OSError:
            self._sock = None
            return self._exec([{"type": "close"}])
        if resp is None or resp.get("error"):
            return []
        return self._exec(resp.get("result") or [])

    def _exec(self, commands: list) -> list:
        """Run adapter commands; returns frames to send to the device."""
        out = []
        for cmd in commands:
            kind = cmd.get("type")
            if kind == "send":
                out.append(bytes.fromhex(cmd.get("bytes_hex", "")))
            elif kind == "authenticate":
                cid = cmd.get("clientid") or f"exproto-{self.conn_ref}"
                if self.ctx.authenticate(cid, cmd.get("username"),
                                         cmd.get("password")):
                    self.clientid = cid
                    self.ctx.open_session(cid, self)
            elif kind == "publish" and self.clientid:
                self.ctx.publish(
                    self.clientid, cmd["topic"],
                    bytes.fromhex(cmd.get("payload_hex", "")),
                    int(cmd.get("qos", 0)))
            elif kind == "subscribe" and self.clientid:
                self.ctx.subscribe(self.clientid, cmd["topic"],
                                   int(cmd.get("qos", 0)))
            elif kind == "unsubscribe" and self.clientid:
                self.ctx.unsubscribe(self.clientid, cmd["topic"])
            elif kind == "close":
                self.conn_state = "disconnected"
                # the conn loop only polls conn_state after inbound data;
                # we're on the worker thread, so drop the transport actively
                self.request_close()
        return out

    # -- GwChannel -----------------------------------------------------------

    def handle_in(self, data: bytes) -> list[bytes]:
        self._enqueue("OnReceivedBytes",
                      {"conn": self.conn_ref, "bytes_hex": data.hex()})
        return []      # replies arrive via send() once the worker answers

    def handle_deliver(self, deliveries: list) -> list[bytes]:
        msgs = [{
            "topic": self.ctx.unmount(msg.topic),
            "payload_hex": msg.payload.hex(),
            "qos": msg.qos,
        } for _st, msg in deliveries]
        self._enqueue("OnReceivedMessages",
                      {"conn": self.conn_ref, "messages": msgs})
        return []

    def terminate(self, reason: str) -> None:
        if self.conn_state != "terminated":
            self.conn_state = "terminated"
            self._enqueue("OnSocketClosed",
                          {"conn": self.conn_ref, "reason": reason})
            self._queue.put(None)     # worker closes the RPC socket
            if self.clientid is not None:
                self.ctx.close_session(self.clientid, self, reason)
            self.request_close()      # admin kick drops the transport


class ExprotoGateway(GatewayImpl):
    name = "exproto"

    def __init__(self, handler_host: str = "127.0.0.1",
                 handler_port: int = 9100,
                 host: str = "127.0.0.1", port: int = 7993) -> None:
        self.handler_addr = (handler_host, handler_port)
        self.host, self.port = host, port
        self.listener = None
        self.ctx: Optional[GwContext] = None

    def on_gateway_load(self, ctx: GwContext, conf: dict) -> None:
        from emqx_tpu_torch.gateway.conn import TcpGwListener

        self.ctx = ctx
        self.host = conf.get("host", self.host)
        self.port = conf.get("port", self.port)
        if "handler_host" in conf or "handler_port" in conf:
            self.handler_addr = (conf.get("handler_host", "127.0.0.1"),
                                 conf.get("handler_port", 9100))
        self.listener = TcpGwListener(
            lambda: Channel(self.ctx, self.handler_addr), RawFrame(),
            host=self.host, port=self.port)

    async def start_listeners(self) -> None:
        await self.listener.start()
        self.port = self.listener.port

    async def stop_listeners(self) -> None:
        await self.listener.stop()


class ConnectionHandler:
    """Base class for external protocol implementations (the role the
    user's gRPC service plays against the reference). Override the
    ``on_*`` methods; each returns a command list."""

    def dispatch(self, rpc_name: str, args: dict) -> list:
        fn = getattr(self, _snake(rpc_name), None)
        return fn(args) if fn is not None else []

    def on_socket_created(self, args: dict) -> list:
        return []

    def on_received_bytes(self, args: dict) -> list:
        return []

    def on_received_messages(self, args: dict) -> list:
        return []

    def on_socket_closed(self, args: dict) -> list:
        return []


def _snake(rpc_name: str) -> str:
    out = []
    for ch in rpc_name:
        if ch.isupper() and out:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class HandlerServer:
    """Threaded TCP host for a ConnectionHandler (the demo external
    service; production handlers are separate processes)."""

    def __init__(self, handler: ConnectionHandler,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        h = handler

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = rpc.recv_frame(self.request)
                    except OSError:
                        return
                    if req is None:
                        return
                    try:
                        result = h.dispatch(req.get("rpc", ""),
                                            req.get("args") or {})
                        resp = {"result": result}
                    except Exception as e:      # noqa: BLE001 — relay
                        resp = {"error": f"{type(e).__name__}: {e}"}
                    try:
                        rpc.send_frame(self.request, resp)
                    except OSError:
                        return

        class _S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _S((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="exproto-handler")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
