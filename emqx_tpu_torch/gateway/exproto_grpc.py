"""ExProto over real gRPC — the ``emqx.exproto.v1`` services of
``apps/emqx_gateway/src/exproto/protos/exproto.proto``:

- the broker STREAMS socket/message events to the external service's
  ``ConnectionHandler`` (client-streaming RPCs, emqx_exproto_gcli.erl);
- the external service drives the connection back through the
  broker-hosted ``ConnectionAdapter`` (7 unary RPCs,
  emqx_exproto_gsvr.erl): Send/Close/Authenticate/StartTimer/Publish/
  Subscribe/Unsubscribe, addressed by the ``conn`` ref.

Schemas ride the generic proto3 codec from exhook/pbwire.py. The
framed-transport gateway (gateway/exproto.py) remains the
dependency-free alternative; this module is selected with
``ExprotoGateway(conf={"transport": "grpc", ...})`` equivalents in
tests and direct construction.

``GrpcProtocolHandlerHost`` hosts a user protocol implementation as the
external service side — in production that's the user's own gRPC
server in any language; here it doubles as the test harness
(the exproto_echo_svr analogue).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Optional

from emqx_tpu_torch.exhook.pbwire import decode, encode
from emqx_tpu_torch.gateway.ctx import GatewayImpl, GwChannel, GwContext

# ---------------------------------------------------------------------------
# emqx.exproto.v1 schemas (exproto.proto field numbers)

ADDRESS = {1: ("host", "str"), 2: ("port", "u32")}
CERT_INFO = {1: ("cn", "str"), 2: ("dn", "str")}
CONN_INFO = {1: ("socktype", "enum"), 2: ("peername", "msg", ADDRESS),
             3: ("sockname", "msg", ADDRESS),
             4: ("peercert", "msg", CERT_INFO)}
CLIENT_INFO = {1: ("proto_name", "str"), 2: ("proto_ver", "str"),
               3: ("clientid", "str"), 4: ("username", "str"),
               5: ("mountpoint", "str")}
MESSAGE = {1: ("node", "str"), 2: ("id", "str"), 3: ("qos", "u32"),
           4: ("from", "str"), 5: ("topic", "str"),
           6: ("payload", "bytes"), 7: ("timestamp", "u64")}

CODE_RESPONSE = {1: ("code", "enum"), 2: ("message", "str")}
EMPTY_SUCCESS: dict = {}

# ConnectionAdapter (broker-hosted) request schemas
ADAPTER_RPCS = {
    "Send": {1: ("conn", "str"), 2: ("bytes", "bytes")},
    "Close": {1: ("conn", "str")},
    "Authenticate": {1: ("conn", "str"),
                     2: ("clientinfo", "msg", CLIENT_INFO),
                     3: ("password", "str")},
    "StartTimer": {1: ("conn", "str"), 2: ("type", "enum"),
                   3: ("interval", "u32")},
    "Publish": {1: ("conn", "str"), 2: ("topic", "str"), 3: ("qos", "u32"),
                4: ("payload", "bytes")},
    "Subscribe": {1: ("conn", "str"), 2: ("topic", "str"),
                  3: ("qos", "u32")},
    "Unsubscribe": {1: ("conn", "str"), 2: ("topic", "str")},
}

# ConnectionHandler (external service) event schemas — client-streaming
HANDLER_RPCS = {
    "OnSocketCreated": {1: ("conn", "str"),
                        2: ("conninfo", "msg", CONN_INFO)},
    "OnSocketClosed": {1: ("conn", "str"), 2: ("reason", "str")},
    "OnReceivedBytes": {1: ("conn", "str"), 2: ("bytes", "bytes")},
    "OnTimerTimeout": {1: ("conn", "str"), 2: ("type", "enum")},
    "OnReceivedMessages": {1: ("conn", "str"),
                           2: ("messages", ("rep", "msg"), MESSAGE)},
}

ADAPTER_SERVICE = "emqx.exproto.v1.ConnectionAdapter"
HANDLER_SERVICE = "emqx.exproto.v1.ConnectionHandler"

RC_SUCCESS, RC_UNKNOWN, RC_NOT_ALIVE, RC_PARAMS, RC_TYPE, RC_DENY = range(6)

_IDENT = lambda b: b      # noqa: E731


# ---------------------------------------------------------------------------
# broker → handler event streams


class HandlerClient:
    """Client-streaming event lanes to the external ConnectionHandler:
    one long-lived stream per RPC, queue-fed, transparently reopened on
    failure (emqx_exproto_gcli keeps per-RPC gRPC streams the same
    way)."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0) -> None:
        import grpc

        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self.timeout_s = timeout_s
        self._lanes: dict[str, queue.Queue] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _lane(self, rpc: str) -> queue.Queue:
        with self._lock:
            q = self._lanes.get(rpc)
            if q is None:
                q = queue.Queue()
                self._lanes[rpc] = q
                self._start_stream(rpc)
            return q

    def _start_stream(self, rpc: str) -> None:
        stub = self._channel.stream_unary(
            f"/{HANDLER_SERVICE}/{rpc}",
            request_serializer=_IDENT, response_deserializer=_IDENT)

        def feed(q: queue.Queue):
            while True:
                item = q.get()
                if item is None:
                    return
                yield item

        def run():
            while True:
                with self._lock:
                    if self._closed:
                        return
                    cur = self._lanes[rpc]
                try:
                    stub(feed(cur))        # completes when feed() ends
                    return                 # clean close()
                except Exception:          # noqa: BLE001 — stream died.
                    # grpcio's request-consumer thread may still be
                    # blocked inside feed(cur).q.get(): swap a FRESH
                    # queue in for new events, then poison the old one
                    # so the abandoned consumer exits instead of eating
                    # a future event. Events in the old queue are lost
                    # (fire-and-forget, like the reference's async gcli
                    # casts).
                    import time
                    with self._lock:
                        if self._closed:
                            return
                        self._lanes[rpc] = queue.Queue()
                    cur.put(None)
                    time.sleep(0.2)

        threading.Thread(target=run, daemon=True,
                         name=f"exproto-grpc-{rpc}").start()

    def emit(self, rpc: str, values: dict) -> None:
        self._lane(rpc).put(encode(HANDLER_RPCS[rpc], values))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for q in self._lanes.values():
                q.put(None)
        self._channel.close()


# ---------------------------------------------------------------------------
# handler → broker adapter service


class AdapterServer:
    """Broker-hosted ConnectionAdapter: routes unary calls by conn ref
    to live channels (emqx_exproto_gsvr.erl)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 4) -> None:
        from emqx_tpu_torch.exhook.grpc_transport import make_grpc_server

        self.channels: dict[str, "GrpcChannel"] = {}
        self._server, self.port = make_grpc_server(
            ADAPTER_SERVICE, ADAPTER_RPCS, self._dispatch,
            host=host, port=port, workers=workers)

    def _code(self, code: int, message: str = "") -> bytes:
        return encode(CODE_RESPONSE, {"code": code, "message": message})

    def _dispatch(self, rpc: str, req: bytes) -> bytes:
        try:
            request = decode(ADAPTER_RPCS[rpc], req)
        except ValueError as e:
            return self._code(RC_TYPE, str(e))
        ch = self.channels.get(request.get("conn", ""))
        if ch is None:
            return self._code(RC_NOT_ALIVE, "conn process not alive")
        try:
            return self._code(*ch.handle_adapter(rpc, request))
        except Exception as e:      # noqa: BLE001 — protocol reply
            return self._code(RC_UNKNOWN, str(e))

    def start(self) -> "AdapterServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=0.2)


# ---------------------------------------------------------------------------
# the channel


class GrpcChannel(GwChannel):
    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, ctx: GwContext, handler: HandlerClient,
                 adapter: AdapterServer) -> None:
        self.ctx = ctx
        self.handler = handler
        self.adapter = adapter
        with GrpcChannel._seq_lock:
            GrpcChannel._seq += 1
            self.conn_ref = f"grpc-conn-{GrpcChannel._seq}"
        self.conn_state = "connected"
        self.clientid: Optional[str] = None
        self.peername: Optional[tuple] = None   # bound by the transport
        adapter.channels[self.conn_ref] = self

    def on_socket_ready(self) -> None:
        """Transport bound (peername now real) — announce the socket."""
        peer = self.peername or ("0.0.0.0", 0)
        self.handler.emit("OnSocketCreated", {
            "conn": self.conn_ref,
            "conninfo": {"socktype": 0,
                         "peername": {"host": str(peer[0]),
                                      "port": int(peer[1])}}})

    # -- adapter ops (called from gRPC worker threads) -----------------------

    def handle_adapter(self, rpc: str, req: dict) -> tuple[int, str]:
        if rpc == "Send":
            self.send([req.get("bytes", b"")])
            return RC_SUCCESS, ""
        if rpc == "Close":
            self.conn_state = "disconnected"
            self.request_close()
            return RC_SUCCESS, ""
        if rpc == "Authenticate":
            ci = req.get("clientinfo") or {}
            cid = ci.get("clientid") or ""
            if not cid:
                return RC_PARAMS, "clientid required"
            if not self.ctx.authenticate(cid, ci.get("username") or None,
                                         req.get("password") or None):
                return RC_DENY, "authentication failed"
            self.clientid = cid
            self.ctx.open_session(cid, self)
            return RC_SUCCESS, ""
        if self.clientid is None:
            return RC_DENY, "not authenticated"
        if rpc == "Publish":
            self.ctx.publish(self.clientid, req.get("topic", ""),
                             req.get("payload", b""),
                             int(req.get("qos", 0)))
            return RC_SUCCESS, ""
        if rpc == "Subscribe":
            self.ctx.subscribe(self.clientid, req.get("topic", ""),
                               int(req.get("qos", 0)))
            return RC_SUCCESS, ""
        if rpc == "Unsubscribe":
            self.ctx.unsubscribe(self.clientid, req.get("topic", ""))
            return RC_SUCCESS, ""
        if rpc == "StartTimer":
            # KEEPALIVE timer: the conn loop owns idle timeouts; accept
            return RC_SUCCESS, ""
        return RC_TYPE, f"unsupported rpc {rpc}"

    # -- GwChannel -----------------------------------------------------------

    def handle_in(self, data: bytes) -> list:
        self.handler.emit("OnReceivedBytes",
                          {"conn": self.conn_ref, "bytes": data})
        return []          # replies arrive via adapter Send

    def handle_deliver(self, deliveries: list) -> list:
        self.handler.emit("OnReceivedMessages", {
            "conn": self.conn_ref,
            "messages": [{
                "id": str(msg.id), "qos": msg.qos, "from": str(msg.from_),
                "topic": self.ctx.unmount(msg.topic),
                "payload": msg.payload, "timestamp": msg.timestamp,
            } for _st, msg in deliveries]})
        return []

    def terminate(self, reason: str) -> None:
        if self.conn_state != "terminated":
            self.conn_state = "terminated"
            self.adapter.channels.pop(self.conn_ref, None)
            self.handler.emit("OnSocketClosed",
                              {"conn": self.conn_ref, "reason": reason})
            if self.clientid is not None:
                self.ctx.close_session(self.clientid, self, reason)
            self.request_close()      # admin kick drops the transport


class GrpcExprotoGateway(GatewayImpl):
    """The gRPC-transport exproto gateway: TCP listener + adapter
    server + handler event streams."""

    name = "exproto"

    def __init__(self, handler_host: str = "127.0.0.1",
                 handler_port: int = 9100, host: str = "127.0.0.1",
                 port: int = 7993, adapter_port: int = 0) -> None:
        self.handler_addr = (handler_host, handler_port)
        self.host, self.port = host, port
        self.adapter_port = adapter_port
        self.listener = None
        self.adapter: Optional[AdapterServer] = None
        self.handler: Optional[HandlerClient] = None
        self.ctx: Optional[GwContext] = None

    def on_gateway_load(self, ctx: GwContext, conf: dict) -> None:
        from emqx_tpu_torch.gateway.conn import TcpGwListener
        from emqx_tpu_torch.gateway.exproto import RawFrame

        self.ctx = ctx
        self.host = conf.get("host", self.host)
        self.port = conf.get("port", self.port)
        if "handler_host" in conf or "handler_port" in conf:
            self.handler_addr = (conf.get("handler_host", "127.0.0.1"),
                                 conf.get("handler_port", 9100))
        self.adapter = AdapterServer(
            port=int(conf.get("adapter_port", self.adapter_port))).start()
        self.handler = HandlerClient(*self.handler_addr)
        self.listener = TcpGwListener(
            lambda: GrpcChannel(self.ctx, self.handler, self.adapter),
            RawFrame(), host=self.host, port=self.port)

    async def start_listeners(self) -> None:
        await self.listener.start()
        self.port = self.listener.port

    async def stop_listeners(self) -> None:
        await self.listener.stop()
        if self.handler is not None:
            self.handler.close()
        if self.adapter is not None:
            self.adapter.stop()


# ---------------------------------------------------------------------------
# external-service side host (test harness / SDK)


class GrpcProtocolHandlerHost:
    """Host a protocol implementation as the emqx.exproto.v1
    ConnectionHandler service, with an adapter-client bound back to the
    broker (the role a user's gRPC service plays; in-repo analogue of
    the reference's exproto_echo_svr).

    impl contract (all optional):
      on_socket_created(conn, conninfo, adapter),
      on_received_bytes(conn, data, adapter),
      on_received_messages(conn, messages, adapter),
      on_socket_closed(conn, reason), on_timer_timeout(conn, type).
    ``adapter`` exposes send/close/authenticate/publish/subscribe/
    unsubscribe/start_timer — each returns (code, message).
    """

    def __init__(self, impl: Any, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 4) -> None:
        from emqx_tpu_torch.exhook.grpc_transport import make_grpc_server

        self.impl = impl
        self.adapter_client: Optional["AdapterClient"] = None
        self._server, self.port = make_grpc_server(
            HANDLER_SERVICE, HANDLER_RPCS, self._consume,
            streaming=True, host=host, port=port, workers=workers)

    def connect_adapter(self, host: str, port: int) -> None:
        self.adapter_client = AdapterClient(host, port)

    def _consume(self, rpc: str, it) -> bytes:
        for raw in it:
            event = decode(HANDLER_RPCS[rpc], raw)
            conn = event.get("conn", "")
            if rpc == "OnSocketCreated":
                fn = getattr(self.impl, "on_socket_created", None)
                if fn:
                    fn(conn, event.get("conninfo") or {},
                       self.adapter_client)
            elif rpc == "OnReceivedBytes":
                fn = getattr(self.impl, "on_received_bytes", None)
                if fn:
                    fn(conn, event.get("bytes", b""), self.adapter_client)
            elif rpc == "OnReceivedMessages":
                fn = getattr(self.impl, "on_received_messages", None)
                if fn:
                    fn(conn, event.get("messages", []),
                       self.adapter_client)
            elif rpc == "OnSocketClosed":
                fn = getattr(self.impl, "on_socket_closed", None)
                if fn:
                    fn(conn, event.get("reason", ""))
            elif rpc == "OnTimerTimeout":
                fn = getattr(self.impl, "on_timer_timeout", None)
                if fn:
                    fn(conn, event.get("type", 0))
        return b""                                 # EmptySuccess

    def start(self) -> "GrpcProtocolHandlerHost":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=0.2)


class AdapterClient:
    """The external service's view of the broker-hosted
    ConnectionAdapter (7 unary RPCs)."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0) -> None:
        import grpc

        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self.timeout_s = timeout_s
        self._stubs: dict[str, Any] = {}

    def _call(self, rpc: str, values: dict) -> tuple[int, str]:
        import grpc

        stub = self._stubs.get(rpc)
        if stub is None:
            stub = self._channel.unary_unary(
                f"/{ADAPTER_SERVICE}/{rpc}",
                request_serializer=_IDENT, response_deserializer=_IDENT)
            self._stubs[rpc] = stub
        try:
            resp = stub(encode(ADAPTER_RPCS[rpc], values),
                        timeout=self.timeout_s)
        except grpc.RpcError as e:
            raise ConnectionError(f"adapter {rpc}: {e.code().name}") \
                from None
        out = decode(CODE_RESPONSE, resp)
        return out.get("code", RC_UNKNOWN), out.get("message", "")

    def send(self, conn: str, data: bytes):
        return self._call("Send", {"conn": conn, "bytes": data})

    def close(self, conn: str):
        return self._call("Close", {"conn": conn})

    def authenticate(self, conn: str, clientid: str,
                     username: str = "", password: str = ""):
        return self._call("Authenticate", {
            "conn": conn, "password": password,
            "clientinfo": {"proto_name": "exproto", "proto_ver": "1",
                           "clientid": clientid, "username": username}})

    def start_timer(self, conn: str, interval: int):
        return self._call("StartTimer",
                          {"conn": conn, "type": 0, "interval": interval})

    def publish(self, conn: str, topic: str, payload: bytes, qos: int = 0):
        return self._call("Publish", {"conn": conn, "topic": topic,
                                      "qos": qos, "payload": payload})

    def subscribe(self, conn: str, topic: str, qos: int = 0):
        return self._call("Subscribe",
                          {"conn": conn, "topic": topic, "qos": qos})

    def unsubscribe(self, conn: str, topic: str):
        return self._call("Unsubscribe", {"conn": conn, "topic": topic})

    def close_channel(self) -> None:
        self._channel.close()
