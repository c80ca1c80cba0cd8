"""gRPC transport for exhook — the real ``HookProvider`` wire
(apps/emqx_exhook/src/emqx_exhook_server.erl over grpc-erl).

``GrpcConn`` implements the same ``call(rpc, args) -> result`` surface
as the framed transport's ``_Conn`` (exhook/server.py), so
``ExhookServer``/``ExhookMgr`` logic is transport-agnostic: requests
are encoded with the hand-written proto codec (exhook/pbwire.py) and
shipped over a grpcio channel as raw bytes (no codegen — grpcio's
generic unary stubs with identity serializers).

``GrpcHookProvider`` is the in-repo provider-side server — the
``emqx_exhook_demo_svr.erl`` analogue: a grpcio server exposing the
21-RPC ``emqx.exhook.v2.HookProvider`` service from a plain handler
object, decoding requests into dicts and encoding ValuedResponse /
LoadedResponse replies. Because both sides speak the real wire format,
a stock gRPC HookProvider (any language) can replace it directly.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Optional

from emqx_tpu_torch.exhook import pbwire


def grpc_available() -> bool:
    try:
        import grpc  # noqa: F401
        return True
    except ImportError:
        return False


_IDENT = lambda b: b      # noqa: E731 — bytes in/out (no codegen)


def make_grpc_server(service: str, rpc_names, dispatch, *,
                     streaming: bool = False, host: str = "127.0.0.1",
                     port: int = 0, workers: int = 4):
    """Generic bytes-in/bytes-out grpcio server for one service.

    ``dispatch(rpc, request)`` gets raw request bytes (or, with
    ``streaming=True``, the request iterator) and returns raw response
    bytes. Shared by the exhook provider host and both exproto sides —
    one place for the method-prefix/handler plumbing. Returns
    (server, bound_port)."""
    import concurrent.futures

    import grpc

    class _Svc(grpc.GenericRpcHandler):
        def service(self, details):
            prefix = f"/{service}/"
            if not details.method.startswith(prefix):
                return None
            rpc = details.method[len(prefix):]
            if rpc not in rpc_names:
                return None
            make = (grpc.stream_unary_rpc_method_handler if streaming
                    else grpc.unary_unary_rpc_method_handler)
            return make(
                lambda req, ctx, rpc=rpc: dispatch(rpc, req),
                request_deserializer=_IDENT,
                response_serializer=_IDENT)

    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(max_workers=workers))
    server.add_generic_rpc_handlers((_Svc(),))
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound


_conn_seq = itertools.count()


class GrpcConn:
    """One gRPC channel (= one HTTP/2 connection). ExhookServer opens
    pool_size of these round-robin — the reference's per-scheduler
    client pool (emqx_exhook_server.erl:135). The unique channel arg
    defeats grpc-core's global subchannel dedup, which would otherwise
    silently collapse N same-target channels onto one TCP connection."""

    def __init__(self, addr: tuple, timeout: float,
                 secure: bool = False) -> None:
        import grpc

        self.timeout = timeout
        target = f"{addr[0]}:{addr[1]}"
        opts = [("emqx_tpu_torch.pool_index", next(_conn_seq))]
        if secure:        # grpcs:// / https:// — system root CAs
            self._channel = grpc.secure_channel(
                target, grpc.ssl_channel_credentials(), options=opts)
        else:
            self._channel = grpc.insecure_channel(target, options=opts)
        self._stubs: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _stub(self, rpc: str):
        with self._lock:
            stub = self._stubs.get(rpc)
            if stub is None:
                stub = self._channel.unary_unary(
                    pbwire.method_path(rpc),
                    request_serializer=_IDENT,
                    response_deserializer=_IDENT)
                self._stubs[rpc] = stub
            return stub

    def call(self, rpc: str, args: dict) -> Any:
        import grpc

        if rpc == "OnMessagePublishBatch":
            # the batch lane is an extension RPC; stock providers
            # don't implement it — per-message calls preserve semantics
            results = []
            for m in args.get("messages", []):
                r = self.call("OnMessagePublish", {"message": m}) or {}
                v = (r.get("value") or {}
                     if r.get("type") == "STOP_AND_RETURN" else {})
                results.append(v)
            return {"results": results}
        req = pbwire.build_request(rpc, args)
        try:
            resp = self._stub(rpc)(req, timeout=self.timeout)
        except grpc.RpcError as e:
            raise ConnectionError(
                f"grpc {rpc}: {e.code().name}") from None
        try:
            return pbwire.parse_response(rpc, resp)
        except ValueError as e:
            # malformed reply bytes must surface as a PROVIDER failure
            # (failed_action applies) — a raw ValueError would escape
            # the hook handlers' (ConnectionError, OSError) guards and
            # crash the auth/publish path
            raise ConnectionError(f"grpc {rpc}: bad response: {e}") \
                from None

    def close(self) -> None:
        self._channel.close()


# ---------------------------------------------------------------------------
# provider-side server (test/demo backend + SDK for real providers)


class GrpcHookProvider:
    """Serve ``emqx.exhook.v2.HookProvider`` from a handler object.

    handler contract (all optional):
      - ``hooks``: list of hookpoint names to register (LoadedResponse)
      - ``on_client_authenticate(clientinfo) -> bool | None``
      - ``on_client_authorize(clientinfo, type, topic) -> bool | None``
      - ``on_message_publish(message) -> dict (rewritten) | False (drop)
        | None (continue)``
      - ``on_notify(rpc, request_dict)``: every other RPC
    None → CONTINUE (chain proceeds), a value → STOP_AND_RETURN.
    """

    def __init__(self, handler: Any, host: str = "127.0.0.1",
                 port: int = 0, workers: int = 4) -> None:
        self.handler = handler
        self.calls: list[str] = []           # observed RPC order (tests)
        self._server, self.port = make_grpc_server(
            pbwire.SERVICE, pbwire.REQUEST_SCHEMAS, self._dispatch,
            host=host, port=port, workers=workers)

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, rpc: str, req: bytes) -> bytes:
        self.calls.append(rpc)
        request = pbwire.decode(pbwire.REQUEST_SCHEMAS[rpc], req)
        if rpc == "OnProviderLoaded":
            hooks = list(getattr(self.handler, "hooks", []))
            return pbwire.encode(pbwire.LOADED_RESPONSE, {
                "hooks": [{"name": h} for h in hooks]})
        if rpc == "OnClientAuthenticate":
            fn = getattr(self.handler, "on_client_authenticate", None)
            verdict = fn(request.get("clientinfo") or {}) if fn else None
            return self._valued_bool(verdict)
        if rpc == "OnClientAuthorize":
            fn = getattr(self.handler, "on_client_authorize", None)
            verdict = fn(request.get("clientinfo") or {},
                         "publish" if request.get("type") == 0
                         else "subscribe",
                         request.get("topic", "")) if fn else None
            return self._valued_bool(verdict)
        if rpc == "OnMessagePublish":
            fn = getattr(self.handler, "on_message_publish", None)
            msg = request.get("message") or {}
            verdict = fn(msg) if fn else None
            if verdict is None:
                return pbwire.encode(pbwire.VALUED_RESPONSE, {"type": 0})
            if verdict is False:                 # drop
                dropped = {**msg,
                           "headers": {**(msg.get("headers") or {}),
                                       "allow_publish": "false"}}
                return pbwire.encode(pbwire.VALUED_RESPONSE, {
                    "type": 2, "message": dropped})
            return pbwire.encode(pbwire.VALUED_RESPONSE, {
                "type": 2, "message": verdict})
        fn = getattr(self.handler, "on_notify", None)
        if fn:
            fn(rpc, request)
        return b""                               # EmptySuccess

    @staticmethod
    def _valued_bool(verdict: Optional[bool]) -> bytes:
        if verdict is None:
            return pbwire.encode(pbwire.VALUED_RESPONSE, {"type": 0})
        return pbwire.encode(pbwire.VALUED_RESPONSE, {
            "type": 2, "bool_result": bool(verdict)})

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "GrpcHookProvider":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop(grace=0.2)
