"""Broker-side exhook — parity with
``apps/emqx_exhook/src/emqx_exhook_server.erl`` (+ ``_mgr``/`_handler``).

``ExhookServer`` holds a small connection pool to one external provider
(pool_size connections, emqx_exhook_server.erl:135), calls
``OnProviderLoaded`` to learn which hookpoints the provider wants, and
bridges those hookpoints to RPCs. Per-call timeout with ``failed_action``
deny|ignore semantics (:95-96,433): on timeout/error, ``deny`` stops the
chain (drops the message / denies auth), ``ignore`` continues.

``ExhookMgr`` manages several named providers and owns the hook
registrations (emqx_exhook_handler.erl:228-236 bridges each hookpoint).
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Optional

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.cluster import codec
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.exhook import proto
from emqx_tpu_torch.mqtt import packet as P

log = logging.getLogger("emqx_tpu_torch.exhook")


class _Conn:
    def __init__(self, addr: tuple[str, int], timeout: float) -> None:
        self.addr = addr
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self.lock = threading.Lock()

    def _ensure(self) -> socket.socket:
        if self.sock is None:
            self.sock = socket.create_connection(self.addr,
                                                 timeout=self.timeout)
        return self.sock

    def call(self, rpc: str, args: dict) -> Any:
        with self.lock:
            try:
                sock = self._ensure()
                proto.send_frame(sock, {"rpc": rpc, "args": args})
                resp = proto.recv_frame(sock)
            except (OSError, socket.timeout):
                self.close()
                raise
            except ValueError as e:      # malformed frame = provider
                self.close()             # failure, not a broker crash
                raise ConnectionError(f"bad provider frame: {e}") \
                    from None
            if resp is None:
                self.close()
                raise ConnectionError("provider closed connection")
            if resp.get("error"):
                raise ConnectionError(resp["error"])
            return resp.get("result")

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None


class ExhookServer:
    """transport="framed" speaks the length-prefixed JSON protocol
    (exhook/proto.py); transport="grpc" speaks the reference's real
    gRPC HookProvider service (exhook/grpc_transport.py) so stock
    providers connect with no adapter."""

    def __init__(self, name: str, host: str, port: int,
                 pool_size: int = 4, timeout_s: float = 5.0,
                 failed_action: str = "deny",
                 transport: str = "framed") -> None:
        self.name = name
        self.failed_action = failed_action
        self.transport = transport
        if transport in ("grpc", "grpcs"):
            from emqx_tpu_torch.exhook.grpc_transport import (GrpcConn,
                                                        grpc_available)
            if not grpc_available():
                raise ValueError(
                    f"exhook {name}: url scheme {transport}:// needs "
                    "grpcio, which is not importable in this "
                    "environment — use the framed:// transport")
            # HTTP/2 multiplexes, but a single channel serializes onto
            # one TCP connection; honor pool_size with N round-robin
            # channels for parity with the framed transport (the
            # reference's gRPC client pool, emqx_exhook_server.erl:135)
            self._pool = [GrpcConn((host, port), timeout_s,
                                   secure=(transport == "grpcs"))
                          for _ in range(max(1, pool_size))]
        elif transport == "framed":
            self._pool = [_Conn((host, port), timeout_s)
                          for _ in range(max(1, pool_size))]
        else:
            raise ValueError(
                f"exhook {name}: unknown transport {transport!r} "
                "(grpc | grpcs | framed)")
        self._rr = 0
        self.hooks_wanted: list[str] = []
        self.loaded = False

    def load(self, broker_info: Optional[dict] = None) -> list[str]:
        resp = self.call("OnProviderLoaded",
                         {"broker": broker_info or {}})
        self.hooks_wanted = list((resp or {}).get("hooks", []))
        self.loaded = True
        return self.hooks_wanted

    def unload(self) -> None:
        try:
            self.call("OnProviderUnloaded", {})
        except ConnectionError:
            pass
        for c in self._pool:
            c.close()
        self.loaded = False

    def call(self, rpc: str, args: dict) -> Any:
        self._rr = (self._rr + 1) % len(self._pool)
        return self._pool[self._rr].call(rpc, args)


class ExhookMgr:
    """Hook-side bridge for N providers (emqx_exhook_mgr)."""

    def __init__(self, metrics=None) -> None:
        self.servers: dict[str, ExhookServer] = {}
        self.metrics = metrics
        self._hooks: Optional[Hooks] = None
        # fired when the provider set (or a provider's wanted hooks)
        # changes — the native host flushes its publish permits so a
        # provider watching message.* sees already-fast topics at once
        self.on_topology_change: list = []

    def _notify(self) -> None:
        for cb in self.on_topology_change:
            cb()

    def attach(self, hooks: Hooks) -> None:
        self._hooks = hooks
        # exhook outranks the built-in security chain: HP_EXHOOK sits
        # above authn/authz in the reference, so providers decide first
        # and CONTINUE falls through to the local chain
        hooks.add("client.authenticate", self._on_authenticate,
                  priority=1100)
        hooks.add("client.authorize", self._on_authorize, priority=1100)
        hooks.add("message.publish", self._on_message_publish,
                  priority=1100)
        for hookpoint in proto.HOOK_RPCS:
            if hookpoint in ("client.authenticate", "client.authorize",
                             "message.publish"):
                continue
            hooks.add(hookpoint, self._make_notify(hookpoint),
                      priority=900)

    def enable(self, server: ExhookServer) -> list[str]:
        wanted = server.load()
        self.servers[server.name] = server
        self._notify()
        return wanted

    def enable_async(self, server: ExhookServer,
                     retry_interval_s: Optional[float] = 5.0) -> bool:
        """Register the provider and try to load it; on failure keep it
        registered unloaded and let tick() retry — the reference's
        auto_reconnect (emqx_exhook_mgr). ``retry_interval_s=None`` =
        auto_reconnect disabled: one attempt, never retried. Returns
        whether the first load succeeded. Until loaded, the provider's
        hooks are not consulted (same fail-open window as the
        reference's waiting-for-reconnect state)."""
        self.servers[server.name] = server
        server.retry_interval_s = retry_interval_s
        server.next_retry_at = 0.0
        # boot must not stall timeout_s per blackholed provider: cap the
        # FIRST attempt at 2s; retries use the configured timeout
        saved = [c.timeout for c in server._pool]
        for c in server._pool:
            c.timeout = min(c.timeout, 2.0)
        try:
            server.load()
            self._notify()     # hooks_wanted now known — flush permits
            return True
        except (ConnectionError, OSError, ValueError) as e:
            import time as _t
            if retry_interval_s is None:
                server.next_retry_at = float("inf")
                log.warning("exhook provider %s unreachable (%s); "
                            "auto_reconnect disabled", server.name, e)
            else:
                server.next_retry_at = _t.monotonic() + retry_interval_s
                log.warning("exhook provider %s unreachable (%s); will "
                            "retry every %.0fs", server.name, e,
                            retry_interval_s)
            return False
        finally:
            for c, t in zip(server._pool, saved):
                c.timeout = t

    def tick(self) -> None:
        """Housekeeping: retry unloaded providers (auto_reconnect)."""
        import time as _t
        now = _t.monotonic()
        for server in self.servers.values():
            if server.loaded or now < getattr(server, "next_retry_at",
                                              float("inf")):
                continue
            try:
                server.load()
                log.info("exhook provider %s reconnected (hooks: %s)",
                         server.name, server.hooks_wanted)
                self._notify()     # hooks_wanted may have changed
            except (ConnectionError, OSError, ValueError):
                # ValueError included: a garbage LoadedResponse must not
                # escape app.tick and kill broker housekeeping
                server.next_retry_at = now + (getattr(
                    server, "retry_interval_s", None) or 5.0)

    def disable(self, name: str) -> bool:
        server = self.servers.pop(name, None)
        if server is None:
            return False
        server.unload()
        self._notify()
        return True

    def _servers_for(self, hookpoint: str) -> list[ExhookServer]:
        return [s for s in self.servers.values()
                if s.loaded and hookpoint in s.hooks_wanted]

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(f"exhook.{name}")

    # -- fold hooks (may deny / rewrite) ------------------------------------

    def _on_authenticate(self, cred: dict, acc: dict):
        for server in self._servers_for("client.authenticate"):
            try:
                resp = server.call("OnClientAuthenticate",
                                   {"clientinfo": _public_cred(cred)})
                self._inc("authenticate")
            except (ConnectionError, OSError):
                self._inc("failed")
                if server.failed_action == "deny":
                    return (Hooks.STOP,
                            {"result": "error", "reason": "exhook_down",
                             "rc": P.RC_NOT_AUTHORIZED})
                continue
            rtype = (resp or {}).get("type", proto.IGNORE)
            if rtype == proto.STOP_AND_RETURN:
                ok = bool((resp.get("value") or {}).get("result"))
                if ok:
                    return (Hooks.OK, {"result": "ok"})
                return (Hooks.STOP,
                        {"result": "error", "reason": "exhook_denied",
                         "rc": P.RC_NOT_AUTHORIZED})
        return None

    def _on_authorize(self, ci: dict, action: str, topic: str, acc: str):
        for server in self._servers_for("client.authorize"):
            try:
                resp = server.call("OnClientAuthorize", {
                    "clientinfo": _public_cred(ci),
                    "type": action, "topic": topic})
                self._inc("authorize")
            except (ConnectionError, OSError):
                self._inc("failed")
                if server.failed_action == "deny":
                    return (Hooks.STOP, "deny")
                continue
            rtype = (resp or {}).get("type", proto.IGNORE)
            if rtype == proto.STOP_AND_RETURN:
                ok = bool((resp.get("value") or {}).get("result"))
                return (Hooks.STOP, "allow" if ok else "deny")
        return None

    def _on_message_publish(self, msg: Message, *rest):
        if msg.topic.startswith("$SYS/"):
            return None
        cur = msg
        for server in self._servers_for("message.publish"):
            try:
                resp = server.call("OnMessagePublish",
                                   {"message": codec.msg_to_dict(cur)})
                self._inc("message_publish")
            except (ConnectionError, OSError):
                self._inc("failed")
                if server.failed_action == "deny":
                    return cur.set_header("allow_publish", False)
                continue
            rtype = (resp or {}).get("type", proto.IGNORE)
            if rtype == proto.STOP_AND_RETURN:
                val = resp.get("value") or {}
                if val.get("drop"):
                    return cur.set_header("allow_publish", False)
                if val.get("message"):
                    new = codec.msg_from_dict(val["message"])
                    # identity + qos are broker-owned; providers rewrite
                    # topic/payload/headers (exhook ValuedResponse scope)
                    cur = Message(
                        topic=new.topic, payload=new.payload, qos=cur.qos,
                        from_=cur.from_, id=cur.id,
                        flags=cur.flags,
                        headers={**cur.headers, **new.headers},
                        timestamp=cur.timestamp)
        return cur if cur is not msg else None

    # -- batch publish (the batched sidecar seam) ---------------------------

    def on_message_publish_batch(
            self, msgs: list[Message]) -> list[Optional[Message]]:
        """Batched OnMessagePublish — the exhook-gRPC-style sidecar lane
        the north star prescribes (SURVEY.md §3.5): one RPC carries the
        whole publish batch; verdicts apply per message. Falls back to
        passing messages through on provider failure with
        failed_action=ignore, drops the batch with deny."""
        out: list[Optional[Message]] = list(msgs)
        for server in self._servers_for("message.publish"):
            live = [(i, m) for i, m in enumerate(out) if m is not None]
            if not live:
                break
            try:
                resp = server.call("OnMessagePublishBatch", {
                    "messages": [codec.msg_to_dict(m) for _, m in live]})
                self._inc("message_publish_batch")
            except (ConnectionError, OSError):
                self._inc("failed")
                if server.failed_action == "deny":
                    return [None] * len(msgs)
                continue
            verdicts = (resp or {}).get("results", [])
            for (i, m), v in zip(live, verdicts):
                if v.get("drop"):
                    out[i] = None
                elif v.get("message"):
                    new = codec.msg_from_dict(v["message"])
                    out[i] = Message(
                        topic=new.topic, payload=new.payload, qos=m.qos,
                        from_=m.from_, id=m.id, flags=m.flags,
                        headers={**m.headers, **new.headers},
                        timestamp=m.timestamp)
        return out

    # -- notify-only hooks --------------------------------------------------

    def _make_notify(self, hookpoint: str):
        rpc = proto.HOOK_RPCS[hookpoint]

        def cb(*args):
            for server in self._servers_for(hookpoint):
                try:
                    server.call(rpc, _notify_args(hookpoint, args))
                    self._inc(hookpoint.replace(".", "_"))
                except (ConnectionError, OSError):
                    self._inc("failed")
            return None
        return cb


def _public_cred(cred: dict) -> dict:
    out = dict(cred)
    pw = out.get("password")
    if isinstance(pw, bytes):
        out["password"] = pw.decode(errors="replace")
    return out


def _notify_args(hookpoint: str, args: tuple) -> dict:
    def plain(x):
        if isinstance(x, Message):
            return codec.msg_to_dict(x)
        if hasattr(x, "__dict__"):
            return {k: v for k, v in x.__dict__.items()
                    if isinstance(v, (str, int, float, bool, type(None)))}
        if isinstance(x, (str, int, float, bool, type(None), dict, list)):
            return x
        return str(x)

    return {"args": [plain(a) for a in args]}
