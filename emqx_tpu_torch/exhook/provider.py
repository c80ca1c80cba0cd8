"""Provider-side harness — what an external HookProvider service runs
(the reference's test fixture is an in-repo gRPC echo server,
``apps/emqx_exhook/test/emqx_exhook_demo_svr.erl``).

Subclass ``HookProvider``, override the RPCs you care about, and
``serve``. The default implementation answers ``OnProviderLoaded`` with
every overridden hookpoint and CONTINUEs everything else.
"""

from __future__ import annotations

import logging
import socketserver
import threading
from typing import Any, Optional

from emqx_tpu_torch.exhook import proto

log = logging.getLogger("emqx_tpu_torch.exhook.provider")


class HookProvider:
    """Override rpc methods named after the proto (``on_client_connect``,
    ``on_message_publish``, ...). Each receives the args dict and returns
    a response dict or None (→ CONTINUE)."""

    def hooks(self) -> list[str]:
        """Hookpoints to register — default: every overridden handler."""
        wanted = []
        for hookpoint, rpc in proto.HOOK_RPCS.items():
            meth = getattr(self, _snake(rpc), None)
            if meth is not None and not getattr(meth, "__isabstract__",
                                                False):
                base = getattr(HookProvider, _snake(rpc), None)
                if meth.__func__ is not base:
                    wanted.append(hookpoint)
        return wanted

    def dispatch(self, rpc: str, args: dict) -> Any:
        if rpc == "OnProviderLoaded":
            return {"hooks": self.hooks()}
        if rpc == "OnProviderUnloaded":
            return {}
        meth = getattr(self, _snake(rpc), None)
        if meth is None:
            return {"type": proto.CONTINUE}
        resp = meth(args)
        return resp if resp is not None else {"type": proto.CONTINUE}

    # default no-op handlers (subclasses override a subset)
    def on_client_connect(self, args):          # noqa: D102
        return None

    def on_client_connack(self, args):
        return None

    def on_client_connected(self, args):
        return None

    def on_client_disconnected(self, args):
        return None

    def on_client_authenticate(self, args):
        return None

    def on_client_authorize(self, args):
        return None

    def on_client_subscribe(self, args):
        return None

    def on_client_unsubscribe(self, args):
        return None

    def on_session_created(self, args):
        return None

    def on_session_subscribed(self, args):
        return None

    def on_session_unsubscribed(self, args):
        return None

    def on_session_resumed(self, args):
        return None

    def on_session_discarded(self, args):
        return None

    def on_session_takenover(self, args):
        return None

    def on_session_terminated(self, args):
        return None

    def on_message_publish(self, args):
        return None

    def on_message_publish_batch(self, args):
        """Default batch = per-message on_message_publish fan-in."""
        results = []
        for m in args.get("messages", []):
            resp = self.on_message_publish({"message": m}) or {}
            val = resp.get("value") or {}
            results.append({"drop": bool(val.get("drop")),
                            "message": val.get("message")})
        return {"results": results}

    def on_message_delivered(self, args):
        return None

    def on_message_acked(self, args):
        return None

    def on_message_dropped(self, args):
        return None


def _snake(rpc: str) -> str:
    out = []
    for ch in rpc:
        if ch.isupper() and out:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


class ProviderServer:
    """TCP server hosting a HookProvider."""

    def __init__(self, provider: HookProvider, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.provider = provider
        prov = provider

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = proto.recv_frame(self.request)
                    except OSError:
                        return
                    if req is None:
                        return
                    try:
                        result = prov.dispatch(req.get("rpc", ""),
                                               req.get("args") or {})
                        resp = {"result": result}
                    except Exception as e:   # noqa: BLE001 — relay
                        log.exception("provider rpc failed")
                        resp = {"error": f"{type(e).__name__}: {e}"}
                    try:
                        proto.send_frame(self.request, resp)
                    except OSError:
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="exhook-provider")
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
