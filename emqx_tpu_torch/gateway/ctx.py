"""Gateway behaviours + context + manager — parity with
``apps/emqx_gateway/src/bhvrs/`` (emqx_gateway_frame / _channel / _impl,
apps/emqx_gateway/src/bhvrs/emqx_gateway_channel.erl:29-105) and
``emqx_gateway_ctx.erl`` (the broker-facing API handed to channels).

A gateway = Impl (lifecycle + listeners) + Frame (codec) + Channel
(per-client FSM). Channels never touch the broker directly: everything
goes through the GwContext, which applies the gateway's mountpoint and
registers the channel with the core CM so broker dispatch reaches it
(``ch.send(ch.handle_deliver(items))`` duck-type, broker/cm.py).
"""

from __future__ import annotations

from typing import Any, Optional

from emqx_tpu_torch.core.message import Message, SubOpts


class GwFrame:
    """Frame codec behaviour (emqx_gateway_frame.erl)."""

    def initial_parse_state(self, opts: Optional[dict] = None) -> Any:
        return b""

    def parse(self, data: bytes, state: Any) -> tuple[list, Any]:
        raise NotImplementedError

    def serialize(self, pkt: Any) -> bytes:
        raise NotImplementedError


class GwChannel:
    """Per-client protocol FSM behaviour (emqx_gateway_channel.erl).

    Ducks the core Channel surface the CM dispatch path expects.
    """

    conn_state = "idle"
    clientid: Optional[str] = None

    def handle_in(self, frame: Any) -> list:
        raise NotImplementedError

    def handle_deliver(self, deliveries: list) -> list:
        raise NotImplementedError

    def handle_timeout(self, kind: str) -> list:
        return []

    def terminate(self, reason: str) -> None:
        pass

    def send(self, frames: list) -> None:
        """Bound to the transport by the conn adapter."""

    def request_close(self) -> None:
        """Ask the transport to drop this connection; bound by the conn
        adapter, thread-safe. Needed by channels whose disconnect
        decision lands on a worker thread (exproto) — the run loop only
        polls conn_state after inbound frames."""

    # CM duck-type (takeover/discard on clientid clash)
    def takeover(self):
        return None, []

    def discard(self) -> None:
        self.terminate("discarded")


class GatewayImpl:
    """Gateway lifecycle behaviour (emqx_gateway_impl.erl)."""

    name = "?"

    def on_gateway_load(self, ctx: "GwContext", conf: dict) -> None:
        raise NotImplementedError

    async def start_listeners(self) -> None:
        raise NotImplementedError

    async def stop_listeners(self) -> None:
        pass

    def on_gateway_unload(self) -> None:
        pass


class GwContext:
    """emqx_gateway_ctx: the only broker surface a channel sees."""

    def __init__(self, app, gwname: str, mountpoint: str = "") -> None:
        self.app = app
        self.gwname = gwname
        self.mountpoint = mountpoint
        # live sessions of THIS gateway (clientid → connected_at ms) —
        # backs the per-gateway clients REST surface (emqx_gateway_api)
        self.sessions: dict[str, int] = {}

    # -- topic namespace -----------------------------------------------------

    def mount(self, topic: str) -> str:
        return self.mountpoint + topic if self.mountpoint else topic

    def unmount(self, topic: str) -> str:
        if self.mountpoint and topic.startswith(self.mountpoint):
            return topic[len(self.mountpoint):]
        return topic

    # -- client lifecycle ----------------------------------------------------

    def open_session(self, clientid: str, channel) -> None:
        """Register with the core CM (clientid clash kicks the old one,
        the gateway default — emqx_gateway_cm discard semantics)."""
        old = self.app.cm.lookup_channel(clientid)
        if old is not None and old is not channel:
            old.discard()
        self.app.cm.register_channel(clientid, channel)
        import time as _t
        self.sessions[clientid] = int(_t.time() * 1000)
        self.app.hooks.run("client.connected",
                           ({"clientid": clientid, "gateway": self.gwname},))

    def close_session(self, clientid: str, channel=None,
                      reason: str = "closed") -> None:
        self.app.broker.subscriber_down(clientid)
        self.app.cm.unregister_channel(clientid, channel)
        self.sessions.pop(clientid, None)
        self.app.hooks.run(
            "client.disconnected",
            ({"clientid": clientid, "gateway": self.gwname}, reason))

    def authenticate(self, clientid: str, username=None,
                     password=None) -> bool:
        try:
            # banned first — the reference gateway channels carry a
            # literal "TODO: How to implement the banned in the gateway
            # instance?" (emqx_stomp_channel.erl:427); enforcing the
            # shared table here closes that gap for every gateway
            banned = getattr(self.app.access, "banned", None)
            if banned is not None and banned.check(
                    {"clientid": clientid, "username": username}):
                return False
            res = self.app.hooks.run_fold(
                "client.authenticate",
                ({"clientid": clientid, "username": username,
                  "password": password, "peername": "gw"},),
                {"result": "ok"},
            )
        except Exception:
            return False      # fail closed, like the core channel
        # authenticators answer 'ok' / 'error' (access/control.py) —
        # anything but 'ok' is a denial (broker/channel.py does the same)
        return (res or {}).get("result", "ok") == "ok"

    # -- pub/sub -------------------------------------------------------------

    def authorize(self, clientid: str, action: str, topic: str) -> bool:
        """client.authorize fold, same contract as the MQTT channel
        (broker/channel.py:281) — gateway clients go through the very
        same ACL chain."""
        verdict = self.app.hooks.run_fold(
            "client.authorize",
            ({"clientid": clientid, "username": None,
              "peername": f"gw:{self.gwname}"}, action, topic),
            "allow",
        )
        return verdict == "allow"

    def publish(self, clientid: str, topic: str, payload: bytes,
                qos: int = 0, retain: bool = False,
                props: Optional[dict] = None) -> bool:
        mounted = self.mount(topic)
        if not self.authorize(clientid, "publish", mounted):
            self.metrics_inc("messages.dropped.authz")
            return False
        msg = Message(
            topic=mounted, payload=payload, qos=qos,
            from_=clientid, flags={"retain": retain} if retain else {},
            headers={"properties": props or {}, "gateway": self.gwname},
        )
        self.app.cm.dispatch(self.app.broker.publish(msg))
        return True

    def subscribe(self, clientid: str, topic: str, qos: int = 0) -> bool:
        mounted = self.mount(topic)
        if not self.authorize(clientid, "subscribe", mounted):
            return False
        self.app.broker.subscribe(clientid, mounted, SubOpts(qos=qos))
        return True

    def unsubscribe(self, clientid: str, topic: str) -> bool:
        return self.app.broker.unsubscribe(clientid, self.mount(topic))

    def metrics_inc(self, key: str) -> None:
        self.app.metrics.inc(f"gateway.{self.gwname}.{key}")


class GatewayManager:
    """Load/unload gateway instances (emqx_gateway.erl registry)."""

    def __init__(self, app) -> None:
        self.app = app
        self.gateways: dict[str, GatewayImpl] = {}
        self.contexts: dict[str, GwContext] = {}
        self._unload_tasks: set = set()   # keep refs: loop holds weak refs

    def load(self, impl: GatewayImpl, conf: Optional[dict] = None
             ) -> GatewayImpl:
        conf = conf or {}
        if impl.name in self.gateways:
            raise ValueError(f"gateway {impl.name} already loaded")
        ctx = GwContext(self.app, impl.name,
                        mountpoint=conf.get("mountpoint", ""))
        impl.on_gateway_load(ctx, conf)
        self.gateways[impl.name] = impl
        self.contexts[impl.name] = ctx
        return impl

    def unload(self, name: str) -> bool:
        impl = self.gateways.get(name)
        if impl is None:
            return False
        # an unloaded gateway must stop accepting traffic: tear down its
        # listeners first, then run the impl's unload hook (scheduled if
        # we're on a running loop, inline otherwise)
        import asyncio

        async def teardown() -> None:
            await impl.stop_listeners()
            impl.on_gateway_unload()

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            ctx = self.contexts.get(name)
            self.gateways.pop(name, None)
            self.contexts.pop(name, None)

            async def guarded() -> None:
                try:
                    await teardown()
                except Exception:
                    # a failed teardown must not leave a LIVE listener
                    # invisible to (and un-unloadable by) the API —
                    # re-register so the operator can retry
                    import logging
                    reg_as = name
                    if name in self.gateways:
                        # a NEW gateway was loaded under this name while
                        # teardown ran — never clobber it; park the
                        # half-torn-down instance under an alias so its
                        # possibly-still-bound listeners stay VISIBLE
                        # and unloadable (retry via the alias)
                        reg_as = f"{name}~failed-{id(impl) & 0xFFFF:x}"
                    logging.getLogger("emqx_tpu_torch.gateway").exception(
                        "gateway %s teardown failed; re-registered "
                        "as %s", name, reg_as)
                    self.gateways[reg_as] = impl
                    if ctx is not None:
                        self.contexts[reg_as] = ctx

            task = loop.create_task(guarded())
            self._unload_tasks.add(task)
            task.add_done_callback(self._unload_tasks.discard)
            return True
        # off-loop caller (REST handler thread): the listener's sockets
        # belong to ITS loop — teardown must run there, not in a fresh
        # asyncio.run() loop (cross-loop await fails). Deregister only
        # AFTER teardown succeeds: a timeout must not leave a live
        # listener invisible to (and un-unloadable by) the API.
        target = getattr(getattr(impl, "listener", None), "_loop", None)
        if target is not None and target.is_running():
            asyncio.run_coroutine_threadsafe(
                teardown(), target).result(timeout=10)
        else:
            asyncio.run(teardown())
        self.gateways.pop(name, None)
        self.contexts.pop(name, None)
        return True

    def get(self, name: str) -> Optional[GatewayImpl]:
        return self.gateways.get(name)

    def list(self) -> list[dict]:
        out = []
        # snapshot: called from the REST handler THREAD while the event
        # loop mutates the registries
        for n, impl in list(self.gateways.items()):
            ctx = self.contexts.get(n)
            out.append({
                "name": n, "status": "running",
                "port": getattr(impl, "port", None),
                "mountpoint": getattr(ctx, "mountpoint", ""),
                "current_connections": len(ctx.sessions) if ctx else 0,
            })
        return out

    def clients(self, name: str) -> Optional[list[dict]]:
        """Per-gateway connected clients (emqx_gateway_api_clients)."""
        ctx = self.contexts.get(name)
        if ctx is None:
            return None
        snapshot = dict(ctx.sessions)       # REST thread vs event loop
        return [{"clientid": cid, "connected_at": at,
                 "gateway": name}
                for cid, at in sorted(snapshot.items())]
