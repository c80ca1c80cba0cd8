"""Config-driven listener lifecycle — the ``emqx_listeners.erl`` start
surface: the ``listeners`` config map (name → conf) becomes running
tcp / ssl / ws / wss servers bound to one BrokerApp.

Mirrors ``emqx_listeners:start/0`` → ``start_listener/3``
(emqx_listeners.erl:189-238): tcp+ssl ride the stream listener
(BrokerServer), ws+wss the websocket listener (WsBrokerServer); ssl/wss
build an ``ssl.SSLContext`` from the listener's ``ssl_options`` (and the
app's PskStore when ``enable_psk``). ``quic`` is an explicitly gated
slot: the reference's quicer/msquic NIF has no stdlib counterpart, so a
quic listener config is accepted by the schema but start raises with the
descope reason rather than pretending to serve
(emqx_quic_connection.erl — SURVEY §2.4 native-deps table).
"""

from __future__ import annotations

import logging
from typing import Optional

from emqx_tpu_torch.broker.server import BrokerServer
from emqx_tpu_torch.broker.ws import WsBrokerServer

log = logging.getLogger("emqx_tpu_torch.listeners")


def parse_bind(bind: "str | int", default_port: int = 1883
               ) -> tuple[str, int]:
    """'0.0.0.0:1883' | ':1883' | '1883' | 1883 | '[::1]:1883'
    → (host, port)."""
    if isinstance(bind, int):
        return "0.0.0.0", bind
    s = str(bind).strip()
    host, sep, port = s.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]                 # bracketed IPv6 literal
    elif ":" in host:
        # '::1' with no port — rpartition split inside the address
        host, port = s.strip("[]"), ""
    elif not sep and not port.isdigit():
        host, port = port, ""             # bare hostname, default port
    try:
        return host or "0.0.0.0", int(port) if port else default_port
    except ValueError:
        raise ValueError(f"invalid listener bind {bind!r} "
                         "(expected host:port, :port, or port)") from None


def build_listener(app, name: str, conf: dict):
    """One listener conf → an (unstarted) server object."""
    ltype = conf.get("type", "tcp")
    host, port = parse_bind(conf.get("bind", "0.0.0.0:1883"))
    ssl_context = None
    extra_ssl: dict = {}
    if ltype in ("ssl", "wss"):
        from emqx_tpu_torch.broker import tls

        psk_store = None
        if conf.get("ssl_options", {}).get("enable_psk"):
            psk_store = getattr(app, "psk", None)
        ssl_context = tls.make_server_context(
            conf.get("ssl_options", {}), psk_store=psk_store)
        hs = conf.get("ssl_options", {}).get("handshake_timeout")
        if hs:
            extra_ssl = {"ssl_handshake_timeout": float(hs)}
        if (conf.get("ssl_options", {}).get("verify", "verify_none")
                != "verify_peer"
                and any(conf.get(k) not in ("disabled", None, "")
                        for k in ("peer_cert_as_username",
                                  "peer_cert_as_clientid"))):
            raise ValueError(
                f"listener {name!r}: peer_cert_as_username/clientid "
                "needs ssl_options.verify = verify_peer — without it "
                "the server never requests a client certificate and "
                "the cert identity would silently not apply")
    elif ltype == "quic":
        raise NotImplementedError(
            "quic listener: the reference rides the quicer/msquic C NIF; "
            "no msquic binding ships in this build — use tcp/ssl/ws/wss "
            "(config slot reserved, emqx_quic_connection.erl)")

    def _ident(key: str) -> Optional[str]:
        v = conf.get(key, "disabled")
        return None if v in ("disabled", None, "") else v

    kw = dict(
        app=app,
        host=host,
        port=port,
        max_connections=int(conf.get("max_connections", 1_000_000)),
        mountpoint=conf.get("mountpoint", ""),
        listener_id=f"{ltype}:{name}",
        ssl_context=ssl_context,
        **extra_ssl,
        peer_cert_as_username=_ident("peer_cert_as_username"),
        peer_cert_as_clientid=_ident("peer_cert_as_clientid"),
        limiter=getattr(app, "limiter", None),
    )
    if ltype in ("ws", "wss"):
        return WsBrokerServer(path=conf.get("websocket_path", "/mqtt"), **kw)
    if ltype == "native":
        # ws_bind opens the C++ RFC6455 listener next to the TCP one —
        # both feed the same epoll loop/fast path; the asyncio ws
        # listener (type = ws) remains the slow-plane oracle
        ws_bind = conf.get("ws_bind")
        ws_host = ws_port = None
        # NOT a truthiness test: the integer bind 0 (ephemeral port)
        # is a valid, enabled configuration
        if ws_bind is not None and ws_bind is not False and ws_bind != "":
            ws_host, ws_port = parse_bind(ws_bind, default_port=8083)
        return NativeListener(
            app=app, host=host, port=port,
            max_connections=kw["max_connections"],
            mountpoint=kw["mountpoint"],
            listener_id=kw["listener_id"],
            fast_path=bool(conf.get("fast_path", True)),
            device_lane=str(conf.get("device_lane", "auto")),
            ws_host=ws_host, ws_port=ws_port,
            ws_path=conf.get("websocket_path", "/mqtt"))
    return BrokerServer(**kw)


class NativeListener:
    """Async-supervisor adapter over the C++ epoll host
    (``broker/native_server.py``) so ``listeners { n1 { type = native } }``
    boots it like any other listener. Construction (which may compile
    the C++ library on first use) and teardown (thread join +
    host.destroy) run in a worker thread — blocking the event loop here
    would stall every other listener and the management API."""

    def __init__(self, app, host: str, port: int, max_connections: int,
                 mountpoint: str, listener_id: str,
                 fast_path: bool = True,
                 device_lane: str = "auto",
                 ws_host: "str | None" = None,
                 ws_port: "int | None" = None,
                 ws_path: str = "/mqtt") -> None:
        self._app = app
        self._bind = (host, port)
        self._kw = dict(max_connections=max_connections,
                        mountpoint=mountpoint, fast_path=fast_path,
                        device_lane=device_lane, ws_host=ws_host,
                        ws_port=ws_port, ws_path=ws_path)
        self.listener_id = listener_id
        self.host = host
        self.port = port
        self.ws_port = ws_port       # bound port known after start()
        self.max_connections = max_connections
        self.ssl_context = None
        self._srv = None
        self._server = None          # "running" flag for info()

    @property
    def connections(self):
        return self._srv.conns if self._srv is not None else {}

    def fast_stats(self) -> dict:
        return self._srv.fast_stats() if self._srv is not None else {}

    async def start(self) -> None:
        import asyncio

        def _boot():
            from emqx_tpu_torch.broker.native_server import NativeBrokerServer
            srv = NativeBrokerServer(
                app=self._app, host=self._bind[0], port=self._bind[1],
                **self._kw)
            srv.start()
            return srv

        self._srv = await asyncio.to_thread(_boot)
        self.port = self._srv.port
        self.ws_port = self._srv.ws_port
        self._server = self._srv

    async def stop(self) -> None:
        import asyncio

        srv, self._srv, self._server = self._srv, None, None
        if srv is not None:
            await asyncio.to_thread(srv.stop)


class Listeners:
    """Supervisor for the app's listener set (start/stop/restart by id)."""

    def __init__(self, app) -> None:
        self.app = app
        self.servers: dict[str, BrokerServer] = {}   # "type:name" → server

    async def start_all(self, listeners_conf: dict) -> list[str]:
        started = []
        try:
            for name, conf in (listeners_conf or {}).items():
                if not conf.get("enabled", True):
                    continue
                server = build_listener(self.app, name, conf)
                await server.start()
                self.servers[server.listener_id] = server
                started.append(server.listener_id)
                log.info("listener %s on %s:%d%s", server.listener_id,
                         server.host, server.port,
                         " (tls)" if server.ssl_context else "")
        except Exception:
            # all-or-nothing boot: a half-started listener set would keep
            # ports bound and make the retry fail with EADDRINUSE
            for lid in started:
                await self.stop(lid)
            raise
        return started

    async def stop(self, listener_id: str) -> bool:
        server = self.servers.pop(listener_id, None)
        if server is None:
            return False
        await server.stop()
        return True

    async def stop_all(self) -> None:
        for lid in list(self.servers):
            await self.stop(lid)

    def find(self, listener_id: str) -> Optional[BrokerServer]:
        return self.servers.get(listener_id)

    def info(self) -> list[dict]:
        return [
            {
                "id": lid,
                "type": lid.split(":", 1)[0],
                "bind": f"{s.host}:{s.port}",
                "running": s._server is not None,
                "current_connections": len(s.connections),
                "max_connections": s.max_connections,
            }
            for lid, s in self.servers.items()
        ]
