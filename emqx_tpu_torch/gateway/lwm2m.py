"""LwM2M gateway — parity with ``apps/emqx_gateway/src/lwm2m/``
(emqx_lwm2m_channel.erl registration interface + the mqtt-topic
up/down link convention), riding the CoAP codec from coap.py.

Registration interface (OMA LwM2M 1.0 §8.2, CoAP bootstrap):

    POST /rd?ep={name}&lt={s}&lwm2m={ver}   → 2.01 + Location /rd/{id}
    POST /rd/{id}  (update)                 → 2.04
    DELETE /rd/{id}                         → 2.02

Uplink events publish to ``lwm2m/{ep}/up/{event}`` (register, update,
notify); downlink commands are MQTT messages on ``lwm2m/{ep}/dn/#``
delivered to the device as CoAP POSTs carrying the payload.
"""

from __future__ import annotations

import json
from typing import Optional

from emqx_tpu_torch.gateway import lwm2m_objects as objects
from emqx_tpu_torch.gateway import lwm2m_tlv as tlv
from emqx_tpu_torch.gateway.coap import (
    ACK, BAD_REQUEST, CHANGED, CREATED, DELETE, DELETED, Frame, GET,
    NON, NOT_FOUND, OPT_CONTENT_FORMAT, OPT_LOCATION_PATH, POST, PUT,
    CoapMessage,
)
from emqx_tpu_torch.gateway.ctx import GatewayImpl, GwChannel, GwContext

UPLINK = "lwm2m/{ep}/up/{event}"
DOWNLINK = "lwm2m/{ep}/dn/#"


class Channel(GwChannel):
    def __init__(self, ctx: GwContext) -> None:
        from emqx_tpu_torch.gateway.coap import TransportManager

        self.ctx = ctx
        self.conn_state = "connected"
        self.clientid: Optional[str] = None
        self.endpoint: Optional[str] = None
        self.reg_id: Optional[str] = None
        self.lifetime = 86400
        self.objects: list[dict] = []      # registry-resolved reg links
        self._mid = 0
        # same message-layer machine as the coap gateway: registration
        # CON retransmits must not re-execute (duplicate register
        # uplinks), and downlink CON POSTs retransmit until ACKed
        self.tm = TransportManager()
        # mid → {reqID, msgType, path} so device responses / timeouts
        # correlate back to the command they answer
        self._cmd_ctx: dict[int, dict] = {}
        # paths this server observed (downlink observe commands) — used
        # to type TLV notify bodies when the device omits ?path=
        self._observed: set[str] = set()

    def _next_mid(self) -> int:
        self._mid = self._mid % 0xFFFF + 1
        return self._mid

    def _uplink(self, event: str, data: dict) -> None:
        self.ctx.publish(
            self.clientid,
            UPLINK.format(ep=self.endpoint, event=event),
            json.dumps(data).encode(), qos=0)

    # -- inbound -------------------------------------------------------------

    def handle_in(self, m: CoapMessage) -> list[CoapMessage]:
        from emqx_tpu_torch.gateway.coap import CON, EMPTY, RST

        if m.code == EMPTY and m.type == CON:        # CoAP ping → RST pong
            return [CoapMessage(RST, EMPTY, m.mid, b"")]
        if m.type in (ACK, RST):
            settled = self.tm.on_ack(m.mid)          # settles downlink CONs
            ctx = self._cmd_ctx.pop(m.mid, {})
            # a REFUSED observe (error ACK, or RST — which carries code
            # EMPTY) must not poison the single-observation typing
            # heuristic for TLV notifies
            if (ctx.get("msgType") == "observe" and ctx.get("path")
                    and (m.code >= 0x80 or m.type == RST)):
                self._observed.discard(str(ctx["path"]))
            if settled and m.type == ACK and m.code != EMPTY:
                # piggybacked device response to a downlink command
                # (read value / write result) — surface it as the uplink
                # the reference's emqx_lwm2m_cmd produces, echoing the
                # command's reqID/msgType/path for correlation. TLV
                # bodies decode into typed {path, name, value} rows via
                # the object registry (emqx_lwm2m_message tlv_to_json)
                self._uplink("response", {
                    "ep": self.endpoint,
                    "reqID": ctx.get("reqID"),
                    "msgType": ctx.get("msgType"),
                    "data": {
                        "path": ctx.get("path"),
                        "code": f"{m.code >> 5}.{m.code & 0x1F:02d}",
                        "content": self._decode_content(
                            m, ctx.get("path")),
                    }})
            return []
        if m.code == EMPTY:
            return []
        cached = self.tm.dedup(m)
        if cached is not None:
            return list(cached)      # duplicate CON: replay, don't re-run
        out = self._handle_request(m)
        self.tm.remember(m, out)
        return out

    def housekeep(self) -> list[CoapMessage]:
        retx, gave_up = self.tm.tick()
        for mid in gave_up:
            # an unresponsive device surfaces as a timeout uplink rather
            # than silence (the reference's command timeout response)
            ctx = self._cmd_ctx.pop(mid, {})
            if ctx.get("msgType") == "observe" and ctx.get("path"):
                self._observed.discard(str(ctx["path"]))   # never ACKed
            self._uplink("response", {
                "ep": self.endpoint,
                "reqID": ctx.get("reqID"),
                "msgType": ctx.get("msgType"),
                "data": {"path": ctx.get("path"),
                         "code": "5.04", "codeMsg": "timeout"}})
        return retx

    def _handle_request(self, m: CoapMessage) -> list[CoapMessage]:
        reply_type = ACK if m.type == 0 else NON
        path = m.uri_path()

        def reply(code: int, options=(), payload: bytes = b"") -> CoapMessage:
            return CoapMessage(reply_type, code, m.mid, m.token,
                               list(options), payload)

        if not path or path[0] != "rd":
            return [reply(NOT_FOUND)]
        if m.code == POST and len(path) == 1:
            q = m.queries()
            ep = q.get("ep")
            if not ep:
                return [reply(BAD_REQUEST)]
            if not self.ctx.authenticate(f"lwm2m-{ep}"):
                return [reply(BAD_REQUEST)]
            self.endpoint = ep
            self.clientid = f"lwm2m-{ep}"
            self.lifetime = int(q.get("lt", 86400))
            self.reg_id = f"{abs(hash(ep)) % 100000}"
            self.ctx.open_session(self.clientid, self)
            # downlink command subscription for this endpoint
            self.ctx.subscribe(self.clientid, DOWNLINK.format(ep=ep), 0)
            # registry-resolved object list (emqx_lwm2m_xml_object):
            # CoRE links → [{path, oid, instance, name}] so consumers see
            # 'Device'/'Firmware Update', not bare numeric ids
            links = objects.parse_core_links(
                m.payload.decode("utf-8", "replace"))
            self.objects = links
            self._uplink("register", {
                "ep": ep, "lt": self.lifetime,
                "lwm2m": q.get("lwm2m", "1.0"),
                "objects": links,
                "alternatePath": q.get("apn", "/"),
            })
            return [reply(CREATED, options=[
                (OPT_LOCATION_PATH, b"rd"),
                (OPT_LOCATION_PATH, self.reg_id.encode()),
            ])]
        if m.code == POST and len(path) == 2:
            if path[1] != self.reg_id:
                return [reply(NOT_FOUND)]
            q = m.queries()
            if "lt" in q:
                self.lifetime = int(q["lt"])
            if m.payload:
                # registration update may carry a fresh object list
                self.objects = objects.parse_core_links(
                    m.payload.decode("utf-8", "replace"))
            self._uplink("update", {"ep": self.endpoint,
                                    "lt": self.lifetime,
                                    "objects": self.objects})
            return [reply(CHANGED)]
        if m.code == DELETE and len(path) == 2:
            if path[1] != self.reg_id:
                return [reply(NOT_FOUND)]
            self._uplink("deregister", {"ep": self.endpoint})
            self.conn_state = "disconnected"
            return [reply(DELETED)]
        # device-originated notify (e.g. POST /rd/{id}/notify) — only from
        # a registered endpoint, addressed by its own registration id
        if m.code == POST and len(path) == 3 and path[2] == "notify":
            if self.reg_id is None or path[1] != self.reg_id:
                return [reply(NOT_FOUND)]
            # TLV typing needs the observed path: take the device's
            # ?path= echo when present, else correlate with the ONE
            # outstanding observe (the common single-observation case)
            base = m.queries().get("path", "")
            if not base and len(self._observed) == 1:
                (base,) = self._observed
            self._uplink("notify", {
                "ep": self.endpoint,
                "payload": self._decode_content(m, base)})
            return [reply(CHANGED)]
        return [reply(NOT_FOUND)]

    # -- outbound (downlink commands as CoAP POSTs) --------------------------

    # write-attr targets notification ATTRIBUTES (pmin/pmax/gt/lt) of
    # readable/observable resources, not the resource value — gate it on
    # R, not W (OMA TS §5.1.2)
    _OPS = {"read": "R", "observe": "R", "discover": "R",
            "write": "W", "write-attr": "R", "execute": "E"}

    def _decode_content(self, m: CoapMessage, base_path) -> object:
        """Device payload → structured rows when the content-format says
        TLV (emqx_lwm2m_message); plain text passes through."""
        cf = m.opt(OPT_CONTENT_FORMAT)
        fmt = int.from_bytes(cf, "big") if cf else None
        if fmt == tlv.CONTENT_TLV:
            if base_path:
                try:
                    return tlv.tlv_to_path_values(str(base_path),
                                                  m.payload)
                except (tlv.TlvError, ValueError):
                    pass             # malformed TLV: hex below
            # binary without a typing context must surface as hex, not
            # utf-8 mojibake
            return m.payload.hex()
        if fmt == tlv.CONTENT_OPAQUE:
            return m.payload.hex()
        return m.payload.decode("utf-8", "replace")

    def handle_deliver(self, deliveries: list) -> list[CoapMessage]:
        out = []
        for _sub_topic, msg in deliveries:
            plain = self.ctx.unmount(msg.topic)
            parts = plain.split("/")
            # lwm2m/{ep}/dn/... → POST /dn/{...} to the device
            cmd_path = parts[3:] if len(parts) > 3 else []
            # JSON commands ({msgType, data.path}) validate against the
            # object registry before reaching the device: an operation a
            # resource doesn't support answers an uplink error instead
            # (emqx_lwm2m_cmd + xml_object op checks)
            try:
                cmd = json.loads(msg.payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                cmd = None
            if isinstance(cmd, dict) and cmd.get("msgType") in self._OPS:
                path = str((cmd.get("data") or {}).get("path", ""))
                if path and not objects.check_operation(
                        path, self._OPS[cmd["msgType"]]):
                    self._uplink("response", {
                        "ep": self.endpoint,
                        "reqID": cmd.get("reqID"),
                        "msgType": cmd["msgType"],
                        "data": {"path": path,
                                 "code": "4.05",
                                 "codeMsg": "method not allowed",
                                 "name": objects.translate_path(path)},
                    })
                    continue
            opts = [(11, seg.encode()) for seg in (["dn"] + cmd_path)]
            payload = msg.payload
            # a write command whose data.content is [{path, value}]
            # rows ships as a typed TLV body (emqx_lwm2m_cmd +
            # emqx_lwm2m_message json_to_tlv), not raw JSON
            if (isinstance(cmd, dict) and cmd.get("msgType") == "write"
                    and isinstance((cmd.get("data") or {}).get("content"),
                                   list)):
                data = cmd["data"]
                try:
                    payload = tlv.path_values_to_tlv(
                        str(data.get("basePath") or data.get("path")),
                        data["content"])
                    opts.append((OPT_CONTENT_FORMAT,
                                 tlv.CONTENT_TLV.to_bytes(2, "big")))
                except (tlv.TlvError, ValueError, TypeError,
                        KeyError, IndexError):
                    # unencodable rows: raw JSON falls through — and a
                    # malformed command must never escape into
                    # CM.dispatch (it has no per-channel containment)
                    pass
            cmd_msg = CoapMessage(
                0, POST, self._next_mid(),
                b"", opts, payload)             # CON request to device
            self.tm.track(cmd_msg)              # retransmit until ACKed
            if isinstance(cmd, dict):
                self._cmd_ctx[cmd_msg.mid] = {
                    "reqID": cmd.get("reqID"),
                    "msgType": cmd.get("msgType"),
                    "path": (cmd.get("data") or {}).get("path"),
                }
                obs_path = (cmd.get("data") or {}).get("path")
                if cmd.get("msgType") == "observe" and obs_path:
                    self._observed.add(str(obs_path))
                elif cmd.get("msgType") == "cancel-observe" and obs_path:
                    self._observed.discard(str(obs_path))
            out.append(cmd_msg)
        return out

    def terminate(self, reason: str) -> None:
        if self.clientid is not None:
            self.ctx.close_session(self.clientid, self, reason)
            self.clientid = None


class Lwm2mGateway(GatewayImpl):
    name = "lwm2m"

    def __init__(self, host: str = "127.0.0.1", port: int = 5783) -> None:
        self.host, self.port = host, port
        self.listener = None
        self.ctx: Optional[GwContext] = None

    def on_gateway_load(self, ctx: GwContext, conf: dict) -> None:
        from emqx_tpu_torch.gateway.conn import UdpGwListener

        self.ctx = ctx
        self.host = conf.get("host", self.host)
        self.port = conf.get("port", self.port)
        self.listener = UdpGwListener(
            lambda: Channel(self.ctx), Frame(),
            host=self.host, port=self.port)

    async def start_listeners(self) -> None:
        await self.listener.start()
        self.port = self.listener.port

    async def stop_listeners(self) -> None:
        await self.listener.stop()
