"""Per-client MQTT protocol FSM — parity with ``apps/emqx/src/emqx_channel.erl``.

conn_state: idle → connecting → connected → (reauthenticating) →
disconnected (emqx_channel.erl:113). The channel consumes *parsed*
packets and returns (outgoing packets, actions); the connection host owns
the socket. Pipelines implemented (reference line refs):

- CONNECT: proto checks → banned check → authenticate hook →
  open_session clean/resume → CONNACK (+session-present, assigned
  clientid) (:338-420, :608-633)
- PUBLISH: quota → topic validate → authorize hook → QoS0/1/2 branches
  (:639-704, :730-757)
- SUBSCRIBE/UNSUBSCRIBE with per-filter authorize + shared-sub parse
  (:795-870)
- deliver → session window (:931-1015); keepalive; will message on
  abnormal terminate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

from emqx_tpu_torch.broker.broker import Broker, ExclusiveLocked
from emqx_tpu_torch.broker.cm import CM
from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Message, SubOpts, now_ms
from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.session.session import Session, SessionError

MAX_CLIENTID_LEN = 65535


@dataclass
class ConnInfo:
    peername: str = "127.0.0.1:0"
    proto_ver: int = P.MQTT_V4
    keepalive: int = 60
    clientid: str = ""
    username: Optional[str] = None
    clean_start: bool = True
    expiry_interval_ms: int = 0
    connected_at: int = 0
    # client's announced Maximum-Packet-Size: the server MUST NOT send a
    # larger packet (MQTT5 3.1.2-25); 0 = no limit announced
    max_packet_out: int = 0


@dataclass
class Will:
    msg: Message
    delay_ms: int = 0


class Channel:
    def __init__(
        self,
        broker: Broker,
        cm: CM,
        conninfo: Optional[ConnInfo] = None,
        max_packet_size: int = 1 << 20,
        session_opts: Optional[dict] = None,
        mountpoint: str = "",
        send=None,
        publish_sink=None,
    ) -> None:
        self.broker = broker
        self.cm = cm
        self.hooks: Hooks = broker.hooks
        self.conninfo = conninfo or ConnInfo()
        self.conn_state = "idle"
        self.session: Optional[Session] = None
        self.will: Optional[Will] = None
        self.alias_in: dict[int, str] = {}        # MQTT5 topic aliases (in)
        # outbound aliasing (server→client): bounded by the client's
        # announced Topic-Alias-Maximum; assignment is first-come-keep
        self.alias_out: dict[str, int] = {}
        self.alias_out_max = 0
        self.session_opts = session_opts or {}
        self.mountpoint = mountpoint
        self.last_packet_at = now_ms()
        self.takeover_to: Optional[str] = None
        # the connection host's "write to my socket"; without one, packets
        # accumulate in outbox for the host to drain
        self.outbox: list[P.Packet] = []
        self._send = send if send is not None else self.outbox.extend
        # device-path seam: when the host wires a PublishPipeline sink,
        # publishes coalesce into batched kernel launches instead of the
        # per-message host walk (broker/pipeline.py)
        self.publish_sink = publish_sink
        self.pending_will_at: Optional[int] = None   # MQTT5 will-delay
        self.session_expire_at: Optional[int] = None  # disconnected TTL

    def send(self, pkts: list[P.Packet]) -> None:
        if pkts:
            self._send(pkts)

    def _publish_and_dispatch(self, msg: Message) -> None:
        """Publish + fan deliveries out to the target channels' sockets
        (the process-boundary send in the reference, emqx_broker.erl:546).
        With a publish_sink, the message joins the next device batch; acks
        don't depend on fan-out, so the FSM's replies are unchanged."""
        if self.publish_sink is not None:
            self.publish_sink(msg)
            return
        deliveries = self.broker.publish(msg)
        self.cm.dispatch(deliveries)

    # -- helpers -----------------------------------------------------------

    @property
    def clientid(self) -> str:
        return self.conninfo.clientid

    def _v5(self) -> bool:
        return self.conninfo.proto_ver == P.MQTT_V5

    def _mount(self, topic: str) -> str:
        if not self.mountpoint:
            return topic
        return T.feed_var(self.mountpoint, {
            "%c": self.clientid, "%u": self.conninfo.username or "",
        }) + topic

    def _unmount(self, topic: str) -> str:
        if not self.mountpoint:
            return topic
        mp = T.feed_var(self.mountpoint, {
            "%c": self.clientid, "%u": self.conninfo.username or "",
        })
        return topic[len(mp):] if topic.startswith(mp) else topic

    # -- main entry --------------------------------------------------------

    def handle_in(self, pkt: P.Packet) -> list[P.Packet]:
        self.last_packet_at = now_ms()
        if self.conn_state == "idle" and pkt.type != P.CONNECT:
            raise P.FrameError("first packet must be CONNECT",
                               P.RC_PROTOCOL_ERROR)
        if self.conn_state == "connected" and pkt.type == P.CONNECT:
            raise P.FrameError("duplicate CONNECT", P.RC_PROTOCOL_ERROR)
        handler = {
            P.CONNECT: self._in_connect,
            P.PUBLISH: self._in_publish,
            P.PUBACK: self._in_puback,
            P.PUBREC: self._in_pubrec,
            P.PUBREL: self._in_pubrel,
            P.PUBCOMP: self._in_pubcomp,
            P.SUBSCRIBE: self._in_subscribe,
            P.UNSUBSCRIBE: self._in_unsubscribe,
            P.PINGREQ: lambda _: [P.PingResp()],
            P.DISCONNECT: self._in_disconnect,
            P.AUTH: self._in_auth,
        }.get(pkt.type)
        if handler is None:
            raise P.FrameError(f"unexpected packet {pkt.type}",
                               P.RC_PROTOCOL_ERROR)
        return handler(pkt)

    # -- CONNECT -----------------------------------------------------------

    def _in_connect(self, pkt: P.Connect) -> list[P.Packet]:
        self.conn_state = "connecting"
        ci = self.conninfo
        ci.proto_ver = pkt.proto_ver
        ci.keepalive = pkt.keepalive
        ci.username = pkt.username
        ci.clean_start = pkt.clean_start
        if pkt.proto_ver not in (P.MQTT_V3, P.MQTT_V4, P.MQTT_V5):
            return self._connack_error(P.RC_UNSUPPORTED_PROTOCOL_VERSION)
        clientid = pkt.clientid
        assigned = None
        if not clientid:
            if not pkt.clean_start and pkt.proto_ver != P.MQTT_V5:
                return self._connack_error(P.RC_CLIENT_IDENTIFIER_NOT_VALID)
            assigned = clientid = f"emqx_tpu_{now_ms():x}_{id(self) & 0xFFFF:x}"
        if len(clientid) > MAX_CLIENTID_LEN:
            return self._connack_error(P.RC_CLIENT_IDENTIFIER_NOT_VALID)
        ci.clientid = clientid

        # banned check ('client.connect' hook may also deny)
        deny = self.hooks.run_fold(
            "client.connect", (dict(clientid=clientid,
                                    username=pkt.username,
                                    peername=ci.peername),), None)
        if deny is not None and deny != P.RC_SUCCESS:
            return self._connack_error(deny)

        # authenticate chain (emqx_channel.erl:374-419 → authn hook)
        auth_result = self.hooks.run_fold(
            "client.authenticate",
            (dict(clientid=clientid, username=pkt.username,
                  password=pkt.password, peername=ci.peername,
                  proto_ver=pkt.proto_ver),),
            {"result": "ok"},
        )
        if auth_result.get("result") != "ok":
            self.hooks.run("client.connack",
                           (ci, P.RC_NOT_AUTHORIZED))
            return self._connack_error(
                auth_result.get("rc", P.RC_NOT_AUTHORIZED))

        if pkt.proto_ver == P.MQTT_V5:
            self.alias_out_max = int(
                (pkt.properties or {}).get("Topic-Alias-Maximum", 0) or 0)
        max_qos = getattr(self.broker, "max_qos_allowed", 2)
        if pkt.will_flag and pkt.will_qos > max_qos:
            # [MQTT-3.2.2-12]: a will above the advertised cap is a
            # connect-time refusal, not a later disconnect
            return self._connack_error(P.RC_QOS_NOT_SUPPORTED)

        # will message
        if pkt.will_flag:
            self.will = Will(
                msg=Message(
                    topic=self._mount(pkt.will_topic),
                    payload=pkt.will_payload or b"",
                    qos=pkt.will_qos,
                    from_=clientid,
                    flags={"retain": pkt.will_retain},
                    headers={"properties": pkt.will_props or {}},
                ),
                delay_ms=1000 * (pkt.will_props or {}).get(
                    "Will-Delay-Interval", 0),
            )

        # session open / takeover (emqx_cm analogue)
        expiry = (pkt.properties or {}).get("Session-Expiry-Interval")
        if expiry is None:
            # v3: clean_start=false means "keep forever"; v5 default is 0
            expiry = (
                0xFFFFFFFF
                if pkt.proto_ver != P.MQTT_V5 and not pkt.clean_start
                else 0
            )
        ci.expiry_interval_ms = int(expiry) * 1000
        session, present, pending = self.cm.open_session(
            pkt.clean_start, clientid, self, self.session_opts
        )
        self.session = session
        # the client's Maximum-Packet-Size caps every packet we send
        # (enforced at serialization by the connection host)
        mps = (pkt.properties or {}).get("Maximum-Packet-Size")
        if mps:
            ci.max_packet_out = int(mps)
        # client flow control: its Receive-Maximum caps our send window
        # (MQTT5 3.1.2-11; reference folds it into the inflight limit)
        rm = (pkt.properties or {}).get("Receive-Maximum")
        if rm:
            session.max_inflight = max(1, min(session.max_inflight, int(rm)))
            session.inflight.max_size = session.max_inflight
        # restart-resume: the store prefilled session.subscriptions —
        # rebuild the broker's routes/tables for any not already live
        for sub_topic, sub_opts in list(session.subscriptions.items()):
            if (clientid, sub_topic) not in self.broker.suboption:
                try:
                    self.broker.subscribe(clientid, sub_topic, sub_opts,
                                          restore=True)
                except ExclusiveLocked:
                    # the $exclusive topic was claimed while we were away:
                    # degrade that one subscription, never the whole resume
                    session.subscriptions.pop(sub_topic, None)
        ci.connected_at = now_ms()
        self.conn_state = "connected"
        self.hooks.run("client.connected", (ci,))

        out: list[P.Packet] = []
        props: dict[str, Any] = {}
        if assigned is not None and self._v5():
            props["Assigned-Client-Identifier"] = assigned
        if self._v5():
            # server capability advertisement (emqx_channel connack props)
            props["Receive-Maximum"] = session.max_inflight
            props["Topic-Alias-Maximum"] = 65535   # inbound aliases accepted
            if max_qos < 2:
                props["Maximum-QoS"] = max_qos     # [MQTT-3.2.2-9]
            if not self.broker.shared_dispatch:
                props["Shared-Subscription-Available"] = 0
        connack = P.Connack(
            session_present=present, reason_code=P.RC_SUCCESS,
            properties=props,
        )
        self.hooks.run("client.connack", (ci, P.RC_SUCCESS))
        out.append(connack)
        # resume: replay pending messages through the fresh window
        if pending:
            deliveries = [
                (m.headers.get("sub_topic", m.topic), m) for m in pending
            ]
            out.extend(self._postprocess_out(session.deliver(deliveries)))
            self.hooks.run("session.resumed", (clientid,))
        return out

    def _connack_error(self, rc: int) -> list[P.Packet]:
        self.conn_state = "disconnected"
        if not self._v5() and rc > 0x80:
            # map v5 codes onto v3 connack codes (emqx_reason_codes:compat)
            rc3 = {
                P.RC_UNSUPPORTED_PROTOCOL_VERSION: 1,
                P.RC_CLIENT_IDENTIFIER_NOT_VALID: 2,
                P.RC_SERVER_UNAVAILABLE: 3,
                P.RC_BAD_USER_NAME_OR_PASSWORD: 4,
                P.RC_NOT_AUTHORIZED: 5,
                P.RC_BANNED: 5,
            }.get(rc, 5)
            return [P.Connack(reason_code=rc3)]
        return [P.Connack(reason_code=rc)]

    # -- PUBLISH (emqx_channel.erl:639-757) ---------------------------------

    def _in_publish(self, pkt: P.Publish) -> list[P.Packet]:
        topic = pkt.topic
        # MQTT5 topic alias resolution
        alias = (pkt.properties or {}).get("Topic-Alias")
        if alias is not None:
            if alias == 0:
                raise P.FrameError("topic alias 0", P.RC_TOPIC_ALIAS_INVALID)
            if topic:
                self.alias_in[alias] = topic
            else:
                topic = self.alias_in.get(alias)
                if topic is None:
                    raise P.FrameError("unknown topic alias",
                                       P.RC_PROTOCOL_ERROR)
        if not T.validate_name(topic):
            # wildcard/invalid topic NAME is a protocol violation, not a
            # deliverable error: the reference disconnects with 0x90
            # (emqx_mqtt_protocol_v5_SUITE t_publish_wildtopic)
            raise P.FrameError("invalid topic name",
                               P.RC_TOPIC_NAME_INVALID)
        if pkt.qos > getattr(self.broker, "max_qos_allowed", 2):
            # [MQTT-3.2.2-11]: DISCONNECT 0x9B, not a puback error
            raise P.FrameError("qos not supported",
                               P.RC_QOS_NOT_SUPPORTED)

        mounted = self._mount(topic)
        # authorize (client.authorize hook fold: allow | deny)
        verdict = self.hooks.run_fold(
            "client.authorize",
            (dict(clientid=self.clientid, username=self.conninfo.username,
                  peername=self.conninfo.peername),
             "publish", mounted),
            "allow",
        )
        if verdict != "allow":
            self.hooks.run("message.dropped.authz", (mounted,))
            return self._puberr(pkt, P.RC_NOT_AUTHORIZED)

        # Topic-Alias is CONNECTION-scoped [MQTT-3.3.2-7]: forwarding the
        # publisher's inbound alias would hand subscribers an alias THEY
        # never negotiated (their own aliasing happens in
        # _postprocess_out against their announced maximum)
        fwd_props = dict(pkt.properties or {})
        fwd_props.pop("Topic-Alias", None)
        msg = Message(
            topic=mounted, payload=pkt.payload, qos=pkt.qos,
            from_=self.clientid,
            flags={"retain": pkt.retain, "dup": pkt.dup},
            headers={
                "properties": fwd_props,
                "username": self.conninfo.username,
                "peername": self.conninfo.peername,
                "protocol": "mqtt",
            },
        )
        if pkt.qos == 0:
            self._publish_and_dispatch(msg)
            return []
        if pkt.qos == 1:
            self._publish_and_dispatch(msg)
            return [P.PubAck(packet_id=pkt.packet_id)]
        # QoS2: exactly-once receive
        try:
            self.session.publish_in(pkt.packet_id, msg)
        except SessionError as e:
            return [P.PubRec(packet_id=pkt.packet_id, reason_code=e.rc)]
        self._publish_and_dispatch(msg)
        return [P.PubRec(packet_id=pkt.packet_id)]

    def _puberr(self, pkt: P.Publish, rc: int) -> list[P.Packet]:
        if pkt.qos == 1:
            return [P.PubAck(packet_id=pkt.packet_id, reason_code=rc)]
        if pkt.qos == 2:
            return [P.PubRec(packet_id=pkt.packet_id, reason_code=rc)]
        return []  # QoS0 errors are silent (no ack slot to carry the rc)

    # -- acks ---------------------------------------------------------------

    def _postprocess_out(self, pkts: list[P.Packet]) -> list[P.Packet]:
        """Unmount topics + fire message.delivered for outgoing PUBLISHes —
        every path that emits them (deliver, dequeue, retry) goes through
        here so the internal mounted namespace never leaks to the client."""
        for pkt in pkts:
            if isinstance(pkt, P.Publish):
                pkt.topic = self._unmount(pkt.topic)
                self.hooks.run(
                    "message.delivered", (self.clientid, pkt.topic)
                )
                if self.alias_out_max and pkt.topic and self._v5():
                    # outbound alias ([MQTT-3.3.2] server side): known
                    # topic → alias with empty name; room left → assign
                    # and send alias WITH the full name this once
                    a = self.alias_out.get(pkt.topic)
                    if a is not None:
                        pkt.properties = {**(pkt.properties or {}),
                                          "Topic-Alias": a}
                        pkt.topic = ""
                    elif len(self.alias_out) < self.alias_out_max:
                        a = len(self.alias_out) + 1
                        self.alias_out[pkt.topic] = a
                        pkt.properties = {**(pkt.properties or {}),
                                          "Topic-Alias": a}
        return pkts

    def _in_puback(self, pkt: P.PubAck) -> list[P.Packet]:
        try:
            out = self.session.puback(pkt.packet_id)
            self.hooks.run("message.acked", (self.clientid, pkt.packet_id))
            return self._postprocess_out(out)
        except SessionError:
            return []

    def _in_pubrec(self, pkt: P.PubRec) -> list[P.Packet]:
        try:
            if pkt.reason_code >= 0x80:
                # receiver refused: drop the inflight entry
                self.session.inflight.delete(pkt.packet_id)
                return []
            return [self.session.pubrec(pkt.packet_id)]
        except SessionError as e:
            return [P.PubRel(packet_id=pkt.packet_id, reason_code=e.rc)]

    def _in_pubrel(self, pkt: P.PubRel) -> list[P.Packet]:
        try:
            self.session.pubrel_in(pkt.packet_id)
            return [P.PubComp(packet_id=pkt.packet_id)]
        except SessionError as e:
            return [P.PubComp(packet_id=pkt.packet_id, reason_code=e.rc)]

    def _in_pubcomp(self, pkt: P.PubComp) -> list[P.Packet]:
        try:
            return self._postprocess_out(self.session.pubcomp(pkt.packet_id))
        except SessionError:
            return []

    # -- SUBSCRIBE / UNSUBSCRIBE -------------------------------------------

    def _in_subscribe(self, pkt: P.Subscribe) -> list[P.Packet]:
        rcs: list[int] = []
        subid = (pkt.properties or {}).get("Subscription-Identifier")
        if isinstance(subid, list):
            subid = subid[0] if subid else None
        # client.subscribe fold: rewrite/veto filters before processing
        # (emqx_rewrite registers here, emqx_rewrite.erl:101-102)
        topic_filters = self.hooks.run_fold(
            "client.subscribe",
            (dict(clientid=self.clientid,
                  username=self.conninfo.username),
             pkt.properties or {}),
            pkt.topic_filters,
        )
        for filt, opts in topic_filters:
            group, real = T.parse_share(filt)
            exclusive = False
            if not group:
                # $exclusive/t → exclusive flag + real topic t
                # (emqx_topic.erl:225-230 parse)
                exclusive, real = T.parse_exclusive(real)
            if exclusive and not self.broker.exclusive_enabled:
                # cap disabled → invalid filter (emqx_mqtt_caps:do_check_sub)
                rcs.append(P.RC_TOPIC_FILTER_INVALID)
                continue
            if not T.validate_filter(real):
                rcs.append(P.RC_TOPIC_FILTER_INVALID)
                continue
            if group and opts.get("nl"):
                # shared subs must not set no-local (MQTT5 spec)
                rcs.append(P.RC_PROTOCOL_ERROR)
                continue
            # mount only the real topic: '$share/g/t' in namespace 'ns/'
            # becomes '$share/g/ns/t' (the reference mounts after share
            # parsing for the same reason)
            mounted_real = self._mount(real)
            mounted_key = (
                f"{T.SHARE_PREFIX}/{group}/{mounted_real}" if group
                else mounted_real
            )
            verdict = self.hooks.run_fold(
                "client.authorize",
                (dict(clientid=self.clientid,
                      username=self.conninfo.username,
                      peername=self.conninfo.peername),
                 "subscribe", mounted_real),
                "allow",
            )
            if verdict != "allow":
                rcs.append(P.RC_NOT_AUTHORIZED)
                continue
            subopts = SubOpts(
                qos=opts.get("qos", 0), nl=opts.get("nl", 0),
                rap=opts.get("rap", 0), rh=opts.get("rh", 0),
                share=group, subid=subid, exclusive=exclusive,
            )
            # remember any prior subscription to this key so a rejected
            # exclusive upgrade can roll back without destroying it
            prior_opts = self.session.subscriptions.get(mounted_key)
            try:
                self.session.subscribe(mounted_key, subopts)
            except SessionError as e:
                rcs.append(e.rc)
                continue
            try:
                self.broker.subscribe(self.clientid, mounted_key, subopts)
            except ExclusiveLocked:
                # $exclusive/... already held → 0x97, same rc the
                # reference returns (emqx_exclusive_subscription.erl)
                if prior_opts is not None:
                    self.session.subscriptions[mounted_key] = prior_opts
                else:
                    self.session.unsubscribe(mounted_key)
                rcs.append(P.RC_QUOTA_EXCEEDED)
                continue
            rcs.append(subopts.qos)  # granted qos
        return [P.SubAck(packet_id=pkt.packet_id, reason_codes=rcs)]

    def _in_unsubscribe(self, pkt: P.Unsubscribe) -> list[P.Packet]:
        rcs: list[int] = []
        topic_filters = self.hooks.run_fold(
            "client.unsubscribe",
            (dict(clientid=self.clientid,
                  username=self.conninfo.username),
             pkt.properties or {}),
            pkt.topic_filters,
        )
        for filt in topic_filters:
            group, real = T.parse_share(filt)
            if not group:
                _excl, real = T.parse_exclusive(real)
            mounted_real = self._mount(real)
            mounted_key = (
                f"{T.SHARE_PREFIX}/{group}/{mounted_real}" if group
                else mounted_real
            )
            try:
                self.session.unsubscribe(mounted_key)
                self.broker.unsubscribe(self.clientid, mounted_key)
                rcs.append(P.RC_SUCCESS)
            except SessionError as e:
                rcs.append(e.rc)
        return [P.UnsubAck(packet_id=pkt.packet_id, reason_codes=rcs)]

    # -- DISCONNECT / AUTH --------------------------------------------------

    def _in_disconnect(self, pkt: P.Disconnect) -> list[P.Packet]:
        if pkt.reason_code == P.RC_SUCCESS:
            self.will = None        # normal disconnect discards the will
        expiry = (pkt.properties or {}).get("Session-Expiry-Interval")
        if expiry is not None:
            self.conninfo.expiry_interval_ms = int(expiry) * 1000
        self.terminate("normal" if pkt.reason_code == P.RC_SUCCESS
                       else "client_disconnect")
        return []

    def _in_auth(self, pkt: P.Auth) -> list[P.Packet]:
        # enhanced auth continuation — delegated to the authn chain
        self.conn_state = "reauthenticating"
        result = self.hooks.run_fold(
            "client.reauthenticate",
            (dict(clientid=self.clientid), pkt.properties),
            {"result": "ok"},
        )
        self.conn_state = "connected"
        if result.get("result") != "ok":
            return [P.Disconnect(reason_code=P.RC_NOT_AUTHORIZED)]
        return [P.Auth(reason_code=P.RC_SUCCESS)]

    # -- broker → client ----------------------------------------------------

    def handle_deliver(
        self, deliveries: list[tuple[str, Message]]
    ) -> list[P.Packet]:
        if self.conn_state != "connected" or self.session is None:
            for sub_topic, msg in deliveries:
                if self.session is not None:
                    self.session.enqueue(sub_topic, msg)
            return []
        out = self._postprocess_out(self.session.deliver(list(deliveries)))
        # per-delivery latency from the deliver-begin stamp (the
        # reference's mark_begin_deliver, emqx_session.erl:908) → slow_subs
        now = now_ms()
        for sub_topic, msg in deliveries:
            begin = msg.extra.get("deliver_begin_at", msg.timestamp)
            self.hooks.run(
                "delivery.completed",
                (self.clientid, msg.topic, now - begin))
        return out

    # -- timers -------------------------------------------------------------

    def keepalive_expired(self, now: Optional[int] = None) -> bool:
        """1.5 × keepalive with no inbound packet (emqx_keepalive)."""
        if self.conninfo.keepalive == 0 or self.conn_state != "connected":
            return False
        now = now_ms() if now is None else now
        return now - self.last_packet_at > self.conninfo.keepalive * 1500

    def handle_timeout(self, kind: str,
                       now: Optional[int] = None) -> list[P.Packet]:
        if self.session is None:
            return []
        if kind == "retry":
            return self._postprocess_out(self.session.retry(now))
        if kind == "expire_awaiting_rel":
            self.session.expire_awaiting_rel(now)
        return []

    # -- lifecycle ----------------------------------------------------------

    def takeover(self) -> tuple[Optional[Session], list[Message]]:
        """Yield the session to a resuming channel; this channel dies
        (emqx_channel:handle_call takeover / emqx_cm.erl 2-phase)."""
        session = self.session
        pending = session.take_pending() if session else []
        self.conn_state = "disconnected"
        self.session = None
        # resuming in time cancels a delayed will (MQTT5 3.1.3.2.2)
        self.pending_will_at = None
        self.will = None
        self.hooks.run("session.takenover", (self.clientid,))
        return session, pending

    def will_tick(self, now: Optional[int] = None) -> None:
        """Fire a due delayed will (driven by the app housekeeping timer)."""
        if self.pending_will_at is None or self.will is None:
            return
        now = now_ms() if now is None else now
        if now >= self.pending_will_at:
            self._publish_and_dispatch(self.will.msg)
            self.will = None
            self.pending_will_at = None

    def discard(self) -> None:
        """Kicked by a clean-start connect or admin (RC 0x8E). Unlike
        takeover, the session state dies — clean its broker footprint
        (routes/subscriber sets/model slots) or they leak forever."""
        self.conn_state = "disconnected"
        if self.session is not None:
            self.broker.subscriber_down(self.clientid)
            self.session = None
        self.cm.unregister_channel(self.clientid, self)
        self.hooks.run("session.discarded", (self.clientid,))

    def terminate(self, reason: str) -> None:
        if self.conn_state == "disconnected":
            return
        self.conn_state = "disconnected"
        if self.will is not None and reason != "normal":
            if (
                self.will.delay_ms > 0
                and self.conninfo.expiry_interval_ms > 0
            ):
                # MQTT5 Will Delay: withhold; cancelled if the session is
                # resumed before it fires (will_tick / takeover). The will
                # MUST be published no later than session end (MQTT5
                # 3.1.2.5: earlier of Will Delay and Session Expiry), so
                # the delay caps at the expiry interval.
                self.pending_will_at = now_ms() + min(
                    self.will.delay_ms, self.conninfo.expiry_interval_ms)
            else:
                self._publish_and_dispatch(self.will.msg)
                self.will = None
        if self.conninfo.expiry_interval_ms == 0:
            # session dies with the connection
            if self.session is not None:
                self.broker.subscriber_down(self.clientid)
                self.hooks.run("session.terminated", (self.clientid, reason))
                self.session = None
            self.cm.unregister_channel(self.clientid, self)
        else:
            # stay registered as a disconnected channel holding the
            # session until expiry/resume (the reference keeps the channel
            # process alive in this state, emqx_channel.erl disconnected);
            # the deadline is enforced by expire_tick
            self.session_expire_at = (
                now_ms() + self.conninfo.expiry_interval_ms)
        self.hooks.run("client.disconnected", (self.conninfo, reason))

    def expire_tick(self, now: Optional[int] = None) -> bool:
        """Enforce a disconnected channel's session-expiry deadline
        (MQTT5 3.1.2-23: session state MUST be discarded when the
        interval elapses). Returns True when the session expired."""
        if (self.conn_state != "disconnected"
                or self.session is None
                or self.session_expire_at is None):
            return False
        now = now_ms() if now is None else now
        if now < self.session_expire_at:
            return False
        # a still-pending delayed will fires at session end at the latest
        if self.will is not None and self.pending_will_at is not None:
            self._publish_and_dispatch(self.will.msg)
            self.will = None
            self.pending_will_at = None
        self.broker.subscriber_down(self.clientid)
        self.hooks.run("session.terminated", (self.clientid, "expired"))
        self.session = None
        self.session_expire_at = None
        self.cm.unregister_channel(self.clientid, self)
        return True
