"""Async MQTT client — the ``emqtt`` analogue (used by the test suites
the way the reference drives its broker with emqtt, and by the MQTT
data bridge)."""

from __future__ import annotations

import asyncio
from typing import Optional

from emqx_tpu_torch.mqtt import packet as P
from emqx_tpu_torch.mqtt.frame import Parser, serialize


class MqttClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 1883,
                 clientid: str = "", proto_ver: int = P.MQTT_V4,
                 clean_start: bool = True, keepalive: int = 60,
                 username: Optional[str] = None,
                 password: Optional[bytes] = None,
                 properties: Optional[dict] = None,
                 will: Optional[P.Connect] = None,
                 ssl=None, server_hostname: Optional[str] = None,
                 auto_ack: bool = True):
        self.host, self.port = host, port
        self.auto_ack = auto_ack        # False: tests ack via puback()
        self.ssl = ssl                  # ssl.SSLContext | None
        self.server_hostname = server_hostname
        self.clientid = clientid
        self.proto_ver = proto_ver
        self.clean_start = clean_start
        self.keepalive = keepalive
        self.username, self.password = username, password
        self.properties = properties or {}
        self._parser = Parser(version=proto_ver)
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._incoming: asyncio.Queue[P.Packet] = asyncio.Queue()
        self.messages: asyncio.Queue[P.Publish] = asyncio.Queue()
        self._next_pid = 0
        self.connack: Optional[P.Connack] = None

    def _pid(self) -> int:
        self._next_pid = self._next_pid % 65535 + 1
        return self._next_pid

    async def connect(self, will_topic=None, will_payload=b"",
                      will_qos=0, timeout: float = 5.0) -> P.Connack:
        kw = {}
        if self.ssl is not None:
            kw["ssl"] = self.ssl
            kw["server_hostname"] = self.server_hostname or self.host
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, **kw
        )
        self._recv_task = asyncio.create_task(self._recv_loop())
        await self._send(P.Connect(
            proto_ver=self.proto_ver, clean_start=self.clean_start,
            keepalive=self.keepalive, clientid=self.clientid,
            username=self.username, password=self.password,
            properties=self.properties,
            will_flag=will_topic is not None, will_qos=will_qos,
            will_topic=will_topic, will_payload=will_payload,
        ))
        pkt = await self._expect(P.CONNACK, timeout)
        self.connack = pkt
        if pkt.reason_code != P.RC_SUCCESS:
            await self.close()
            raise ConnectionRefusedError(
                f"CONNACK reason_code=0x{pkt.reason_code:02x}")
        return pkt

    async def _send(self, pkt: P.Packet) -> None:
        assert self._writer is not None
        self._writer.write(serialize(pkt, self.proto_ver))
        await self._writer.drain()

    async def _recv_loop(self) -> None:
        try:
            while True:
                data = await self._reader.read(65536)
                if not data:
                    break
                for pkt in self._parser.feed(data):
                    await self._route_in(pkt)
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def _route_in(self, pkt: P.Packet) -> None:
        if pkt.type == P.PUBLISH:
            await self.messages.put(pkt)
            if not self.auto_ack:
                pass
            elif pkt.qos == 1:
                await self._send(P.PubAck(packet_id=pkt.packet_id))
            elif pkt.qos == 2:
                await self._send(P.PubRec(packet_id=pkt.packet_id))
        elif pkt.type == P.PUBREL:
            if self.auto_ack:
                await self._send(P.PubComp(packet_id=pkt.packet_id))
            else:
                # manual-ack mode: surface the PUBREL so tests can run
                # the subscriber-side QoS2 exchange by hand (the old
                # unconditional auto-PubComp swallowed it, making
                # _expect(PUBREL) unreachable)
                await self._incoming.put(pkt)
        elif pkt.type == P.PINGRESP:
            pass
        else:
            await self._incoming.put(pkt)

    async def _expect(self, ptype: int, timeout: float = 5.0) -> P.Packet:
        while True:
            pkt = await asyncio.wait_for(self._incoming.get(), timeout)
            if pkt.type == ptype:
                return pkt

    async def subscribe(self, topic: str, qos: int = 0,
                        properties: Optional[dict] = None,
                        **opts) -> P.SubAck:
        """``properties`` are SUBSCRIBE packet-level (e.g.
        Subscription-Identifier); ``opts`` are per-filter (nl/rap/rh)."""
        await self._send(P.Subscribe(
            packet_id=self._pid(), properties=properties or {},
            topic_filters=[(topic, {"qos": qos, **opts})],
        ))
        return await self._expect(P.SUBACK)

    async def unsubscribe(self, topic: str) -> P.UnsubAck:
        await self._send(P.Unsubscribe(
            packet_id=self._pid(), topic_filters=[topic]
        ))
        return await self._expect(P.UNSUBACK)

    async def publish(self, topic: str, payload: bytes = b"",
                      qos: int = 0, retain: bool = False,
                      properties: Optional[dict] = None) -> Optional[int]:
        pid = self._pid() if qos else None
        await self._send(P.Publish(
            topic=topic, payload=payload, qos=qos, retain=retain,
            packet_id=pid, properties=properties or {},
        ))
        if qos == 1:
            await self._expect(P.PUBACK)
        elif qos == 2:
            await self._expect(P.PUBREC)
            await self._send(P.PubRel(packet_id=pid))
            await self._expect(P.PUBCOMP)
        return pid

    async def recv(self, timeout: float = 5.0) -> P.Publish:
        return await asyncio.wait_for(self.messages.get(), timeout)

    async def puback(self, packet_id: int) -> None:
        """Manual QoS1 ack (use with auto_ack=False)."""
        await self._send(P.PubAck(packet_id=packet_id))

    async def ping(self) -> None:
        await self._send(P.PingReq())

    async def disconnect(self, reason_code: int = P.RC_SUCCESS) -> None:
        try:
            await self._send(P.Disconnect(reason_code=reason_code))
        except ConnectionError:
            pass
        await self.close()

    async def close(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, Exception):
                pass
