"""MQTT-bridge connector — parity with ``emqx_connector_mqtt.erl`` +
its ``mqtt/`` worker (emqtt client + replayq in the reference; our
MqttClient + the BufferWorker's replayq here).

The client runs on a private asyncio loop in a daemon thread so the
synchronous resource/worker machinery can drive it:

- egress: ``on_query({"topic", "payload", "qos", "retain"})`` publishes
  to the remote broker (raises on failure → buffer worker retries).
- ingress: ``subscribe_remote(filter, on_message)`` subscribes on the
  remote side and calls back for every message (the ``$bridges/...``
  hook-topic feed, emqx_rule_events.erl:145).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, Optional

from emqx_tpu_torch.mqtt.client import MqttClient
from emqx_tpu_torch.resource.resource import Resource


class MqttConnector(Resource):
    def __init__(self, host: str = "127.0.0.1", port: int = 1883, *,
                 clientid: str = "bridge", username: Optional[str] = None,
                 password: Optional[bytes] = None,
                 timeout_s: float = 5.0) -> None:
        self.host, self.port = host, port
        self.clientid = clientid
        self.username, self.password = username, password
        self.timeout_s = timeout_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._client: Optional[MqttClient] = None
        self._ingress_task = None
        self._on_message: dict[str, Callable] = {}

    # -- loop-thread plumbing ------------------------------------------------

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()

    def _call(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout or self.timeout_s)

    # -- resource behaviour --------------------------------------------------

    def on_start(self, conf: dict) -> None:
        if self._loop is None:
            self._loop = asyncio.new_event_loop()
            self._thread = threading.Thread(
                target=self._run_loop, daemon=True,
                name=f"mqtt-bridge-{self.clientid}")
            self._thread.start()
        self._client = MqttClient(
            host=self.host, port=self.port, clientid=self.clientid,
            username=self.username, password=self.password,
        )
        self._call(self._client.connect(timeout=self.timeout_s))
        if self._on_message:
            for filt in self._on_message:
                self._call(self._client.subscribe(filt, qos=1))
            self._start_ingress()

    def on_stop(self) -> None:
        if self._ingress_task is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(self._ingress_task.cancel)
            self._ingress_task = None
        if self._client is not None:
            try:
                self._call(self._client.close())
            except Exception:
                pass
            self._client = None
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout=2)
            self._loop, self._thread = None, None

    def on_query(self, req: Any) -> Any:
        self._call(self._client.publish(
            topic=req["topic"], payload=_as_bytes(req.get("payload", b"")),
            qos=int(req.get("qos", 0)), retain=bool(req.get("retain")),
        ))
        return {"ok": True}

    def on_health_check(self) -> bool:
        if self._client is None or self._loop is None:
            return False
        try:
            self._call(self._client.ping())
            return True
        except Exception:
            return False

    # -- ingress -------------------------------------------------------------

    def subscribe_remote(self, filt: str,
                         on_message: Callable[[str, bytes, int], None]) -> None:
        """Register an ingress leg; takes effect at (re)connect, or
        immediately if already connected."""
        self._on_message[filt] = on_message
        if self._client is not None and self._loop is not None:
            self._call(self._client.subscribe(filt, qos=1))
            self._start_ingress()

    def unsubscribe_remote(self, filt: str) -> None:
        self._on_message.pop(filt, None)
        if self._client is not None and self._loop is not None:
            try:
                self._call(self._client.unsubscribe(filt))
            except Exception:
                pass

    def _start_ingress(self) -> None:
        from emqx_tpu_torch.core import topic as T

        client = self._client           # bind: a reconnect swaps clients

        async def pump():
            while True:
                pkt = await client.messages.get()
                for filt, cb in list(self._on_message.items()):
                    # route by the subscribed filter — one connector can
                    # carry several ingress legs with disjoint topics
                    if not T.match(pkt.topic, filt):
                        continue
                    try:
                        cb(pkt.topic, pkt.payload, pkt.qos)
                    except Exception:
                        pass

        async def spawn():
            # always re-pump on (re)connect: the old task is parked on
            # the *previous* client's queue and must not block the new one
            if self._ingress_task is not None:
                self._ingress_task.cancel()
            self._ingress_task = asyncio.ensure_future(pump())

        self._call(spawn())


def _as_bytes(p) -> bytes:
    if isinstance(p, bytes):
        return p
    return str(p).encode()
