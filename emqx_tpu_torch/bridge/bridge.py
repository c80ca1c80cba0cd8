"""Bridge config layer — parity with ``apps/emqx_bridge/src/``
(``emqx_bridge_resource.erl`` naming, the ``$bridges/...`` ingress hook
topics of emqx_rule_events.erl:145, and the bridge↔rule-action seam).

A bridge = connector + ResourceManager + BufferWorker under a
``type:name`` id:

- egress: registered as rule action ``type:name`` — the rule's output
  columns render through the bridge's templates into a request and
  flow through the buffer worker (batching, disk queue, retry).
- ``direct_publish``: hook a local topic filter straight to the bridge
  (the config-only egress path that needs no SQL rule).
- mqtt ingress: remote messages re-publish locally under
  ``local_topic`` and/or fire rules FROM ``$bridges/mqtt:name``.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Optional

from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.resource.resource import ResourceManager
from emqx_tpu_torch.resource.worker import BufferWorker
from emqx_tpu_torch.rules.engine import render_template


def _json_safe(columns: dict) -> dict:
    """Bytes → str so a rendered request survives the buffer worker's
    JSON disk-queue codec (one rule for every renderer branch)."""
    return {k: (v.decode("utf-8", "replace") if isinstance(v, bytes)
                else v) for k, v in columns.items()}
from emqx_tpu_torch.rules.events import message_columns

BRIDGE_HOOK_PREFIX = "$bridges"


class Bridge:
    def __init__(self, type: str, name: str, conf: dict,
                 manager: ResourceManager, worker: BufferWorker) -> None:
        self.type, self.name = type, name
        self.id = f"{type}:{name}"
        self.conf = conf
        self.manager = manager
        self.worker = worker
        self.enabled = True

    # -- template rendering (request per bridge type) ------------------------

    def render_request(self, columns: dict) -> Any:
        c = self.conf
        if self.type == "http":
            body_tmpl = c.get("body", "")
            body = (render_template(body_tmpl, columns) if body_tmpl
                    else json.dumps({k: v for k, v in columns.items()
                                     if not isinstance(v, bytes)}))
            return {
                "method": c.get("method", "post"),
                "path": render_template(c.get("path", "/"), columns),
                "headers": c.get("headers") or {},
                "body": body,
            }
        if self.type == "mqtt":
            remote = (c.get("egress") or {}).get("remote") or {}
            topic_tmpl = remote.get("topic") or "${topic}"
            payload_tmpl = remote.get("payload")
            payload = (render_template(payload_tmpl, columns)
                       if payload_tmpl else columns.get("payload", ""))
            if isinstance(payload, bytes):
                # the request must survive the worker's JSON disk codec;
                # the connector re-encodes to bytes on publish
                payload = payload.decode("utf-8", "replace")
            return {
                "topic": render_template(topic_tmpl, columns),
                "payload": payload,
                "qos": remote.get("qos", columns.get("qos", 0)),
                "retain": bool(remote.get("retain", False)),
            }
        if self.type == "redis":
            # emqx_ee_bridge_redis: command template per message
            tmpl = c.get("command_template") or [
                "LPUSH", "mqtt:${topic}", "${payload}"]
            return {"cmd": [render_template(x, columns) for x in tmpl]}
        if self.type in ("mysql", "pgsql", "postgresql"):
            # emqx_ee_bridge_mysql/pgsql: one INSERT per message from a
            # sql template (client-side bound, connector/pgsql.render_sql)
            tmpl = c.get("sql") or (
                "INSERT INTO mqtt_msg (topic, qos, payload) VALUES "
                "(${topic}, ${qos}, ${payload})")
            return {"sql": tmpl, "binds": _json_safe(columns)}
        if self.type == "mongodb":
            # emqx_ee_bridge_mongodb: payload template → one document
            coll = c.get("collection", "mqtt_msg")
            tmpl = c.get("payload_template")
            if tmpl:
                doc = {"payload": render_template(tmpl, columns)}
            else:
                doc = {k: v for k, v in _json_safe(columns).items()
                       if isinstance(v, (str, int, float, bool))
                       or v is None}
            return {"insert": coll, "documents": [doc]}
        if self.type == "kafka":
            # emqx_ee_bridge_kafka (wolff): key/value templates per
            # message; key defaults to clientid (the reference's
            # key_template default), value to the payload
            key_t = c.get("key_template") or "${clientid}"
            val_t = c.get("value_template")
            value = (render_template(val_t, columns) if val_t
                     else _json_safe(columns).get("payload", ""))
            return {
                "topic": c.get("kafka_topic", "mqtt"),
                "key": render_template(key_t, columns),
                "value": value,
            }
        if self.type == "gcp_pubsub":
            # emqx_ee_connector_gcp_pubsub encode_payload/2: data =
            # base64 of the rendered payload template (whole-columns
            # JSON when no template); orderingKey/attributes templates
            # are renderer extras on the same message shape
            import base64 as _b64
            tmpl = c.get("payload_template")
            data = (render_template(tmpl, columns) if tmpl
                    else json.dumps(_json_safe(columns)))
            msg: dict = {"data": _b64.b64encode(data.encode()).decode()}
            if c.get("attributes_template"):
                msg["attributes"] = {
                    k: render_template(v, columns)
                    for k, v in c["attributes_template"].items()}
            if c.get("ordering_key_template"):
                msg["orderingKey"] = render_template(
                    c["ordering_key_template"], columns)
            return {"messages": [msg]}
        if self.type == "influxdb":
            # emqx_ee_bridge_influxdb: write_syntax template → one line
            # of line protocol, shipped over the HTTP connector's /write
            tmpl = c.get("write_syntax") or \
                "mqtt,topic=${topic} payload=\"${payload}\""
            return {
                "method": "post",
                "path": c.get("path", "/write"),
                "headers": {"Content-Type": "text/plain"},
                "body": render_template(tmpl, columns),
            }
        # generic connectors take the columns (bytes decoded — requests
        # must survive the buffer worker's JSON disk codec)
        return _json_safe(columns)

    def send(self, columns: dict) -> bool:
        if not self.enabled:
            return False
        return self.worker.enqueue(self.render_request(columns))

    def status(self) -> dict:
        return {
            "id": self.id, "type": self.type, "name": self.name,
            "enabled": self.enabled,
            "resource": self.manager.status(),
            "queuing": self.worker.queuing(),
            "metrics": dict(self.worker.metrics),
        }


class BridgeManager:
    """Create/delete/enable bridges; ticks their resource FSMs + buffer
    workers from the app housekeeping timer."""

    def __init__(self, rules=None, publish_fn=None, hooks=None,
                 queue_base_dir: Optional[str] = None) -> None:
        self.rules = rules
        self.publish_fn = publish_fn
        self.hooks = hooks
        self.queue_base_dir = queue_base_dir
        self.bridges: dict[str, Bridge] = {}
        self._lock = threading.RLock()
        # fired after create/delete — the native host flushes its
        # publish permits here so a new egress bridge sees topics that
        # were already fast-pathing (broker/native_server.py)
        self.on_topology_change: list = []

    # -- lifecycle -----------------------------------------------------------

    def create(self, type: str, name: str, connector, conf: Optional[dict]
               = None, *, start: bool = True, **worker_opts) -> Bridge:
        conf = conf or {}
        bid = f"{type}:{name}"
        with self._lock:
            if bid in self.bridges:
                raise ValueError(f"bridge {bid} already exists")
            manager = ResourceManager(
                bid, connector, conf,
                auto_restart_s=conf.get("auto_restart_s", 2.0),
                health_check_s=conf.get("health_check_s", 15.0),
            )
            qdir = None
            if self.queue_base_dir and conf.get("disk_queue", False):
                qdir = f"{self.queue_base_dir}/{type}_{name}"
            # auto_flush: production bridges honour batch_time_s with a
            # dedicated flusher; the 5s app tick is only the safety net
            worker_opts.setdefault("auto_flush", True)
            worker = BufferWorker(manager, queue_dir=qdir, **worker_opts)
            bridge = Bridge(type, name, conf, manager, worker)
            self.bridges[bid] = bridge
        if start:
            manager.start()
        # record each detach as soon as its attach lands, so a failure
        # mid-way (e.g. ingress subscribe on a dead remote) can always
        # unwind completely — otherwise delete() would leave a rule
        # action / publish hook pointing at a dead bridge forever
        bridge._cleanups = cleanups = []
        try:
            # rule-action seam: actions reference bridges as "type:name"
            if self.rules is not None:
                self.rules.register_action(
                    bid, lambda columns, args, b=bridge: b.send(columns))
                cleanups.append(
                    lambda: self.rules.unregister_action(bid))
            # direct egress from a local topic filter (config-only path)
            local = ((conf.get("egress") or {}).get("local") or {})
            if local.get("topic") and self.hooks is not None:
                filt = local["topic"]
                hook_fn = (lambda msg, b=bridge, f=filt:
                           self._direct_egress(msg, b, f))
                self.hooks.add("message.publish", hook_fn, priority=-150)
                cleanups.append(
                    lambda: self.hooks.delete("message.publish", hook_fn))
            # mqtt ingress leg
            ingress = ((conf.get("ingress") or {}).get("remote") or {})
            if ingress.get("topic") and hasattr(connector,
                                                "subscribe_remote"):
                rfilt = ingress["topic"]
                connector.subscribe_remote(
                    rfilt,
                    lambda t, p, q, b=bridge: self._on_ingress(b, t, p, q),
                )
                cleanups.append(
                    lambda: connector.unsubscribe_remote(rfilt))
        except Exception:
            self.delete(bid)
            raise
        for cb in self.on_topology_change:
            cb()
        return bridge

    def _direct_egress(self, msg: Message, bridge: Bridge, filt: str):
        from emqx_tpu_torch.core import topic as T
        if not msg.sys and T.match(msg.topic, filt):
            bridge.send(message_columns(msg))
        return None

    def _on_ingress(self, bridge: Bridge, topic: str, payload: bytes,
                    qos: int) -> None:
        """Remote → local: republish under local_topic and/or feed rules
        bound to the ``$bridges/mqtt:name`` hook topic."""
        local = ((bridge.conf.get("ingress") or {}).get("local") or {})
        hook_topic = f"{BRIDGE_HOOK_PREFIX}/{bridge.id}"
        if self.rules is not None:
            self.rules.ingest(Message(
                topic=hook_topic, payload=payload, qos=qos,
                headers={"bridge_origin_topic": topic},
            ))
        if local.get("topic") and self.publish_fn is not None:
            cols = {"topic": topic,
                    "payload": payload.decode("utf-8", "replace"),
                    "qos": qos}
            self.publish_fn(Message(
                topic=render_template(local["topic"], cols),
                payload=payload,
                qos=int(local.get("qos", qos)),
            ))

    def delete(self, bid: str) -> bool:
        with self._lock:
            bridge = self.bridges.pop(bid, None)
        if bridge is None:
            return False
        # detach every traffic source first, or the dead bridge keeps
        # accumulating requests in a queue nothing will ever flush
        for fn in getattr(bridge, "_cleanups", ()):
            try:
                fn()
            except Exception:
                pass
        bridge.enabled = False
        bridge.worker.close()
        bridge.manager.stop()
        for cb in self.on_topology_change:
            cb()
        return True

    def get(self, bid: str) -> Optional[Bridge]:
        return self.bridges.get(bid)

    def list(self) -> list[dict]:
        return [b.status() for b in self.bridges.values()]

    def enable(self, bid: str, on: bool = True) -> bool:
        b = self.bridges.get(bid)
        if b is None:
            return False
        b.enabled = on
        b.worker.paused = not on     # keep buffered data while disabled
        if on and b.manager.state == "stopped":
            b.manager.start()
        elif not on:
            b.manager.stop()
        return True

    # -- periodic ------------------------------------------------------------

    def tick(self) -> None:
        for b in list(self.bridges.values()):
            if b.enabled:
                b.manager.tick()
                b.worker.tick()

    def stop_all(self) -> None:
        for b in list(self.bridges.values()):
            b.manager.stop()
