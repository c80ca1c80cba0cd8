"""Hook-event → SQL-columns mapping — parity with
``apps/emqx_rule_engine/src/emqx_rule_events.erl:75-123``.

Each hookpoint surfaces as an event topic selectable in FROM:

    message.publish      → plain topic filters ("t/#")
    message.delivered    → "$events/message_delivered"
    message.acked        → "$events/message_acked"
    message.dropped      → "$events/message_dropped"
    client.connected     → "$events/client_connected"
    client.disconnected  → "$events/client_disconnected"
    session.subscribed   → "$events/session_subscribed"
    session.unsubscribed → "$events/session_unsubscribed"
"""

from __future__ import annotations

import time
from typing import Any

from emqx_tpu_torch.core.message import Message

EVENT_TOPICS = {
    "$events/message_delivered": "message.delivered",
    "$events/message_acked": "message.acked",
    "$events/message_dropped": "message.dropped",
    "$events/client_connected": "client.connected",
    "$events/client_disconnected": "client.disconnected",
    "$events/session_subscribed": "session.subscribed",
    "$events/session_unsubscribed": "session.unsubscribed",
}


def message_columns(msg: Message, node: str = "") -> dict[str, Any]:
    """Columns for message.publish (emqx_rule_events:eventmsg_publish)."""
    props = msg.headers.get("properties") or {}
    return {
        "id": msg.id,
        "event": "message.publish",
        "clientid": msg.from_,
        "username": msg.headers.get("username"),
        "payload": msg.payload,
        "peerhost": (msg.headers.get("peername") or "").rsplit(":", 1)[0],
        "topic": msg.topic,
        "qos": msg.qos,
        "flags": dict(msg.flags),
        "retain": 1 if msg.retain else 0,
        "pub_props": props,
        "timestamp": msg.timestamp,
        "publish_received_at": msg.timestamp,
        "node": node,
    }


def event_columns(event: str, args: tuple, node: str = "") -> dict[str, Any]:
    """Columns for the $events/* hookpoints; ``args`` are the hook args
    as fired by the broker."""
    ts = time.time_ns() // 1_000_000
    base = {"event": event, "timestamp": ts, "node": node}
    if event == "client.connected":
        ci = args[0]
        return {**base,
                "clientid": getattr(ci, "clientid", None),
                "username": getattr(ci, "username", None),
                "keepalive": getattr(ci, "keepalive", 0),
                "proto_ver": getattr(ci, "proto_ver", 0),
                "peername": getattr(ci, "peername", ""),
                "clean_start": getattr(ci, "clean_start", True),
                "connected_at": getattr(ci, "connected_at", ts)}
    if event == "client.disconnected":
        ci, reason = args[0], args[1] if len(args) > 1 else "normal"
        return {**base,
                "clientid": getattr(ci, "clientid", None),
                "username": getattr(ci, "username", None),
                "reason": reason,
                "disconnected_at": ts}
    if event in ("session.subscribed", "session.unsubscribed"):
        sid, topic = args[0], args[1]
        opts = args[2] if len(args) > 2 else None
        return {**base, "clientid": sid, "topic": topic,
                "qos": getattr(opts, "qos", 0)}
    if event == "message.delivered":
        cid, topic = args[0], args[1]
        return {**base, "clientid": cid, "topic": topic}
    if event == "message.acked":
        cid, packet_id = args[0], args[1]
        return {**base, "clientid": cid, "packet_id": packet_id}
    if event == "message.dropped":
        msg, reason = args[0], args[1] if len(args) > 1 else "unknown"
        cols = message_columns(msg, node)
        return {**cols, "event": "message.dropped", "reason": reason}
    return {**base, "args": list(map(str, args))}
