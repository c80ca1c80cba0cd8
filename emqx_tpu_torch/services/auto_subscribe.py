"""Server-side auto-subscribe — ``apps/emqx_auto_subscribe/``.

A configured list of topic templates (placeholders ``%c`` clientid,
``%u`` username, ``%h`` host, ``%p`` port) is subscribed on behalf of
every client at connect, through the channel's normal subscribe pipeline
(the reference messages the channel process with the topic tables so
authz and session bookkeeping all apply).
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import SubOpts

MAX_AUTO_SUBSCRIBE = 20      # reference cap


class AutoSubscribe:
    def __init__(self, app, topics: Optional[list[dict]] = None) -> None:
        self.app = app
        self.topics: list[dict] = []
        for spec in (topics or [])[:MAX_AUTO_SUBSCRIBE]:
            self.add(**spec)

    def add(self, topic: str, qos: int = 0, nl: int = 0, rh: int = 0,
            rap: int = 0) -> None:
        if len(self.topics) >= MAX_AUTO_SUBSCRIBE:
            raise ValueError("too many auto-subscribe topics")
        self.topics.append({"topic": topic, "qos": qos, "nl": nl,
                            "rh": rh, "rap": rap})

    def attach(self, hooks) -> None:
        hooks.add("client.connected", self._on_connected, priority=-500)

    def _on_connected(self, ci) -> None:
        if not self.topics:
            return
        cid = getattr(ci, "clientid", None) or (
            ci.get("clientid") if isinstance(ci, dict) else None)
        if not cid:
            return
        username = getattr(ci, "username", None) or (
            ci.get("username") if isinstance(ci, dict) else None)
        peer = str(getattr(ci, "peername", "") or
                   (ci.get("peername", "") if isinstance(ci, dict) else ""))
        host, _, port = peer.partition(":")
        ch = self.app.cm.lookup_channel(cid)
        binds = {"%c": cid, "%u": username or "", "%h": host, "%p": port}
        for spec in self.topics:
            topic = T.feed_var(spec["topic"], binds)
            if not T.validate_filter(topic):
                continue
            # same pipeline guarantees the channel's SUBSCRIBE has: the
            # client's mountpoint applies and the ACL chain can veto
            # (the reference routes auto-subscribe through the channel's
            # normal subscribe path for exactly this)
            if ch is not None and hasattr(ch, "_mount"):
                topic = ch._mount(topic)
            verdict = self.app.hooks.run_fold(
                "client.authorize",
                ({"clientid": cid, "username": username,
                  "peername": peer}, "subscribe", topic),
                "allow",
            )
            if verdict != "allow":
                continue
            opts = SubOpts(qos=spec["qos"], nl=spec["nl"],
                           rh=spec["rh"], rap=spec["rap"])
            # through the session when there is one (keeps resume state
            # coherent), else straight into the broker tables
            session = getattr(ch, "session", None)
            if session is not None:
                try:
                    session.subscribe(topic, opts)
                except Exception:
                    continue
            self.app.broker.subscribe(cid, topic, opts)
