"""Per-topic metrics — ``apps/emqx_modules/src/emqx_topic_metrics.erl``.

Operators register topic filters (bounded set, reference cap 512);
publishes/deliveries matching a registered filter bump its counters:
messages.in (+qosN.in breakdown), messages.out, messages.dropped.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from emqx_tpu_torch.core import topic as T

MAX_TOPICS = 512


class TopicMetrics:
    def __init__(self, max_topics: int = MAX_TOPICS) -> None:
        self.max_topics = max_topics
        self._metrics: dict[str, dict[str, int]] = {}
        self._created: dict[str, float] = {}
        # fired after register/deregister — the native host flushes its
        # publish permits here so a freshly watched topic's messages
        # come back through Python immediately, not after permit-TTL
        self.on_topology_change: list = []
        self._lock = threading.RLock()

    # -- registry ------------------------------------------------------------

    def register(self, topic_filter: str) -> bool:
        if not T.validate_filter(topic_filter):
            raise ValueError(f"bad topic filter {topic_filter}")
        with self._lock:
            if topic_filter in self._metrics:
                return False
            if len(self._metrics) >= self.max_topics:
                raise ValueError("too many registered topics")
            self._metrics[topic_filter] = {
                "messages.in": 0, "messages.out": 0,
                "messages.qos0.in": 0, "messages.qos1.in": 0,
                "messages.qos2.in": 0, "messages.dropped": 0,
            }
            self._created[topic_filter] = time.time()
        for cb in self.on_topology_change:
            cb()
        return True

    def deregister(self, topic_filter: Optional[str] = None) -> bool:
        with self._lock:
            if topic_filter is None:
                changed = bool(self._metrics)
                self._metrics.clear()
                self._created.clear()
                hit = True
            else:
                self._created.pop(topic_filter, None)
                changed = hit = (
                    self._metrics.pop(topic_filter, None) is not None)
        if changed:               # fire only when something was removed
            for cb in self.on_topology_change:
                cb()
        return hit

    def topics(self) -> list[str]:
        with self._lock:          # snapshot: off-thread readers iterate
            return list(self._metrics)

    def metrics(self, topic_filter: str) -> Optional[dict[str, int]]:
        m = self._metrics.get(topic_filter)
        return dict(m) if m is not None else None

    def all(self) -> list[dict]:
        with self._lock:
            return [{"topic": t, "create_time": self._created.get(t, 0),
                     "metrics": dict(m)}
                    for t, m in self._metrics.items()]

    # -- counting ------------------------------------------------------------

    def _bump(self, topic: str, key: str, extra: Optional[str] = None
              ) -> None:
        with self._lock:
            for filt, m in self._metrics.items():
                if T.match(topic, filt):
                    m[key] += 1
                    if extra:
                        m[extra] += 1

    def attach(self, hooks) -> None:
        hooks.add("message.publish", self._on_publish, priority=-800)
        hooks.add("message.delivered", self._on_delivered, priority=-800)
        hooks.add("message.dropped", self._on_dropped, priority=-800)

    def _on_publish(self, msg):
        if not msg.sys:
            self._bump(msg.topic, "messages.in",
                       f"messages.qos{min(msg.qos, 2)}.in")
        return None

    def _on_delivered(self, clientid: str, topic: str) -> None:
        self._bump(topic, "messages.out")

    def _on_dropped(self, msg, *args) -> None:
        topic = msg if isinstance(msg, str) else msg.topic
        self._bump(topic, "messages.dropped")
