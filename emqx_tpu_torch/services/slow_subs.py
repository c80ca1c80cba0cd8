"""Slow-subscriber tracking — ``apps/emqx_slow_subs/`` analogue.

Per-delivery latency (publish timestamp → delivery, the
``mark_begin_deliver`` stamp emqx_session.erl:908) feeds a bounded
top-K table of the slowest (clientid, topic) pairs; entries expire after
``expire_interval_s`` so the table reflects the recent window, exactly
the reference's moving top-K (emqx_slow_subs.erl).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class SlowEntry:
    clientid: str
    topic: str
    latency_ms: int
    last_update: float
    # which delivery plane observed the latency: "python" (the
    # delivery.completed hook, publish-ts -> delivery) or "native" (a
    # sampled C++ fast-path ack RTT, delivery write -> PUBACK/PUBCOMP —
    # kind-8 slow-ack records via broker/native_server.py). Before the
    # telemetry plane the native fast path was invisible here: a slow
    # native subscriber never ranked.
    plane: str = "python"


class SlowSubs:
    def __init__(self, threshold_ms: int = 500, top_k: int = 10,
                 expire_interval_s: float = 300.0,
                 enable: bool = True) -> None:
        self.enable = enable
        self.threshold_ms = threshold_ms
        self.top_k = top_k
        self.expire_interval_s = expire_interval_s
        self._table: dict[tuple[str, str], SlowEntry] = {}
        self._lock = threading.RLock()

    def attach(self, hooks) -> None:
        hooks.add("delivery.completed", self._on_delivery, priority=-900)

    def _on_delivery(self, clientid: str, topic: str,
                     latency_ms: int) -> None:
        self.record(clientid, topic, latency_ms)

    def record(self, clientid: str, topic: str, latency_ms: int,
               now: Optional[float] = None,
               plane: str = "python") -> None:
        if not self.enable or latency_ms < self.threshold_ms:
            return
        now = time.time() if now is None else now
        with self._lock:
            key = (clientid, topic)
            cur = self._table.get(key)
            if cur is None or latency_ms > cur.latency_ms:
                self._table[key] = SlowEntry(clientid, topic,
                                             latency_ms, now, plane)
            else:
                cur.last_update = now
            if len(self._table) > self.top_k:
                # evict the fastest of the slow (bounded top-K)
                worst = min(self._table.values(),
                            key=lambda e: e.latency_ms)
                del self._table[(worst.clientid, worst.topic)]

    def top(self) -> list[SlowEntry]:
        with self._lock:
            return sorted(self._table.values(),
                          key=lambda e: -e.latency_ms)

    def gc(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        with self._lock:
            dead = [k for k, e in self._table.items()
                    if now - e.last_update >= self.expire_interval_s]
            for k in dead:
                del self._table[k]
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._table.clear()

    def __len__(self) -> int:
        return len(self._table)
