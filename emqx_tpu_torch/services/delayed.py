"""Delayed publish (``$delayed/<secs>/<topic>``) — parity with
``apps/emqx_modules/src/emqx_delayed.erl``.

A publish to ``$delayed/5/a/b`` is intercepted at the ``message.publish``
hookpoint, stored, and re-published to ``a/b`` after 5 seconds. Pure
scheduler core (heap by due time + explicit clock) so it runs under any
event loop; the server wires ``tick()`` into its housekeeping timer.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Optional

from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.core import topic as T
from emqx_tpu_torch.core.message import Message, now_ms

PREFIX = "$delayed"
MAX_DELAY_S = 4294967  # emqx_delayed: seconds cap (~49.7 days)


def parse_delayed(topic: str) -> Optional[tuple[int, str]]:
    """'$delayed/5/a/b' → (5, 'a/b'); None if not a delayed topic."""
    ws = T.words(topic)
    if len(ws) < 3 or ws[0] != PREFIX:
        return None
    try:
        secs = int(ws[1])
    except ValueError:
        raise ValueError(f"invalid delay in {topic!r}")
    if not 0 <= secs <= MAX_DELAY_S:
        raise ValueError(f"delay out of range in {topic!r}")
    return secs, T.join(ws[2:])


class Delayed:
    def __init__(self, publish_fn: Callable[[Message], None],
                 max_delayed: int = 0):
        self.publish_fn = publish_fn
        self.max_delayed = max_delayed     # 0 = unlimited
        self._heap: list[tuple[int, int, Message]] = []
        self._seq = itertools.count()
        self._lock = threading.RLock()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._heap)

    def attach(self, hooks: Hooks, priority: int = 100) -> None:
        hooks.add("message.publish", self._on_publish, priority=priority)

    def _on_publish(self, msg: Message):
        try:
            parsed = parse_delayed(msg.topic)
        except ValueError:
            # malformed client-controlled delay ('$delayed/xx/t'): drop the
            # single message, never crash the pipeline (reference behavior)
            self.dropped += 1
            return (Hooks.STOP, msg.set_header("allow_publish", False))
        if parsed is None:
            return None                     # not ours — continue the fold
        secs, real_topic = parsed
        self.store(msg, secs, real_topic)
        # stop the pipeline: the delayed message must not route now
        return (Hooks.STOP, msg.set_header("allow_publish", False))

    def store(self, msg: Message, secs: int, real_topic: str,
              now: Optional[int] = None) -> bool:
        now = now_ms() if now is None else now
        with self._lock:
            if self.max_delayed and len(self._heap) >= self.max_delayed:
                self.dropped += 1
                return False
            due = now + secs * 1000
            from dataclasses import replace
            heapq.heappush(
                self._heap,
                (due, next(self._seq), replace(msg, topic=real_topic)),
            )
            return True

    def tick(self, now: Optional[int] = None) -> int:
        """Publish everything due; returns the count."""
        now = now_ms() if now is None else now
        fired = 0
        while True:
            with self._lock:
                if not self._heap or self._heap[0][0] > now:
                    break
                _, _, msg = heapq.heappop(self._heap)
            self.publish_fn(msg)
            fired += 1
        return fired

    def next_due(self) -> Optional[int]:
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def peek_topics(self) -> list[str]:
        with self._lock:
            return [m.topic for _, _, m in sorted(self._heap)]
