"""Message queue with priorities and drop policies — parity with
``apps/emqx/src/emqx_mqueue.erl`` (:44-45, :83-108) and
``emqx_pqueue.erl``: bounded queue of messages awaiting an inflight slot,
with per-topic priorities, optional QoS0 bypass, and drop-oldest or
drop-current behavior when full."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

from emqx_tpu_torch.core.message import Message


@dataclass
class MQueueOpts:
    max_len: int = 1000                      # 0 = unlimited
    store_qos0: bool = True                  # keep QoS0 when no conn?
    priorities: dict[str, int] = field(default_factory=dict)  # topic -> prio
    default_priority: str = "lowest"         # "lowest" | "highest"
    shift_multiplier: int = 10               # fairness: msgs per prio round


class MQueue:
    """Priority buckets of FIFO deques; drop-oldest when full."""

    def __init__(self, opts: Optional[MQueueOpts] = None):
        self.opts = opts or MQueueOpts()
        self._qs: dict[int, deque] = {}      # prio -> deque
        self._len = 0
        self.dropped = 0
        self._shift_budget: dict[int, int] = {}

    def _prio(self, msg: Message) -> int:
        p = self.opts.priorities.get(msg.topic)
        if p is not None:
            return p
        if self.opts.default_priority == "highest":
            return max(self.opts.priorities.values(), default=0) + 1
        return 0

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def insert(self, msg: Message) -> Optional[Message]:
        """Enqueue; returns a dropped message if the queue was full
        (drop-oldest within the same priority, emqx_mqueue.erl:83-108),
        or the message itself if QoS0 and store_qos0=false."""
        if msg.qos == 0 and not self.opts.store_qos0:
            self.dropped += 1
            return msg
        prio = self._prio(msg)
        q = self._qs.setdefault(prio, deque())
        dropped = None
        if self.opts.max_len and self._len >= self.opts.max_len:
            # evict from the lowest-priority non-empty bucket; if the
            # newcomer itself is below every queued message, drop it
            low = min(p for p, b in self._qs.items() if b)
            if prio < low:
                self.dropped += 1
                return msg
            dropped = self._qs[low].popleft()
            self._len -= 1
            self.dropped += 1
        q.append(msg)
        self._len += 1
        return dropped

    def pop(self) -> Optional[Message]:
        """Dequeue highest priority, with shift-budget fairness so lower
        priorities are not starved (emqx_pqueue round-robin shift)."""
        if self._len == 0:
            return None
        prios = sorted((p for p, q in self._qs.items() if q), reverse=True)
        if not prios:
            return None
        if len(prios) > 1:
            top = prios[0]
            budget = self._shift_budget.get(top, self.opts.shift_multiplier)
            if budget <= 0:
                self._shift_budget[top] = self.opts.shift_multiplier
                prios = prios[1:] + [top]
            else:
                self._shift_budget[top] = budget - 1
        q = self._qs[prios[0]]
        msg = q.popleft()
        self._len -= 1
        return msg

    def peek_all(self) -> list[Message]:
        out = []
        for p in sorted(self._qs, reverse=True):
            out.extend(self._qs[p])
        return out
