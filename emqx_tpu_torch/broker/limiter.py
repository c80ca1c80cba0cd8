"""Hierarchical token-bucket rate limiting — parity with
``apps/emqx/src/emqx_limiter/`` (13 modules).

The reference layers three levels — node-wide bucket → listener/zone
bucket (``emqx_limiter_server.erl`` allocator) → per-connection client
bucket (``emqx_htb_limiter.erl``), composed per connection in
``emqx_limiter_container.erl`` and hooked into the socket loop via
``emqx_esockd_htb_limiter.erl``. Here the same shape is a parent-linked
token-bucket tree: consuming at a leaf must also draw from every
ancestor, so a node cap throttles all listeners and a listener cap
throttles all its connections.

Limit types (emqx_limiter_schema.erl): ``bytes_in``, ``message_in``,
``connection``, ``message_routing``. Unconfigured type = infinity
(always allow).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

TYPES = ("bytes_in", "message_in", "connection", "message_routing")


class Bucket:
    """One token bucket; ``rate`` tokens/second, ``burst`` capacity.
    rate=None → infinity."""

    def __init__(self, rate: Optional[float], burst: Optional[float] = None,
                 parent: Optional["Bucket"] = None, name: str = "") -> None:
        self.rate = rate
        self.burst = burst if burst is not None else (
            rate if rate is not None else 0.0)
        self.tokens = self.burst
        self.parent = parent
        self.name = name
        self._last = time.monotonic()

    def _refill(self, now: float) -> None:
        if self.rate is None:
            return
        elapsed = now - self._last
        if elapsed > 0:
            self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
            self._last = now

    def _available(self, now: float) -> float:
        if self.rate is None:
            mine = float("inf")
        else:
            self._refill(now)
            mine = self.tokens
        if self.parent is not None:
            return min(mine, self.parent._available(now))
        return mine

    def _take(self, n: float, now: float) -> None:
        if self.rate is not None:
            self._refill(now)
            self.tokens -= n
        if self.parent is not None:
            self.parent._take(n, now)

    def try_consume(self, n: float = 1.0,
                    now: Optional[float] = None) -> tuple[bool, float]:
        """→ (granted, retry_after_s). All-or-nothing across the chain
        (the htb client either gets its demand or registers a wait)."""
        now = time.monotonic() if now is None else now
        # epsilon absorbs float error at exact refill boundaries
        # (0.1s * 10/s must count as 1 token)
        if self._available(now) + 1e-9 >= n:
            self._take(n, now)
            return True, 0.0
        return False, self.retry_after(n, now)

    def retry_after(self, n: float, now: Optional[float] = None) -> float:
        """Seconds until ``n`` tokens could be available on the chain."""
        now = time.monotonic() if now is None else now
        worst = 0.0
        node: Optional[Bucket] = self
        while node is not None:
            if node.rate is not None:
                node._refill(now)
                deficit = n - node.tokens
                if deficit > 0:
                    worst = max(worst, deficit / node.rate
                                if node.rate > 0 else float("inf"))
            node = node.parent
        return worst

    def child(self, rate: Optional[float] = None,
              burst: Optional[float] = None, name: str = "") -> "Bucket":
        return Bucket(rate, burst, parent=self, name=name)


class LimiterContainer:
    """Per-connection composite (emqx_limiter_container.erl): one leaf
    bucket per limit type; missing type = infinity."""

    def __init__(self, buckets: Optional[dict[str, Bucket]] = None) -> None:
        self.buckets: dict[str, Bucket] = dict(buckets or {})

    def check(self, type_: str, n: float = 1.0) -> tuple[bool, float]:
        b = self.buckets.get(type_)
        if b is None:
            return True, 0.0
        return b.try_consume(n)


@dataclass
class LimiterConfig:
    """Rates for one scope (node / listener / per-client). None=infinity.
    ``*_burst`` defaults to one second's worth of tokens."""
    bytes_in: Optional[float] = None
    message_in: Optional[float] = None
    connection: Optional[float] = None
    message_routing: Optional[float] = None
    bytes_in_burst: Optional[float] = None
    message_in_burst: Optional[float] = None
    connection_burst: Optional[float] = None
    message_routing_burst: Optional[float] = None

    def rate(self, t: str) -> Optional[float]:
        return getattr(self, t)

    def burst(self, t: str) -> Optional[float]:
        return getattr(self, f"{t}_burst")


class LimiterServer:
    """Root/listener bucket registry (emqx_limiter_server.erl). Builds
    per-connection containers whose leaves chain to the listener buckets,
    which chain to the node buckets."""

    def __init__(self, node_config: Optional[LimiterConfig] = None) -> None:
        self.node_config = node_config or LimiterConfig()
        self._node: dict[str, Bucket] = {}
        for t in TYPES:
            r = self.node_config.rate(t)
            if r is not None:
                self._node[t] = Bucket(r, self.node_config.burst(t),
                                       name=f"node.{t}")
        self._listeners: dict[str, dict[str, Bucket]] = {}
        self._listener_cfg: dict[str, LimiterConfig] = {}

    def add_listener(self, listener_id: str, config: LimiterConfig,
                     client_config: Optional[LimiterConfig] = None) -> None:
        buckets: dict[str, Bucket] = {}
        for t in TYPES:
            r = config.rate(t)
            parent = self._node.get(t)
            if r is not None or parent is not None:
                buckets[t] = Bucket(r, config.burst(t), parent=parent,
                                    name=f"{listener_id}.{t}")
        self._listeners[listener_id] = buckets
        self._listener_cfg[listener_id] = client_config or LimiterConfig()

    def connect(self, listener_id: str) -> tuple[bool, float]:
        """New-connection admission (the esockd conn-rate limit)."""
        buckets = self._listeners.get(listener_id, {})
        b = buckets.get("connection")
        if b is None:
            return True, 0.0
        return b.try_consume(1.0)

    def make_container(self, listener_id: str) -> LimiterContainer:
        buckets = self._listeners.get(listener_id, {})
        cfg = self._listener_cfg.get(listener_id, LimiterConfig())
        leaves: dict[str, Bucket] = {}
        for t in ("bytes_in", "message_in", "message_routing"):
            parent = buckets.get(t)
            r = cfg.rate(t)
            if r is not None or parent is not None:
                leaves[t] = Bucket(r, cfg.burst(t), parent=parent,
                                   name=f"client.{t}")
        return LimiterContainer(leaves)
