"""Message / route / subscription data model.

Parity with the reference records in ``apps/emqx/include/emqx.hrl:63-101``
(#message{}, #route{}, #delivery{}, #subscription{}) and helpers from
``apps/emqx/src/emqx_message.erl`` — as plain dataclasses (host side; the
device side sees only tokenized topic ids and subscriber bitmaps).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Any, Optional

_guid_counter = itertools.count()


def guid() -> int:
    """Monotonic snowflake-ish message id (emqx_guid.erl analogue):
    48-bit µs timestamp | 16-bit sequence."""
    return (time.time_ns() // 1000 << 16) | (next(_guid_counter) & 0xFFFF)


def now_ms() -> int:
    return time.time_ns() // 1_000_000


@dataclass
class Message:
    """#message{} — emqx.hrl:63-82."""

    topic: str
    payload: bytes = b""
    qos: int = 0
    from_: str = ""                      # clientid of the publisher
    id: int = field(default_factory=guid)
    flags: dict[str, bool] = field(default_factory=dict)   # retain/dup/sys
    headers: dict[str, Any] = field(default_factory=dict)  # props/peer/username
    timestamp: int = field(default_factory=now_ms)
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def retain(self) -> bool:
        return bool(self.flags.get("retain"))

    @property
    def dup(self) -> bool:
        return bool(self.flags.get("dup"))

    @property
    def sys(self) -> bool:
        return bool(self.flags.get("sys"))

    def set_flag(self, flag: str, val: bool = True) -> "Message":
        return replace(self, flags={**self.flags, flag: val})

    def set_header(self, key: str, val: Any) -> "Message":
        return replace(self, headers={**self.headers, key: val})

    def is_expired(self, now: Optional[int] = None) -> bool:
        """Message-expiry-interval (MQTT5 property, seconds)."""
        interval = (self.headers.get("properties") or {}).get(
            "Message-Expiry-Interval"
        )
        if interval is None:
            return False
        now = now_ms() if now is None else now
        return now - self.timestamp >= interval * 1000

    def update_expiry(self) -> "Message":
        """Shrink the expiry interval by elapsed time on forward (MQTT5)."""
        props = dict(self.headers.get("properties") or {})
        interval = props.get("Message-Expiry-Interval")
        if interval is None:
            return self
        remaining = max(1, interval - (now_ms() - self.timestamp) // 1000)
        props["Message-Expiry-Interval"] = remaining
        return self.set_header("properties", props)


@dataclass(frozen=True)
class Route:
    """#route{} — a topic filter routed to a destination.

    dest is a node name, ``(group, node)`` for shared subs, or a session id
    for persistent session routes (emqx_router.erl dest forms).
    """

    topic: str
    dest: Any


@dataclass(frozen=True)
class Subscription:
    """#subscription{} — subscriber (session) × topic filter."""

    topic: str
    subid: str
    subopts: "SubOpts"


@dataclass(frozen=True)
class SubOpts:
    """Subscription options (MQTT5 + emqx extensions).

    Defaults mirror ?DEFAULT_SUBOPTS (emqx.hrl / emqx_types).
    """

    qos: int = 0
    rh: int = 0      # retain-handling: 0 send, 1 send-if-new, 2 don't send
    rap: int = 0     # retain-as-published
    nl: int = 0      # no-local
    share: Optional[str] = None   # $share group name
    subid: Optional[int] = None   # MQTT5 subscription identifier
    exclusive: bool = False       # came in as $exclusive/... (is_exclusive)

    def effective_qos(self, msg_qos: int) -> int:
        """Granted delivery QoS = min(subscription max QoS, message QoS)."""
        return min(self.qos, msg_qos)


@dataclass
class Delivery:
    """#delivery{} — sender + message travelling through the broker."""

    sender: str
    message: Message
