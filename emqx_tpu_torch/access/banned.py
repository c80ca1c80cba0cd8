"""Ban table — parity with ``apps/emqx/src/emqx_banned.erl``.

Bans keyed by ``(kind, value)`` where kind ∈ clientid | username |
peerhost, each with an ``until`` deadline (None = forever). ``check``
runs at CONNECT (emqx_channel calls emqx_banned:check/1 before authn);
expired entries lazily removed (the reference also sweeps on a timer —
``expire()`` is that sweep, driven by the app housekeeping tick).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

KINDS = ("clientid", "username", "peerhost")


@dataclass
class BanEntry:
    kind: str
    value: str
    by: str = "admin"
    reason: str = ""
    at: float = field(default_factory=time.time)
    until: Optional[float] = None          # unix seconds; None = forever


class Banned:
    def __init__(self) -> None:
        self._t: dict[tuple[str, str], BanEntry] = {}

    def create(self, kind: str, value: str, *, by: str = "admin",
               reason: str = "", duration_s: Optional[float] = None,
               until: Optional[float] = None) -> BanEntry:
        if kind not in KINDS:
            raise ValueError(f"bad ban kind {kind!r}")
        if duration_s is not None:
            until = time.time() + duration_s
        entry = BanEntry(kind, value, by=by, reason=reason, until=until)
        self._t[(kind, value)] = entry
        return entry

    def delete(self, kind: str, value: str) -> bool:
        return self._t.pop((kind, value), None) is not None

    def look_up(self, kind: str, value: str) -> Optional[BanEntry]:
        e = self._t.get((kind, value))
        if e is not None and e.until is not None and time.time() >= e.until:
            del self._t[(kind, value)]
            return None
        return e

    def all(self) -> list[BanEntry]:
        self.expire()
        return list(self._t.values())

    def check(self, clientinfo: dict) -> bool:
        """True if the client is banned (emqx_banned:check/1)."""
        peer = (clientinfo.get("peername") or "").rsplit(":", 1)[0]
        return any((
            self.look_up("clientid", clientinfo.get("clientid") or ""),
            self.look_up("username", clientinfo.get("username") or ""),
            self.look_up("peerhost", peer),
        ))

    def expire(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        dead = [k for k, e in self._t.items()
                if e.until is not None and now >= e.until]
        for k in dead:
            del self._t[k]
