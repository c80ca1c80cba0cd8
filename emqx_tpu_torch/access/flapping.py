"""Flapping detection — parity with ``apps/emqx/src/emqx_flapping.erl``.

Counts disconnects per clientid in a sliding window; crossing
``max_count`` within ``window_s`` bans the client for ``ban_duration_s``
via the shared ``Banned`` table (the reference bans by clientid with
by="flapping detector").
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from emqx_tpu_torch.access.banned import Banned


class Flapping:
    def __init__(self, banned: Banned, *, max_count: int = 15,
                 window_s: float = 60.0,
                 ban_duration_s: float = 300.0) -> None:
        self.banned = banned
        self.max_count = max_count
        self.window_s = window_s
        self.ban_duration_s = ban_duration_s
        self._events: dict[str, deque[float]] = {}

    def on_disconnect(self, clientid: str,
                      now: Optional[float] = None) -> bool:
        """Record one disconnect; returns True if this tripped a ban."""
        now = time.time() if now is None else now
        dq = self._events.setdefault(clientid, deque())
        dq.append(now)
        while dq and now - dq[0] > self.window_s:
            dq.popleft()
        if len(dq) >= self.max_count:
            self.banned.create(
                "clientid", clientid, by="flapping detector",
                reason=f"flapping: {len(dq)} disconnects in "
                       f"{self.window_s:.0f}s",
                duration_s=self.ban_duration_s)
            dq.clear()
            return True
        return False

    def gc(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        dead = [cid for cid, dq in self._events.items()
                if not dq or now - dq[-1] > self.window_s]
        for cid in dead:
            del self._events[cid]
