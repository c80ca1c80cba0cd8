"""Gauges with high-water marks — parity with
``apps/emqx/src/emqx_stats.erl``.

``setstat(stat, max_stat, val)`` updates a gauge and ratchets its
companion ``*.max``; updater funs registered with ``set_updater`` run on
the housekeeping tick (the reference's periodic ``update_interval``
casts from broker/cm/router helpers).
"""

from __future__ import annotations

from typing import Callable, Optional

NAMES = [
    "connections.count", "connections.max",
    "live_connections.count", "live_connections.max",
    "sessions.count", "sessions.max",
    "topics.count", "topics.max",
    "suboptions.count", "suboptions.max",
    "subscribers.count", "subscribers.max",
    "subscriptions.count", "subscriptions.max",
    "subscriptions.shared.count", "subscriptions.shared.max",
    "retained.count", "retained.max",
    "delayed.count", "delayed.max",
]


class Stats:
    def __init__(self) -> None:
        self._v: dict[str, int] = {n: 0 for n in NAMES}
        self._updaters: dict[str, Callable[[], int]] = {}

    def setstat(self, stat: str, val: int,
                max_stat: Optional[str] = None) -> None:
        self._v[stat] = val
        if max_stat is not None and val > self._v.get(max_stat, 0):
            self._v[max_stat] = val

    def getstat(self, stat: str) -> int:
        return self._v.get(stat, 0)

    def all(self) -> dict[str, int]:
        return dict(self._v)

    def set_updater(self, stat: str, fn: Callable[[], int],
                    max_stat: Optional[str] = None) -> None:
        self._updaters[stat] = fn
        if max_stat is not None:
            self._max_of = getattr(self, "_max_of", {})
            self._max_of[stat] = max_stat

    def tick(self) -> None:
        max_of = getattr(self, "_max_of", {})
        for stat, fn in self._updaters.items():
            try:
                self.setstat(stat, int(fn()), max_of.get(stat))
            except Exception:
                pass
