"""Overload protection, forced GC, and congestion alarms — the
``emqx_olp.erl`` (+ `lc` dep), ``emqx_gc.erl`` and ``emqx_congestion.erl``
analogues.

The reference watches BEAM run-queue pressure and then sheds load by
skipping hibernation/GC and refusing new connections
(emqx_olp:backoff_new_conn/1). Our load signal is event-loop lag: the
housekeeping timer knows when it *should* have fired; the drift is the
Python-side run-queue. The native (C++) host reports its poll-loop lag
through the same interface.
"""

from __future__ import annotations

import gc as _pygc
import time
from typing import Optional


class Olp:
    """Load flags from loop lag; consumers ask before doing optional work."""

    def __init__(self, enable: bool = True,
                 backoff_delay_ms: float = 100.0,
                 backoff_new_conn: bool = True,
                 backoff_hibernation: bool = True,
                 backoff_gc: bool = True) -> None:
        self.enable = enable
        self.backoff_delay_ms = backoff_delay_ms
        self._flag_new_conn = backoff_new_conn
        self._flag_hib = backoff_hibernation
        self._flag_gc = backoff_gc
        self.lag_ms = 0.0
        self._overloaded = False

    def note_lag(self, lag_ms: float) -> None:
        """Feed the measured scheduling drift (EWMA-smoothed)."""
        self.lag_ms = 0.7 * self.lag_ms + 0.3 * max(0.0, lag_ms)
        self._overloaded = self.enable and self.lag_ms > self.backoff_delay_ms

    def is_overloaded(self) -> bool:
        return self._overloaded

    def backoff_new_conn(self) -> bool:
        """True → refuse the incoming connection at accept."""
        return self._overloaded and self._flag_new_conn

    def backoff_hibernation(self) -> bool:
        return self._overloaded and self._flag_hib

    def backoff_gc(self) -> bool:
        return self._overloaded and self._flag_gc


class GcPolicy:
    """Force a collection every N messages / bytes per connection
    (emqx_gc:run/3 — zone config ``force_gc``)."""

    def __init__(self, count: int = 16000, bytes_: int = 16 * 1024 * 1024,
                 enable: bool = True) -> None:
        self.enable = enable
        self.count_budget = count
        self.bytes_budget = bytes_
        self._count = count
        self._bytes = bytes_

    def note(self, msgs: int, nbytes: int,
             olp: Optional[Olp] = None) -> bool:
        """Returns True if a collection ran."""
        if not self.enable:
            return False
        self._count -= msgs
        self._bytes -= nbytes
        if self._count > 0 and self._bytes > 0:
            return False
        self._count = self.count_budget
        self._bytes = self.bytes_budget
        if olp is not None and olp.backoff_gc():
            return False        # overloaded: skip optional GC
        _pygc.collect(0)        # young generation only, like the per-proc GC
        return True


class Congestion:
    """TCP congestion alarms: socket send buffer persistently above the
    high watermark → alarm; clears below the low watermark
    (emqx_congestion.erl)."""

    def __init__(self, alarms=None, high_watermark: int = 1 << 20,
                 low_watermark: int = 1 << 16,
                 min_alarm_sustain_s: float = 1.0) -> None:
        self.alarms = alarms
        self.high = high_watermark
        self.low = low_watermark
        self.sustain_s = min_alarm_sustain_s
        self._over_since: dict[str, float] = {}
        self.congested: set[str] = set()

    def check(self, conn_id: str, buffered: int,
              now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if buffered >= self.high:
            since = self._over_since.setdefault(conn_id, now)
            if (now - since >= self.sustain_s
                    and conn_id not in self.congested):
                self.congested.add(conn_id)
                if self.alarms is not None:
                    self.alarms.activate(
                        f"conn_congestion/{conn_id}",
                        message=f"send buffer {buffered}B > {self.high}B")
        else:
            # below high: the sustain clock resets (must be continuously
            # over the watermark); the ALARM clears only under the low
            # watermark (hysteresis band keeps it active in between)
            self._over_since.pop(conn_id, None)
            if buffered <= self.low and conn_id in self.congested:
                self.congested.discard(conn_id)
                if self.alarms is not None:
                    self.alarms.deactivate(f"conn_congestion/{conn_id}")

    def forget(self, conn_id: str) -> None:
        self._over_since.pop(conn_id, None)
        if conn_id in self.congested:
            self.congested.discard(conn_id)
            if self.alarms is not None:
                self.alarms.deactivate(f"conn_congestion/{conn_id}")
