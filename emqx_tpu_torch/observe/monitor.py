"""Dashboard rate monitor — ``emqx_dashboard_monitor.erl`` analogue.

Periodically samples the broker's counter/gauge surface into a bounded
time-series ring; the dashboard reads back N seconds of history plus a
"current rates" view (deltas per sampling interval → msg/s).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

# counters sampled for rate derivation (matches the reference's
# ?SAMPLER_LIST: received/sent/dropped + conn/sub/topic gauges)
RATE_COUNTERS = ("messages.received", "messages.sent", "messages.dropped")
GAUGES = ("connections.count", "subscriptions.count", "topics.count",
          "retained.count")

DEFAULT_RETENTION_S = 7 * 24 * 3600
DEFAULT_INTERVAL_S = 10.0


class DashboardMonitor:
    def __init__(self, app, interval_s: float = DEFAULT_INTERVAL_S,
                 retention_s: float = DEFAULT_RETENTION_S) -> None:
        self.app = app
        self.interval_s = interval_s
        self.maxlen = max(1, int(retention_s / interval_s))
        self.samples: deque = deque(maxlen=self.maxlen)
        self._last_counters: Optional[dict[str, int]] = None
        self._last_sample_at = 0.0
        self._lock = threading.RLock()

    def _read(self, tick_stats: bool = False
              ) -> tuple[dict[str, int], dict[str, int]]:
        m = self.app.metrics
        counters = {k: m.val(k) for k in RATE_COUNTERS}
        if tick_stats:
            # only when nothing else refreshed the gauges (REST reads);
            # the housekeeping path ticks stats right before monitor.tick
            self.app.stats.tick()
        s = self.app.stats.all()
        gauges = {k: s.get(k, 0) for k in GAUGES}
        return counters, gauges

    def sample(self, now: Optional[float] = None) -> dict:
        """Take one sample (idempotent within the interval via tick())."""
        now = time.time() if now is None else now
        with self._lock:
            counters, gauges = self._read()
            rates = {}
            if self._last_counters is not None:
                dt = max(now - self._last_sample_at, 1e-9)
                for k in RATE_COUNTERS:
                    delta = counters[k] - self._last_counters[k]
                    rates[k.replace("messages.", "") + "_rate"] = round(
                        max(delta, 0) / dt, 3)
            self._last_counters = counters
            self._last_sample_at = now
            point = {"time_stamp": int(now * 1000), **counters, **gauges,
                     **rates}
            self.samples.append(point)
            return point

    def tick(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        if now - self._last_sample_at < self.interval_s:
            return False
        self.sample(now)
        return True

    def history(self, latest_s: Optional[float] = None) -> list[dict]:
        with self._lock:
            if latest_s is None:
                return list(self.samples)
            cutoff = (time.time() - latest_s) * 1000
            return [p for p in self.samples if p["time_stamp"] >= cutoff]

    def current(self) -> dict:
        """The dashboard's headline card: live gauges + latest rates."""
        with self._lock:
            counters, gauges = self._read(tick_stats=True)
            latest = self.samples[-1] if self.samples else {}
            return {
                **counters, **gauges,
                **{k: v for k, v in latest.items() if k.endswith("_rate")},
            }
