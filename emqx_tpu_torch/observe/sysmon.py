"""OS / runtime monitors — ``emqx_os_mon.erl`` / ``emqx_vm_mon.erl`` /
``emqx_sys_mon.erl`` analogues.

Watermark checks over /proc (CPU busy fraction, memory use, open fds vs
limit) plus runtime signals (event-loop lag from Olp, GC pressure) raised
as edge-triggered alarms through the AlarmManager — the same
alarm-name surface the reference exposes (``high_cpu_usage``,
``high_system_memory_usage``, ``too_many_processes`` → here fd exhaustion).
"""

from __future__ import annotations

import os
import time
from typing import Optional


def _read_proc_stat() -> Optional[tuple[int, int]]:
    """(busy_jiffies, total_jiffies) from /proc/stat, None off-Linux."""
    try:
        with open("/proc/stat", "r", encoding="ascii") as fh:
            parts = fh.readline().split()
    except OSError:
        return None
    if parts[0] != "cpu" or len(parts) < 5:
        return None
    vals = [int(x) for x in parts[1:11]]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0)   # idle + iowait
    return sum(vals) - idle, sum(vals)


def _read_mem_fraction() -> Optional[float]:
    try:
        with open("/proc/meminfo", "r", encoding="ascii") as fh:
            info = {}
            for line in fh:
                k, _, v = line.partition(":")
                info[k] = int(v.split()[0])
    except (OSError, ValueError, IndexError):
        return None
    total = info.get("MemTotal")
    avail = info.get("MemAvailable")
    if not total or avail is None:
        return None
    return 1.0 - avail / total


def _read_fd_fraction() -> Optional[float]:
    try:
        n_open = len(os.listdir("/proc/self/fd"))
        import resource

        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    except (OSError, ImportError, ValueError):
        return None
    if soft <= 0:
        return None
    return n_open / soft


class SysMon:
    """Periodic watermark checks → alarms (edge-triggered via ensure)."""

    def __init__(self, alarms, *, olp=None,
                 cpu_high: float = 0.80, cpu_low: float = 0.60,
                 mem_high: float = 0.70,
                 fd_high: float = 0.85,
                 interval_s: float = 60.0) -> None:
        self.alarms = alarms
        self.olp = olp
        self.cpu_high, self.cpu_low = cpu_high, cpu_low
        self.mem_high = mem_high
        self.fd_high = fd_high
        self.interval_s = interval_s
        self._last_check = 0.0
        self._last_stat = _read_proc_stat()
        self._cpu_alarm = False

    def check(self) -> dict:
        """One pass; returns the readings (for /api and tests)."""
        readings: dict = {}
        stat = _read_proc_stat()
        if stat is not None and self._last_stat is not None:
            dbusy = stat[0] - self._last_stat[0]
            dtotal = stat[1] - self._last_stat[1]
            if dtotal > 0:
                cpu = dbusy / dtotal
                readings["cpu"] = cpu
                # hysteresis like the reference's cpu_high/low watermarks
                if cpu >= self.cpu_high:
                    self._cpu_alarm = True
                elif cpu <= self.cpu_low:
                    self._cpu_alarm = False
                self.alarms.ensure(
                    "high_cpu_usage", self._cpu_alarm,
                    message=f"cpu {cpu:.0%} (high={self.cpu_high:.0%})")
        self._last_stat = stat

        mem = _read_mem_fraction()
        if mem is not None:
            readings["mem"] = mem
            self.alarms.ensure(
                "high_system_memory_usage", mem >= self.mem_high,
                message=f"mem {mem:.0%} (high={self.mem_high:.0%})")

        fds = _read_fd_fraction()
        if fds is not None:
            readings["fds"] = fds
            self.alarms.ensure(
                "too_many_open_files", fds >= self.fd_high,
                message=f"fds {fds:.0%} of rlimit")

        if self.olp is not None:
            readings["loop_lag_ms"] = self.olp.lag_ms
            # the long_schedule analogue: sustained event-loop lag
            self.alarms.ensure(
                "runtime_overloaded", self.olp.is_overloaded(),
                message=f"event-loop lag {self.olp.lag_ms:.0f}ms")
        return readings

    def tick(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        if now - self._last_check < self.interval_s:
            return False
        self._last_check = now
        self.check()
        return True
