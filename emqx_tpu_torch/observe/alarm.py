"""Alarms — parity with ``apps/emqx/src/emqx_alarm.erl``.

Activate/deactivate named alarms with details; deactivated alarms move
to a bounded history (the reference's mnesia ``emqx_deactivated_alarm``
with validity sweep). An optional publish hook mirrors the reference's
``alarm.activated``/``alarm.deactivated`` $SYS messages.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Alarm:
    name: str
    details: dict = field(default_factory=dict)
    message: str = ""
    activate_at: float = field(default_factory=time.time)
    deactivate_at: Optional[float] = None


class AlarmManager:
    def __init__(self, history_size: int = 1000,
                 on_change: Optional[Callable[[str, Alarm], None]] = None
                 ) -> None:
        self._active: dict[str, Alarm] = {}
        self._history: list[Alarm] = []
        self.history_size = history_size
        self.on_change = on_change

    def activate(self, name: str, details: Optional[dict] = None,
                 message: str = "") -> bool:
        """→ False if already active (reference returns
        {error, already_existed})."""
        if name in self._active:
            return False
        alarm = Alarm(name, details or {}, message or name)
        self._active[name] = alarm
        if self.on_change:
            self.on_change("activated", alarm)
        return True

    def deactivate(self, name: str) -> bool:
        alarm = self._active.pop(name, None)
        if alarm is None:
            return False
        alarm.deactivate_at = time.time()
        self._history.append(alarm)
        del self._history[:-self.history_size]
        if self.on_change:
            self.on_change("deactivated", alarm)
        return True

    def ensure(self, name: str, active: bool,
               details: Optional[dict] = None, message: str = "") -> None:
        """Idempotent edge-trigger helper used by monitors."""
        if active:
            self.activate(name, details, message)
        else:
            self.deactivate(name)

    def is_active(self, name: str) -> bool:
        return name in self._active

    def get_alarms(self, which: str = "all") -> list[Alarm]:
        if which == "activated":
            return list(self._active.values())
        if which == "deactivated":
            return list(self._history)
        return list(self._active.values()) + list(self._history)

    def delete_all_deactivated(self) -> None:
        self._history.clear()
