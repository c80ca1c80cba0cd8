"""Resource behaviour + manager FSM — parity with
``apps/emqx_resource/src/emqx_resource_manager.erl``.

A *resource* is a managed client to an external system (HTTP service,
remote broker, database). The manager owns its lifecycle FSM:

    connecting ⇄ connected → disconnected → (retry) connecting
                    ↓
                 stopped

- ``start()`` runs ``on_start``; failure leaves the resource
  ``connecting`` and retried with backoff (the reference's
  auto_restart_interval).
- ``health_check()`` (driven by the app tick, like the reference's
  health_check_interval timer) probes ``on_health_check``; a failure
  flips connected → disconnected and schedules reconnect.
- queries route through a BufferWorker (worker.py), which asks the
  manager for the live resource and backs off while it is down.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Optional

log = logging.getLogger(__name__)


class Resource:
    """The behaviour (-callback on_start/on_stop/on_query/... of
    emqx_resource.erl). Subclasses raise on failure."""

    def on_start(self, conf: dict) -> None:
        raise NotImplementedError

    def on_stop(self) -> None:
        pass

    def on_query(self, req: Any) -> Any:
        raise NotImplementedError

    def on_batch_query(self, reqs: list) -> list:
        return [self.on_query(r) for r in reqs]

    def on_health_check(self) -> bool:
        return True


class ResourceManager:
    def __init__(self, id: str, resource: Resource, conf: Optional[dict] = None,
                 *, auto_restart_s: float = 2.0,
                 health_check_s: float = 15.0) -> None:
        self.id = id
        self.resource = resource
        self.conf = conf or {}
        self.auto_restart_s = auto_restart_s
        self.health_check_s = health_check_s
        self.state = "stopped"
        self.error: Optional[str] = None
        self._next_retry_at = 0.0
        self._next_health_at = 0.0

    # -- lifecycle -----------------------------------------------------------

    def start(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        try:
            self.resource.on_start(self.conf)
        except Exception as e:
            self.state = "connecting"
            self.error = str(e)
            self._next_retry_at = now + self.auto_restart_s
            log.warning("resource %s failed to start: %s", self.id, e)
            return False
        self.state = "connected"
        self.error = None
        self._next_health_at = now + self.health_check_s
        return True

    def stop(self) -> None:
        if self.state != "stopped":
            try:
                self.resource.on_stop()
            except Exception:
                log.exception("resource %s on_stop failed", self.id)
            self.state = "stopped"

    def restart(self) -> bool:
        self.stop()
        return self.start()

    # -- periodic (app tick) -------------------------------------------------

    def tick(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self.state == "connecting" and now >= self._next_retry_at:
            self.start(now)
        elif self.state == "connected" and now >= self._next_health_at:
            self.health_check(now)
        elif self.state == "disconnected" and now >= self._next_retry_at:
            self.start(now)

    def health_check(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._next_health_at = now + self.health_check_s
        try:
            ok = self.resource.on_health_check()
        except Exception as e:
            ok, self.error = False, str(e)
        if not ok and self.state == "connected":
            self.state = "disconnected"
            self._next_retry_at = now + self.auto_restart_s
            log.warning("resource %s went down: %s", self.id, self.error)
        return ok

    # -- query surface (used by BufferWorker) --------------------------------

    @property
    def connected(self) -> bool:
        return self.state == "connected"

    def query(self, req: Any) -> Any:
        if not self.connected:
            raise ConnectionError(f"resource {self.id} is {self.state}")
        return self.resource.on_query(req)

    def batch_query(self, reqs: list) -> list:
        if not self.connected:
            raise ConnectionError(f"resource {self.id} is {self.state}")
        return self.resource.on_batch_query(reqs)

    def status(self) -> dict:
        return {"id": self.id, "status": self.state, "error": self.error}
