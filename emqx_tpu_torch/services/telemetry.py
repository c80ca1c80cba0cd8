"""Telemetry report — ``apps/emqx_modules/src/emqx_telemetry.erl``.

Builds the periodic usage report (uuid, node/OS/version facts, broker
counters, enabled-feature inventory). Phone-home is OFF by default and
the transport is injectable — tests and air-gapped deployments read the
report locally (the reference posts the same JSON to its endpoint).
"""

from __future__ import annotations

import json
import platform
import time
import uuid as _uuid
from typing import Callable, Optional

REPORT_INTERVAL_S = 7 * 24 * 3600        # weekly, like the reference


class Telemetry:
    def __init__(self, app=None, enable: bool = False,
                 send_fn: Optional[Callable[[dict], None]] = None) -> None:
        self.app = app
        self.enable = enable
        self.send_fn = send_fn
        self.uuid = str(_uuid.uuid4())
        self.started_at = time.time()
        self._last_report_at = 0.0
        self.reports_sent = 0

    def build_report(self) -> dict:
        app = self.app
        report = {
            "uuid": self.uuid,
            "emqx_version": "5.0.14-tpu",
            "license": {"edition": "opensource"},
            "os_name": platform.system(),
            "os_version": platform.release(),
            "otp_version": platform.python_version(),   # runtime version
            "up_time": int(time.time() - self.started_at),
            "nodes_uuid": [],
            "active_plugins": [],
            "num_clients": 0,
            "messages_received": 0,
            "messages_sent": 0,
            "build_info": {"arch": platform.machine()},
            "vm_specs": {},
        }
        if app is not None:
            m = app.metrics
            report.update({
                "num_clients": sum(1 for _ in app.cm.all_channels()),
                "messages_received": m.val("messages.received"),
                "messages_sent": m.val("messages.sent"),
                "topic_count": len(app.broker.router.topics()),
                "rule_count": len(getattr(app.rules, "rules", {})),
                "bridge_count": len(getattr(app.bridges, "bridges", {})),
                "gateway_count": len(app.gateway.gateways),
                "retained_count": len(app.retainer),
            })
        return report

    def tick(self, now: Optional[float] = None) -> bool:
        """Send a report when due; returns True if one went out."""
        if not self.enable:
            return False
        now = time.time() if now is None else now
        if now - self._last_report_at < REPORT_INTERVAL_S:
            return False
        self._last_report_at = now
        report = self.build_report()
        if self.send_fn is not None:
            self.send_fn(report)
        self.reports_sent += 1
        return True

    def to_json(self) -> str:
        return json.dumps(self.build_report())
