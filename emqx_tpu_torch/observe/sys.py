"""$SYS heartbeat topics — parity with ``apps/emqx/src/emqx_sys.erl``.

Publishes retained broker liveness under ``$SYS/brokers[/<node>/...]``
(version/uptime/datetime/sysdescr, emqx_sys.erl:80-120) on a heartbeat
interval, plus stats and metrics trees on a (slower) tick. $SYS messages
are produced broker-internally and routed like any publish — wildcard
root filters never see them ($SYS exclusion in the trie matcher).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from emqx_tpu_torch.core.message import Message

VERSION = "0.1.0"
SYSDESCR = "emqx_tpu broker"


class SysHeartbeat:
    def __init__(self, node: str, publish_fn: Callable[[Message], None],
                 metrics=None, stats=None, ledger=None, kernel=None,
                 heartbeat_s: float = 30.0, tick_s: float = 60.0) -> None:
        self.node = node
        self.publish_fn = publish_fn
        self.metrics = metrics
        self.stats = stats
        self.ledger = ledger    # DegradationLedger, optional
        self.kernel = kernel    # DeviceMetricsFold, optional
        self.heartbeat_s = heartbeat_s
        self.tick_s = tick_s
        self.started_at = time.time()
        self._last_heartbeat = 0.0
        self._last_tick = 0.0

    def uptime_s(self) -> float:
        return time.time() - self.started_at

    def _pub(self, subtopic: str, payload: str) -> None:
        self.publish_fn(Message(
            topic=f"$SYS/brokers/{self.node}/{subtopic}",
            payload=payload.encode(), qos=0, from_="$SYS",
            flags={"retain": True, "sys": True},
        ))

    def heartbeat(self) -> None:
        self.publish_fn(Message(
            topic="$SYS/brokers", payload=self.node.encode(), qos=0,
            from_="$SYS", flags={"retain": True, "sys": True}))
        self._pub("version", VERSION)
        self._pub("sysdescr", SYSDESCR)
        self._pub("uptime", str(int(self.uptime_s())))
        self._pub("datetime",
                  time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime()))

    def publish_stats(self) -> None:
        if self.stats is not None:
            for name, val in self.stats.all().items():
                self._pub(f"stats/{name}", str(val))

    def publish_metrics(self) -> None:
        if self.metrics is not None:
            for name, val in self.metrics.all().items():
                self._pub(f"metrics/{name}", str(val))

    def publish_latency(self) -> None:
        """Latency heartbeat from the telemetry plane's histograms:
        ``$SYS/brokers/<node>/latency/<stage>/p50|p99|p999`` in ms
        (plus ``.../count``). Histogram names like
        ``latency.native.ingress_route`` map to
        ``latency/native/ingress_route``; stages with no observations
        publish nothing."""
        hists = getattr(self.metrics, "hists", None)
        if not callable(hists):
            return
        for name, h in hists().items():
            if h.count <= 0:
                continue
            base = name.replace(".", "/")
            if not base.startswith("latency/"):
                base = "latency/" + base
            for q, v in (("p50", h.percentile(0.5)),
                         ("p99", h.percentile(0.99)),
                         ("p999", h.percentile(0.999))):
                self._pub(f"{base}/{q}", f"{v / 1e6:.3f}")
            self._pub(f"{base}/count", str(int(h.count)))

    def publish_ledger(self) -> None:
        """Degradation-ledger heartbeat:
        ``$SYS/brokers/<node>/ledger/<reason>`` = total decisions per
        reason, plus ``ledger/last`` = the newest structured event —
        the $SYS face of the bounded event ring the mgmt API pages."""
        if self.ledger is None:
            return
        for reason, total in self.ledger.totals().items():
            self._pub(f"ledger/{reason}", str(total))
        recent = self.ledger.recent(1)
        if recent:
            import json

            self._pub("ledger/last", json.dumps(recent[-1]))

    def publish_kernel(self) -> None:
        """Kernel-plane heartbeat:
        ``$SYS/brokers/<node>/kernel/<stage>/p50|p99`` in ms plus
        ``.../count`` for every device-path stage histogram
        (submit/step/decode). Unlike publish_latency this publishes
        UNCONDITIONALLY — a kernel stage that never observed anything
        is itself a signal (the device plane is dark), so the fixed
        stage set renders at zero."""
        if self.kernel is None:
            return
        for stage, h in self.kernel.stage_hists().items():
            for q, v in (("p50", h.percentile(0.5)),
                         ("p99", h.percentile(0.99))):
                self._pub(f"kernel/{stage}/{q}", f"{v / 1e6:.3f}")
            self._pub(f"kernel/{stage}/count", str(int(h.count)))

    def tick(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if now - self._last_heartbeat >= self.heartbeat_s:
            self._last_heartbeat = now
            self.heartbeat()
        if now - self._last_tick >= self.tick_s:
            self._last_tick = now
            self.publish_stats()
            self.publish_metrics()
            self.publish_latency()
            self.publish_ledger()
            self.publish_kernel()
