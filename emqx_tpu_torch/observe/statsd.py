"""Statsd push — ``apps/emqx_statsd/`` analogue.

Flattens the same metric surface Prometheus exports into statsd gauge
lines (``emqx.<name>:<value>|g``) and pushes them over UDP on a flush
interval. The socket is injectable so tests capture lines without a
collector.
"""

from __future__ import annotations

import socket
import time
from typing import Callable, Optional


def render_lines(metrics, stats, prefix: str = "emqx") -> list[str]:
    lines = []
    for name, val in metrics.all().items():
        lines.append(f"{prefix}.{name}:{val}|g")
    for name, val in stats.all().items():
        lines.append(f"{prefix}.{name}:{val}|g")
    return lines


class StatsdPusher:
    def __init__(self, app, host: str = "127.0.0.1", port: int = 8125,
                 flush_interval_s: float = 30.0, prefix: str = "emqx",
                 enable: bool = False,
                 send_fn: Optional[Callable[[bytes], None]] = None) -> None:
        self.app = app
        self.addr = (host, port)
        self.flush_interval_s = flush_interval_s
        self.prefix = prefix
        self.enable = enable
        self._send_fn = send_fn
        self._sock: Optional[socket.socket] = None
        self._last_flush = 0.0
        self.pushes = 0

    def _send(self, payload: bytes) -> None:
        if self._send_fn is not None:
            self._send_fn(payload)
            return
        if self._sock is None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self._sock.sendto(payload, self.addr)
        except OSError:
            pass                          # fire-and-forget, like statsd

    def flush(self) -> int:
        """Push one datagram batch; returns number of lines."""
        self.app.stats.tick()
        lines = render_lines(self.app.metrics, self.app.stats, self.prefix)
        # statsd datagrams should stay under the MTU: chunk by ~1400B
        chunk: list[str] = []
        size = 0
        for line in lines:
            if size + len(line) + 1 > 1400 and chunk:
                self._send("\n".join(chunk).encode())
                chunk, size = [], 0
            chunk.append(line)
            size += len(line) + 1
        if chunk:
            self._send("\n".join(chunk).encode())
        self.pushes += 1
        return len(lines)

    def tick(self, now: Optional[float] = None) -> bool:
        if not self.enable:
            return False
        now = time.monotonic() if now is None else now
        if now - self._last_flush < self.flush_interval_s:
            return False
        self._last_flush = now
        self.flush()
        return True

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
