"""Client/topic trace — the ``apps/emqx/src/emqx_trace/`` analogue.

The reference installs filtered ``logger_disk_log_h`` handlers per trace
(filter_clientid | filter_topic | filter_ip_address,
emqx_trace_handler.erl:89-145) over scheduled start/stop records kept in
mnesia (emqx_trace.erl:152,295-364). Here each trace is a filter + ring
buffer (optionally mirrored to a file) fed from the broker hookpoints;
the management API exposes list/start/stop/download.

Device note: device-side match batches are traced at batch granularity by
the router model's stats; this module covers the host-side per-client
flight recorder the operator actually greps.
"""

from __future__ import annotations

import contextvars as _contextvars
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from emqx_tpu_torch.core import topic as T


@dataclass
class Trace:
    name: str
    filter_type: str            # clientid | topic | ip_address
    filter_value: str
    start_at: float
    end_at: Optional[float] = None          # None = until stopped
    status: str = "running"                 # running | stopped
    max_lines: int = 10_000
    # clientid traces only: "punt" forces the traced conn's
    # publishes through the Python plane (full hook fidelity — every
    # message logged, at slow-path cost); "native" keeps the conn on
    # the fast path and logs the 1-in-N SAMPLED publishes' span
    # timelines instead (SPAN lines fed by the native server), so
    # tracing a production workload no longer turns off the thing
    # being observed.
    mode: str = "punt"
    lines: deque = field(default_factory=deque)

    def matches(self, clientid: str, topic: Optional[str],
                peername: str) -> bool:
        if self.filter_type == "clientid":
            return clientid == self.filter_value
        if self.filter_type == "topic":
            return topic is not None and T.match(topic, self.filter_value)
        if self.filter_type == "ip_address":
            return peername.split(":")[0] == self.filter_value
        return False

    def log(self, event: str, detail: str) -> None:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        self.lines.append(f"{ts} [{event}] {detail}")
        while len(self.lines) > self.max_lines:
            self.lines.popleft()


class TraceManager:
    """Start/stop-scheduled traces fed from hookpoints."""

    def __init__(self, max_traces: int = 32) -> None:
        self.max_traces = max_traces
        self.traces: dict[str, Trace] = {}
        self._lock = threading.RLock()
        # fired after start/stop/delete — the native host flushes its
        # publish permits here so a new trace sees topics that were
        # already on the fast path (broker/native_server.py); without
        # this a fresh trace could miss up to permit-TTL of messages
        self.on_topology_change: list = []

    # -- lifecycle -----------------------------------------------------------

    def start(self, name: str, filter_type: str, filter_value: str,
              duration_s: Optional[float] = None,
              mode: str = "punt") -> Trace:
        if filter_type not in ("clientid", "topic", "ip_address"):
            raise ValueError(f"bad trace filter type {filter_type}")
        if mode not in ("punt", "native"):
            raise ValueError(f"bad trace mode {mode}")
        with self._lock:
            if name in self.traces:
                raise ValueError(f"trace {name} already exists")
            if len(self.traces) >= self.max_traces:
                raise ValueError("too many traces")
            now = time.time()
            tr = Trace(name=name, filter_type=filter_type,
                       filter_value=filter_value, start_at=now,
                       end_at=now + duration_s if duration_s else None,
                       mode=mode)
            self.traces[name] = tr
        for cb in self.on_topology_change:
            cb()
        return tr

    def stop(self, name: str) -> bool:
        with self._lock:
            tr = self.traces.get(name)
            if tr is None:
                return False
            tr.status = "stopped"
        for cb in self.on_topology_change:
            cb()
        return True

    def running(self) -> list:
        """Snapshot of running traces — safe to iterate off-thread
        (the permit-grant path reads this from the broker poll loop
        while REST threads mutate the table)."""
        with self._lock:
            return [t for t in self.traces.values()
                    if t.status == "running"]

    def delete(self, name: str) -> bool:
        with self._lock:
            hit = self.traces.pop(name, None) is not None
        if hit:
            for cb in self.on_topology_change:
                cb()
        return hit

    def list(self) -> list[dict]:
        with self._lock:
            return [{
                "name": t.name, "type": t.filter_type,
                "value": t.filter_value, "status": t.status,
                "mode": t.mode, "lines": len(t.lines),
            } for t in self.traces.values()]

    def log_lines(self, name: str) -> list[str]:
        with self._lock:
            tr = self.traces.get(name)
            return list(tr.lines) if tr else []

    def tick(self, now: Optional[float] = None) -> None:
        """Expire scheduled traces (the reference's trace scheduler)."""
        now = time.time() if now is None else now
        expired = 0
        with self._lock:
            for tr in self.traces.values():
                if (tr.status == "running" and tr.end_at is not None
                        and now >= tr.end_at):
                    tr.status = "stopped"
                    expired += 1
        if expired:
            # same eager flush as an explicit stop(): the slow-path
            # penalty must not outlive the trace by a permit TTL
            for cb in self.on_topology_change:
                cb()

    # -- event feed (hook callbacks) -----------------------------------------

    def log_for_client(self, clientid: str, event: str,
                       detail: str) -> None:
        """Append one line to every running clientid trace matching
        ``clientid`` — the native plane's entry point for attaching a
        connection's flight-recorder tail (broker/native_server.py
        _on_telemetry) to the trace the operator is watching."""
        for tr in self.running():
            if (tr.filter_type == "clientid"
                    and tr.filter_value == clientid):
                tr.log(event, detail)

    def _active(self):
        return self.running()

    def trace(self, event: str, clientid: str, topic: Optional[str],
              peername: str, detail: str) -> None:
        for tr in self._active():
            if tr.matches(clientid, topic, peername):
                tr.log(event, detail)

    def attach(self, hooks) -> None:
        """Wire onto the standard hookpoints (?TRACE call sites:
        emqx_broker.erl:224 publish, channel connect/subscribe)."""
        hooks.add("message.publish", self._on_publish, priority=-900)
        hooks.add("client.connected", self._on_connected, priority=-900)
        hooks.add("client.disconnected", self._on_disconnected,
                  priority=-900)
        hooks.add("session.subscribed", self._on_subscribed, priority=-900)
        hooks.add("session.unsubscribed", self._on_unsubscribed,
                  priority=-900)

    def _on_publish(self, msg):
        if not msg.sys:
            self.trace("PUBLISH", msg.from_, msg.topic,
                       str(msg.headers.get("peername", "")),
                       f"{msg.topic} qos{msg.qos} {len(msg.payload)}B")
        return None

    def _on_connected(self, ci) -> None:
        cid = getattr(ci, "clientid", None) or (
            ci.get("clientid", "") if isinstance(ci, dict) else "")
        peer = getattr(ci, "peername", None) or (
            ci.get("peername", "") if isinstance(ci, dict) else "")
        self.trace("CONNECT", cid, None, str(peer), f"client {cid} up")

    def _on_disconnected(self, ci, reason) -> None:
        cid = getattr(ci, "clientid", None) or (
            ci.get("clientid", "") if isinstance(ci, dict) else "")
        peer = getattr(ci, "peername", None) or (
            ci.get("peername", "") if isinstance(ci, dict) else "")
        self.trace("DISCONNECT", cid, None, str(peer),
                   f"client {cid} down: {reason}")

    def _on_subscribed(self, sid, topic, opts, is_new=True) -> None:
        self.trace("SUBSCRIBE", sid, topic, "", f"{sid} subscribed {topic}")

    def _on_unsubscribed(self, sid, topic) -> None:
        self.trace("UNSUBSCRIBE", sid, topic, "",
                   f"{sid} unsubscribed {topic}")


# ---------------------------------------------------------------------------
# distributed-tracing span collector

# The publish path's one clock: the pipeline's, broker's, CM's and
# model's spans and the kernel fold's span points all read it.  On Linux
# it is CLOCK_MONOTONIC, the clock of the native plane's span points, so
# both planes' timestamps lie on one timeline.
now_ns = time.perf_counter_ns

# the batch trace of the delivery running on this thread or task: the CM's
# dispatch takes only the deliveries, so the pipeline hands the batch's
# trace to it here (``with trace:``)
_ACTIVE: "_contextvars.ContextVar[Optional[BatchTrace]]" = \
    _contextvars.ContextVar("emqx_batch_trace", default=None)


class BatchTrace:
    """One publish batch's trace: the id the pipeline gave the batch, the
    ids of its messages (``SpanCollector.find`` looks a message up by its
    id), its interval spans ``(name, t0_ns, t1_ns, n)`` on :data:`now_ns`
    and its named counters.  The stages of the batch fill it as they run,
    on the pipeline's consumer thread; ``PublishPipeline`` commits it to the
    span ring once the batch is delivered.  Inside ``with trace:`` it is
    the :func:`active_batch` of the thread or task.

    Where a batch trace is passed, the stages see one of three values:
    a ``BatchTrace`` (the batch is traced), ``False`` (the pipeline samples
    batches and left this one out) or ``None`` (nothing upstream samples:
    the kernel fold samples the model's batches itself)."""

    __slots__ = ("trace_id", "msg_ids", "spans", "counters", "_token")

    def __init__(self, trace_id: int, msg_ids: list) -> None:
        self.trace_id = trace_id
        self.msg_ids = msg_ids
        self.spans: list[tuple[str, int, int, int]] = []
        self.counters: dict[str, int] = {}
        self._token = None

    def __enter__(self) -> "BatchTrace":
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._token)

    def span(self, name: str, t0_ns: int, t1_ns: int, n: int = 0) -> None:
        """One stage of the batch, from ``t0_ns`` to ``t1_ns``, over ``n``
        items (the batch's messages, or the CM's sessions)."""
        self.spans.append((name, t0_ns, t1_ns, n))


def active_batch() -> Optional[BatchTrace]:
    """The batch trace of the delivery running here, or None."""
    return _ACTIVE.get()


class SpanCollector:
    """Stitches kind-12 span events (and Python-emitted replay spans)
    into per-message timelines, and keeps the publish pipeline's batch
    traces beside them.

    A sampled publish's 64-bit trace id propagates through every native
    seam — cross-shard ring entries, trunk BATCH records, durable
    MSG-BATCH records — and each plane emits compact span points
    (stage, t_ns, shard, aux). This class assembles them, bounded to
    the last ``max_traces`` distinct ids (the queryable span ring the
    mgmt API serves). Thread-safe: N poll threads feed it when sharded.

    Span tuples are ``(t_ns, stage, shard, node, aux)``; the native
    plane's t_ns is CLOCK_MONOTONIC, so ordering is meaningful per machine
    (and across the in-process multi-node tests).  A pipeline batch's
    trace (:class:`BatchTrace`, committed whole by ``commit``) shares the
    ring and its id with the kernel fold's points for that batch; its
    spans and those points read :data:`now_ns`, the same clock on Linux."""

    def __init__(self, max_traces: int = 512,
                 max_spans_per_trace: int = 64) -> None:
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._traces: "dict[int, list]" = {}
        self._batches: "dict[int, BatchTrace]" = {}
        self._order: deque = deque()
        self._lock = threading.Lock()

    def _admit(self, trace_id: int) -> list:
        """The point list of ``trace_id``, made (and the oldest traces
        evicted past ``max_traces``) when new.  Holds the lock."""
        spans = self._traces.get(trace_id)
        if spans is None:
            spans = self._traces[trace_id] = []
            self._order.append(trace_id)
            self._evict()
        return spans

    def _evict(self) -> None:
        while len(self._order) > self.max_traces:
            old = self._order.popleft()
            self._traces.pop(old, None)
            self._batches.pop(old, None)

    def record(self, trace_id: int, stage: str, t_ns: int,
               shard: int = 0, aux: int = 0, node: str = "") -> None:
        with self._lock:
            spans = self._admit(trace_id)
            if len(spans) >= self.max_spans_per_trace:
                return      # a megafan-out must not grow one timeline
            spans.append((int(t_ns), stage, int(shard), node, int(aux)))

    def commit(self, batch: BatchTrace) -> None:
        """Keep a finished batch trace under its id."""
        with self._lock:
            self._admit(batch.trace_id)
            self._batches[batch.trace_id] = batch

    def resize(self, max_traces: int) -> None:
        """Keep the newest ``max_traces`` traces from now on."""
        with self._lock:
            self.max_traces = max(1, int(max_traces))
            self._evict()

    def trace(self, trace_id: int) -> list:
        """One assembled timeline, sorted by t_ns ([] = unknown id)."""
        with self._lock:
            return sorted(self._traces.get(trace_id, ()))

    def stages(self, trace_id: int) -> list:
        """The stage names of one timeline in t_ns order."""
        return [s for _t, s, _sh, _n, _a in self.trace(trace_id)]

    def batch(self, trace_id: int) -> Optional[BatchTrace]:
        """The committed batch trace of ``trace_id``, or None."""
        with self._lock:
            return self._batches.get(trace_id)

    def batches(self) -> list:
        """The committed batch traces in the ring, oldest first."""
        with self._lock:
            return [self._batches[t] for t in self._order
                    if t in self._batches]

    def find(self, msg_id: int) -> Optional[BatchTrace]:
        """The newest batch trace in the ring that carried message
        ``msg_id``, or None."""
        for batch in reversed(self.batches()):
            if msg_id in batch.msg_ids:
                return batch
        return None

    def recent(self, limit: int = 32) -> list:
        """Newest-first ``(trace_id, sorted spans)`` pairs."""
        limit = max(1, int(limit))   # a negative slice would invert
        with self._lock:
            ids = list(self._order)[-limit:][::-1]
            return [(tid, sorted(self._traces.get(tid, ())))
                    for tid in ids]

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)
