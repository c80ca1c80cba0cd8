"""Fixed-slot metric counters — parity with
``apps/emqx/src/emqx_metrics.erl``.

The reference allocates one BEAM ``counters`` array (C, per-scheduler
striped) at boot with a fixed name→index map kept in ``persistent_term``
(emqx_metrics.erl:338-384,541-542). Here: one numpy int64 array + a
frozen name→slot dict built at construction; ``inc`` is a single
in-place array add under the GIL. Dynamic late registration appends to a
spillover dict (the reference forbids it; we allow it for rule/bridge
metrics which the reference hosts in emqx_metrics_worker instead — see
``MetricsWorker`` below).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterable, Optional

import numpy as np

# emqx_metrics.hrl name set (bytes/packets/messages/delivery/client/
# session/authz slices), trimmed of reserved-for-future slots
BYTES = ["bytes.received", "bytes.sent"]
PACKETS = [
    "packets.received", "packets.sent",
    "packets.connect.received", "packets.connack.sent",
    "packets.publish.received", "packets.publish.sent",
    "packets.publish.error", "packets.publish.auth_error",
    "packets.publish.dropped",
    "packets.puback.received", "packets.puback.sent",
    "packets.puback.missed",
    "packets.pubrec.received", "packets.pubrec.sent",
    "packets.pubrec.missed",
    "packets.pubrel.received", "packets.pubrel.sent",
    "packets.pubrel.missed",
    "packets.pubcomp.received", "packets.pubcomp.sent",
    "packets.pubcomp.missed",
    "packets.subscribe.received", "packets.suback.sent",
    "packets.subscribe.error", "packets.subscribe.auth_error",
    "packets.unsubscribe.received", "packets.unsuback.sent",
    "packets.unsubscribe.error",
    "packets.pingreq.received", "packets.pingresp.sent",
    "packets.disconnect.received", "packets.disconnect.sent",
    "packets.auth.received", "packets.auth.sent",
    "packets.connect.error", "packets.connect.auth_error",
]
MESSAGES = [
    "messages.received", "messages.sent",
    "messages.qos0.received", "messages.qos0.sent",
    "messages.qos1.received", "messages.qos1.sent",
    "messages.qos2.received", "messages.qos2.sent",
    "messages.publish", "messages.dropped",
    "messages.dropped.await_pubrel_timeout", "messages.dropped.no_subscribers",
    "messages.forward", "messages.retained", "messages.delayed",
    "messages.delivered", "messages.acked",
    # forward-lane split: .native counts trunked
    # legs (C++ trunk plane, folded by native_server._merge_fast_
    # metrics), .slow the Python forward_fn lane; messages.forward
    # stays the total. Fixed slots so both render at zero and ride the
    # $SYS metrics heartbeat before the first cross-node leg.
    "messages.forward.native", "messages.forward.slow",
]
DELIVERY = [
    "delivery.dropped", "delivery.dropped.no_local",
    "delivery.dropped.too_large", "delivery.dropped.qos0_msg",
    "delivery.dropped.queue_full", "delivery.dropped.expired",
]
# native (below-the-GIL) fast-path counters, folded in batches by
# broker/native_server.py: per-qos publish splits, batched ack-plane
# completions, and the per-topic device-lane overload drop (distinct
# from delivery backpressure by design)
NATIVE = [
    "messages.native.received",
    "messages.native.qos1.received", "messages.native.qos2.received",
    "messages.native.acked",
    "messages.native.lane_topic_overflow",
    # device-path batches served from the host oracle after a model
    # failure (broker._device_failover) — a fixed slot so it renders at
    # zero in prometheus/$SYS instead of appearing only after the first
    # failover
    "messages.device_failover",
    # durable-session plane: .stored counts markers written
    # for publishes the C++ host persisted below the GIL (kind-10
    # reconciliation), .replayed counts messages drained from the
    # native store on clean_start=false resume, .settled counts
    # markers spent at the SETTLE seam — subscriber ack / qos0 write /
    # final drop, the consume-on-ack contract. Fixed slots:
    # all render at zero and ride the $SYS metrics heartbeat.
    "messages.durable.stored", "messages.durable.replayed",
    "messages.durable.settled",
    # degradation ledger: one fixed slot per ladder-decision
    # reason (DegradationLedger folds both the C++ kind-12 ledger
    # entries and the Python-plane decisions here), so every reason
    # renders at zero in prometheus and rides the $SYS heartbeat before
    # the first degradation ever happens.
    "messages.ledger.ring_full", "messages.ledger.trunk_punt",
    "messages.ledger.shed", "messages.ledger.fault",
    "messages.ledger.accept_shed", "messages.ledger.coap_giveup",
    "messages.ledger.device_failover",
    "messages.ledger.store_degraded",
    # conn-scale plane: hibernation + accept-storm shedding.
    # Cumulative event counters folded from the host's stat slots by
    # native_server._merge_fast_metrics — fixed so all three render at
    # zero and ride the $SYS metrics heartbeat before the first park.
    "conns.parked", "conns.inflated", "conns.shed",
]
# faultline: one fixed slot per fault-injection site, so
# every faults.<site> counter renders at zero in prometheus/$SYS before
# the first injection — canonical site order mirrors native/__init__.py
# FAULT_SITES (test_stats_lint pins the pair against the fault.h enum)
FAULT_SITES = ("conn_read", "conn_write", "conn_accept",
               "trunk_read", "trunk_write", "trunk_accept",
               "trunk_connect", "store_msync", "store_seg_open",
               "ring_seal", "ring_doorbell", "housekeep_clock")
FAULTS = [f"faults.{s}" for s in FAULT_SITES]
CLIENT = [
    "client.connect", "client.connack", "client.connected",
    "client.authenticate", "client.auth.anonymous", "client.authorize",
    "client.subscribe", "client.unsubscribe", "client.disconnected",
]
SESSION = [
    "session.created", "session.resumed", "session.takenover",
    "session.discarded", "session.terminated",
]
AUTHZ = ["authorization.allow", "authorization.deny",
         "authorization.cache_hit", "authorization.cache_miss"]
OLP = ["olp.delay.ok", "olp.delay.timeout", "olp.hbn", "olp.gc",
       "olp.new_conn"]

# kernel plane: device-router observability. Fixed slots so
# every counter renders at zero in prometheus and rides the $SYS metrics
# heartbeat before the first batch. messages.kernel.hostmatch counts
# batches the cpu host-matcher served (RouterModel.host_match_count,
# promoted from an ad-hoc attribute); kernel.uploads/upload_patches
# mirror the full-upload and incremental-scatter counts the same way.
# The two messages.ledger.* slots back the kernel_overflow /
# kernel_hostmatch degradation reasons (appended at the END of
# LEDGER_REASONS — Python-plane reasons, so the C++ enum stays a prefix).
KERNEL = [
    "messages.kernel.hostmatch",
    "kernel.uploads", "kernel.upload_patches",
    "messages.ledger.kernel_overflow",
    "messages.ledger.kernel_hostmatch",
]

ALL_NAMES: list[str] = (BYTES + PACKETS + MESSAGES + DELIVERY + NATIVE
                        + FAULTS + CLIENT + SESSION + AUTHZ + OLP
                        + KERNEL)


# ---------------------------------------------------------------------------
# latency histograms (native telemetry plane)
#
# HDR-histogram-style log-bucketed capture: 64 fixed buckets at
# ~power-of-√2 spacing, mirroring host.cc HistBucket EXACTLY — the C++
# poll thread bumps plain uint64 arrays and ships per-cycle deltas
# (event kind 8); this class is the Python accumulator those deltas
# fold into, and the percentile/exposition surface for prometheus,
# $SYS, and bench.py.


def _hist_edges() -> tuple:
    """Upper bucket edges in ns. Bucket 0 = [0,2); for MSB position
    e >= 1, bucket 2e-1 tops at √2·2^e (1448/1024 fixed-point, the C++
    comparison) and bucket 2e at 2^(e+1); bucket 63 = +inf."""
    edges: list[float] = [2.0]
    for e in range(1, 32):
        edges.append((1448 << e) / 1024.0)
        edges.append(float(1 << (e + 1)))
    return tuple(edges + [float("inf")])  # 63 finite edges + inf


HIST_EDGES_NS: tuple = _hist_edges()


def hist_bucket(ns: int) -> int:
    """Python mirror of host.cc HistBucket (differential-tested)."""
    ns = int(ns)
    if ns < 2:
        return 0
    e = ns.bit_length() - 1
    if e >= 32:
        return 63
    return 2 * e - 1 + (1 if (ns << 10) >= (1448 << e) else 0)


class LatencyHistogram:
    """Fixed 64-bucket log-scale latency histogram (sum/count carried
    alongside, prometheus-histogram shaped). Not thread-safe: owners
    feed it from one thread (the native poll thread's _on_telemetry)
    and readers tolerate torn-but-monotone snapshots like the counter
    array above."""

    __slots__ = ("counts", "sum_ns", "count", "exemplars")

    def __init__(self) -> None:
        self.counts = np.zeros(64, dtype=np.int64)
        self.sum_ns = 0
        self.count = 0
        # OpenMetrics exemplars: bucket index -> (trace_id,
        # value_ns, unix_ts) — the most recent sampled trace whose
        # measured duration landed in that bucket; prometheus renders
        # them on the _bucket lines so operators can jump from a
        # histogram spike straight to a stitched trace timeline
        self.exemplars: dict = {}

    def observe(self, ns: int) -> None:
        self.counts[hist_bucket(ns)] += 1
        self.sum_ns += int(ns)
        self.count += 1

    def observe_delta(self, count_d: int, sum_d: int,
                      bucket_deltas: dict[int, int]) -> None:
        """Fold one kind-8 per-cycle delta record in."""
        self.count += count_d
        self.sum_ns += sum_d
        for idx, d in bucket_deltas.items():
            self.counts[idx] += d

    def put_exemplar(self, trace_id: int, value_ns: int) -> None:
        """Hang a trace id off the bucket ``value_ns`` falls into."""
        self.exemplars[hist_bucket(value_ns)] = (
            int(trace_id), int(value_ns), time.time())

    def percentile(self, q: float) -> float:
        """q in [0,1] -> ns, linearly interpolated inside the bucket
        (the +inf bucket reports its lower edge)."""
        if self.count <= 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i in range(64):
            c = int(self.counts[i])
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                lo = HIST_EDGES_NS[i - 1] if i else 0.0
                hi = HIST_EDGES_NS[i]
                if hi == float("inf"):
                    return lo
                return lo + (hi - lo) * max(0.0, target - prev) / c
        return 0.0

    def summary(self) -> dict:
        """p50/p99/p999 in µs + count/sum — the bench artifact shape."""
        return {
            "count": int(self.count),
            "sum_ms": round(self.sum_ns / 1e6, 3),
            "p50_us": round(self.percentile(0.5) / 1e3, 2),
            "p99_us": round(self.percentile(0.99) / 1e3, 2),
            "p999_us": round(self.percentile(0.999) / 1e3, 2),
        }


# ---------------------------------------------------------------------------
# degradation ledger
#
# Every native-plane degradation-ladder decision — ring-full→punt,
# trunk→punt, kHighWater shed — and every Python-plane one — device
# failover, durable-store degradation — used to be visible only as bare
# counters: when `trunk_punts` ticked up at 3am there was no record of
# WHICH messages degraded or WHY. The ledger holds a bounded in-memory
# event ring (surfaced via $SYS and the mgmt API) next to per-reason
# FIXED metric slots (messages.ledger.*), each event carrying the
# deciding shard, the reason, and the active trace id when the decision
# hit a sampled publish.

# canonical reason set — must match native/__init__.py LEDGER_REASONS
# (test_stats_lint pins the pair; the C++ LedgerReason enum is a prefix:
# "fault" is a faultline injection firing). kernel_overflow /
# kernel_hostmatch are Python-plane reasons folded at the
# broker's publish_batch_collect seam — appended at the END so the C++
# prefix is preserved.
LEDGER_REASONS = ("ring_full", "trunk_punt", "shed", "fault",
                  "accept_shed", "coap_giveup",
                  "device_failover", "store_degraded",
                  "kernel_overflow", "kernel_hostmatch")


class DegradationLedger:
    """Bounded ring of structured degradation events + per-reason
    totals folded into the fixed ``messages.ledger.*`` metric slots.
    Thread-safe: C++ ledger entries arrive on N poll threads while
    Python-plane sources (broker device failover, the durable-store
    degradation watch) record from theirs."""

    def __init__(self, metrics: Optional["Metrics"] = None,
                 maxlen: int = 256) -> None:
        self._events: deque = deque(maxlen=maxlen)
        self._totals: dict[str, int] = {r: 0 for r in LEDGER_REASONS}
        self._metrics = metrics
        self._lock = threading.Lock()

    def record(self, reason: str, count: int = 1, *, shard: int = 0,
               trace_id: int = 0, aux: int = 0,
               detail: str = "") -> None:
        with self._lock:
            self._totals[reason] = self._totals.get(reason, 0) + count
            self._events.append({
                "ts_ms": int(time.time() * 1000), "reason": reason,
                "count": int(count), "shard": int(shard),
                "trace_id": int(trace_id), "aux": int(aux),
                "detail": detail,
            })
        if self._metrics is not None and reason in LEDGER_REASONS:
            self._metrics.inc(f"messages.ledger.{reason}", count)

    def totals(self) -> dict[str, int]:
        with self._lock:
            return dict(self._totals)

    def recent(self, limit: int = 64) -> list[dict]:
        """Newest-last event dicts (the mgmt/$SYS surface)."""
        with self._lock:
            ev = list(self._events)
        return ev[-limit:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Metrics:
    def __init__(self, names: Optional[Iterable[str]] = None) -> None:
        names = list(names) if names is not None else list(ALL_NAMES)
        self._idx: dict[str, int] = {n: i for i, n in enumerate(names)}
        self._c = np.zeros(len(names), dtype=np.int64)
        self._dyn: dict[str, int] = {}
        self._hists: dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        i = self._idx.get(name)
        if i is not None:
            self._c[i] += n
            return
        with self._lock:
            self._dyn[name] = self._dyn.get(name, 0) + n

    def val(self, name: str) -> int:
        i = self._idx.get(name)
        if i is not None:
            return int(self._c[i])
        return self._dyn.get(name, 0)

    def all(self) -> dict[str, int]:
        out = {n: int(self._c[i]) for n, i in self._idx.items()}
        out.update(self._dyn)
        return out

    def reset(self) -> None:
        self._c[:] = 0
        with self._lock:
            self._dyn.clear()
            for h in self._hists.values():
                h.counts[:] = 0
                h.sum_ns = h.count = 0
                h.exemplars.clear()

    # -- latency histograms -------------------------------------------------

    def register_hist(self, name: str) -> LatencyHistogram:
        """Idempotent: one LatencyHistogram per name (e.g.
        ``latency.native.ingress_route``), shared by all callers."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            return h

    def hist(self, name: str) -> Optional[LatencyHistogram]:
        return self._hists.get(name)

    def hists(self) -> dict[str, LatencyHistogram]:
        return dict(self._hists)

    # -- convenience used by the packet host --------------------------------

    def inc_recv_packet(self, type_name: str) -> None:
        self.inc("packets.received")
        self.inc(f"packets.{type_name}.received")

    def inc_sent_packet(self, type_name: str) -> None:
        self.inc("packets.sent")
        self.inc(f"packets.{type_name}.sent")

    def inc_msg(self, direction: str, qos: int) -> None:
        self.inc(f"messages.{direction}")
        if qos in (0, 1, 2):
            self.inc(f"messages.qos{qos}.{direction}")


class MetricsWorker:
    """Per-resource dynamic counters + EWMA rates — parity with
    ``apps/emqx/src/emqx_metrics_worker.erl`` (rule-engine / bridge
    metrics). Each (id, name) holds a counter and a 5s-EWMA rate."""

    TAU = 5.0

    def __init__(self) -> None:
        self._c: dict[str, dict[str, int]] = {}
        self._rate: dict[str, dict[str, tuple[float, float, int]]] = {}
        # rate entry: (ewma_per_s, last_ts, last_count)

    def create_metrics(self, id_: str,
                       names: Iterable[str] = ()) -> None:
        self._c.setdefault(id_, {n: 0 for n in names})
        self._rate.setdefault(id_, {})

    def clear_metrics(self, id_: str) -> None:
        self._c.pop(id_, None)
        self._rate.pop(id_, None)

    def inc(self, id_: str, name: str, n: int = 1) -> None:
        d = self._c.setdefault(id_, {})
        d[name] = d.get(name, 0) + n

    def get(self, id_: str, name: str) -> int:
        return self._c.get(id_, {}).get(name, 0)

    def get_counters(self, id_: str) -> dict[str, int]:
        return dict(self._c.get(id_, {}))

    def tick(self, now: Optional[float] = None) -> None:
        """Advance EWMA rates (the reference's per-second timer)."""
        now = time.time() if now is None else now
        for id_, counters in self._c.items():
            rates = self._rate.setdefault(id_, {})
            for name, count in counters.items():
                ewma, last_ts, last_count = rates.get(
                    name, (0.0, now, count))
                dt = max(now - last_ts, 1e-9)
                inst = (count - last_count) / dt
                alpha = 1.0 - pow(2.718281828, -dt / self.TAU)
                rates[name] = (ewma + alpha * (inst - ewma), now, count)

    def get_rate(self, id_: str, name: str) -> float:
        return self._rate.get(id_, {}).get(name, (0.0, 0.0, 0))[0]
