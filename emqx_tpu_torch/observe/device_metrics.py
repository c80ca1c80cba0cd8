"""Kernel-plane observability fold.

The device router computes a compact per-batch counters vector IN the
routing step (ops/trie_match.py KERNEL_COUNTER_FIELDS — frontier
peak, probe iterations, candidate counts pre/post-compact, compact-slot
utilization, overflow/truncation rows) and ships it in the same
``publish_batch_collect`` copy to the host as the results — no extra sync.
This module is the host side: it folds those vectors plus the model's
submit/step/decode wall timings into the SAME observability surfaces
the native plane already uses —

- ``LatencyHistogram`` stages ``latency.kernel.submit|step|decode``
  (prometheus ``emqx_latency_kernel_*_seconds``, render-at-zero; the
  $SYS latency heartbeat once observed; ``$SYS/.../kernel/<stage>/...``
  always);
- trie-health gauges from the (Sharded)TrieIndex — per-shard filter
  counts, live-node occupancy, edge-table load factor, shard-skew
  ratio, patch-upload bytes — the ``emqx_kernel_*`` prometheus gauges
  and the ``GET /api/v5/kernel/stats`` mgmt snapshot;
- fixed metric slots ``messages.kernel.hostmatch`` /
  ``kernel.uploads`` / ``kernel.upload_patches`` (promoted from the
  model's ad-hoc counters);
- span stages ``kernel_submit`` / ``kernel_collect`` into a
  ``SpanCollector``, under the trace id of a batch the publish pipeline
  traced, or for 1-in-N sampled batches of a model driven without one,
  so a traced message's timeline no longer has a hole where the device
  was.

The degradation-ledger reasons (``kernel_overflow`` /
``kernel_hostmatch``) fold at the BROKER's publish_batch_collect
fallback seam (broker/broker.py), next to ``device_failover`` — the
fold here never double-counts them.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

# the counters vector's field order, from the step that packs it
from emqx_tpu_torch.ops.trie_match import KERNEL_COUNTER_FIELDS

# per-field fold rule: peaks take max across shards/batches, the rest sum
_PEAK_FIELDS = ("frontier_peak", "compact_peak")

# stage names — latency.kernel.<stage> histograms + the $SYS
# kernel/<stage>/p50|p99 heartbeat subtree
KERNEL_STAGES = ("submit", "step", "decode")


class KernelCounters:
    """Decoded view of one batch's raw counters block.

    Accepts the flat ``[C]`` vector or the sharded ``[S, C]`` block;
    ``per_shard`` is always 2-D ``[S, C]`` (S=1 for the flat layout).
    """

    __slots__ = ("per_shard",)

    def __init__(self, raw) -> None:
        a = np.asarray(raw, dtype=np.int64)
        C = len(KERNEL_COUNTER_FIELDS)
        if a.size % C:
            raise ValueError(
                f"counters block of {a.size} elements is not a multiple "
                f"of the {C}-field layout")
        self.per_shard = a.reshape(-1, C)

    @property
    def n_shards(self) -> int:
        return self.per_shard.shape[0]

    def field(self, name: str) -> np.ndarray:
        """Per-shard [S] vector of one named field."""
        return self.per_shard[:, KERNEL_COUNTER_FIELDS.index(name)]

    def value(self, name: str) -> int:
        """Shard-aggregated scalar (max for peaks, sum otherwise)."""
        col = self.field(name)
        return int(col.max() if name in _PEAK_FIELDS else col.sum())

    def as_dict(self) -> dict[str, int]:
        return {n: self.value(n) for n in KERNEL_COUNTER_FIELDS}


class DeviceMetricsFold:
    """Per-batch fold point the RouterModel notifies at collect time.

    Single-writer like LatencyHistogram: batches collect on one thread
    (the pipeline's flush worker); readers (scrape/mgmt/$SYS) tolerate
    torn-but-monotone snapshots, the repo-wide observe discipline.
    """

    def __init__(self, metrics, ledger=None, spans=None, model=None,
                 node: str = "", sample_every: int = 8) -> None:
        self.metrics = metrics
        self.ledger = ledger          # kept for symmetry/mgmt; reasons
        #                               fold at the broker seam
        self.spans = spans            # SpanCollector | None
        self.model = model            # RouterModel | None
        self.node = node
        self.sample_every = max(1, int(sample_every))
        self.batches = 0
        self.host_batches = 0
        self.host_topics = 0
        self.last: Optional[KernelCounters] = None
        self.totals: dict[str, int] = {n: 0 for n in KERNEL_COUNTER_FIELDS}
        self.last_trace_id = 0
        self._synced: dict[str, int] = {}
        # register the stage histograms NOW: fixed stages render at
        # zero in prometheus before the first batch (the render-at-zero
        # discipline every other plane follows)
        self._hists = {
            s: metrics.register_hist(f"latency.kernel.{s}")
            for s in KERNEL_STAGES
        }

    # -- model notification seams ------------------------------------------

    def on_batch(self, counters, *, n_topics: int, submit_ns: int,
                 step_ns: int, decode_ns: int, t_submit_ns: int,
                 t_collect_ns: int, trace=None) -> None:
        """One device batch collected. ``counters`` is the raw [C] or
        [S, C] block from the shared copy to the host (None when the model
        was built with kernel_telemetry off).  ``trace`` is the batch's
        ``BatchTrace``, False when the publish pipeline sampled the batch
        out, or None when nothing upstream samples; the times are on
        ``observe.trace.now_ns``."""
        self.batches += 1
        self._hists["submit"].observe(submit_ns)
        self._hists["step"].observe(step_ns)
        self._hists["decode"].observe(decode_ns)
        if counters is not None:
            kc = KernelCounters(counters)
            self.last = kc
            for name in KERNEL_COUNTER_FIELDS:
                v = kc.value(name)
                if name in _PEAK_FIELDS:
                    self.totals[name] = max(self.totals[name], v)
                else:
                    self.totals[name] += v
        # trace stitching: kernel_submit/kernel_collect span points
        # under the pipeline's trace of the batch; a model driven without
        # a sampling pipeline (trace None) gets an id for every
        # sample_every-th batch (the FIRST one included, so a
        # single-batch test sees a timeline): its batch count with bit
        # 63 set, clear of the pipeline's batch numbers
        if trace:
            tid = trace.trace_id
        elif trace is None and (self.batches - 1) % self.sample_every == 0:
            tid = (1 << 63) | self.batches
        else:
            tid = 0
        if self.spans is not None and tid:
            self.last_trace_id = tid
            self.spans.record(tid, "kernel_submit", t_submit_ns,
                              aux=n_topics, node=self.node)
            self.spans.record(tid, "kernel_collect", t_collect_ns,
                              aux=n_topics, node=self.node)
            # hang the submit→collect wall off the step histogram as an
            # OpenMetrics exemplar — a latency spike links to the trace
            self._hists["step"].put_exemplar(tid, step_ns)
        self._sync_slots()

    def on_host_batch(self, n_topics: int) -> None:
        """One batch served by the cpu host-matcher instead of the
        kernel (local tally only; the messages.kernel.hostmatch slot
        and the kernel_hostmatch ledger leg fold at the broker seam)."""
        self.host_batches += 1
        self.host_topics += int(n_topics)
        self._sync_slots()

    def _sync_slots(self) -> None:
        """Diff the model's ad-hoc upload counters into their fixed
        metric slots (promotion without changing the model's test
        surface). messages.kernel.hostmatch is NOT synced here — the
        broker increments it at its collect seam (next to the
        kernel_hostmatch ledger record), and syncing it too would
        double-count."""
        m = self.model
        if m is None:
            return
        for attr, slot in (
                ("upload_count", "kernel.uploads"),
                ("patch_count", "kernel.upload_patches")):
            cur = int(getattr(m, attr, 0))
            delta = cur - self._synced.get(slot, 0)
            if delta > 0:
                self.metrics.inc(slot, delta)
                self._synced[slot] = cur

    # -- read surfaces ------------------------------------------------------

    def stage_hists(self) -> dict:
        return dict(self._hists)

    def gauges(self) -> dict:
        """Trie-health + upload gauges for the prometheus ``kernel=``
        section (``emqx_kernel_<name>``; list values render one series
        per shard with a ``shard`` label)."""
        self._sync_slots()
        out: dict = {"batches": self.batches,
                     "host_batches": self.host_batches}
        m = self.model
        if m is not None:
            out["shards"] = getattr(m, "n_shards", 1)
            out["launches"] = getattr(m, "launch_count", 0)
            out["uploads"] = getattr(m, "upload_count", 0)
            out["upload_patches"] = getattr(m, "patch_count", 0)
            out["patch_upload_bytes"] = getattr(m, "patch_upload_bytes", 0)
            idx = m.index
            shards = getattr(idx, "shards", None) or [idx]
            filters = [sum(1 for f in s.filters if f is not None)
                       for s in shards]
            occ, load = [], []
            for s in shards:
                arrays = getattr(s, "arrays", None)
                cap = (arrays.plus_child.shape[0]
                       if arrays is not None else 0)
                ht = (arrays.ht_parent.shape[0]
                      if arrays is not None else 0)
                occ.append(round(s.n_nodes / cap, 4) if cap else 0.0)
                load.append(round(s.n_edges / ht, 4) if ht else 0.0)
            total = sum(filters)
            mean = total / max(1, len(filters))
            out["filters"] = filters if len(filters) > 1 else filters[0]
            out["filters_total"] = total
            out["node_occupancy"] = occ if len(occ) > 1 else occ[0]
            out["edge_load"] = load if len(load) > 1 else load[0]
            out["shard_skew"] = (round(max(filters) / mean, 4)
                                 if mean > 0 else 1.0)
        if self.last is not None:
            for name in KERNEL_COUNTER_FIELDS:
                col = self.last.field(name)
                out[f"last.{name}"] = (col.tolist() if len(col) > 1
                                       else int(col[0]))
        return out

    def kernel_summary(self) -> dict:
        """Stage percentiles + counter totals — the bench/server
        surface (``server.kernel_summary()``)."""
        self._sync_slots()
        return {
            "batches": self.batches,
            "host_batches": self.host_batches,
            "stages": {s: h.summary() for s, h in self._hists.items()},
            "counters": dict(self.totals),
            "last_counters": (self.last.as_dict()
                              if self.last is not None else None),
        }

    def snapshot(self) -> dict:
        """The mgmt ``GET /api/v5/kernel/stats`` body: trie health +
        last-batch counters, shard-resolved."""
        out = {
            "ts_ms": int(time.time() * 1000),
            "gauges": self.gauges(),
            "summary": self.kernel_summary(),
        }
        if self.last is not None:
            out["last_per_shard"] = {
                n: self.last.field(n).tolist()
                for n in KERNEL_COUNTER_FIELDS}
        return out

    def spans_recent(self, limit: int = 32) -> list[dict]:
        """Assembled recent kernel traces, JSON-shaped like the native
        server's spans_recent (the app's default native_spans_fn when
        no native server is attached).  A publish pipeline batch's trace
        adds its interval spans, its counters and its message count."""
        if self.spans is None:
            return []
        out = []
        for tid, spans in self.spans.recent(limit):
            entry = {
                "trace_id": f"{tid:016x}",
                "spans": [{"t_ns": t, "stage": s, "shard": sh,
                           "node": n, "aux": a}
                          for t, s, sh, n, a in spans],
            }
            batch = self.spans.batch(tid)
            if batch is not None:
                entry["intervals"] = [
                    {"name": name, "t0_ns": t0, "t1_ns": t1, "n": n}
                    for name, t0, t1, n in batch.spans]
                entry["counters"] = dict(batch.counters)
                entry["messages"] = len(batch.msg_ids)
            out.append(entry)
        return out
