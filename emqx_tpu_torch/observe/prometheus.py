"""Prometheus text exposition — parity with
``apps/emqx_prometheus/src/emqx_prometheus.erl``.

Renders the metric counters, stat gauges, VM/process figures, the
native host's fast-path stat slots (``emqx_native_*`` gauges — with a
``shard`` label per shard host when the server is sharded), and the
native telemetry plane's latency histograms
(``emqx_latency_*_seconds`` with ``_bucket``/``_sum``/``_count``
series; per-shard stage histograms render under the SAME metric name
with a ``shard`` label) into the text 0.0.4 format the scrape endpoint
serves. Metric names map ``a.b.c`` → ``emqx_a_b_c`` as the reference's
collector does.

Round 13: with ``openmetrics=True`` the histogram ``_bucket`` lines
carry OpenMetrics-style exemplars (``# {trace_id="..."} value ts``)
hung off the distributed-tracing plane's sampled trace ids, so a
latency spike links straight to a stitched per-message timeline.
Exemplar syntax is ILLEGAL in the classic text 0.0.4 format (the
default scrape — a 0.0.4 parser errors on the ``#`` after the sample
value, failing the whole scrape), so the default render omits them;
scrapers opt in via ``GET /api/v5/prometheus?format=openmetrics``.
"""

from __future__ import annotations

import os
import re
import time
from typing import Optional

_SHARD_HIST_RE = re.compile(r"^latency\.(native|kernel)\.shard(\d+)\.(.+)$")


def _san(name: str) -> str:
    return "emqx_" + name.replace(".", "_")


def _render_hists(lines: list[str], hists: dict, node: str,
                  openmetrics: bool = False) -> None:
    """``_bucket``/``_sum``/``_count`` series per latency histogram.

    Bucket edges convert ns → seconds (prometheus convention); only
    buckets with occupants are listed (le labels are explicit, so a
    sparse cumulative series stays well-formed) plus the mandatory
    ``le="+Inf"`` line. Names of the ``latency.native.shard<i>.<stage>``
    shape render under the aggregate stage's metric name with a
    ``shard="<i>"`` label (one TYPE line per metric name).
    """
    from emqx_tpu_torch.observe.metrics import HIST_EDGES_NS

    rows = []
    for name, h in hists.items():
        m = _SHARD_HIST_RE.match(name)
        if m:
            base = _san(
                f"latency.{m.group(1)}.{m.group(3)}") + "_seconds"
            label = f'{{node="{node}",shard="{m.group(2)}"}}'
            bucket_label = f'node="{node}",shard="{m.group(2)}"'
        else:
            base = _san(name) + "_seconds"
            label = f'{{node="{node}"}}'
            bucket_label = f'node="{node}"'
        rows.append((base, label, bucket_label, h))
    rows.sort(key=lambda r: (r[0], r[1]))
    typed = None
    for base, label, bucket_label, h in rows:
        if base != typed:
            lines.append(f"# TYPE {base} histogram")
            typed = base
        cum = 0
        ex = ((getattr(h, "exemplars", None) or {})
              if openmetrics else {})
        unrendered = dict(ex)
        for i in range(63):  # bucket 63 is the +Inf line below
            c = int(h.counts[i])
            if c == 0:
                continue
            cum += c
            line = (f'{base}_bucket{{{bucket_label},'
                    f'le="{HIST_EDGES_NS[i] / 1e9:.9g}"}} {cum}')
            if i in ex:
                tid, val_ns, ts = ex[i]
                unrendered.pop(i, None)
                line += (f' # {{trace_id="{tid:016x}"}} '
                         f"{val_ns / 1e9:.9g} {ts:.3f}")
            lines.append(line)
        inf_line = (f'{base}_bucket{{{bucket_label},le="+Inf"}} '
                    f"{h.count}")
        if unrendered:
            # an exemplar whose own bucket printed no line (the
            # exemplar came from the span plane, the histogram counts
            # from the 1-in-8 sampler — they need not coincide) still
            # surfaces, on the mandatory +Inf line
            tid, val_ns, ts = max(unrendered.values(),
                                  key=lambda e: e[2])
            inf_line += (f' # {{trace_id="{tid:016x}"}} '
                         f"{val_ns / 1e9:.9g} {ts:.3f}")
        lines.append(inf_line)
        lines.append(f"{base}_sum{label} {h.sum_ns / 1e9:.9g}")
        lines.append(f"{base}_count{label} {h.count}")


def render(metrics=None, stats=None, extra: Optional[dict] = None,
           node: str = "emqx_tpu", native: Optional[dict] = None,
           native_shards: Optional[list] = None,
           native_store: Optional[dict] = None,
           kernel: Optional[dict] = None,
           openmetrics: bool = False) -> str:
    lines: list[str] = []
    label = f'{{node="{node}"}}'
    if metrics is not None:
        for name, val in sorted(metrics.all().items()):
            mn = _san(name)
            lines.append(f"# TYPE {mn} counter")
            lines.append(f"{mn}{label} {val}")
        hists = getattr(metrics, "hists", None)
        if callable(hists):
            h = hists()
            if h:
                _render_hists(lines, h, node, openmetrics)
    if stats is not None:
        for name, val in sorted(stats.all().items()):
            mn = _san(name)
            lines.append(f"# TYPE {mn} gauge")
            lines.append(f"{mn}{label} {val}")
    typed_native: set = set()
    if native:
        # the C++ host's monotonic stat slots (NativeHost.stats());
        # tests/test_stats_lint.py asserts every exported slot lands here
        for name, val in sorted(native.items()):
            mn = "emqx_native_" + name.replace(".", "_")
            lines.append(f"# TYPE {mn} gauge")
            typed_native.add(mn)
            lines.append(f"{mn}{label} {val}")
    if native_store:
        # the durable store's slots (STORE_STAT_NAMES, the
        # one-recovery-path surface: segment/session/trunk-ring gauges
        # next to the append/replay counters)
        for name, val in sorted(native_store.items()):
            mn = "emqx_native_store_" + name.replace(".", "_")
            lines.append(f"# TYPE {mn} gauge")
            lines.append(f"{mn}{label} {val}")
    if native_shards:
        # per-shard series under the same names, shard-labelled:
        # operators see which epoll plane is hot, not
        # just the aggregate; the label set is pinned by the stats lint
        for i, st in enumerate(native_shards):
            for name, val in sorted(st.items()):
                mn = "emqx_native_" + name.replace(".", "_")
                if mn not in typed_native:
                    lines.append(f"# TYPE {mn} gauge")
                    typed_native.add(mn)
                lines.append(f'{mn}{{node="{node}",shard="{i}"}} {val}')
    if kernel:
        # the device router's trie-health gauges (DeviceMetricsFold
        # .gauges()): list-valued entries are per-shard and render one
        # shard-labelled series each, scalars render plain
        for name, val in sorted(kernel.items()):
            mn = "emqx_kernel_" + name.replace(".", "_")
            lines.append(f"# TYPE {mn} gauge")
            if isinstance(val, (list, tuple)):
                for i, v in enumerate(val):
                    lines.append(
                        f'{mn}{{node="{node}",shard="{i}"}} {v}')
            else:
                lines.append(f"{mn}{label} {val}")
    # VM slice (the reference exports erlang_vm_*; we export process RSS)
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            rss_pages = int(f.read().split()[1])
        lines.append("# TYPE emqx_vm_memory_bytes gauge")
        lines.append(
            f"emqx_vm_memory_bytes{label} "
            f"{rss_pages * os.sysconf('SC_PAGE_SIZE')}")
    except OSError:
        pass
    if extra:
        for name, val in sorted(extra.items()):
            mn = _san(name)
            lines.append(f"# TYPE {mn} gauge")
            lines.append(f"{mn}{label} {val}")
    lines.append(f"# EOF scraped_at={int(time.time())}")
    return "\n".join(lines) + "\n"
