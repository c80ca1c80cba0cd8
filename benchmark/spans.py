"""The traced run's instruments, all from the benchmark's side: timers
around the calls into each layer, a tap on the model's telemetry hook, and
a ``torch.profiler`` trace of the whole loop, read for the device's busy
time, its kernels and its idle gaps over the measured window.

Layers and their calls:

- broker fold: ``Broker.publish_batch_submit`` less the model's submit;
- model submit: ``RouterModel.publish_batch_submit`` (tokenize, upload,
  launch, start of the copy back);
- model collect: ``RouterModel.publish_batch_collect`` (wait, decode);
- broker map build: ``Broker.publish_batch_collect`` less the model's
  collect, and the CM dispatch.
"""

from __future__ import annotations

import functools
import time

from benchmark.drive import msg_index
from benchmark.yardstick import union_length

# record_function names of the timed calls, and what the host was doing
# inside each (innermost wins) when the device sat idle
RANGES = {
    "bench.broker_submit": "fold",
    "bench.model_submit": "model_submit",
    "bench.broker_collect": "map_build",
    "bench.model_collect": "model_collect",
    "bench.dispatch": "dispatch",
}
WALK_KERNEL = "walk_compact_kernel"
FANOUT_KERNEL = "row_or_kernel"


class Spans:
    """Wraps the system's calls on the instance (nothing of the program is
    edited): each call's ``(start_ns, end_ns, n_messages)``; for each
    broker submit, the indices of its messages; the telemetry hook's stage
    times."""

    def __init__(self, sut) -> None:
        self.calls: dict[str, list] = {k: [] for k in RANGES}
        self.batches: list[tuple[int, list[int]]] = []
        # (perf_counter_ns at collect, topics, submit, step, decode ns)
        self.telemetry: list[tuple] = []
        self._undo: list = []
        self._wrap(sut.broker, "publish_batch_submit", "bench.broker_submit",
                   lambda a: len(a[0]), self._note_batch)
        self._wrap(sut.model, "publish_batch_submit", "bench.model_submit",
                   lambda a: len(a[0]))
        self._wrap(sut.broker, "publish_batch_collect", "bench.broker_collect",
                   lambda a: len(a[0][1]))
        self._wrap(sut.model, "publish_batch_collect", "bench.model_collect",
                   lambda a: 0)
        self._wrap(sut.cm, "dispatch", "bench.dispatch", lambda a: 0)
        if sut.fold is not None:
            orig = sut.fold.on_batch

            def on_batch(counters, **kw):
                self.telemetry.append((time.perf_counter_ns(), kw["n_topics"],
                                       kw["submit_ns"], kw["step_ns"],
                                       kw["decode_ns"]))
                return orig(counters, **kw)

            sut.fold.on_batch = on_batch
            self._undo.append((sut.fold, "on_batch"))

    def _note_batch(self, t0: int, args) -> None:
        self.batches.append((t0, [msg_index(m) for m in args[0]]))

    def _wrap(self, obj, attr: str, name: str, count, note=None) -> None:
        from torch.profiler import record_function
        orig = getattr(obj, attr)
        rows = self.calls[name]

        @functools.wraps(orig)
        def timed(*args, **kw):
            t0 = time.perf_counter_ns()
            if note is not None:
                note(t0, args)
            with record_function(name):
                out = orig(*args, **kw)
            rows.append((t0, time.perf_counter_ns(), count(args)))
            return out

        setattr(obj, attr, timed)
        self._undo.append((obj, attr))

    def remove(self) -> None:
        for obj, attr in reversed(self._undo):
            delattr(obj, attr)
        self._undo.clear()


class Trace:
    """A ``torch.profiler`` session over the loop, with two clock marks that
    map ``perf_counter_ns`` onto the trace's clock."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self.marks: list[tuple[str, int]] = []

    def _mark(self, name: str) -> None:
        from torch.profiler import record_function
        with record_function(name):
            self.marks.append((name, time.perf_counter_ns()))

    def __enter__(self):
        self.prof.__enter__()
        self._mark("bench.clock0")
        return self

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._mark("bench.clock1")
        return self.prof.__exit__(*exc)

    def summary(self, t0_ns: int, t1_ns: int) -> dict:
        """Over ``[t0_ns, t1_ns)`` (``perf_counter_ns``): the device's busy
        seconds (the union of its kernels, copies and sets), the window's
        length, each device operation's seconds, the kernels' launch
        intervals by name, and the idle seconds by what the host was doing
        (the innermost timed call around the gap, else ``harness``)."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        clock = {e.name: e.time_range.start for e in events
                 if e.name in ("bench.clock0", "bench.clock1")
                 and e.device_type != cuda}
        (n0, p0), (n1, p1) = self.marks
        scale = (clock[n1] - clock[n0]) / ((p1 - p0) / 1e3)

        def at(ns: int) -> float:
            return clock[n0] + (ns - p0) / 1e3 * scale

        lo, hi = at(t0_ns), at(t1_ns)
        dev, host = [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if not getattr(e, "is_user_annotation", False) \
                        and e.name not in RANGES and b > lo and a < hi:
                    dev.append((e.name, max(a, lo), min(b, hi)))
            elif e.name in RANGES and b > lo and a < hi:
                host.append((a, b, RANGES[e.name]))
        busy = union_length([(a, b) for _, a, b in dev], lo, hi)
        ops: dict[str, float] = {}
        for name, a, b in dev:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6,
                "device_ops": ops,
                "kernels": {k: [(b - a) / 1e6 for name, a, b in dev
                                if k in name]
                            for k in (WALK_KERNEL, FANOUT_KERNEL)},
                "idle_by_host": idle_by_host(
                    [(a, b) for _, a, b in dev], host, lo, hi),
                "device_events": len(dev)}


def idle_by_host(dev, host, lo: float, hi: float) -> dict:
    """Seconds of ``[lo, hi]`` in which no device interval ran, split by the
    innermost host range covering each moment (``harness`` where none)."""
    gaps, end = [], lo
    for a, b in sorted(dev):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    # elementary segments between every boundary; the innermost covering
    # range is the shortest one that contains the segment
    cuts = sorted({lo, hi} | {x for a, b, _ in host for x in (a, b)
                              if lo < x < hi}
                  | {x for g in gaps for x in g})
    host = sorted(host)
    out: dict[str, float] = {}
    gi, active, hi_idx = 0, [], 0
    for x, y in zip(cuts, cuts[1:]):
        while gi < len(gaps) and gaps[gi][1] <= x:
            gi += 1
        if gi == len(gaps) or gaps[gi][0] > x:
            continue
        while hi_idx < len(host) and host[hi_idx][0] <= x:
            active.append(host[hi_idx])
            hi_idx += 1
        active = [r for r in active if r[1] > x]
        label = (min(active, key=lambda r: r[1] - r[0])[2] if active
                 else "harness")
        out[label] = out.get(label, 0.0) + (y - x) / 1e6
    return out
