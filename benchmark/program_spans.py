"""The program's own span plane in a run: the batch traces the port's
publish pipeline keeps (``emqx_tpu_torch/observe/trace.py``), read where the
benchmark's outside timers (``spans.py``) can only subtract one call from
another.

- :func:`attach` turns on the app's batch tracing for every batch, with a
  ring that holds a run's warm-up, window and drain: one program call,
  ``BrokerApp.trace_batches``.  A program without it is left as it is.
- :func:`in_window` gives the traces of the window's batches, for the
  readers of ``metrics/*.py`` that take ``run.program`` (the ring).
- :func:`idle_by_program` splits the card's idle time of the window by the
  innermost program span around each idle moment (``outside`` where none
  is): the profiler's device intervals against the program's spans mapped
  onto the profiler's clock, by ``spans.idle_by_host``'s method.

``harness.py`` hands the readers neither the ring nor the split yet, so
the benchmark's own runs leave the readers of these metrics silent.
``python3 benchmark/program_spans.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs a cell as ``run.py`` does, with the
ring attached to the run's record and the split added to its trace, and
prints the result line with the metrics of :data:`METRICS` added (``--trace
1``); ``--sample-every <n>`` instead sets the program's sampling in an
untraced run, for the cost of tracing.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, system  # noqa: E402
from benchmark import spans as outside  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402

# the per-layer metrics read from the program's spans and counters, and
# their units
METRICS = {
    "pipeline.loop_us_per_msg.tput": "us/msg",
    "broker.expand_us_per_msg.tput": "us/msg",
    "broker.expand_yield.tput": "share",
    "broker.route_walk_us_per_msg.tput": "us/msg",
    "broker.route_walk_yield.tput": "share",
    "model.wait_us_per_msg.tput": "us/msg",
    "device.idle_outside_spans_share.tput": "share",
    "broker.fold_span_us_per_msg.tput": "us/msg",
}
# batches a second the ring is sized for, over the warm-up and the window,
# and batches more for the warm-up's shapes and the drain
RING_RATE = 64
RING_SPARE = 1024


def attach(sut, mix: dict, seconds: float, sample_every: int = 1):
    """Trace 1 in ``sample_every`` of the app's pipeline batches into a
    ring sized for the run; the ring, or None where the program has no
    batch tracing."""
    fn = getattr(getattr(sut, "app", None), "trace_batches", None)
    if fn is None:
        return None
    ring = int(RING_RATE * (mix["warm_s"] + seconds)) + RING_SPARE
    return fn(sample_every, ring)


def in_window(run) -> list:
    """The batch traces whose ``pipeline.assemble`` (the batch's pop)
    started inside the window; [] without a ring."""
    ring = getattr(run, "program", None)
    if ring is None:
        return []
    out = []
    for b in ring.batches():
        t0 = next((a for name, a, _, _ in b.spans
                   if name == "pipeline.assemble"), None)
        if t0 is not None and run.in_window(t0):
            out.append(b)
    return out


def messages(batches) -> int:
    return sum(len(b.msg_ids) for b in batches)


def span_ns(batches, *names: str) -> int:
    """Nanoseconds of the spans called ``names`` over ``batches``."""
    return sum(b - a for bt in batches for name, a, b, _ in bt.spans
               if name in names)


def counter(batches, name: str) -> int:
    return sum(bt.counters.get(name, 0) for bt in batches)


def per_msg_us(batches, ns: int) -> Optional[float]:
    n = messages(batches)
    return ns / 1e3 / n if n else None


# spans of a batch's wait, not of the host's work: a batch's queue span
# overlaps the host's work on the batches before it
WAITS = ("pipeline.queue",)


def idle_by_program(dev, at, batches, lo: float, hi: float) -> dict:
    """Seconds of ``[lo, hi]`` (the profiler's clock, us) in which no
    device interval of ``dev`` ran, by the innermost span of ``batches``
    (on ``tracing.now_ns``, mapped by ``at``; :data:`WAITS` left out)
    around each moment; the time no span covers is ``outside``."""
    host = [(at(a), at(b), name) for bt in batches
            for name, a, b, _ in bt.spans if b > a and name not in WAITS]
    out = outside.idle_by_host(dev, host, lo, hi)
    if "harness" in out:
        out["outside"] = out.pop("harness")
    return out


def trace_idle(tr, batches, t0_ns: int, t1_ns: int) -> dict:
    """:func:`idle_by_program` over the window ``[t0_ns, t1_ns)`` of a
    finished ``spans.Trace``: its device intervals and its clock marks,
    read as ``Trace.summary`` reads them."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = tr.prof.events()
    clock = {e.name: e.time_range.start for e in events
             if e.name in ("bench.clock0", "bench.clock1")
             and e.device_type != cuda}
    (n0, p0), (n1, p1) = tr.marks
    scale = (clock[n1] - clock[n0]) / ((p1 - p0) / 1e3)

    def at(ns: int) -> float:
        return clock[n0] + (ns - p0) / 1e3 * scale

    lo, hi = at(t0_ns), at(t1_ns)
    dev = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
           for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and e.name not in outside.RANGES
           and e.time_range.end > lo and e.time_range.start < hi]
    return idle_by_program(dev, at, batches, lo, hi)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root=ROOT, t_start: Optional[int] = None,
        sample_every: Optional[int] = None) -> dict:
    """``harness.run`` with the program's ring attached (every batch under
    ``trace``, else 1 in ``sample_every``; the program's own sampling
    where that is None) and, under ``trace``, :data:`METRICS` read from
    the run's record with the ring and the idle split added to it."""
    every = 1 if trace else sample_every
    rings, records, traces = [], [], []

    def build(conf, dev, data_dir):
        sut = system.build(conf, dev, data_dir)
        if every is not None:
            rings.append(attach(sut, man.traffic(cell["traffic"]), seconds,
                                every))
        return sut

    def record(*a, **kw):
        records.append(real_record(*a, **kw))
        return records[-1]

    def profile():
        traces.append(real_trace())
        return traces[-1]

    man = Manifest(root)
    cell = man.cell(workload)
    real_record, real_trace = harness.Record, outside.Trace
    harness.Record, outside.Trace = record, profile
    try:
        out = harness.run(workload, seed, seconds, trace, device=device,
                          root=root, t_start=t_start, build=build)
    finally:
        harness.Record, outside.Trace = real_record, real_trace
    ring = rings[0] if rings else None
    if trace and ring is not None:
        rec = records[-1]
        rec.program = ring
        win = in_window(rec)
        if traces and rec.trace is not None:
            # every batch's spans: the window's first collects and
            # deliveries are of batches popped before it opened
            rec.trace["idle_by_program"] = trace_idle(
                traces[-1], ring.batches(), rec.win.t0, rec.win.t_end)
            out["breakdown"]["idle_by_program"] = sorted(
                ([k, v] for k, v in rec.trace["idle_by_program"].items()),
                key=lambda kv: -kv[1])
        for name, unit in METRICS.items():
            v = man.reader(name)(rec)
            if v is not None:
                out["metrics"][name] = {"value": float(v), "unit": unit}
        out["program_batches"] = len(win)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sample-every", type=int, default=None)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = run(a.workload, a.seed, a.seconds, bool(a.trace),
              sample_every=a.sample_every)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
