"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the reference, and the metrics the cell reports.

The run's end-to-end metrics, taken over the whole window:

- ``msgs_per_s`` (closed loop): messages whose every delivery reached its
  channel inside the window, over the window's length;
- ``publish_p95_ms`` (open loop): the 95th percentile, by nearest rank,
  over every message due inside the window, of the time from when it was
  due to when its last delivery reached a channel (a message that never
  arrives whole counts as infinitely late);
- ``setup_s``: process start to the window's first timed message.

With ``trace`` the run is instrumented (``benchmark/spans.py``) and reports
the cell's per-layer metrics instead, each read by
``benchmark/metrics/<name>.py`` from the :class:`Record`.
"""

from __future__ import annotations

import gc
import math
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from benchmark import drive, system
from benchmark.manifest import ROOT, Manifest
from benchmark.reference.check import LIMITS, compare
from benchmark.reference.router import ReferenceRouter
from benchmark.reference.work import batch_bytes
from benchmark.yardstick import nearest_rank


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Record:
    """What a run saw, for the per-layer readers."""
    cell: dict
    conf: dict
    mix: dict
    seconds: float
    win: Any
    log: Any
    setup: dict
    spans: Any = None
    trace: Optional[dict] = None
    router: Any = None
    _work: Optional[list] = field(default=None, repr=False)

    def in_window(self, t_ns: int) -> bool:
        return self.win.t0 <= t_ns < self.win.t_end

    def calls(self, name: str) -> list:
        """``(start_ns, end_ns, n)`` of each timed call of ``name`` that
        started inside the window."""
        if self.spans is None:
            return []
        return [c for c in self.spans.calls[name] if self.in_window(c[0])]

    def batches(self) -> list:
        """``(start_ns, [message index])`` of each broker submit that started
        inside the window."""
        if self.spans is None:
            return []
        return [b for b in self.spans.batches if self.in_window(b[0])]

    def work(self) -> list:
        """``(walk bytes, fan-out bytes)`` of each batch of the window."""
        if self._work is None:
            slots = self.conf["router_device"]["n_sub_slots"]
            self._work = [batch_bytes(
                self.router, [self.log.pool[self.log.topic[i]] for i in idx],
                slots) for _, idx in self.batches()]
        return self._work


def seeds(seed: int) -> dict:
    names = ("table", "overlay", "topics", "payload", "arrivals", "warm")
    return dict(zip(names, (np.random.default_rng(s) for s in
                            np.random.SeedSequence(seed).spawn(len(names)))))


@dataclass
class Prepared:
    """A system with the configuration's subscriptions, refreshed, a
    recording channel for each session and every batch shape warmed."""
    sut: Any
    table: list
    log: Any
    channels: dict
    setup: dict


def prepare(conf: dict, mix: dict, gen, rng: dict, device: str,
            data_dir: str, build: Callable = system.build) -> Prepared:
    import torch
    table = gen.subscriptions(conf, rng["table"])
    pool = gen.topic_pool(table, conf, mix, rng["topics"])
    table += gen.overlay(mix, conf, rng["overlay"])
    tails = rng["payload"].bytes(drive.TAIL * len(pool))
    sut = build(conf, device, data_dir)
    t0 = time.perf_counter()
    for sid, filt in table:
        sut.broker.subscribe(sid, filt)
    t1 = time.perf_counter()
    if sut.model is not None:
        sut.model.refresh()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    t2 = time.perf_counter()
    channels = {}
    for sid, _ in table:
        if sid not in channels:
            channels[sid] = drive.RecordingChannel()
            sut.cm.register_channel(sid, channels[sid])
    log = drive.MessageLog(pool, tails)
    drive.warm_shapes(sut.pipe, log, rng["warm"], mix["publishers"])
    return Prepared(sut, table, log, channels,
                    {"subscribe_s": t1 - t0, "refresh_s": t2 - t1})


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", root=ROOT, t_start: Optional[int] = None,
        build: Callable = system.build) -> dict:
    """Run ``workload`` and return the result line's object.  ``build``
    makes the system from the configuration (the control puts the
    reference in the program's place through it)."""
    import torch
    t_start = t_start or time.perf_counter_ns()
    man = Manifest(root)
    cell = man.cell(workload)
    conf = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    gen = man.generator(conf["generator"])
    rng = seeds(seed)
    on_card = torch.device(device).type == "cuda"

    due = (drive.arrivals(mix, seconds, rng["arrivals"])
           if mix["loop"] == "open" else None)

    with tempfile.TemporaryDirectory(prefix="bench_data_") as data_dir:
        p = prepare(conf, mix, gen, rng, device, data_dir, build)
        sut, table, log, channels, setup = (p.sut, p.table, p.log,
                                            p.channels, p.setup)
        spans = tr = None
        if trace:
            from benchmark.spans import Spans, Trace
            spans = Spans(sut)
            tr = Trace()
        say(f"set-up: {len(table)} subscriptions, {len(channels)} sessions, "
            f"subscribe {setup['subscribe_s']:.3f} s, refresh "
            f"{setup['refresh_s']:.3f} s, {len(log)} warm-up messages")
        gc.collect()
        gc.freeze()
        try:
            if tr is not None:
                tr.__enter__()
            try:
                if mix["loop"] == "closed":
                    win = drive.closed_loop(sut.pipe, sut.cm, log, mix,
                                            seconds)
                else:
                    win = drive.open_loop(sut.pipe, log, mix, seconds, due)
            finally:
                if tr is not None:
                    tr.__exit__(None, None, None)
        finally:
            gc.unfreeze()
        t_closed = time.perf_counter_ns()
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        summary = tr.summary(win.t0, win.t_end) if tr is not None else None
        if spans is not None:
            spans.remove()
        batches = (sut.pipe.batches, sut.pipe.published)
        p = sut = None
        if on_card:
            torch.cuda.empty_cache()

    setup_s = (win.t0 - t_start) / 1e9
    say(f"loop: {len(log)} messages in {batches[0]} batches, window "
        f"{seconds} s, drained {(t_closed - win.t_end) / 1e9:.3f} s after "
        f"it closed" + (" (stalled: nothing left in flight)"
                        if win.stalled else ""))
    late = [(s - d) / 1e6 for s, d in zip(log.submit, log.due) if d]
    if mix["loop"] == "open" and late:
        say(f"generator lateness ms: p50 {nearest_rank(late, 0.5):.3f} "
            f"p95 {nearest_rank(late, 0.95):.3f} max {max(late):.3f}")
    if win.backlog:
        say("backlog (s from start, queued): " + " ".join(
            f"{(t - win.backlog[0][0]) / 1e9:.1f}:{q}"
            for t, q in win.backlog[::10]))

    # the reference builds millions of small dicts: the collector would
    # walk the whole heap again and again while it does
    gc.disable()
    try:
        t_ref = time.perf_counter()
        router = ReferenceRouter(table)
        t_built = time.perf_counter()
        cmp = compare(router, {s: ch.log for s, ch in channels.items()}, log)
    finally:
        gc.enable()
    say(f"reference: built in {t_built - t_ref:.3f} s; {cmp['checked']} "
        f"messages, {cmp['deliveries']} deliveries compared in "
        f"{time.perf_counter() - t_built:.3f} s")
    done, faulty = cmp["done"], cmp["faulty"]

    values = {"setup_s": setup_s}
    if mix["loop"] == "closed":
        whole = sum(1 for i, t in done.items()
                    if win.t0 <= t <= win.t_end and i not in faulty)
        values["msgs_per_s"] = whole / seconds
    lat = [(done[i] - log.due[i]) / 1e6
           if i in done and i not in faulty else math.inf
           for i in range(len(log)) if win.t0 <= log.due[i] < win.t_end]
    if lat:
        say(f"latency ms over {len(lat)} messages: p50 "
            f"{nearest_rank(lat, 0.5):.3f} p95 {nearest_rank(lat, 0.95):.3f} "
            f"p99 {nearest_rank(lat, 0.99):.3f}")
        values["publish_p95_ms"] = nearest_rank(lat, 0.95)

    rec = Record(cell, conf, mix, seconds, win, log, setup, spans, summary,
                 router)
    metrics = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in man.metrics(workload, kind):
        v = values.get(m["name"]) if kind == "end_to_end" \
            else man.reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name() if on_card else device,
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    out = {"correct": all(cmp["counts"][k] <= LIMITS[k] for k in LIMITS)
           and cmp["checked"] > 0,
           "attempted": cmp["checked"], "failed": len(faulty),
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        top = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1])
        idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [list(kv) for kv in top[:10]],
                            "idle_gaps": [list(kv) for kv in idle[:10]]}
    out["compared"] = {k: {"value": cmp["counts"][k], "limit": LIMITS[k]}
                       for k in LIMITS}
    return out
