"""The readers of the program's spans (``program_spans.py``) on made-up batch
traces and device intervals, and a tiny run of the cell with the program's
ring attached, on the CPU."""

import math
from types import SimpleNamespace

import pytest

from benchmark import program_spans as ps
from benchmark.manifest import Manifest
from conftest import ROOT
from emqx_tpu_torch.observe.trace import BatchTrace, SpanCollector

CELL = "fleet-1m.plain"
SPANS = {"pipeline.assemble", "pipeline.merge", "pipeline.deliver",
         "broker.fold", "broker.collect", "cm.dispatch", "model.refresh",
         "model.tokenize", "model.launch", "model.wait", "model.decode"}
WINDOW = (1_000, 100_000)


def batch(tid, n, t0, spans=(), **counters):
    """A committed-style trace of ``n`` messages popped at ``t0``; its
    ``spans`` are ``(name, offset from t0, length)``."""
    bt = BatchTrace(tid, list(range(tid * 1000, tid * 1000 + n)))
    bt.span("pipeline.assemble", t0, t0 + 10, n)
    for name, off, length in spans:
        bt.span(name, t0 + off, t0 + off + length, n)
    bt.counters.update(counters)
    return bt


def ring(*batches):
    r = SpanCollector(max_traces=16)
    for b in batches:
        r.commit(b)
    return r


def record(program, trace=None):
    lo, hi = WINDOW
    return SimpleNamespace(program=program, trace=trace,
                           in_window=lambda t: lo <= t < hi)


def read(name, rec):
    return Manifest(ROOT).reader(name)(rec)


def test_readers_sum_the_window_batches_over_their_messages():
    before = batch(1, 100, 500, [("pipeline.merge", 20, 5_000)],
                   expand_ns=10**6)
    a = batch(2, 4, 2_000, [("pipeline.merge", 20, 30),
                            ("broker.fold", 40, 4_000),
                            ("model.wait", 50, 8_000)],
              expand_ns=2_000, expand_probes=16, deliveries=12,
              route_walk_ns=6_000, route_walks=4, route_walk_hits=0)
    b = batch(3, 6, 50_000, [("pipeline.merge", 20, 50),
                             ("broker.fold", 40, 6_000),
                             ("model.wait", 50, 2_000)],
              expand_ns=8_000, expand_probes=4, deliveries=4,
              route_walk_ns=4_000, route_walks=6, route_walk_hits=1)
    after = batch(4, 8, 100_000, expand_ns=10**6)
    rec = record(ring(before, a, b, after))
    assert ps.in_window(rec) == [a, b]
    # 10 messages: assemble 10 + 10 ns, merge 30 + 50 ns
    assert read("pipeline.loop_us_per_msg.tput", rec) == \
        pytest.approx(100 / 1e3 / 10)
    assert read("broker.expand_us_per_msg.tput", rec) == \
        pytest.approx(10_000 / 1e3 / 10)
    assert read("broker.expand_yield.tput", rec) == pytest.approx(16 / 20)
    assert read("broker.route_walk_us_per_msg.tput", rec) == \
        pytest.approx(10_000 / 1e3 / 10)
    assert read("broker.route_walk_yield.tput", rec) == pytest.approx(0.1)
    assert read("model.wait_us_per_msg.tput", rec) == \
        pytest.approx(10_000 / 1e3 / 10)
    assert read("broker.fold_span_us_per_msg.tput", rec) == \
        pytest.approx(10_000 / 1e3 / 10)


@pytest.mark.parametrize("name", list(ps.METRICS))
def test_readers_silent_without_the_program(name):
    """A record without the ring (the harness as it is, or a program
    without batch traces) or with no batch in the window reads nothing."""
    no_ring = SimpleNamespace(trace=None, in_window=lambda t: True)
    assert read(name, no_ring) is None
    empty = record(ring(batch(1, 4, 10)), trace={"busy_s": 0.0})
    assert read(name, empty) is None


def test_idle_split_by_innermost_program_span():
    dev = [(10.0, 20.0), (60.0, 70.0)]
    b = BatchTrace(1, [1])
    # on now_ns: 1 ns maps to 1 us of the profiler's clock, shifted by 5
    b.span("pipeline.deliver", -5, 45, 1)
    b.span("cm.dispatch", 0, 35, 1)
    b.span("broker.collect", 50, 95, 1)
    b.span("pipeline.queue", 0, 95, 1)       # a wait: left out
    out = ps.idle_by_program(dev, lambda ns: ns + 5.0, [b], 0.0, 100.0)
    # idle: 0-10 (deliver 0-5, cm 5-10), 20-60 (cm 20-40, deliver 40-50,
    # outside 50-55, collect 55-60), 70-100 (collect)
    assert out == pytest.approx({"pipeline.deliver": 15e-6,
                                 "cm.dispatch": 25e-6, "outside": 5e-6,
                                 "broker.collect": 35e-6})
    share = read("device.idle_outside_spans_share.tput",
                 SimpleNamespace(trace={"idle_by_program": out}))
    assert share == pytest.approx(5 / 80)


def test_traced_run_reports_the_program_metrics(tiny):
    out = ps.run(CELL, 2**33 + 11, 1.5, True, device="cpu", root=tiny)
    assert out["correct"] is True and out["program_batches"] > 0
    for name, unit in ps.METRICS.items():
        m = out["metrics"][name]
        assert m["unit"] == unit and math.isfinite(m["value"]), name
    assert 0 < out["metrics"]["broker.expand_yield.tput"]["value"] <= 1
    assert out["metrics"]["broker.route_walk_yield.tput"]["value"] == 0
    share = out["metrics"]["device.idle_outside_spans_share.tput"]["value"]
    assert 0 <= share < 1
    # no device interval on the CPU: the split covers the whole window,
    # by the program's spans (queue waits left out) and what none covers
    idle = dict(out["breakdown"]["idle_by_program"])
    assert sum(idle.values()) == pytest.approx(out["device"]["window_s"])
    assert set(idle) <= SPANS | {"outside"} and idle.keys() & SPANS
    # beside the cell's accepted per-layer metrics
    accepted = {m["name"] for m in Manifest(tiny).metrics(CELL, "per_layer")}
    assert set(out["metrics"]) <= accepted | set(ps.METRICS)
    assert "pipeline.batch_fill.tput" in out["metrics"]


@pytest.mark.parametrize("every", [None, 1])
def test_untraced_run_attaches_no_ring_to_the_record(tiny, every):
    """``--trace 0`` reads the end-to-end metrics alone; a sampling set for
    the cost of tracing reaches the program and no reader."""
    out = ps.run(CELL, 2**33 + 13, 0.5, False, device="cpu", root=tiny,
                 sample_every=every)
    assert out["correct"] is True
    doc = Manifest(tiny).doc
    assert set(out["metrics"]) == {
        m["name"] for m in doc["end_to_end"]
        if CELL in m.get("workloads", [CELL])}
    assert "program_batches" not in out and "breakdown" not in out
