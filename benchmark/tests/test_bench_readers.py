"""The device readers on a made-up trace: what a traced run on the card
hands them, so their arithmetic is checked without the card."""

from types import SimpleNamespace

import pytest

from benchmark.manifest import Manifest
from benchmark.spans import FANOUT_KERNEL, WALK_KERNEL, idle_by_host
from conftest import ROOT


def run(trace, work):
    return SimpleNamespace(trace=trace, work=lambda: work)


def test_rooflines_and_idle():
    man = Manifest(ROOT)
    trace = {"busy_s": 0.5, "window_s": 50.0, "device_events": 10,
             "kernels": {WALK_KERNEL: [2e-5, 4e-5], FANOUT_KERNEL: [1e-5]}}
    work = [(67_000, 3_350_000), (67_000, 3_350_000)]
    walk = man.reader("kernel.walk_roofline.tput")(run(trace, work))
    fan = man.reader("kernel.fanout_roofline.tput")(run(trace, work))
    # 67 kB at 3.35 TB/s is 20 ns, over a 30 us mean launch
    assert walk == pytest.approx(100 * 2e-8 / 3e-5)
    assert fan == pytest.approx(100 * 1e-6 / 1e-5)
    idle = man.reader("device.idle_share.tput")(run(trace, work))
    assert idle == pytest.approx(0.99)
    empty = {**trace, "kernels": {WALK_KERNEL: [], FANOUT_KERNEL: []},
             "device_events": 0}
    assert man.reader("kernel.walk_roofline.tput")(run(empty, work)) is None
    assert man.reader("device.idle_share.lat")(run(empty, work)) is None
    assert man.reader("kernel.fanout_roofline.tput")(run(None, work)) is None


def test_idle_split_by_innermost_host_range():
    dev = [(10.0, 20.0), (60.0, 70.0)]
    host = [(0.0, 50.0, "fold"), (5.0, 40.0, "model_submit"),
            (55.0, 100.0, "map_build")]
    out = idle_by_host(dev, host, 0.0, 100.0)
    # idle: 0-10 (fold 0-5, submit 5-10), 20-60 (submit 20-40, fold
    # 40-50, harness 50-55, map 55-60), 70-100 (map)
    assert out == pytest.approx({"fold": 15e-6, "model_submit": 25e-6,
                                 "harness": 5e-6, "map_build": 35e-6})


def test_fanout_bytes_count_only_dense_rows():
    from benchmark.reference.router import ReferenceRouter
    from benchmark.reference.work import batch_bytes
    from benchmark.yardstick import DENSE_THRESHOLD
    wide = [(f"s{i}", "a/+") for i in range(DENSE_THRESHOLD + 1)]
    table = wide + [("t0", "a/b"), ("t1", "a/c"), ("t2", "a/#")]
    r = ReferenceRouter(table)
    slots, row = 8192, 8192 // 8
    # a/b: a/+, a/b, a/#; a/c: a/+, a/c, a/#; only a/+ owns a pool row
    walk, fan = batch_bytes(r, ["a/b", "a/c"], slots)
    assert fan == 8 * 6 + 1 * row + 2 * row
    # with no filter over the threshold no pool row is read
    _, sparse = batch_bytes(ReferenceRouter(table[-3:]), ["a/b"], slots)
    assert sparse == 8 * 2 + 1 * row
