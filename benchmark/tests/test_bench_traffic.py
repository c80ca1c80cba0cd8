"""The generators are deterministic from the seed; an open loop's gaps are
the same set for every seed; a new mix is a new file found by name."""

import json

import numpy as np

from benchmark import drive, harness
from benchmark.manifest import Manifest
from conftest import LAT_METRICS, add_rate_cell, make_tiny


def draw(root, seed):
    man = Manifest(root)
    conf, mix = man.config("fleet-1m"), man.traffic("dense")
    gen = man.generator(conf["generator"])
    rng = harness.seeds(seed)
    table = gen.subscriptions(conf, rng["table"])
    pool = gen.topic_pool(table, conf, mix, rng["topics"])
    return table, pool, gen.overlay(mix, conf, rng["overlay"])


def test_generators_follow_the_seed(tiny):
    big = 2**31 + 12345
    a, b, c = draw(tiny, big), draw(tiny, big), draw(tiny, big + 1)
    assert a == b
    assert a[0] != c[0] and a[1] != c[1] and a[2] != c[2]
    table, pool, overlay = a
    assert len(table) == 4000 and len(pool) == 1024
    assert len(overlay) == 24 * 16
    # every topic is a subscribed filter with its wildcards filled in
    from benchmark.reference.router import ReferenceRouter
    r = ReferenceRouter(table)
    assert all(r.match(t) for t in pool)


def test_arrivals_are_one_set_of_gaps():
    mix = {"rate": 500.0, "warm_s": 1.0}
    d1 = drive.arrivals(mix, 3.0, np.random.default_rng(1))
    d2 = drive.arrivals(mix, 3.0, np.random.default_rng(2))
    assert len(d1) == len(d2) == 2000
    assert not np.array_equal(d1, d2)
    g1, g2 = np.diff(d1, prepend=0), np.diff(d2, prepend=0)
    assert np.allclose(np.sort(g1), np.sort(g2), atol=2)
    assert abs(d1[-1] / 1e9 - 4.0) < 0.1          # the mean rate is 500/s


def test_a_new_mix_is_found_by_name(tmp_path):
    root = make_tiny(tmp_path / "checkout")
    mix = json.loads((root / "benchmark/traffic/plain.json").read_text())
    mix.update(publishers=8, inflight=4)
    (root / "benchmark/traffic/few-publishers.json").write_text(
        json.dumps(mix))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "fleet-1m.few-publishers",
                             "config": "fleet-1m",
                             "traffic": "few-publishers", "chips": 1,
                             "why": "a mix added as a file"})
    for m in doc["end_to_end"]:
        if m["name"] == "msgs_per_s":
            m["workloads"].append("fleet-1m.few-publishers")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    out = harness.run("fleet-1m.few-publishers", 5, 0.5, False,
                      device="cpu", root=root)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"msgs_per_s", "setup_s"}


def test_an_open_loop_cell_is_added_by_entries(tiny):
    cell = add_rate_cell(tiny)
    out = harness.run(cell, 2**31 + 1, 0.5, False, device="cpu", root=tiny)
    assert out["correct"] and set(out["metrics"]) == {"publish_p95_ms",
                                                      "setup_s"}
    out = harness.run(cell, 2**31 + 1, 0.5, True, device="cpu", root=tiny)
    assert out["correct"]
    # the device's idle share needs the card's trace; the rest are read
    assert set(out["metrics"]) == set(LAT_METRICS[:2]) | {
        "setup.subscribe_s", "setup.refresh_s"}
