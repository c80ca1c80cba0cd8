"""``run.py`` end to end at a tiny size on the CPU (the look for a card
skipped): a well-formed last line for every cell, traced and not; and no
result without a card."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import run
from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def wanted(cell, kind):
    return {m["name"] for m in DOC[kind]
            if cell in m.get("workloads", [cell])}


def execute(root, cell, trace, device="cpu"):
    out, err = io.StringIO(), io.StringIO()
    args = run.parse(["--workload", cell, "--seed", str(2**33 + 7),
                      "--seconds", "0.5", "--trace", str(trace)])
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.execute(args, device, root=root)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny, cell, trace):
    rc, out, err = execute(tiny, cell, trace)
    assert rc == 0
    res = json.loads(out[-1])
    assert list(res)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    assert set(res["metrics"]) <= wanted(cell, kind)
    if not trace:
        assert set(res["metrics"]) == wanted(cell, kind)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    compared = [ln for ln in err if ln.startswith("compared ")]
    assert err[-len(compared):] == compared
    assert len(compared) == len(res["compared"])


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


@pytest.mark.cuda
def test_on_the_card(card, tiny):
    rc, out, _ = execute(tiny, CELLS[0], 1, device=card)
    res = json.loads(out[-1])
    assert rc == 0 and res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0


def test_a_sharded_configuration_is_added_by_entries(tiny):
    """A configuration on the subscription-sharded trie is a file and
    entries: the same app, handed a ``ShardedTrieIndex`` model."""
    conf = json.loads((tiny / "benchmark/configs/fleet-1m.json").read_text())
    conf.update(name="fleet-s2", trie_shards=2)
    (tiny / "benchmark/configs/fleet-s2.json").write_text(json.dumps(conf))
    doc = json.loads((tiny / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "fleet-s2", "source": "a test",
                           "file": "benchmark/configs/fleet-s2.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "fleet-s2.plain", "config": "fleet-s2",
                             "traffic": "plain", "chips": 1, "why": "a test"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "fleet-1m.plain" in m.get("workloads", []):
            m["workloads"].append("fleet-s2.plain")
    (tiny / "BENCHMARK.json").write_text(json.dumps(doc))
    rc, out, _ = execute(tiny, "fleet-s2.plain", 1)
    res = json.loads(out[-1])
    assert rc == 0 and res["correct"] and res["attempted"] > 0
    from emqx_tpu_torch.router.index import ShardedTrieIndex
    from benchmark import system
    sut = system.build(conf, "cpu", str(tiny))
    assert isinstance(sut.model.index, ShardedTrieIndex)
    assert sut.app is not None and sut.fold is sut.app.device_metrics
