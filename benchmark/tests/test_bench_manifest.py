"""``BENCHMARK.json`` against the benchmark's contract: names, units, keys,
which cells report which metrics, and the files it names."""

import json
import math
import re

import pytest

from benchmark.manifest import Manifest
from conftest import ROOT

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {m["name"]: m for m in DOC["end_to_end"]}
CELLS = {w["name"]: w for w in DOC["workloads"]}


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(DOC["command"]) <= 32 and all(map(line, DOC["command"]))
    assert 1 <= len(DOC["paths"]) <= 16
    for p in DOC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(DOC["run_seconds"], int) and \
        1 <= DOC["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert ((2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DOC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in DOC["end_to_end"] + DOC["per_layer"])) \
        == len(DOC["end_to_end"]) + len(DOC["per_layer"])
    assert len(set(CELLS)) == len(DOC["workloads"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs():
    assert 1 <= len(DOC["configs"]) <= 24
    used = {w["config"] for w in DOC["workloads"]}
    files = set()
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        assert "guarantees" in conf


def test_workloads():
    assert 1 <= len(DOC["workloads"]) <= 24
    pairs = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(DOC["workloads"]) // 4)


def test_end_to_end():
    assert 1 <= len(DOC["end_to_end"]) <= 16 and "setup_s" in E2E
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        got = [m for m in DOC["end_to_end"] if reports(cell, m)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2


def test_per_layer():
    assert 1 <= len(DOC["per_layer"]) <= 128
    layers = {}
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in E2E
        # every cell it lists reports the end-to-end metric it moves
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and reports(cell, E2E[m["moves"]]), \
                (m["name"], cell)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        assert any(reports(cell, m) for m in DOC["per_layer"])


def test_every_cell_is_found_by_name():
    man = Manifest(ROOT)
    for name, w in CELLS.items():
        conf = man.config(w["config"])
        mix = man.traffic(w["traffic"])
        gen = man.generator(conf["generator"])
        assert callable(gen.subscriptions) and mix["loop"] in ("open",
                                                               "closed")
        for kind in ("end_to_end", "per_layer"):
            for m in man.metrics(name, kind):
                if kind == "per_layer":
                    assert callable(man.reader(m["name"]))


@pytest.mark.parametrize("x", [0.0, 1.0, 2.5])
def test_percentile_rule(x):
    from benchmark.yardstick import nearest_rank
    vals = [x] * 19 + [math.inf]
    assert nearest_rank(vals, 0.95) == x
    assert nearest_rank(vals + [math.inf], 0.95) == math.inf
