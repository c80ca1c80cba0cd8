"""CPU tests of the benchmark: ``python -m pytest benchmark/tests`` from the
repository's root.  Tests that need the card carry the ``cuda`` marker and
skip without one (the ``card`` fixture decides)."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# the CPU model runs the step's plain versions, not the host matcher
os.environ.setdefault("EMQX_TPU_CPU_KERNEL", "xla")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def make_tiny(root: Path, subscriptions: int = 4000, sessions: int = 512,
              pool: int = 1024, rate: int = 1000) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``root`` with
    every configuration and mix cut to a size a CPU test holds."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (root / "benchmark" / "configs").glob("*.json"):
        d = json.loads(f.read_text())
        d["subscriptions"], d["sessions"] = subscriptions, sessions
        f.write_text(json.dumps(d))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        d["topic_pool"] = pool
        d["warm_s"] = min(d["warm_s"], 0.2)
        if d["loop"] == "open":
            d["rate"] = rate
        if "broadcast" in d:
            d["broadcast"]["sessions_each"] = 16
        f.write_text(json.dumps(d))
    return root


@pytest.fixture
def tiny(tmp_path) -> Path:
    return make_tiny(tmp_path / "checkout")


RATE_CELL = "fleet-1m.plain-rate"
LAT_METRICS = ("pipeline.queue_ms_p95.lat", "broker.map_build_us_per_msg.lat",
               "device.idle_share.lat")


def add_rate_cell(root: Path) -> str:
    """Add the open-loop cell that waits in PERF.md's open questions to the
    copy's ``BENCHMARK.json``, as a later PR would: entries only, over the
    mix file and readers already under ``benchmark/``."""
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": RATE_CELL, "config": "fleet-1m",
                             "traffic": "plain-rate", "chips": 1,
                             "why": "the plain topics as a Poisson stream"})
    doc["end_to_end"].append({"name": "publish_p95_ms", "unit": "ms",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": [RATE_CELL]})
    layer = {"pipeline": "pipeline", "broker": "broker", "device": "device"}
    for name in LAT_METRICS:
        doc["per_layer"].append({"name": name, "unit": "ms",
                                 "better": "lower", "source": "program_span",
                                 "layer": layer[name.split(".")[0]],
                                 "moves": "publish_p95_ms",
                                 "workloads": [RATE_CELL]})
    for m in doc["per_layer"]:
        if m["name"].startswith("setup."):
            m["workloads"].append(RATE_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return RATE_CELL
