"""``BENCHMARK.json`` and the files it names, found by name under the
benchmark's own directories: ``configs/<config>.json``,
``traffic/<mix>.json`` (and the generator module ``traffic/<name>.py``
that a mix or a configuration names), ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Manifest:
    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def generator(self, name: str):
        return load_module(self.bench / "traffic" / f"{name}.py",
                           f"bench_traffic_{name}")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports: those
        that list it, and those that list no cells."""
        return [m for m in self.doc[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_")).read


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
