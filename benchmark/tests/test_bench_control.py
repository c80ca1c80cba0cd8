"""The control (``benchmark/control.py``: the reference in the program's
place, with its exact-topic fast path) comes out not correct, in every
cell, while the reference itself, put in the same place, comes out
correct."""

import json

import pytest

from benchmark import control, harness
from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny, cell):
    out = control.run(cell, 2**32 + 3, 0.5, root=tiny)
    assert out["correct"] is False
    assert out["compared"]["missing_deliveries"]["value"] > 0


def test_reference_in_the_same_place_passes(tiny, monkeypatch):
    from benchmark.reference.router import ReferenceRouter
    monkeypatch.setattr(control, "FastPathRouter", ReferenceRouter)
    out = harness.run(CELLS[0], 3, 0.5, False, device="cpu", root=tiny,
                      build=control.build)
    assert out["correct"] is True
