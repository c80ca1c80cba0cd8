"""A run with the timed path broken underneath comes out not correct: the
routing answers of the model, where the step's result is decoded, altered
in each of the ways a step can go wrong on one card (the cells use no
exchange between cards)."""

import pytest

from benchmark import harness
from conftest import add_rate_cell


def fault(kind):
    from emqx_tpu_torch.models.router_model import RouterModel
    orig = RouterModel.publish_batch_collect
    prev = {}

    def collect(self, pending):
        matched, aux, slots, fallback = orig(self, pending)
        n = len(matched)
        if kind == "half":             # half of the batch left out
            for j in range(n // 2, n):
                matched[j], slots[j] = [], []
        elif kind == "stale":          # the step answers with its last state
            last = prev.get("res")
            prev["res"] = (matched, aux, slots)
            if last is not None:
                pad = [[]] * n
                matched, aux, slots = ((x + pad)[:n] for x in last)
                fallback = []
        elif kind == "altered":        # one answer altered where produced
            if n > 1 and matched[0] != matched[1]:
                matched[0] = list(matched[1])
        return matched, aux, slots, fallback

    return collect


@pytest.mark.parametrize("kind", ["half", "stale", "altered"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_broken_step_is_not_correct(tiny, monkeypatch, kind, loop):
    from emqx_tpu_torch.models.router_model import RouterModel
    cell = "fleet-1m.plain" if loop == "closed" else add_rate_cell(tiny)
    monkeypatch.setattr(RouterModel, "publish_batch_collect", fault(kind))
    out = harness.run(cell, 99, 0.5, False, device="cpu", root=tiny)
    assert out["correct"] is False and out["failed"] > 0
    assert out["compared"]["missing_deliveries"]["value"] > 0
