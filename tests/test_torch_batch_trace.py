"""The publish path's batch traces on the port: one ``BatchTrace`` a sampled
``PublishPipeline`` batch, carried through the broker, the model and the CM
and committed to the kernel fold's ``SpanCollector``.

Every case runs the port's app over a port ``RouterModel`` on the CPU (the
routing step's plain kernels; ``tests/conftest.py`` pins them)."""

from __future__ import annotations

import zlib

import pytest

from emqx_tpu_torch import RouterModel
from emqx_tpu_torch.app import BrokerApp
from emqx_tpu_torch.config.config import Config
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.observe import trace as tracing
from emqx_tpu_torch.router.index import TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

PIPELINE_SPANS = {"pipeline.queue", "pipeline.assemble", "pipeline.merge",
                  "pipeline.deliver"}
BROKER_SPANS = {"broker.fold", "broker.collect", "cm.dispatch"}
MODEL_SPANS = {"model.tokenize", "model.launch", "model.wait",
               "model.decode"}
COUNTERS = {"expand_ns", "expand_probes", "deliveries", "route_walk_ns",
            "route_walks", "route_walk_hits", "route_walk_away",
            "away_routes"}


class Channel:
    def __init__(self) -> None:
        self.got: list = []

    def handle_deliver(self, items):
        return items

    def send(self, items) -> None:
        self.got.extend(items)


def device_app(n_sub_slots: int = 64) -> BrokerApp:
    conf = Config()
    conf.put("router.device.enable", True)
    conf.put("router.device.min_batch", 0)
    model = RouterModel(TrieIndex(max_levels=8), device="cpu",
                        n_sub_slots=n_sub_slots, kernel_telemetry=True)
    model.refresh()
    return BrokerApp.from_config(conf, router_model=model)


def subscribe(app: BrokerApp, sid: str, *filters: str) -> Channel:
    for f in filters:
        app.broker.subscribe(sid, f)
    ch = app.cm.lookup_channel(sid)
    if ch is None:
        ch = Channel()
        app.cm.register_channel(sid, ch)
    return ch


def publish(app: BrokerApp, *topics: str) -> list:
    msgs = [Message(topic=t, payload=b"x") for t in topics]
    for m in msgs:
        app.pipeline.submit(m)
    app.pipeline.flush()
    return msgs


def spans_of(batch) -> dict:
    out = {}
    for name, t0, t1, n in batch.spans:
        assert name not in out, f"{name} twice"
        assert t0 <= t1, name
        out[name] = (t0, t1, n)
    return out


def inside(outer, inner) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_batch_is_one_trace_nested_with_its_message_ids():
    app = device_app()
    ring = app.trace_batches(1, 16)
    chs = [subscribe(app, f"s{i}", "a/+") for i in range(2)]
    msgs = publish(app, "a/b", "a/c", "z/z")
    assert [len(ch.got) for ch in chs] == [2, 2]
    (batch,) = ring.batches()
    assert batch.trace_id == 1
    assert batch.msg_ids == [m.id for m in msgs]
    assert ring.find(msgs[2].id) is batch and ring.find(-1) is None
    sp = spans_of(batch)
    # the subscriptions left the tables dirty: the submit patched them
    assert set(sp) == (PIPELINE_SPANS | BROKER_SPANS | MODEL_SPANS
                       | {"model.refresh"})
    assert set(batch.counters) == COUNTERS
    for name in PIPELINE_SPANS | MODEL_SPANS | {"broker.fold",
                                                "broker.collect"}:
        assert sp[name][2] == 3, name
    assert sp["cm.dispatch"][2] == 2          # sessions reached
    # submit side, in order: queue, assemble, fold, refresh, tokenize,
    # launch; collect side: the model's wait and decode inside the
    # broker's collect, then merge, then deliver around the CM's dispatch
    order = ["pipeline.queue", "pipeline.assemble", "broker.fold",
             "model.refresh", "model.tokenize", "model.launch"]
    for a, b in zip(order, order[1:]):
        assert sp[a][1] <= sp[b][0], (a, b)
    assert sp["pipeline.queue"][1] == sp["pipeline.assemble"][0]
    assert sp["model.wait"][1] <= sp["model.decode"][0]
    assert inside(sp["broker.collect"], sp["model.wait"])
    assert inside(sp["broker.collect"], sp["model.decode"])
    assert sp["model.launch"][1] <= sp["broker.collect"][0]
    assert sp["broker.collect"][1] <= sp["pipeline.merge"][0]
    assert sp["pipeline.merge"][1] <= sp["pipeline.deliver"][0]
    assert inside(sp["pipeline.deliver"], sp["cm.dispatch"])
    # the kernel fold's points under the batch's id, served with the
    # intervals and counters by the tracing-spans surface
    fold = app.device_metrics
    assert fold.last_trace_id == 1
    assert ring.stages(1) == ["kernel_submit", "kernel_collect"]
    (entry,) = app.native_spans_fn(4)
    assert entry["trace_id"] == f"{1:016x}" and entry["messages"] == 3
    assert [s["stage"] for s in entry["spans"]] == ["kernel_submit",
                                                    "kernel_collect"]
    assert {i["name"] for i in entry["intervals"]} == set(sp)
    assert entry["counters"] == batch.counters
    # a clean table: no refresh span in the next batch
    publish(app, "a/d")
    assert "model.refresh" not in spans_of(ring.batch(2))


def test_sampling_off_records_nothing():
    app = device_app()
    ring = app.trace_batches(0, 16)
    subscribe(app, "s0", "a/+")
    app.pipeline.max_batch = 1
    publish(app, "a/b", "a/c", "a/d")
    assert app.pipeline.batches == 3
    assert len(ring) == 0 and ring.batches() == []
    assert app.device_metrics.batches == 3
    assert app.device_metrics.last_trace_id == 0


@pytest.mark.parametrize("every", [1, 3, 8])
def test_sample_every_n_traces_batches_1_n_plus_1(every):
    app = device_app()
    ring = app.trace_batches(every, 64)
    subscribe(app, "s0", "a/+")
    app.pipeline.max_batch = 1
    publish(app, *[f"a/{i}" for i in range(10)])
    want = list(range(1, 11, every))
    assert [b.trace_id for b in ring.batches()] == want
    assert sorted(t for t, _ in ring.recent(64)) == want


def test_ring_keeps_the_newest_traces():
    app = device_app()
    ring = app.trace_batches(1, 3)
    subscribe(app, "s0", "a/+")
    app.pipeline.max_batch = 1
    publish(app, *[f"a/{i}" for i in range(5)])
    assert [b.trace_id for b in ring.batches()] == [3, 4, 5]
    assert len(ring) == 3


def _sids_by_slot(n_each: int) -> list[list[str]]:
    """Session ids that a 2-slot registry puts ``n_each`` to a slot: the
    first two take slots 0 and 1, the rest hash (crc32) into them."""
    by_slot = [["u0"], ["u1"]]
    i = 2
    while min(map(len, by_slot)) < n_each:
        sid = f"u{i}"
        slot = by_slot[zlib.crc32(sid.encode()) % 2]
        if len(slot) < n_each:
            slot.append(sid)
        i += 1
    return by_slot


def test_expansion_counters_on_a_planted_table():
    """2 slots x 4 sessions x 2 matched filters: the sessions of slot 0
    hold both filters, those of slot 1 one, so the walk checks the 8
    subscribers of ``a/+`` and the 4 of ``a/#`` against the row's slots:
    12 probes, 12 deliveries.  A fifth session in slot 0 that holds no
    matching subscription adds no probe (a slot -> session -> filter walk
    would probe 2 x 9 pairs) and gets nothing."""
    app = device_app(n_sub_slots=2)
    ring = app.trace_batches(1, 16)
    (*both, bystander), one = _sids_by_slot(5)
    one = one[:4]
    for a, b in zip(both, one):      # slots 0, 1 first, in that order
        subscribe(app, a, "a/+", "a/#")
        subscribe(app, b, "a/+")
    idle = subscribe(app, bystander, "z/1")
    assert {app.broker.slots.lookup_slot(s) for s in both} == {0}
    assert {app.broker.slots.lookup_slot(s) for s in one} == {1}
    assert app.broker.slots.lookup_slot(bystander) == 0
    publish(app, "a/b")
    (batch,) = ring.batches()
    c = batch.counters
    assert c["expand_probes"] == 4 * 2 + 4 * 1
    assert c["deliveries"] == 4 * 2 + 4 * 1
    assert idle.got == []
    assert c["route_walks"] == 1 and c["route_walk_hits"] == 0
    assert c["expand_ns"] > 0 and c["route_walk_ns"] > 0
    # a plain table on one node: every route is the node's own, so the
    # walk covers the router's empty away index
    assert c["away_routes"] == 0
    assert c["route_walk_away"] == c["route_walks"]


def test_route_walk_hits_a_shared_subscription():
    app = device_app()
    ring = app.trace_batches(1, 16)
    subscribe(app, "s0", "a/+")
    member = subscribe(app, "g0", "$share/g/a/+")
    publish(app, "a/b", "b/c")
    (batch,) = ring.batches()
    c = batch.counters
    assert c["route_walks"] == 2 and c["route_walk_hits"] == 1
    assert len(member.got) == 1
    # the shared route is the away index's one route, and the walk over
    # the index alone still finds its leg
    assert c["away_routes"] == 1 and c["route_walk_away"] == 2


def test_model_fold_and_spans_read_the_one_clock(monkeypatch):
    """Every timestamp of a traced batch, the model's and the kernel
    fold's included, comes from ``observe.trace.now_ns``."""
    base = 10 ** 15
    ticks = iter(range(base, base + 10 ** 9, 1000))
    app = device_app()
    ring = app.trace_batches(1, 16)
    subscribe(app, "s0", "a/+")
    monkeypatch.setattr(tracing, "now_ns", lambda: next(ticks))
    publish(app, "a/b")
    (batch,) = ring.batches()
    stamps = [t for _, t0, t1, _ in batch.spans for t in (t0, t1)]
    stamps += [t for t, *_ in ring.trace(batch.trace_id)]
    assert len(stamps) == 2 * len(batch.spans) + 2
    assert all(base <= t < base + 10 ** 9 and t % 1000 == 0
               for t in stamps)
    sp = spans_of(batch)
    # the fold's points are the model's submit start and wait end
    (t_submit, _, *_), (t_collect, *_) = ring.trace(batch.trace_id)
    assert t_submit <= sp["model.tokenize"][0]
    assert t_collect == sp["model.wait"][1]
