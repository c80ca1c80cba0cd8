"""The port's RouterModel on the serving path, and the port's fold and
broker around it.

The reference app takes its routing model by injection
(``BrokerApp(router_model=...)``, ``BrokerApp.from_config(conf,
router_model=...)``), so these tests put ``emqx_tpu_torch.RouterModel(
device="cpu")`` under the reference's ``BrokerApp`` and ``BrokerServer`` and
mirror the reference's serving tests, whose own model does not import on
jax 0.9.0 (``ROADMAP.md`` R1):

- the 11 tests of ``tests/test_device_serving.py`` (live MQTT clients over
  TCP, deliveries off batched steps, the host-oracle fallback, the
  pipeline's knee, depth and spill);
- ``tests/test_broker.py::test_publish_batch_device_path_equals_host``;
- the 5 device tests of ``tests/test_rules.py`` (rules co-batched into the
  step);
- ``tests/test_kernel_observe.py``: its fold and broker tests on the port's
  own ``DeviceMetricsFold``, ``Broker`` and model, and its app-level tests
  with the port's model injected.

The port package itself imports nothing of ``emqx_tpu``; only this test
does.  ``tests/conftest.py`` pins ``EMQX_TPU_CPU_KERNEL=xla``, so the port's
model runs its step (the kernels' plain versions) here.
"""

from __future__ import annotations

import asyncio

import pytest

from emqx_tpu.app import BrokerApp
from emqx_tpu.broker.server import BrokerServer
from emqx_tpu.config.config import Config
from emqx_tpu.core.message import Message as RefMessage
from emqx_tpu.mqtt import packet as P
from emqx_tpu.mqtt.client import MqttClient
from emqx_tpu_torch import RouterModel
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.observe.device_metrics import (KERNEL_COUNTER_FIELDS,
                                                   DeviceMetricsFold)
from emqx_tpu_torch.observe.metrics import DegradationLedger, Metrics
from emqx_tpu_torch.observe.trace import BatchTrace, SpanCollector
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)


def port_model(max_levels: int = 8, **kw) -> RouterModel:
    return RouterModel(TrieIndex(max_levels=max_levels), device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_device_serving.py, with the port's model
# ---------------------------------------------------------------------------


def make_device_app(**kw):
    conf = Config()
    conf.put("router.device.enable", True)
    conf.put("router.device.max_levels", 8)
    # every batch launches the step (the adaptive knee would send single
    # messages to the host oracle; the policy tests cover that)
    conf.put("router.device.min_batch", 0)
    # the model from_config would build, as the port's
    model = port_model(
        int(conf.get("router.device.max_levels")),
        n_sub_slots=int(conf.get("router.device.n_sub_slots")),
        K=int(conf.get("router.device.frontier_k")),
        M=int(conf.get("router.device.match_cap")),
        ret_cap=int(conf.get("router.device.return_cap")))
    model.refresh()
    return BrokerApp.from_config(conf, router_model=model, **kw)


@pytest.fixture
def run():
    def _run(scenario, app=None):
        async def main():
            server = BrokerServer(port=0, app=app or make_device_app())
            await server.start()
            try:
                await scenario(server)
            finally:
                await server.stop()
        asyncio.run(main())
    return _run


def test_from_config_builds_router_model():
    app = make_device_app()
    assert isinstance(app.broker.model, RouterModel)
    assert app.pipeline is not None
    assert app.pipeline.max_batch == 512
    assert app.device_metrics is not None


def test_e2e_delivery_via_kernel(run):
    async def scenario(server):
        model = server.app.broker.model
        sub = MqttClient(port=server.port, clientid="sub")
        pub = MqttClient(port=server.port, clientid="pub")
        await sub.connect()
        await pub.connect()
        await sub.subscribe("room/+/temp", qos=1)
        launches0 = model.launch_count
        await pub.publish("room/7/temp", b"21.5", qos=1)
        got = await sub.recv(timeout=60)
        assert got.topic == "room/7/temp" and got.payload == b"21.5"
        assert model.launch_count > launches0
        assert model.host_match_count == 0
        assert server.app.pipeline.published >= 1
        await sub.disconnect()
        await pub.disconnect()
    run(scenario)


def test_e2e_concurrent_publishers_batched(run):
    async def scenario(server):
        model = server.app.broker.model
        sub = MqttClient(port=server.port, clientid="sub")
        await sub.connect()
        await sub.subscribe("fleet/#", qos=0)
        n_pubs, n_msgs = 8, 10
        pubs = [MqttClient(port=server.port, clientid=f"p{i}")
                for i in range(n_pubs)]
        for p in pubs:
            await p.connect()
        launches0 = model.launch_count

        async def blast(i, p):
            for j in range(n_msgs):
                await p.publish(f"fleet/v{i}/m{j}", b"x", qos=0)

        await asyncio.gather(*(blast(i, p) for i, p in enumerate(pubs)))
        want = {f"fleet/v{i}/m{j}"
                for i in range(n_pubs) for j in range(n_msgs)}
        got = set()
        while len(got) < len(want):
            m = await sub.recv(timeout=30)
            assert m.topic not in got, "duplicate delivery"
            got.add(m.topic)
        assert got == want
        assert model.launch_count - launches0 >= 1
        assert server.app.pipeline.published >= n_pubs * n_msgs
        for p in pubs:
            await p.disconnect()
        await sub.disconnect()
    run(scenario)


def test_e2e_ordering_per_publisher(run):
    async def scenario(server):
        sub = MqttClient(port=server.port, clientid="sub")
        pub = MqttClient(port=server.port, clientid="pub")
        await sub.connect()
        await pub.connect()
        await sub.subscribe("seq/t", qos=1)
        for i in range(20):
            await pub.publish("seq/t", b"%d" % i, qos=1)
        seen = [int((await sub.recv(timeout=30)).payload) for _ in range(20)]
        assert seen == list(range(20))
        await sub.disconnect()
        await pub.disconnect()
    run(scenario)


def test_e2e_host_oracle_fallback_deep_topic(run):
    async def scenario(server):
        sub = MqttClient(port=server.port, clientid="sub")
        pub = MqttClient(port=server.port, clientid="pub")
        await sub.connect()
        await pub.connect()
        await sub.subscribe("deep/#", qos=0)
        deep = "deep/" + "/".join(str(i) for i in range(12))   # 13 levels
        await pub.publish(deep, b"fb", qos=0)
        got = await sub.recv(timeout=30)
        assert got.topic == deep and got.payload == b"fb"
        await sub.disconnect()
        await pub.disconnect()
    run(scenario)


def test_e2e_shared_and_retained_still_work(run):
    async def scenario(server):
        a = MqttClient(port=server.port, clientid="a")
        b = MqttClient(port=server.port, clientid="b")
        pub = MqttClient(port=server.port, clientid="pub")
        await a.connect()
        await b.connect()
        await pub.connect()
        await a.subscribe("$share/g/t", qos=0)
        await b.subscribe("t", qos=0)
        await pub.publish("t", b"ret", qos=0, retain=True)
        got_b = await b.recv(timeout=30)
        assert got_b.payload == b"ret"
        got_a = await a.recv(timeout=30)
        assert got_a.payload == b"ret"
        c = MqttClient(port=server.port, clientid="c")
        await c.connect()
        await c.subscribe("t", qos=0)
        got_c = await c.recv(timeout=30)
        assert got_c.payload == b"ret" and got_c.retain
        for cl in (a, b, pub, c):
            await cl.disconnect()
    run(scenario)


def test_small_batch_host_bypass_policy(run):
    """Batches below the knee answer from the host oracle (no step); a
    burst above it runs the step.  The burst is one socket write and the
    spill deadline is far off, so the launch is a policy decision."""
    from emqx_tpu.mqtt.frame import serialize

    app = make_device_app()
    app.pipeline.min_device_batch = 4
    app.pipeline.spill_ms = 60_000.0

    async def scenario(server):
        model = app.broker.model
        sub = MqttClient(port=server.port, clientid="bp-s")
        await sub.connect()
        await sub.subscribe("kb/+", qos=0)
        pub = MqttClient(port=server.port, clientid="bp-p")
        await pub.connect()
        launches0 = model.launch_count
        for i in range(3):
            await pub.publish("kb/t", f"lo{i}".encode(), qos=0)
            m = await sub.recv(timeout=10)
            assert m.payload == f"lo{i}".encode()
        assert app.pipeline.host_batches >= 3
        assert model.launch_count == launches0, "bypass launched the step"
        burst = b"".join(
            serialize(P.Publish(topic="kb/t", payload=f"hi{i}".encode(),
                                qos=0, properties={}),
                      pub.proto_ver)
            for i in range(16))
        pub._writer.write(burst)
        await pub._writer.drain()
        got = sorted([(await sub.recv(timeout=10)).payload
                      for _ in range(16)])
        assert got == sorted(f"hi{i}".encode() for i in range(16))
        assert model.launch_count > launches0, "burst did not run the step"
        await sub.close()
        await pub.close()

    run(scenario, app=app)


def test_host_bypass_rules_still_fire(run):
    app = make_device_app()
    app.pipeline.min_device_batch = 8
    hits = []
    app.rules.register_action("sink", lambda cols, a: hits.append(cols))
    app.rules.create_rule("r", 'SELECT topic FROM "rb/#"',
                          [{"function": "sink", "args": {}}])

    async def scenario(server):
        sub = MqttClient(port=server.port, clientid="rb-s")
        await sub.connect()
        await sub.subscribe("rb/t", qos=0)
        pub = MqttClient(port=server.port, clientid="rb-p")
        await pub.connect()
        for _ in range(3):
            await pub.publish("rb/t", b"x", qos=0)
            await sub.recv(timeout=10)
        assert len(hits) == 3, hits
        await sub.close()
        await pub.close()

    run(scenario, app=app)


def test_adaptive_knee_tracks_measured_costs():
    from emqx_tpu_torch.broker.pipeline import PublishPipeline

    class FakeBroker:
        model = object()
    p = PublishPipeline(FakeBroker(), cm=None)
    p._rtt_ema = 0.070
    p._host_cost_ema = 5e-6
    assert p.device_knee() == p.max_batch
    p._rtt_ema = 0.001
    assert p.device_knee() == 200
    p.min_device_batch = 32
    assert p.device_knee() == 32
    p.broker.model = None
    assert p.device_knee() == 0


def test_pipeline_depth_preserves_order_and_raises_throughput(run):
    app = make_device_app()
    app.pipeline.depth = 4
    app.pipeline.max_batch = 8

    async def scenario(server):
        sub = MqttClient(port=server.port, clientid="dsub")
        pub = MqttClient(port=server.port, clientid="dpub")
        await sub.connect()
        await pub.connect()
        await sub.subscribe("dp/t", qos=0)
        for i in range(120):
            await pub.publish("dp/t", b"%d" % i, qos=0)
        seen = [int((await sub.recv(timeout=30)).payload)
                for _ in range(120)]
        assert seen == list(range(120))
        assert app.pipeline.batches >= 120 // 8
        await sub.disconnect()
        await pub.disconnect()
    run(scenario, app=app)


def test_sojourn_spill_bounds_loaded_latency():
    app = make_device_app()
    app.broker.subscribe("s1", "sp/t")
    pipe = app.pipeline
    pipe.depth = 2
    pipe.spill_ms = 5

    class _SpyCM:
        def __init__(self):
            self.got = []

        def dispatch(self, merged):
            self.got.append(merged)

    pipe.cm = _SpyCM()
    old = RefMessage(topic="sp/t", payload=b"x")
    old.timestamp -= 1000
    pipe.submit(old)
    pipe.flush()
    assert pipe.spilled_batches == 1, pipe.spilled_batches
    assert pipe.cm.got and "s1" in pipe.cm.got[0], pipe.cm.got


# ---------------------------------------------------------------------------
# tests/test_broker.py:160, on the port's broker and on the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["emqx_tpu_torch", "emqx_tpu"])
def test_publish_batch_device_path_equals_host(pkg):
    import importlib
    broker_mod = importlib.import_module(f"{pkg}.broker.broker")
    Msg = importlib.import_module(f"{pkg}.core.message").Message
    model = port_model(n_sub_slots=64)
    b = broker_mod.Broker(router_model=model)
    b.subscribe("s1", "t/+")
    b.subscribe("s2", "t/1")
    b.subscribe("s3", "zzz/#")
    msgs = [Msg(topic=t) for t in ("t/1", "t/2", "nope", "zzz/a/b")]
    got_dev = b.publish_batch(msgs)
    assert model.launch_count == 1

    b2 = broker_mod.Broker()
    for s, t in [("s1", "t/+"), ("s2", "t/1"), ("s3", "zzz/#")]:
        b2.subscribe(s, t)
    got_host = [b2.publish(m) for m in msgs]
    for dd, hh in zip(got_dev, got_host):
        assert {k: [t for t, _ in v] for k, v in dd.items()} == \
               {k: [t for t, _ in v] for k, v in hh.items()}


# ---------------------------------------------------------------------------
# the device tests of tests/test_rules.py, with the port's model
# ---------------------------------------------------------------------------


def _rules_app(model, rule_id, sql):
    app = BrokerApp(router_model=model)
    fired = []
    app.rules.register_action("record", lambda cols, args: fired.append(
        cols["topic"]))
    app.rules.create_rule(rule_id, sql, [{"function": "record", "args": {}}])
    return app, fired


def test_device_cobatch_fires_rules_once():
    model = port_model(n_sub_slots=64)
    app, fired = _rules_app(model, "rb", 'SELECT topic FROM "fleet/+/speed"')
    assert model.index.fid_of("fleet/+/speed") is not None
    app.broker.subscribe("subA", "fleet/#")
    launches0 = model.launch_count
    out = app.broker.publish_batch([
        RefMessage(topic="fleet/v1/speed", payload=b"1"),
        RefMessage(topic="fleet/v1/other", payload=b"2"),
    ])
    assert model.launch_count == launches0 + 1
    assert fired == ["fleet/v1/speed"]
    assert "subA" in out[0] and "subA" in out[1]
    app.broker.publish(RefMessage(topic="fleet/v2/speed", payload=b"3"))
    assert fired == ["fleet/v1/speed", "fleet/v2/speed"]


def test_cobatch_fallback_topic_still_fires_rules():
    model = port_model(4, n_sub_slots=64)
    app, fired = _rules_app(model, "rf", 'SELECT topic FROM "deep/#"')
    deep = "deep/a/b/c/d/e/f"
    app.broker.subscribe("subD", "deep/#")
    out = app.broker.publish_batch([RefMessage(topic=deep, payload=b"x")])
    assert fired == [deep]
    assert "subD" in out[0]
    assert app.ledger.totals()["kernel_overflow"] == 1


def test_rule_filter_shared_with_subscription_survives_unsubscribe():
    model = port_model(n_sub_slots=64)
    fid = model.aux_register("shared/+")
    model.subscribe("shared/+", slot=3)
    model.unsubscribe("shared/+", slot=3)
    assert model.index.fid_of("shared/+") == fid
    model.aux_release("shared/+")
    assert model.index.fid_of("shared/+") is None
    model.subscribe("keep/+", slot=1)
    model.aux_register("keep/+")
    model.aux_release("keep/+")
    assert model.index.fid_of("keep/+") is not None


def test_delayed_message_from_device_batch_still_fires_rules():
    model = port_model(n_sub_slots=64)
    app, fired = _rules_app(model, "rd", 'SELECT topic FROM "sensor/t"')
    app.broker.publish_batch(
        [RefMessage(topic="$delayed/1/sensor/t", payload=b"x")])
    assert fired == []
    assert len(app.delayed) == 1
    due, seq, msg = app.delayed._heap[0]
    app.delayed._heap[0] = (0, seq, msg)
    app.delayed.tick(now=1)
    assert fired == ["sensor/t"], "rule suppressed after delayed republish"


def test_denied_publish_still_fires_rules_on_device_path():
    model = port_model(n_sub_slots=64)
    app, fired = _rules_app(model, "rx", 'SELECT topic FROM "audit/#"')

    def deny(msg):
        msg.headers["allow_publish"] = False
        return msg

    app.hooks.add("message.publish", deny, priority=-200)
    out = app.broker.publish_batch(
        [RefMessage(topic="audit/evt", payload=b"x")])
    assert out == [{}]
    assert fired == ["audit/evt"], "rules must fire before the deny"


# ---------------------------------------------------------------------------
# tests/test_kernel_observe.py: the port's fold, broker and model
# ---------------------------------------------------------------------------

FAN_FILTERS = ["a/b/c/d", "a/b/c/+", "a/b/+/d", "a/b/+/+",
               "a/+/c/d", "a/+/c/+", "a/+/+/d", "a/+/+/+"]


def _fold(model, **kw):
    metrics = Metrics()
    ledger = DegradationLedger(metrics)
    fold = DeviceMetricsFold(metrics, ledger=ledger,
                             spans=SpanCollector(), model=model,
                             node="n1", **kw)
    model.telemetry = fold
    return metrics, ledger, fold


def _drive(model, topics):
    return model.publish_batch_collect(model.publish_batch_submit(topics))


def test_fold_counters_and_stage_hists_flat():
    model = port_model(n_sub_slots=64, kernel_telemetry=True)
    for f in ("a/+/c", "a/b/#", "d/e"):
        model.subscribe(f, 1)
    _metrics, _ledger, fold = _fold(model)
    _drive(model, ["a/b/c", "d/e", "x/y"])
    assert fold.batches == 1
    assert fold.last is not None and fold.last.n_shards == 1
    last = fold.last.as_dict()
    assert last["cand_pre"] == 3
    assert last["cand_post"] == 3
    assert last["overflow_rows"] == 0 and last["trunc_rows"] == 0
    assert last["frontier_peak"] >= 2 and last["probe_iters"] >= 1
    for h in fold.stage_hists().values():
        assert h.count == 1
    _drive(model, ["a/b/c"])
    assert fold.batches == 2
    assert fold.totals["cand_pre"] == 3 + 2
    ks = fold.kernel_summary()
    assert ks["batches"] == 2
    assert set(ks["counters"]) == set(KERNEL_COUNTER_FIELDS)
    assert ks["stages"]["step"]["count"] == 2


def test_fold_truncation_counter():
    model = port_model(n_sub_slots=64, M=1, kernel_telemetry=True)
    model.subscribe("t/+", 1)
    model.subscribe("t/1", 2)
    _metrics, _ledger, fold = _fold(model)
    _drive(model, ["t/1"])
    last = fold.last.as_dict()
    assert last["trunc_rows"] >= 1
    assert last["cand_post"] <= last["cand_pre"]


def test_fold_gauges_flat_and_upload_slots():
    model = port_model(n_sub_slots=64, kernel_telemetry=True)
    for f in ("a/b", "c/+", "d/#"):
        model.subscribe(f, 1)
    metrics, _ledger, fold = _fold(model)
    model.refresh()
    g = fold.gauges()
    assert g["filters_total"] == 3 and g["shards"] == 1
    assert g["shard_skew"] == 1.0
    assert 0 < g["node_occupancy"] < 1 and 0 < g["edge_load"] < 1
    assert g["uploads"] >= 1
    assert metrics.val("kernel.uploads") == model.upload_count >= 1
    model.subscribe("new/filter/x", 3)
    model.refresh()
    g = fold.gauges()
    assert g["upload_patches"] == model.patch_count >= 1
    assert g["patch_upload_bytes"] > 0
    assert metrics.val("kernel.upload_patches") >= 1


def test_fold_gauges_sharded_skew():
    model = RouterModel(ShardedTrieIndex(4, max_levels=8), n_sub_slots=64,
                        kernel_telemetry=True, device="cpu")
    for i in range(16):
        model.subscribe(f"s/{i}/x", 1)
    _metrics, _ledger, fold = _fold(model)
    g = fold.gauges()
    assert g["shards"] == 4
    assert isinstance(g["filters"], list) and len(g["filters"]) == 4
    assert sum(g["filters"]) == g["filters_total"] == 16
    assert g["shard_skew"] == pytest.approx(max(g["filters"]) / 4.0)
    assert isinstance(g["node_occupancy"], list)
    _drive(model, ["s/3/x", "s/7/x"])
    assert fold.last.n_shards == 4
    assert int(fold.last.field("cand_pre").sum()) == 2


def test_span_stitching_submit_collect():
    """The fold records its points under the trace id of the batch it is
    handed: the id the publish pipeline gave the batch."""
    model = port_model(n_sub_slots=64, kernel_telemetry=True)
    model.subscribe("a/b", 1)
    _metrics, _ledger, fold = _fold(model)
    trace = BatchTrace(7, [])
    model.publish_batch_collect(model.publish_batch_submit(["a/b"],
                                                           trace=trace))
    assert fold.last_trace_id == 7
    stages = fold.spans.stages(7)
    assert stages == ["kernel_submit", "kernel_collect"]
    spans = fold.spans.trace(7)
    assert spans[0][0] <= spans[1][0]
    rec = fold.spans_recent(4)
    assert rec and rec[0]["trace_id"] == f"{7:016x}"
    assert [s["stage"] for s in rec[0]["spans"]] == stages
    assert rec[0]["spans"][0]["node"] == "n1"
    assert fold.stage_hists()["step"].exemplars
    assert [s[0] for s in trace.spans] == [
        "model.refresh", "model.tokenize", "model.launch", "model.wait",
        "model.decode"]


def test_span_sampling_1_in_n():
    """A pipeline with the fold's ring traces batches 1, 5, ... and the
    fold adopts their ids; the batches it leaves out get no points."""
    from emqx_tpu_torch.broker.cm import CM
    from emqx_tpu_torch.broker.pipeline import PublishPipeline
    model = port_model(n_sub_slots=64, kernel_telemetry=True)
    _metrics, _ledger, fold = _fold(model)
    broker = Broker(router_model=model)
    broker.subscribe("c1", "a/b")
    pipe = PublishPipeline(broker, CM(), max_batch=1)
    pipe.spans, pipe.sample_every = fold.spans, 4
    pipe.min_device_batch = 0          # every batch runs the step
    for _ in range(8):
        pipe.submit(Message(topic="a/b"))
    pipe.flush()
    assert fold.batches == 8
    assert len(fold.spans) == 2
    assert sorted(t for t, _ in fold.spans.recent(8)) == [1, 5]
    assert [b.trace_id for b in fold.spans.batches()] == [1, 5]


def test_span_minted_for_a_model_driven_alone():
    """With no pipeline sampling (the model driven alone), the fold traces
    every sample_every-th batch under an id of its own."""
    model = port_model(n_sub_slots=64, kernel_telemetry=True)
    model.subscribe("a/b", 1)
    _metrics, _ledger, fold = _fold(model, sample_every=4)
    for _ in range(8):
        _drive(model, ["a/b"])
    assert len(fold.spans) == 2
    assert sorted(t for t, _ in fold.spans.recent(8)) == [
        (1 << 63) | 1, (1 << 63) | 5]
    assert fold.spans.batches() == []


def test_broker_kernel_overflow_ledger():
    model = port_model(n_sub_slots=64, K=2)
    metrics = Metrics()
    b = Broker(router_model=model, metrics=metrics)
    b.ledger = DegradationLedger(metrics)
    for i, f in enumerate(FAN_FILTERS):
        b.subscribe(f"c{i}", f)
    out = b.publish_batch([Message(topic="a/b/c/d"),
                           Message(topic="a/b/c/x")])
    assert len(out[0]) == len(FAN_FILTERS)
    assert b.ledger.totals()["kernel_overflow"] == 2
    ev = [e for e in b.ledger.recent(8)
          if e["reason"] == "kernel_overflow"]
    assert ev and ev[-1]["count"] == 2
    assert metrics.val("messages.ledger.kernel_overflow") == 2
    assert metrics.val("messages.ledger.kernel_hostmatch") == 0


def test_broker_kernel_hostmatch_ledger(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "host")
    model = port_model(n_sub_slots=64)
    assert model._host_matcher is not None
    metrics = Metrics()
    b = Broker(router_model=model, metrics=metrics)
    b.ledger = DegradationLedger(metrics)
    _m, _l, fold = _fold(model)
    b.subscribe("c1", "a/b")
    out = b.publish_batch([Message(topic="a/b")])
    assert "c1" in out[0]
    assert metrics.val("messages.kernel.hostmatch") == 1
    assert b.ledger.totals()["kernel_hostmatch"] == 1
    assert metrics.val("messages.ledger.kernel_hostmatch") == 1
    assert b.ledger.totals().get("kernel_overflow", 0) == 0
    assert fold.host_batches == 1 and fold.host_topics == 1
    assert fold.batches == 0


def test_kernel_telemetry_escape_hatch(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "0")
    model = port_model(n_sub_slots=64)
    assert model.kernel_telemetry is False
    model.subscribe("a/b", 1)
    _metrics, _ledger, fold = _fold(model)
    _drive(model, ["a/b"])
    assert fold.batches == 1
    assert fold.last is None
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "1")
    assert port_model().kernel_telemetry is True
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "0")
    assert port_model(kernel_telemetry=True).kernel_telemetry is True


# -- app wiring: prometheus, $SYS, mgmt, server surface ----------------------


def _app():
    return BrokerApp(router_model=port_model(n_sub_slots=64))


def test_app_wires_fold_and_prometheus_gauges(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "1")
    app = _app()
    assert app.device_metrics is not None
    assert app.broker.model.telemetry is app.device_metrics
    assert app.native_spans_fn == app.device_metrics.spans_recent
    app.broker.subscribe("c1", "a/b")
    app.broker.publish_batch([RefMessage(topic="a/b")])
    out = app.prometheus()
    assert "emqx_kernel_filters_total" in out
    assert "emqx_kernel_shard_skew" in out
    assert "emqx_kernel_batches" in out
    assert "emqx_latency_kernel_submit_seconds_count" in out
    assert "emqx_latency_kernel_decode_seconds_count" in out
    ks = app.kernel_summary()
    assert ks["batches"] == 1 and "gauges" in ks


def test_app_without_kernel_telemetry(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "off")
    app = _app()
    assert app.device_metrics is None
    assert app.kernel_summary() == {}
    assert "emqx_kernel_batches" not in app.prometheus()


def test_sys_kernel_heartbeat_renders_at_zero(monkeypatch):
    from emqx_tpu.observe.sys import SysHeartbeat

    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "1")
    app = _app()
    seen = {}
    hb = SysHeartbeat("n1", lambda m: seen.__setitem__(
        m.topic, m.payload), metrics=app.metrics,
        kernel=app.device_metrics)
    hb.publish_kernel()
    for stage in ("submit", "step", "decode"):
        assert seen[f"$SYS/brokers/n1/kernel/{stage}/p50"] == b"0.000"
        assert seen[f"$SYS/brokers/n1/kernel/{stage}/p99"] == b"0.000"
        assert seen[f"$SYS/brokers/n1/kernel/{stage}/count"] == b"0"
    hb.tick(now=1e12)
    assert "$SYS/brokers/n1/kernel/step/p99" in seen


def test_mgmt_kernel_stats_endpoint(monkeypatch):
    from emqx_tpu.mgmt.api import ApiError, ManagementApi

    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "1")
    app = _app()
    app.broker.subscribe("c1", "a/b")
    app.broker.publish_batch([RefMessage(topic="a/b")])
    api = ManagementApi(app)
    snap = api.h_kernel_stats({}, None)
    assert snap["gauges"]["filters_total"] == 1
    assert snap["summary"]["batches"] == 1
    assert snap["last_per_shard"]["cand_pre"] == [1]
    status, body = api.handle("GET", "/api/v5/kernel/stats", {}, None,
                              authed=True)
    assert status == 200 and body["summary"]["batches"] == 1
    app.device_metrics = None
    with pytest.raises(ApiError) as ei:
        api.h_kernel_stats({}, None)
    assert ei.value.status == 404


def test_server_kernel_summary_surface(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", "1")
    app = _app()
    srv = BrokerServer(app=app, port=0)
    app.broker.subscribe("c1", "a/b")
    app.broker.publish_batch([RefMessage(topic="a/b")])
    ks = srv.kernel_summary()
    assert ks["batches"] == 1
    assert ks["stages"]["submit"]["count"] == 1
