"""The port's TCP server and client (``emqx_tpu_torch/broker/server.py``,
``emqx_tpu_torch/mqtt/client.py``) against the reference's.

- every case of ``tests/test_server.py`` and
  ``tests/test_v5_conformance.py`` over both packages (``pkg``), from the
  reference's own source with the package name pointed at the port for
  ``port``, each package's ``BrokerServer(port=0)`` over its own default
  ``BrokerApp`` (the retainer, shared-subscription dispatch and
  ``BrokerApp.from_config`` included); the server's own
  Maximum-Packet-Size drop path also runs over each package's app;
- one scripted client scenario (v3.1.1 and v5, QoS 0/1/2, retain as
  published, outbound topic aliases, subscription identifiers, takeover of
  a persistent session, a will) against the reference's server and the port's, every packet each
  client receives equal;
- the port's server over a ``PublishPipeline`` and a
  ``RouterModel(device="cpu")``: every subscriber's deliveries equal the
  host path's;
- ``BrokerServer()`` and ``WsBrokerServer()`` with neither an app nor a
  broker build the package's own default ``BrokerApp``;
- on the card (``cuda``): the port's TCP and WS servers over a model there,
  8 clients over TCP and 2 over WS.
"""

from __future__ import annotations

import asyncio
import inspect
from collections import Counter

import pytest

from emqx_tpu_torch.core import topic as T
from test_torch_harness import PKGS, app_class, net, packet_key, \
    reference_case_names, reference_tests, ws_client_class
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

CASES = [(mod, case) for mod in ("test_server", "test_v5_conformance")
         for case in reference_case_names(mod)]


def test_reference_case_counts():
    for mod, n in (("test_server", 10), ("test_v5_conformance", 16)):
        assert len(reference_case_names(mod)) == n
    assert len(CASES) == 26


def make_run(n):
    """The reference's ``run`` fixture: a scenario against
    ``BrokerServer(port=0)`` of package ``n``, which builds that package's
    default ``BrokerApp``."""
    def run(scenario):
        async def main():
            server = n.BrokerServer(port=0)
            await server.start()
            try:
                await scenario(server)
            finally:
                await server.stop()
        asyncio.run(main())
    return run


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("mod,case", CASES)
def test_reference_server_case(mod, case, pkg):
    fn = getattr(reference_tests(mod, pkg), case)
    if "run" in inspect.signature(fn).parameters:
        fn(make_run(net(pkg)))
    else:
        fn()


@pytest.mark.parametrize("pkg", PKGS)
def test_broker_server_without_app_or_broker_builds_the_default_app(pkg):
    """``BrokerServer()`` and ``WsBrokerServer()`` with neither an app nor
    a broker build the package's own default ``BrokerApp`` and serve its
    broker and CM; a broker alone, or a broker and a CM, is enough."""
    n = net(pkg)
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    for server in (n.BrokerServer(), n.ws.WsBrokerServer()):
        assert type(server.app).__module__ == f"{root}.app"
        assert type(server.app).__name__ == "BrokerApp"
        assert server.broker is server.app.broker
        assert server.cm is server.app.cm
        assert server.app.broker.model is None
    s = n.BrokerServer(broker=n.Broker())
    assert s.app is None and isinstance(s.cm, n.CM)
    cm = n.CM()
    assert n.BrokerServer(broker=n.Broker(), cm=cm).cm is cm


# ---------------------------------------------------------------------------
# the server's Maximum-Packet-Size drop path, over each package's app
# ---------------------------------------------------------------------------


def run_with_app(n, scenario):
    async def main():
        app = app_class(n.pkg)()
        server = n.BrokerServer(port=0, app=app)
        await server.start()
        try:
            await scenario(server, app)
        finally:
            await server.stop()
    asyncio.run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_outbound_maximum_packet_size_over_broker(pkg):
    """tests/test_server.py's case over the package's app: a PUBLISH larger
    than the client's Maximum-Packet-Size is dropped for that client and
    counted; the small one and the other client's flow."""
    n = net(pkg)

    async def scenario(server, app):
        C = n.MqttClient
        tiny = C(port=server.port, clientid="tiny", proto_ver=5,
                 properties={"Maximum-Packet-Size": 64})
        big = C(port=server.port, clientid="bigc", proto_ver=5)
        pub = C(port=server.port, clientid="p", proto_ver=5)
        for c in (tiny, big, pub):
            await c.connect()
        await tiny.subscribe("mps/t", qos=0)
        await big.subscribe("mps/t", qos=0)
        await pub.publish("mps/t", b"x" * 500, qos=0)
        await pub.publish("mps/t", b"ok", qos=0)
        got = {(await big.recv()).payload, (await big.recv()).payload}
        assert got == {b"x" * 500, b"ok"}
        assert (await tiny.recv()).payload == b"ok"
        assert tiny.messages.empty()
        assert app.metrics.val("delivery.dropped.too_large") == 1
        for c in (tiny, big, pub):
            await c.disconnect()
    run_with_app(n, scenario)


@pytest.mark.parametrize("pkg", PKGS)
def test_size_dropped_qos1_releases_inflight_window_over_broker(pkg):
    """tests/test_server.py's case over the package's app: oversized QoS 1
    publishes release their window slots, so the small ones still flow."""
    n = net(pkg)

    async def scenario(server, app):
        tiny = n.MqttClient(port=server.port, clientid="tq", proto_ver=5,
                            properties={"Maximum-Packet-Size": 64,
                                        "Receive-Maximum": 2})
        pub = n.MqttClient(port=server.port, clientid="pq", proto_ver=5)
        await tiny.connect()
        await tiny.subscribe("mq/t", qos=1)
        await pub.connect()
        for _ in range(3):
            await pub.publish("mq/t", b"z" * 300, qos=1)
        for i in range(3):
            await pub.publish("mq/t", f"s{i}".encode(), qos=1)
        got = [(await tiny.recv()).payload for _ in range(3)]
        assert got == [b"s0", b"s1", b"s2"]
        assert len(app.cm.lookup_channel("tq").session.inflight) <= 2
        assert app.metrics.val("delivery.dropped.too_large") == 3
        await tiny.disconnect()
        await pub.disconnect()
    run_with_app(n, scenario)


# ---------------------------------------------------------------------------
# one scripted scenario: every packet each client receives
# ---------------------------------------------------------------------------


def recording_class(base):
    class Recording(base):
        """Keeps every packet it receives, in order, as plain data."""

        def __init__(self, *a, **kw) -> None:
            super().__init__(*a, **kw)
            self.transcript: list = []

        async def _route_in(self, pkt) -> None:
            self.transcript.append(packet_key(pkt))
            await super()._route_in(pkt)

        def publishes(self, qos=None) -> int:
            return sum(k == "Publish" and qos in (None, f["qos"])
                       for k, f in self.transcript)

        async def settle(self) -> None:
            """Wait until every QoS 2 delivery got its PUBREL (the client
            answers PUBCOMP at once), then a SUBSCRIBE round trip: the
            server has processed every ack this client sent."""
            loop = asyncio.get_running_loop()
            end = loop.time() + 10.0
            while (sum(k == "PubRel" for k, _ in self.transcript)
                   < self.publishes(qos=2)):
                assert loop.time() < end, self.clientid
                await asyncio.sleep(0.01)
            await self.subscribe("sync/" + self.clientid, qos=0)

    return Recording


async def wait_publishes(client, n: int, timeout: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while client.publishes() < n:
        assert loop.time() < end, (client.clientid, client.publishes(), n)
        await asyncio.sleep(0.01)


PLAN = [("t/a", 0), ("t/a", 1), ("t/a/b", 2), ("t/b", 1), ("t/a", 2),
        ("t/c/d", 0), ("t/a", 1), ("t/b", 0), ("t/a/b", 1), ("t/b", 2)]


async def transcript_scenario(n, server) -> dict:
    C = recording_class(n.MqttClient)
    port = server.port
    # the receive window (32) never fills here: a queued QoS 1/2 delivery
    # would let a QoS 0 one overtake it depending on when the acks land
    s5 = C(port=port, clientid="s5", proto_ver=5, clean_start=False,
           properties={"Topic-Alias-Maximum": 2,
                       "Session-Expiry-Interval": 600})
    s4 = C(port=port, clientid="s4")
    p = C(port=port, clientid="p", proto_ver=5)
    await s5.connect()
    await s4.connect()
    await p.connect(will_topic="w/p", will_payload=b"gone", will_qos=1)
    await s5.subscribe("t/+", qos=1,
                       properties={"Subscription-Identifier": [5]})
    await s5.subscribe("t/#", qos=2, rap=1)
    await s4.subscribe("t/a", qos=2)
    await s4.subscribe("w/+", qos=0)
    # s5: t/+ matches one-level names, t/# all; s4: t/a only
    want5 = sum(1 + (t.count("/") == 1) for t, _ in PLAN)
    want4 = sum(t == "t/a" for t, _ in PLAN)
    for i, (topic, qos) in enumerate(PLAN):
        await p.publish(topic, b"m%d" % i, qos=qos, retain=i % 3 == 0,
                        properties={"User-Property": [("i", str(i))]}
                        if i % 2 else {})
    await wait_publishes(s5, want5)
    await wait_publishes(s4, want4)
    await s5.settle()
    # takeover: a second s5 resumes the session, nothing left in flight
    s5b = C(port=port, clientid="s5", proto_ver=5, clean_start=False,
            properties={"Topic-Alias-Maximum": 1,
                        "Session-Expiry-Interval": 600})
    await s5b.connect()
    await p.publish("t/z", b"after", qos=1)
    await wait_publishes(s5b, 2)
    # p's socket dies without a DISCONNECT: its will reaches s4
    await s4.settle()
    p._writer.close()
    await wait_publishes(s4, want4 + 1)
    await s5b.settle()
    await s4.settle()
    for c in (s4, s5b):
        await c.disconnect()
    await s5.close()
    await p.close()
    return {c: x.transcript for c, x in
            (("s5", s5), ("s4", s4), ("p", p), ("s5b", s5b))}


@pytest.mark.parametrize("app", [False, True])
def test_client_transcripts_equal(app):
    """The same scenario against each package's server (``app``: behind a
    package's ``BrokerApp``): every packet each client receives, in
    order, equal."""
    out = {}
    for pkg in PKGS:
        n = net(pkg)

        async def main():
            if app:
                server = n.BrokerServer(port=0, app=app_class(pkg)())
            else:
                server = n.BrokerServer(port=0, broker=n.Broker(),
                                        cm=n.CM())
            await server.start()
            try:
                return await transcript_scenario(n, server)
            finally:
                await server.stop()
        out[pkg] = asyncio.run(main())
    assert out["port"] == out["ref"]
    kinds = Counter(k for t in out["ref"].values() for k, _ in t)
    assert kinds["Publish"] >= 20
    assert {"Connack", "SubAck", "PubAck", "PubRec", "PubComp"} <= set(kinds)


# ---------------------------------------------------------------------------
# the server over the routing step
# ---------------------------------------------------------------------------

FILTERS = ["fleet/+/speed", "fleet/v1/#", "fleet/v2/speed", "+/v3/speed",
           "fleet/#", "fleet/v4/+", "other/x"]
TOPICS = ["fleet/v1/speed", "fleet/v2/speed", "fleet/v3/speed",
          "fleet/v4/rpm", "fleet/v1/a/b", "other/x", "none/here"]


def model_app(n, device: str):
    """The package's ``BrokerApp`` whose pipeline runs every batch on the
    routing step of a ``RouterModel`` on ``device``."""
    from emqx_tpu_torch import RouterModel, TrieIndex
    model = RouterModel(TrieIndex(max_levels=8), device=device)
    model.refresh()         # the tables on the device: SUBSCRIBEs patch them
    app = app_class(n.pkg)(router_model=model)
    app.pipeline.min_device_batch = 0
    return app, model


async def fleet_scenario(n, servers, n_tcp: int, n_ws: int = 0) -> dict:
    """``n_tcp`` subscribers over TCP and ``n_ws`` over WS, two filters
    each (QoS 0 and 1), and two publishers (one a WS client when ``n_ws``)
    sending 24 messages each, QoS 0/1 in turns; every subscriber's
    deliveries as a multiset of (topic, payload, qos)."""
    tcp, ws = servers
    W = ws_client_class(n)
    subs = []
    for i in range(n_tcp + n_ws):
        C, port = ((n.MqttClient, tcp.port) if i < n_tcp
                   else (W, ws.port))
        c = C(port=port, clientid=f"s{i}", proto_ver=5 if i % 2 else 4)
        await c.connect()
        for j, qos in ((i, 0), (i + 3, 1)):
            await c.subscribe(FILTERS[j % len(FILTERS)], qos=qos)
        subs.append(c)
    pubs = [n.MqttClient(port=tcp.port, clientid="p0"),
            (W(port=ws.port, clientid="p1") if n_ws
             else n.MqttClient(port=tcp.port, clientid="p1"))]
    for p in pubs:
        await p.connect()

    async def publish(k, p):
        for i in range(24):
            await p.publish(TOPICS[(i + k) % len(TOPICS)], b"%d:%d" % (k, i),
                            qos=i % 2)

    await asyncio.gather(*(publish(k, p) for k, p in enumerate(pubs)))
    out = {}
    for i, c in enumerate(subs):
        mine = [FILTERS[j % len(FILTERS)] for j in (i, i + 3)]
        want = sum(T.match(TOPICS[(j + k) % len(TOPICS)], f)
                   for k in range(len(pubs)) for j in range(24)
                   for f in mine)
        out[c.clientid] = [(m.topic, m.payload, m.qos) for m in [
            await c.recv(timeout=10.0) for _ in range(want)]]
    await asyncio.sleep(0.05)
    assert all(c.messages.empty() for c in subs)
    for c in subs + pubs:
        await c.disconnect()
    return out


def per_publisher_in_order(got: list) -> bool:
    """Each publisher's messages arrive in order at each QoS (a message
    that matches two of the subscriber's filters comes twice)."""
    seq: dict = {}
    for _, payload, qos in got:
        k, i = map(int, payload.split(b":"))
        if seq.get((k, qos), -1) > i:
            return False
        seq[(k, qos)] = i
    return True


def serve(n, scenario, app=None):
    async def main():
        if app is None:
            broker, cm = n.Broker(), n.CM()
            tcp = n.BrokerServer(port=0, broker=broker, cm=cm)
            ws = n.ws.WsBrokerServer(port=0, broker=broker, cm=cm)
        else:
            tcp = n.BrokerServer(port=0, app=app)
            ws = n.ws.WsBrokerServer(port=0, app=app)
        await tcp.start()
        await ws.start()
        try:
            return await scenario((tcp, ws))
        finally:
            await ws.stop()
            await tcp.stop()
    return asyncio.run(main())


def test_server_over_model_equals_host_path():
    """The port's TCP and WS servers over a pipeline and a CPU RouterModel
    (the step's plain kernels): every subscriber gets the multiset the
    host path (the same servers over a bare Broker) delivers, each
    publisher's messages in order per QoS."""
    n = net("port")
    host = serve(n, lambda s: fleet_scenario(n, s, 6, 2))
    app, model = model_app(n, "cpu")
    dev = serve(n, lambda s: fleet_scenario(n, s, 6, 2), app)
    assert {c: Counter(v) for c, v in dev.items()} == {
        c: Counter(v) for c, v in host.items()}
    assert sum(map(len, host.values())) > 60
    assert all(per_publisher_in_order(v) for v in dev.values())
    assert app.pipeline.batches >= 1 and app.pipeline.host_batches == 0
    assert model.launch_count == app.pipeline.batches
    assert model.patch_count >= 1
    assert app.metrics.val("messages.device_failover") == 0


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the servers over a model on the "
                    "card, whose kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_server_over_model_on_card(cuda_device):
    """8 clients over TCP and 2 over WS through the port's servers over a
    RouterModel on the card: deliveries equal the host path's, the walk,
    the fan-out and the patch kernel launched, no host batch, no
    failover."""
    from emqx_tpu_torch.ops import _build
    n = net("port")
    host = serve(n, lambda s: fleet_scenario(n, s, 8, 2))
    app, model = model_app(n, cuda_device)
    _build.reset_launch_counts()
    dev = serve(n, lambda s: fleet_scenario(n, s, 8, 2), app)
    counts = _build.launch_counts()
    assert {c: Counter(v) for c, v in dev.items()} == {
        c: Counter(v) for c, v in host.items()}
    assert all(per_publisher_in_order(v) for v in dev.values())
    assert counts["walk_compact"] == model.launch_count \
        == app.pipeline.batches >= 1
    assert counts["fanout_pool"] == model.launch_count
    assert counts["patch"] >= 1 and model.patch_count >= 1
    assert app.pipeline.host_batches == 0 and model.host_match_count == 0
    assert app.metrics.val("messages.device_failover") == 0
