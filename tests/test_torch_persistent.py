"""The port's persistent sessions (``emqx_tpu_torch/session/persistent.py``)
and management plane (``emqx_tpu_torch/mgmt/``) against the reference's.

- The cases of ``tests/test_persistent.py``, ``test_mgmt.py`` and
  ``test_plugins.py`` over both packages (``pkg``), from the reference's
  own source with the package name pointed at the port for ``port``, over
  each package's own ``BrokerApp``, every case of them: the cases on the
  native durable store (``NativeDurableStore``, and ``durable.enable``
  booting on it) run on each package's own native library.
- One seeded op stream (subscribe, unsubscribe, disconnect, QoS 1 batches
  through a CPU ``RouterModel``, ack, resume, takeover, clean start, gc, a
  restart on the same store) through both packages' ``PersistentSessions``
  on ``MemStore``: after every op the same sessions, markers, kept
  messages and packets.
- ``PUT /configs`` answers as the reference's: a value put, and a value
  the config rejects 400 ``BAD_VALUE``.
- ``chip_smoke.py``'s durable path runs whole at a small size on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_harness import PKGS, call_reference, net, reference_calls, \
    reference_case_names, waiting
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

REFERENCE = {"test_persistent": 23, "test_mgmt": 17, "test_plugins": 6}
CASES = [(name, case, i) for name in REFERENCE
         for case, i in reference_calls(name, waiting(name))]


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_case_names(name)) == n, name
        assert not waiting(name), name
    assert len(CASES) == sum(REFERENCE.values())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,case,i", CASES)
def test_reference_persistent_case(name, case, i, pkg, tmp_path,
                                   monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    call_reference(name, pkg, case, i, tmp_path=tmp_path,
                   monkeypatch=monkeypatch, capsys=capsys)


# ---------------------------------------------------------------------------
# the persistent-session service over one seeded op stream
# ---------------------------------------------------------------------------

WORDS = ["a", "b", "c", "dd"]
CLIENTS = [f"c{i}" for i in range(6)]


def gen_ops(seed: int, n: int = 60) -> list:
    """A seeded stream of client ops: connect (resume, takeover or clean
    start), subscribe, unsubscribe, disconnect, ack, QoS 1 publish
    batches, gc and a restart; every published payload is unique."""
    rng = np.random.default_rng(seed)
    filters = ["a/+", "a/b", "b/#", "+/c", "dd", "#", "a/b/c", "+/+"]
    ops, k = [("connect", cid, False, 3600) for cid in CLIENTS], 0
    for cid in CLIENTS:
        for f in rng.choice(filters, int(rng.integers(1, 3)), replace=False):
            ops.append(("subscribe", cid, str(f)))
    for _ in range(n):
        r, cid = rng.random(), str(rng.choice(CLIENTS))
        if r < 0.3:
            batch = []
            for _ in range(int(rng.integers(1, 9))):
                topic = "/".join(rng.choice(WORDS, int(rng.integers(1, 4))))
                batch.append((topic, f"m{k}".encode()))
                k += 1
            ops.append(("publish", batch))
        elif r < 0.45:
            ops.append(("disconnect", cid))
        elif r < 0.6:
            ops.append(("connect", cid, False,
                        int(rng.choice([1, 3600]))))
        elif r < 0.65:
            ops.append(("connect", cid, True, 3600))      # clean start
        elif r < 0.75:
            ops.append(("subscribe", cid, str(rng.choice(filters))))
        elif r < 0.8:
            ops.append(("unsubscribe", cid, str(rng.choice(filters))))
        elif r < 0.9:
            ops.append(("ack", cid))
        elif r < 0.95:
            ops.append(("gc",))
        else:
            ops.append(("restart",))
    return ops


def drive_persistent(pkg: str, ops) -> list:
    """Apply ``ops`` to ``pkg``'s ``BrokerApp`` on a ``MemStore``, its
    publishes batched through the port's ``RouterModel`` on the CPU, and
    return after each op what the service left: every stored session's
    subscriptions and pending markers (by payload), the messages kept,
    and the packets the op gave the client (a resume's replay).  A
    restart drops the app and its channels unclosed (a crash) and boots a
    new one, with a new model, on the same store: a resume after it
    replays from the store and subscribes the saved filters again."""
    import importlib

    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    n = net(pkg)
    persistent = importlib.import_module(f"{root}.session.persistent")
    app_mod = importlib.import_module(f"{root}.app")
    def boot(store):
        model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=64, K=8,
                            M=16, ret_cap=8, device="cpu")
        return app_mod.BrokerApp(router_model=model, persistent_store=store)

    app = boot(persistent.MemStore())
    store, P, models = app.persistent.store, n.P, [app.broker.model]
    channels: dict = {}
    t0 = n.message.now_ms()

    def packets(pkts) -> list:
        return [(type(p).__name__, getattr(p, "topic", None),
                 getattr(p, "payload", None), getattr(p, "reason_code",
                                                      None),
                 getattr(p, "session_present", None)) for p in pkts]

    seen = []
    for op, *args in ops:
        got = []
        if op == "connect":
            cid, clean, expiry = args
            ch = n.Channel(app.broker, app.cm)
            got = packets(ch.handle_in(P.Connect(
                clientid=cid, proto_ver=P.MQTT_V5, clean_start=clean,
                properties={"Session-Expiry-Interval": expiry})))
            channels[cid] = ch
        elif op in ("subscribe", "unsubscribe") and args[0] in channels \
                and channels[args[0]].conn_state == "connected":
            ch = channels[args[0]]
            pkt = (P.Subscribe(packet_id=1, topic_filters=[
                (args[1], {"qos": 1})]) if op == "subscribe" else
                P.Unsubscribe(packet_id=1, topic_filters=[args[1]]))
            got = packets(ch.handle_in(pkt))
        elif op == "disconnect" and args[0] in channels:
            channels.pop(args[0]).terminate("sock_closed")
        elif op == "ack" and args[0] in channels:
            ch = channels[args[0]]
            if ch.conn_state == "connected":
                for pid, _entry in list(ch.session.inflight.items()):
                    got += packets(ch.handle_in(P.PubAck(packet_id=pid)))
        elif op == "publish":
            msgs = [n.Message(topic=t, payload=p, qos=1, from_="pub")
                    for t, p in args[0]]
            for deliveries in app.broker.publish_batch(msgs):
                app.cm.dispatch(deliveries)
        elif op == "gc":
            got = [app.persistent.gc(now=t0 + 2_000_000)]
        elif op == "restart":
            app, channels = boot(store), {}
            models.append(app.broker.model)
        for ch in channels.values():      # live deliveries, then cleared
            got += packets(ch.outbox)
            ch.outbox.clear()
        payload = {g: d["payload"] for g, d in store.messages.items()}
        seen.append((op, got, {
            sid: (sorted(rec.get("subs", {})),
                  rec.get("expiry_ms"),
                  rec.get("disconnected_at") is not None,
                  sorted((payload.get(g), f) for g, f in store.pending(sid)))
            for sid, rec in sorted(store.all_sessions())},
            sorted(payload.values()), sorted(app.persistent.router.routes_of(
                cid) for cid in CLIENTS)))
    assert not any(m.host_match_count for m in models)
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_persistent_sessions_match_the_reference(seed):
    """Over the same seeded op stream, the port's ``PersistentSessions``
    on ``MemStore`` leaves exactly the reference's markers, replays and
    discards, op by op, with every publish batch on the step."""
    ops = gen_ops(seed)
    ref, port = drive_persistent("ref", ops), drive_persistent("port", ops)
    assert len(ref) == len(port) == len(ops)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, (i, ops[i])
    # the stream did what it is for: markers stored, replayed and spent
    assert any(markers for _, _, sessions, _, _ in ref
               for *_, markers in sessions.values())
    assert any(any(k == "Publish" for k, *_ in got)
               for op, got, *_ in ref if op == "connect")
    assert "restart" in {op for op, *_ in ops}


@pytest.mark.parametrize("pkg", PKGS)
def test_two_sessions_take_over_one_stored_message(pkg, tmp_path):
    """Two persistent sessions on one filter, both disconnected, one QoS 1
    message stored for both on ``NativeDurableStore``; each session then
    takes over its old channel.  The port delivers the message once to
    each (D7: the id translation retires with the last session's replay);
    the reference retires it at the first, so the second session's
    replay misses its live copy and arrives twice (R13)."""
    import importlib
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    P = importlib.import_module(f"{root}.mqtt.packet")
    Channel = importlib.import_module(f"{root}.broker.channel").Channel
    store = importlib.import_module(
        f"{root}.session.persistent").NativeDurableStore(
        str(tmp_path / "ps"))
    app = importlib.import_module(f"{root}.app").BrokerApp(
        persistent_store=store)
    expiry = {"Session-Expiry-Interval": 3600}

    def connect(cid, **kw):
        ch = Channel(app.broker, app.cm)
        out = ch.handle_in(P.Connect(clientid=cid, proto_ver=P.MQTT_V5,
                                     **kw))
        return ch, out

    for cid in ("s1", "s2"):
        ch, _ = connect(cid, properties=expiry)
        ch.handle_in(P.Subscribe(packet_id=1,
                                 topic_filters=[("t", {"qos": 1})]))
        ch.terminate("sock_closed")
    pub, _ = connect("p1")
    pub.handle_in(P.Publish(topic="t", payload=b"offline", qos=1,
                            packet_id=10))
    toks = [store.native.lookup(c) for c in ("s1", "s2")]
    assert [store.native.pending(t) for t in toks] == [1, 1]
    got = {}
    for cid in ("s1", "s2"):
        _, out = connect(cid, clean_start=False, properties=expiry)
        assert out[0].session_present is True
        got[cid] = [p.payload for p in out if isinstance(p, P.Publish)]
    assert [store.native.pending(t) for t in toks] == [0, 0]
    assert got["s1"] == [b"offline"]
    assert got["s2"] == ([b"offline"] if pkg == "port"
                         else [b"offline", b"offline"])
    # every translation retired once both sessions replayed
    assert not store._pyid_of and not store._guid_of and not store._refs


def test_cluster_config_put_waits_for_its_slice():
    """``PUT /configs`` classifies a rejected put with the cluster-config
    plane (``cluster/conf.py``), which came with the cluster slice: the
    port answers ``GET`` and ``PUT /configs`` as the reference does, a
    value put and a rejected one alike."""
    import importlib
    got = {}
    for pkg in PKGS:
        root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
        config = importlib.import_module(f"{root}.config.config")
        conf = config.Config()
        conf.init_load("")
        app = importlib.import_module(f"{root}.app").BrokerApp.from_config(
            conf)
        api = importlib.import_module(f"{root}.mgmt.api").ManagementApi(app)
        got[pkg] = [api.handle(method, "/api/v5/configs", query, body,
                               authed=True) for method, query, body in (
            ("GET", {"path": "mqtt.max_inflight"}, None),
            ("PUT", {}, {"path": "mqtt.max_inflight", "value": 64}),
            ("PUT", {}, {"path": "mqtt.max_inflight", "value": "lots"}),
            ("PUT", {}, {"value": 1}))]
    assert got["port"] == got["ref"]
    assert got["ref"][1] == (200, {"value": 64})
    assert [s for s, _ in got["ref"][2:]] == [400, 400]
    assert got["ref"][2][1]["code"] == "BAD_VALUE"


def test_smoke_durable_path_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s durable path at a small size over a CPU model:
    the second app's boot (``NativeDurableStore``, the exhook server,
    MySQL and MongoDB), its
    five legs and their checks, clients in the smoke's child process; then
    its gateway path (five gateways on the same app) and its cluster path
    (a second node booted from its config, joined over ``TcpTransport``)
    with their checks.  The card runs them at 1M subscriptions; the launch
    counts are the card's alone."""
    import gc

    import chip_smoke
    import emqx_tpu_torch.broker.pipeline as pipeline
    monkeypatch.setattr(chip_smoke, "path_counts", lambda name: {})
    monkeypatch.setattr(pipeline, "_on_card", lambda model: True)
    try:
        out = chip_smoke.durable_phase(
            42, "cpu", "cpu", n_filters=4000, sessions=512, subs=16,
            pubs=4, n_msgs=128, n_exhook=48, connects=4, n_bridge=48,
            gateway={"stomp": 6, "sn": 6, "coap": 4, "lwm2m": 3,
                     "exproto": 3, "pubs": 3, "qos0": 96, "qos1": 24,
                     "up_subs": 4, "up_stomp": 3, "up_sn": 3, "up_coap": 2},
            cluster={"subs": 8, "pubs": 3, "qos0": 96, "qos1": 24,
                     "n2_msgs": 48, "takeover": 3, "pending": 4,
                     "recorded": 32, "after": 48})
    finally:
        gc.unfreeze()               # the phase's load froze its heap
    assert out["persistent"]["markers_stored"] > 0
    assert out["exhook"]["provider_calls"] == 48
    assert out["bridge"]["records"] == 24
    assert out["bridge"]["fallback_rows"] == 0
    assert out["steps_per_batch"] == 1.0
    gw, cl = out["gateway"], out["cluster"]
    assert gw["steps_per_batch"] == 1.0 and gw["subscriptions"]["patches"]
    assert gw["downlink"]["deliveries"] > 0
    assert gw["uplink"]["deliveries"] == gw["uplink"]["messages"] == 50
    assert gw["mgmt"]["gateways"] == 5
    assert cl["join"]["routes"] > 0 and cl["conf"]["tnx_id"] == 1
    assert cl["n1_to_n2"]["n2_deliveries"] > 0
    assert cl["n2_to_n1"]["n1_sampled_deliveries"] > 0
    assert cl["takeover"]["clients"] == 3
    assert set(out["counts"]) == {"durable", "gateway", "cluster"}
