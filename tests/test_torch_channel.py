"""The port's channel FSM (``emqx_tpu_torch/broker/channel.py``) against the
reference's.

- the 28 cases of ``tests/test_channel.py`` over both packages (``pkg``),
  from the reference's own source with the package name pointed at the
  port for ``port``;
- seeded op streams — CONNECT (v3.1.1 and v5, clean or resumed, with and
  without a will), SUBSCRIBE with options and identifiers, UNSUBSCRIBE,
  PUBLISH at QoS 0/1/2 (with the publisher's PUBREL), the subscribers'
  PUBACK / PUBREC / PUBCOMP, PINGREQ, DISCONNECT, a dropped socket and
  takeover by a second channel — through each package's ``Channel`` over its
  own ``Broker`` and ``CM``: every outbound packet, serialized, and the
  broker's subscription tables equal;
- the port's channels with a ``publish_sink`` into a ``PublishPipeline``
  over ``Broker(router_model=RouterModel(device="cpu"))``, flushed after
  each op: every outbound packet equals the reference's channels, broker and
  pipeline over the same kind of model; and what each client is delivered
  (topic, payload, QoS, retain) equals the reference's host path, as a
  multiset (a message that matches several of one client's subscriptions
  is delivered once for each, in route-table order on the host path and in
  the step's filter order on the device path, so its packet ids differ).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from test_torch_harness import PKGS, net, reference_case_names, \
    reference_tests
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

CASES = reference_case_names("test_channel")


def test_reference_case_count():
    assert len(CASES) == 28


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", CASES)
def test_reference_channel_case(case, pkg):
    getattr(reference_tests("test_channel", pkg), case)()


# ---------------------------------------------------------------------------
# seeded op streams
# ---------------------------------------------------------------------------

CIDS = [f"c{i}" for i in range(6)]
FILTERS = ["a/b", "a/+", "a/#", "+/b", "s/x/y", "s/#", "#", "will/+",
           "$SYS/x", "a/b/c"]
NAMES = ["a/b", "a/c", "a/b/c", "s/x/y", "s/z", "will/c0", "x/b", "$SYS/x"]


def gen_ops(seed: int, n: int = 260) -> list[tuple]:
    """An op stream that is valid for any broker that follows MQTT: only
    connected clients act, which the generator tracks itself."""
    rng = np.random.default_rng(seed)
    up: dict[str, int] = {}              # cid -> protocol version
    ops: list[tuple] = []
    for _ in range(n):
        cid = CIDS[int(rng.integers(len(CIDS)))]
        if cid not in up or rng.random() < 0.04:
            ver = int(rng.choice([4, 5]))
            clean = bool(rng.random() < 0.5)
            will = None
            if rng.random() < 0.4:
                will = (f"will/{cid}", b"bye-" + cid.encode(),
                        int(rng.integers(0, 3)), bool(rng.random() < 0.3))
            ops.append(("connect", cid, ver, clean, will))
            up[cid] = ver
            continue
        k = float(rng.random())
        ver = up[cid]
        if k < 0.20:
            fl = [(FILTERS[int(i)], {
                "qos": int(rng.integers(0, 3)),
                "nl": int(rng.integers(0, 2)) if ver == 5 else 0,
                "rap": int(rng.integers(0, 2)) if ver == 5 else 0,
                "rh": int(rng.integers(0, 3)) if ver == 5 else 0})
                for i in rng.integers(0, len(FILTERS),
                                      int(rng.integers(1, 4)))]
            subid = (int(rng.integers(1, 100)) if ver == 5
                     and rng.random() < 0.4 else None)
            ops.append(("subscribe", cid, fl, subid))
        elif k < 0.26:
            ops.append(("unsubscribe", cid, [
                FILTERS[int(i)] for i in rng.integers(
                    0, len(FILTERS), int(rng.integers(1, 3)))]))
        elif k < 0.62:
            ops.append(("publish", cid, NAMES[int(rng.integers(len(NAMES)))],
                        int(rng.integers(0, 3)), bool(rng.random() < 0.2),
                        b"p%d" % len(ops)))
        elif k < 0.86:
            ops.append(("ack", cid))
        elif k < 0.90:
            ops.append(("ping", cid))
        elif k < 0.95:
            ops.append(("disconnect", cid))
            del up[cid]
        else:
            ops.append(("drop", cid))
            del up[cid]
    return ops


class Clients:
    """Packet-level clients over one package's Broker and CM: each
    client's outbound packets are logged serialized, in order, with the
    client id."""

    def __init__(self, pkg: str, model=None, sink: bool = False) -> None:
        self.n = n = net(pkg)
        self.broker = n.Broker(router_model=model)
        self.cm = n.CM()
        self.pipe = None
        if sink:
            self.pipe = n.pipeline.PublishPipeline(self.broker, self.cm)
            # every batch on the step (over a CPU model the default knee
            # is the adaptive one, which sends small batches to the host)
            self.pipe.min_device_batch = 0
        self.chans: dict[str, object] = {}
        self.log: list[tuple[str, str, bytes]] = []
        self.delivered: dict[str, list] = {c: [] for c in CIDS}
        self.unacked: dict[str, list] = {c: [] for c in CIDS}
        self.pubcomp: dict[str, list] = {c: [] for c in CIDS}

    def _sender(self, cid: str, ch_box: list):
        def send(pkts):
            ch = ch_box[0]
            for p in pkts:
                self.log.append((cid, type(p).__name__, self.n.serialize(
                    p, ch.conninfo.proto_ver)))
                if p.type == self.n.P.PUBLISH:
                    self.delivered[cid].append(
                        (p.topic, p.payload, p.qos, p.retain))
                if p.type == self.n.P.PUBLISH and p.qos:
                    self.unacked[cid].append((p.qos, p.packet_id))
                elif p.type == self.n.P.PUBREL:
                    self.pubcomp[cid].append(p.packet_id)
        return send

    def _in(self, cid: str, pkt) -> None:
        ch = self.chans[cid]
        ch.send(ch.handle_in(pkt))

    def run(self, op: tuple) -> None:
        P, kind, cid = self.n.P, op[0], op[1]
        if kind == "connect":
            _, _, ver, clean, will = op
            box: list = []
            ch = self.n.Channel(
                self.broker, self.cm, send=self._sender(cid, box),
                publish_sink=self.pipe.submit if self.pipe else None)
            box.append(ch)
            props = ({"Session-Expiry-Interval": 600}
                     if ver == 5 and not clean else {})
            kw = {}
            if will:
                kw = dict(will_flag=True, will_topic=will[0],
                          will_payload=will[1], will_qos=will[2],
                          will_retain=will[3])
            self.chans[cid] = ch
            self.unacked[cid], self.pubcomp[cid] = [], []
            ch.conninfo.proto_ver = ver
            ch.send(ch.handle_in(P.Connect(
                clientid=cid, proto_ver=ver, clean_start=clean,
                properties=props, **kw)))
        elif kind == "subscribe":
            _, _, fl, subid = op
            self._in(cid, P.Subscribe(
                packet_id=7, topic_filters=[(f, dict(o)) for f, o in fl],
                properties={"Subscription-Identifier": [subid]}
                if subid else {}))
        elif kind == "unsubscribe":
            self._in(cid, P.Unsubscribe(packet_id=8,
                                        topic_filters=list(op[2])))
        elif kind == "publish":
            _, _, topic, qos, retain, payload = op
            pid = 100 + len(self.log) % 1000 if qos else None
            self._in(cid, P.Publish(topic=topic, payload=payload, qos=qos,
                                    retain=retain, packet_id=pid))
            if qos == 2:
                self._in(cid, P.PubRel(packet_id=pid))
        elif kind == "ack":
            if self.pubcomp[cid]:
                self._in(cid, P.PubComp(packet_id=self.pubcomp[cid].pop(0)))
            elif self.unacked[cid]:
                qos, pid = self.unacked[cid].pop(0)
                self._in(cid, P.PubAck(packet_id=pid) if qos == 1
                         else P.PubRec(packet_id=pid))
        elif kind == "ping":
            self._in(cid, P.PingReq())
        elif kind == "disconnect":
            self._in(cid, P.Disconnect())
        else:                                           # a dropped socket
            self.chans[cid].terminate("sock_closed")
        if self.pipe is not None:
            self.pipe.flush()

    def state(self) -> dict:
        b = self.broker
        return {
            "suboption": {f"{s}|{t}": dataclasses.asdict(o)
                          for (s, t), o in sorted(b.suboption.items())},
            "subscription": {s: sorted(v) for s, v in
                             sorted(b.subscription.items())},
            "subscriber": {t: sorted(v) for t, v in
                           sorted(b.subscriber.items()) if v},
            "channels": sorted(c for c, _ in self.cm.all_channels()),
        }


def drive(pkg: str, ops, **kw) -> Clients:
    cl = Clients(pkg, **kw)
    for op in ops:
        cl.run(op)
    return cl


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_op_stream_equal(seed):
    ops = gen_ops(seed)
    ref, port = drive("ref", ops), drive("port", ops)
    assert len(ref.log) > 200
    kinds = {k for _, k, _ in ref.log}
    assert {"Connack", "SubAck", "UnsubAck", "Publish", "PubAck", "PubRec",
            "PubComp", "PingResp"} <= kinds
    assert port.log == ref.log
    assert port.state() == ref.state()


def port_model():
    from emqx_tpu_torch import RouterModel, TrieIndex
    return RouterModel(TrieIndex(max_levels=8), device="cpu")


@pytest.mark.parametrize("seed", [21, 22])
def test_op_stream_through_model_and_pipeline(seed):
    """The channels hand every PUBLISH and will to a pipeline over a
    RouterModel on the CPU (the routing step's plain kernels), flushed after
    each op."""
    ops = gen_ops(seed)
    host = drive("ref", ops)
    ref = drive("ref", ops, model=port_model(), sink=True)
    model = port_model()
    port = drive("port", ops, model=model, sink=True)
    assert port.pipe.batches > 20 and port.pipe.host_batches == 0
    assert model.launch_count == port.pipe.batches
    assert port.log == ref.log
    assert port.state() == ref.state() == host.state()
    assert {c: sorted(v) for c, v in port.delivered.items()} == {
        c: sorted(v) for c, v in host.delivered.items()}
    assert sum(map(len, host.delivered.values())) > 100
