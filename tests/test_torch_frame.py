"""The port's MQTT codec (``emqx_tpu_torch/mqtt/frame.py``) against the
reference's (``emqx_tpu/mqtt/frame.py``).

- the 12 cases of ``tests/test_frame.py`` and the 7 of ``tests/test_props.py``
  run over both packages (``pkg``), from the reference's own source with the
  package name pointed at the port for ``port``;
- a seeded corpus of every packet type at v3.1.1 and v5, properties
  included: both serializers give the same bytes, and both parsers the same
  packets and the same resumable state, also with each packet's bytes split
  at every offset inside a stream;
- each malformed input raises ``FrameError`` with the same ``rc`` and the
  same reason on both sides.

Every output here is bytes or host state, so the comparisons are exact.
"""

from __future__ import annotations

import copy
import dataclasses
import random

import numpy as np
import pytest

from test_torch_harness import PKGS, net, packet_key, reference_tests, \
    reference_case_names

FRAME_CASES = reference_case_names("test_frame")
PROPS_CASES = reference_case_names("test_props")


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", FRAME_CASES)
def test_reference_frame_case(case, pkg):
    fn = getattr(reference_tests("test_frame", pkg), case)
    if case == "test_randomized_roundtrip":
        fn(random.Random(0xE19))          # tests/conftest.py's rng fixture
    else:
        fn()


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", PROPS_CASES)
def test_reference_props_case(case, pkg):
    getattr(reference_tests("test_props", pkg), case)()


def test_reference_case_counts():
    assert len(FRAME_CASES) == 12 and len(PROPS_CASES) == 7


# ---------------------------------------------------------------------------
# a seeded corpus of every packet type
# ---------------------------------------------------------------------------

WORDS = ["a", "b", "sensor", "v42", "ü", "码", "$SYS", ""]


def _word(rng) -> str:
    return WORDS[int(rng.integers(len(WORDS)))]


def _topic(rng, wild: bool = False) -> str:
    ws = [_word(rng) or "x" for _ in range(int(rng.integers(1, 6)))]
    if wild:
        ws = [("+" if rng.random() < 0.3 else w) for w in ws]
        if rng.random() < 0.3:
            ws[-1] = "#"
    return "/".join(ws)


def _bytes(rng, hi: int = 40) -> bytes:
    return rng.integers(0, 256, int(rng.integers(0, hi))).astype(
        np.uint8).tobytes()


def _props(rng, names: list[str]) -> dict:
    """A random subset of ``names`` with values of their wire types."""
    out = {}
    for name in names:
        if rng.random() < 0.5:
            continue
        if name == "User-Property":
            out[name] = [(_word(rng), _word(rng))
                         for _ in range(int(rng.integers(1, 4)))]
        elif name == "Subscription-Identifier":
            out[name] = [int(rng.integers(1, 1 << 28))
                         for _ in range(int(rng.integers(1, 3)))]
        elif name in ("Correlation-Data", "Authentication-Data"):
            out[name] = _bytes(rng)
        elif name in ("Content-Type", "Response-Topic", "Reason-String",
                      "Assigned-Client-Identifier", "Authentication-Method",
                      "Response-Information", "Server-Reference"):
            out[name] = _topic(rng)
        elif name in ("Message-Expiry-Interval", "Session-Expiry-Interval",
                      "Will-Delay-Interval", "Maximum-Packet-Size"):
            out[name] = int(rng.integers(0, 1 << 32))
        elif name in ("Receive-Maximum", "Topic-Alias-Maximum",
                      "Topic-Alias", "Server-Keep-Alive"):
            out[name] = int(rng.integers(1, 1 << 16))
        else:                                             # byte properties
            out[name] = int(rng.integers(0, 2))
    return out


ACK_PROPS = ["Reason-String", "User-Property"]


def corpus(seed: int, ver: int, n: int = 40) -> list[tuple[str, dict]]:
    """``n`` rounds of one packet of each type, as (class name, fields):
    properties only at v5, where every type carries its own set."""
    rng = np.random.default_rng(seed)
    v5 = ver == 5
    out = []
    for _ in range(n):
        qos = int(rng.integers(0, 3))
        will = bool(rng.random() < 0.5)
        pid = int(rng.integers(1, 1 << 16))
        out += [
            ("Connect", dict(
                proto_ver=ver, clean_start=bool(rng.random() < 0.5),
                keepalive=int(rng.integers(0, 1 << 16)),
                clientid=_topic(rng).replace("/", ""),
                username=_word(rng) if rng.random() < 0.5 else None,
                password=_bytes(rng) if rng.random() < 0.5 else None,
                will_flag=will, will_qos=int(rng.integers(0, 3)) if will
                else 0, will_retain=bool(will and rng.random() < 0.5),
                will_topic=_topic(rng) if will else None,
                will_payload=_bytes(rng) if will else None,
                will_props=_props(rng, [
                    "Will-Delay-Interval", "Payload-Format-Indicator",
                    "Message-Expiry-Interval", "Content-Type",
                    "Response-Topic", "Correlation-Data", "User-Property"])
                if v5 and will else {},
                properties=_props(rng, [
                    "Session-Expiry-Interval", "Receive-Maximum",
                    "Maximum-Packet-Size", "Topic-Alias-Maximum",
                    "Request-Response-Information",
                    "Request-Problem-Information", "User-Property",
                    "Authentication-Method", "Authentication-Data"])
                if v5 else {})),
            ("Connack", dict(
                session_present=bool(rng.random() < 0.5),
                reason_code=int(rng.choice([0, 0x80, 0x85, 0x87]) if v5
                                else rng.integers(0, 6)),
                properties=_props(rng, [
                    "Session-Expiry-Interval", "Receive-Maximum",
                    "Maximum-QoS", "Retain-Available", "Maximum-Packet-Size",
                    "Assigned-Client-Identifier", "Topic-Alias-Maximum",
                    "Reason-String", "User-Property",
                    "Wildcard-Subscription-Available",
                    "Subscription-Identifier-Available",
                    "Shared-Subscription-Available", "Server-Keep-Alive",
                    "Response-Information", "Server-Reference"])
                if v5 else {})),
            ("Publish", dict(
                topic=_topic(rng), payload=_bytes(rng, 300), qos=qos,
                retain=bool(rng.random() < 0.5),
                dup=bool(qos and rng.random() < 0.5),
                packet_id=pid if qos else None,
                properties=_props(rng, [
                    "Payload-Format-Indicator", "Message-Expiry-Interval",
                    "Topic-Alias", "Response-Topic", "Correlation-Data",
                    "User-Property", "Subscription-Identifier",
                    "Content-Type"]) if v5 else {})),
        ]
        for name in ("PubAck", "PubRec", "PubRel", "PubComp"):
            rc = int(rng.choice([0, 0x10, 0x80, 0x92])) if v5 else 0
            out.append((name, dict(
                packet_id=int(rng.integers(1, 1 << 16)), reason_code=rc,
                properties=_props(rng, ACK_PROPS) if v5 and rc else {})))
        nf = int(rng.integers(1, 4))
        out += [
            ("Subscribe", dict(
                packet_id=pid, topic_filters=[
                    (_topic(rng, wild=True),
                     {"qos": int(rng.integers(0, 3)),
                      "nl": int(rng.integers(0, 2)) if v5 else 0,
                      "rap": int(rng.integers(0, 2)) if v5 else 0,
                      "rh": int(rng.integers(0, 3)) if v5 else 0})
                    for _ in range(nf)],
                properties=_props(rng, ["Subscription-Identifier",
                                        "User-Property"]) if v5 else {})),
            ("SubAck", dict(
                packet_id=pid, reason_codes=[
                    int(rng.choice([0, 1, 2, 0x80] + ([0x87, 0x8F]
                                                      if v5 else [])))
                    for _ in range(nf)],
                properties=_props(rng, ACK_PROPS) if v5 else {})),
            ("Unsubscribe", dict(
                packet_id=pid,
                topic_filters=[_topic(rng, wild=True) for _ in range(nf)],
                properties=_props(rng, ["User-Property"]) if v5 else {})),
            ("UnsubAck", dict(
                packet_id=pid,
                reason_codes=[int(rng.choice([0, 0x11, 0x80]))
                              for _ in range(nf)] if v5 else [],
                properties=_props(rng, ACK_PROPS) if v5 else {})),
            ("PingReq", {}), ("PingResp", {}),
        ]
        if v5:
            rc = int(rng.choice([0, 4, 0x8E, 0x95]))
            out += [
                ("Disconnect", dict(reason_code=rc, properties=_props(rng, [
                    "Session-Expiry-Interval", "Reason-String",
                    "User-Property", "Server-Reference"]))),
                ("Auth", dict(reason_code=int(rng.choice([0, 0x18, 0x19])),
                              properties=_props(rng, [
                                  "Authentication-Method",
                                  "Authentication-Data", "Reason-String",
                                  "User-Property"]))),
            ]
        else:
            out.append(("Disconnect", {}))
    return out


def build(n, spec):
    """The corpus as packets of one package (fields deep-copied, so the
    two packages never share a list or a dict)."""
    return [getattr(n.P, name)(**copy.deepcopy(fields))
            for name, fields in spec]


def state_key(parser) -> dict:
    return dataclasses.asdict(parser.state)


def feed_all(n, ver: int, chunks: list[bytes]) -> tuple[list, list]:
    """Parse ``chunks`` with one parser: the packets and the parser's state
    after each chunk."""
    parser = n.Parser(version=ver)
    pkts, states = [], []
    for c in chunks:
        pkts.extend(packet_key(p) for p in parser.feed(c))
        states.append(state_key(parser))
    return pkts, states


@pytest.mark.parametrize("ver", [4, 5])
def test_corpus_bytes_and_packets_equal(ver):
    ref, port = net("ref"), net("port")
    spec = corpus(0x9E7 + ver, ver)
    assert {name for name, _ in spec} >= {
        "Connect", "Connack", "Publish", "PubAck", "PubRec", "PubRel",
        "PubComp", "Subscribe", "SubAck", "Unsubscribe", "UnsubAck",
        "PingReq", "PingResp", "Disconnect"}
    ref_pkts, port_pkts = build(ref, spec), build(port, spec)
    wires = []
    for rp, pp in zip(ref_pkts, port_pkts):
        assert packet_key(rp) == packet_key(pp)
        w = ref.serialize(rp, ver)
        assert port.serialize(pp, ver) == w, packet_key(rp)
        wires.append(w)
    stream = b"".join(wires)
    # the reference's parse of the whole stream (not always the packets
    # built: a v3.1.1 password without a username comes back with "")
    want, _ = feed_all(ref, ver, [stream])
    assert len(want) == len(spec)
    # whole stream, then byte by byte: both parsers give every packet back
    for chunks in ([stream], [stream[i:i + 1] for i in range(len(stream))]):
        got_ref, st_ref = feed_all(ref, ver, chunks)
        got_port, st_port = feed_all(port, ver, chunks)
        assert got_port == got_ref == want
        assert st_port == st_ref
    # parse_one on each complete frame
    assert [packet_key(port.frame.parse_one(w, ver)) for w in wires] == want


@pytest.mark.parametrize("ver", [4, 5])
def test_corpus_split_at_every_offset(ver):
    """Each packet's bytes, between its neighbours in the stream, split
    into two reads at every offset (header, remaining-length varint and
    body boundaries included): the same packets and the same resumable
    state after each read, on both sides."""
    ref, port = net("ref"), net("port")
    spec = corpus(0x5B1 + ver, ver, n=6)
    wires = [ref.serialize(p, ver) for p in build(ref, spec)]
    checked = 0
    for k in range(1, len(wires) - 1):
        prev, cur, nxt = wires[k - 1:k + 2]
        want, _ = feed_all(ref, ver, [prev + cur + nxt])
        for cut in range(1, len(cur)):
            chunks = [prev + cur[:cut], cur[cut:] + nxt]
            got_ref, st_ref = feed_all(ref, ver, chunks)
            got_port, st_port = feed_all(port, ver, chunks)
            assert got_port == got_ref == want
            assert st_port == st_ref
            checked += 1
    assert checked > 200


# ---------------------------------------------------------------------------
# malformed input: the same FrameError on both sides
# ---------------------------------------------------------------------------


def _publish(ver, **kw):
    n = net("ref")
    return n.serialize(n.P.Publish(**{"topic": "tt", "payload": b"p", **kw}),
                       ver)


def _malformed() -> dict:
    ref = net("ref")
    pub = bytearray(_publish(4))
    bad_utf8 = bytearray(pub)
    bad_utf8[4:6] = b"\xff\xfe"
    conn = bytearray(ref.serialize(ref.P.Connect(clientid="c")))
    reserved = bytearray(conn)
    reserved[9] |= 0x01
    bad_name = bytearray(conn)
    bad_name[4:8] = b"MQTX"
    q2 = _publish(4, qos=2, packet_id=1)
    body = b"\x00\x01t" + bytes([2, 0x7F, 0x00]) + b"payload"
    dup_prop = b"\x00\x01t" + bytes([4, 0x01, 0x00, 0x01, 0x01]) + b"x"
    sub = bytearray(ref.serialize(ref.P.Subscribe(
        packet_id=1, topic_filters=[("a", {"qos": 1})]), 5))
    sub_reserved = bytearray(sub)
    sub_reserved[-1] |= 0xC0
    return {
        "reserved_type_0": (4, bytes([0x00, 0x01, 0x00]), None),
        "publish_qos3": (4, bytes([q2[0] | 0x06]) + q2[1:], None),
        "varint_5_bytes": (4, bytes([0x30, 0x80, 0x80, 0x80, 0x80, 0x01]),
                           None),
        "too_large": (4, _publish(4, payload=b"x" * 200), 100),
        "bad_utf8_topic": (4, bytes(bad_utf8), None),
        "unknown_property": (5, bytes([0x30, len(body)]) + body, None),
        "duplicate_property": (5, bytes([0x30, len(dup_prop)]) + dup_prop,
                               None),
        "connect_reserved_flag": (4, bytes(reserved), None),
        "bad_protocol_name": (4, bytes(bad_name), None),
        "pubrel_flags": (4, bytes([0x60, 0x02, 0x00, 0x01]), None),
        "subscribe_flags": (4, bytes([0x80]) + bytes(sub[1:]), None),
        "subscribe_reserved_bits": (5, bytes(sub_reserved), None),
        "empty_subscribe": (4, bytes([0x82, 0x02, 0x00, 0x01]), None),
        "empty_unsubscribe": (4, bytes([0xA2, 0x02, 0x00, 0x01]), None),
        "unsubscribe_flags": (4, bytes([0xA0, 0x05, 0x00, 0x01, 0x00, 0x01,
                                        0x61]), None),
        "truncated_puback": (4, bytes([0x40, 0x01, 0x00]), None),
        "truncated_connect": (4, bytes([0x10, 0x03, 0x00, 0x04, 0x4D]),
                              None),
        "property_length_mismatch": (5, bytes([0x40, 0x05, 0x00, 0x01, 0x00,
                                               0x01, 0x01]), None),
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_same_frame_error(case):
    ver, data, max_size = MALFORMED[case]
    errs = {}
    for pkg in PKGS:
        n = net(pkg)
        kw = {} if max_size is None else {"max_size": max_size}
        with pytest.raises(n.P.FrameError) as ei:
            n.Parser(version=ver, **kw).feed(data)
        errs[pkg] = (ei.value.rc, str(ei.value))
    assert errs["port"] == errs["ref"]


def test_serialize_errors_equal():
    """What the serializers refuse, both refuse alike."""
    for pkg in PKGS:
        n = net(pkg)
        with pytest.raises(n.P.FrameError, match="packet_id"):
            n.serialize(n.P.Publish(topic="t", qos=1))
