"""The reference router against the MQTT 5.0 spec's cases and a brute-force
matcher, and the comparison against deliveries with each kind of fault."""

import random
from types import SimpleNamespace

import pytest

from benchmark.reference.check import compare
from benchmark.reference.router import ReferenceRouter

SPEC = [  # (filter, topic, matches) — MQTT 5.0 section 4.7
    ("sport/tennis/player1/#", "sport/tennis/player1", True),
    ("sport/tennis/player1/#", "sport/tennis/player1/ranking", True),
    ("sport/tennis/player1/#", "sport/tennis/player1/score/wimbledon", True),
    ("sport/#", "sport", True),
    ("#", "sport/tennis", True),
    ("sport/tennis/#", "sport/tennis", True),
    ("sport/tennis/+", "sport/tennis/player1", True),
    ("sport/tennis/+", "sport/tennis/player1/ranking", False),
    ("sport/+", "sport", False),
    ("sport/+", "sport/", True),
    ("+/+", "/finance", True),
    ("/+", "/finance", True),
    ("+", "/finance", False),
    ("+", "finance", True),
    ("a//b", "a//b", True),
    ("a/+/b", "a//b", True),
    ("#", "$SYS/monitor/Clients", False),
    ("+/monitor/Clients", "$SYS/monitor/Clients", False),
    ("$SYS/#", "$SYS/monitor/Clients", True),
    ("$SYS/monitor/+", "$SYS/monitor/Clients", True),
    ("$SYS/+/Clients", "$SYS/monitor/Clients", True),
    ("sport/tennis", "sport/tennis/x", False),
    ("sport/tennis/x", "sport/tennis", False),
]


@pytest.mark.parametrize("filt,topic,want", SPEC)
def test_spec_cases(filt, topic, want):
    r = ReferenceRouter([("s", filt)])
    assert (r.match(topic) == [filt]) is want


def brute(filt: str, topic: str) -> bool:
    fw, tw = filt.split("/"), topic.split("/")
    if tw[0].startswith("$") and fw[0] in ("+", "#"):
        return False
    for i, f in enumerate(fw):
        if f == "#":
            return True
        if i >= len(tw) or (f != "+" and f != tw[i]):
            return False
    return len(fw) == len(tw)


def test_against_brute_force():
    rng = random.Random(7)
    words = ["a", "b", "", "$x"]

    def filt():
        n = rng.randint(1, 4)
        ws = [rng.choice(words[:3] + ["+"]) for _ in range(n)]
        if rng.random() < 0.3:
            ws[-1] = "#"
        return "/".join(ws)

    filters = list({filt() for _ in range(300)})
    table = [(f"s{rng.randrange(20)}", f) for f in filters for _ in range(2)]
    r = ReferenceRouter(table)
    for _ in range(500):
        topic = "/".join(rng.choice(words) for _ in range(rng.randint(1, 4)))
        assert sorted(r.match(topic)) == sorted(
            f for f in filters if brute(f, topic)), topic
        want = {(s, f) for s, f in table if brute(f, topic)}
        assert r.deliveries(topic) == want


def test_walk_counts_edges():
    r = ReferenceRouter([("s", "a/b"), ("s", "a/+"), ("s", "a/#"),
                         ("s", "c")])
    matched, edges = r.walk("a/b")
    assert sorted(matched) == ["a/#", "a/+", "a/b"]
    # a, then a's '#', '+' and 'b'; then the '#' below b and +: none
    assert edges == 4


class Msg:
    def __init__(self, topic, payload):
        self.topic, self.payload = topic, payload


def tiny_case():
    table = [("s1", "a/+"), ("s2", "a/b"), ("s2", "a/#"), ("s3", "b")]
    log = SimpleNamespace(pool=["a/b", "b"], topic=[0, 1, 0], pub=[0, 0, 0],
                          seq=[0, 1, 2])
    log.payload = lambda i: bytes([i]) + bytes(7) + b"x"
    msgs = [Msg(log.pool[log.topic[i]], log.payload(i)) for i in range(3)]
    return ReferenceRouter(table), log, msgs


def deliveries(msgs, router):
    """As the recording channels keep them: per session, the stamp, the
    filter, the payload and the topic of each delivery, flat."""
    chans = {}
    for i, m in enumerate(msgs):
        for sid, f in sorted(router.deliveries(m.topic)):
            chans.setdefault(sid, []).append((i, f, m.payload, m.topic))
    return chans


def flat(chans):
    return {sid: [x for e in es for x in e] for sid, es in chans.items()}


def test_compare_exact():
    router, log, msgs = tiny_case()
    out = compare(router, flat(deliveries(msgs, router)), log)
    assert out["counts"] == dict.fromkeys(out["counts"], 0)
    assert out["checked"] == 3 and not out["faulty"]


@pytest.mark.parametrize("fault,count", [
    ("drop", "missing_deliveries"), ("dup", "extra_deliveries"),
    ("wrong_sid", "extra_deliveries"), ("payload", "payload_mismatches"),
    ("order", "order_violations"), ("lost", "undelivered_messages")])
def test_compare_finds(fault, count):
    router, log, msgs = tiny_case()
    chans = deliveries(msgs, router)
    if fault == "drop":
        chans["s2"].pop()
    elif fault == "dup":
        chans["s1"].append(chans["s1"][0])
    elif fault == "wrong_sid":
        chans["s3"].append((9, "a/+", msgs[0].payload, msgs[0].topic))
    elif fault == "payload":
        chans["s3"][0] = (0, "b", b"\x01" + bytes(7) + b"y", "b")
    elif fault == "order":
        chans["s1"].reverse()
    elif fault == "lost":
        for sid in chans:
            chans[sid] = [e for e in chans[sid] if e[2] != msgs[1].payload]
    out = compare(router, flat(chans), log)
    assert out["counts"][count] > 0 and out["faulty"]
