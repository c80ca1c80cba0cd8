"""The broker's delivery-map build on the port: a matched row's deliveries
come from a filter-first walk over the broker's subscriber table, each
subscriber kept where the step delivers the row to its slot.

The walk is held to the slot -> session -> filter probe loop it replaced
(:func:`probe_loop`, the oracle here) over the same step results and the
same tables, in every slot regime and with subscriptions changed while a
batch is in flight, and to the host oracle (``Broker._route``) where
nothing is in flight.  Then subscribes and unsubscribes on another thread
race a ``PublishPipeline`` that collects batches.

Every case runs the port's ``Broker`` over a port ``RouterModel`` on the
CPU (the routing step's plain kernels; ``tests/conftest.py`` pins them)."""

from __future__ import annotations

import logging
import sys
import threading

import numpy as np
import pytest

from emqx_tpu_torch import RouterModel
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.cm import CM
from emqx_tpu_torch.broker.pipeline import PublishPipeline
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.observe.metrics import Metrics
from emqx_tpu_torch.router.index import TrieIndex
from emqx_tpu_torch.router.router import Router

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import RecordingChannel, gen_filters, gen_topics

LEVELS = 6
N_SIDS = 24
# the bystander: past 2 or 16 unique slots it hashes into slot 0, c0's
BY = "by5"


def probe_loop(broker: Broker, m: Message, matched, slots) -> dict:
    """The expansion the filter-first walk replaced: every session of
    every slot the step delivers the row to, probed against every matched
    filter in the suboption table."""
    out: dict = {}
    for slot in slots:
        for sid in broker.slots.lookup_sids(slot):
            for filt in matched:
                if (sid, filt) in broker.suboption:
                    out.setdefault(sid, []).append((filt, m))
    return out


def plane(n_sub_slots: int, dense_threshold: int, router=None):
    """A port Broker over a port RouterModel on the CPU (and ``router``,
    where given), with a deterministic shared dispatch, whose model
    records what each collect returned."""
    model = RouterModel(TrieIndex(max_levels=LEVELS), device="cpu",
                        n_sub_slots=n_sub_slots,
                        dense_threshold=dense_threshold)
    broker = Broker(node="n1", router=router, router_model=model,
                    metrics=Metrics())

    def shared_dispatch(group, topic, _msg):
        sids = broker.subscriber.get(f"$share/{group}/{topic}", ())
        return [(min(sids), f"$share/{group}/{topic}")] if sids else []

    broker.shared_dispatch = shared_dispatch
    collect, results = model.publish_batch_collect, []

    def recording_collect(pending):
        res = collect(pending)
        results.append(res)
        return res

    model.publish_batch_collect = recording_collect
    return model, broker, results


def subscribe_table(broker: Broker, rng, hot: int) -> list:
    """Seeded subscriptions of ``N_SIDS`` sessions: random filters with one
    to three subscribers each, ``a/+`` with ``hot`` of them, session c0 on
    ``a/+`` both plainly and as ``$share/g/a/+``, and the bystander ``BY``,
    whose one filter no published topic matches.  The sessions subscribe
    in order, so slots go out c0, c1, ... while unique ones last."""
    sids = [f"c{i}" for i in range(N_SIDS)]
    subs = [(sids[int(k)], f)
            for f in gen_filters(rng, 60, max_words=LEVELS)
            for k in rng.choice(N_SIDS, int(rng.integers(1, 4)),
                                replace=False)]
    subs += [(sids[i], "a/+") for i in range(hot)]
    subs += [("c0", "$share/g/a/+"), ("c1", "$share/g/a/+"), (BY, "no/0")]
    for sid in sids + [BY]:
        for s, f in subs:
            if s == sid:
                broker.subscribe(s, f)
    return subs


def batch(rng, n: int) -> list:
    topics = gen_topics(rng, n, max_words=LEVELS + 2) + ["a/b", "a/x1", "a"]
    return [Message(topic=t, payload=b"p%d" % i) for i, t in enumerate(topics)]


def delivered(broker: Broker) -> int:
    return broker.metrics.all().get("messages.delivered", 0)


def check_walk(broker: Broker, msgs, out, res) -> int:
    """Each row the step matched and did not punt equals the probe loop's
    map (its ``$share`` legs aside), legs in the same order; returns how
    many rows delivered to the bystander's slot."""
    matched, _aux, slots, fallback = res
    by_slot, touched, fallback = broker.slots.lookup_slot(BY), 0, set(fallback)
    for j, m in enumerate(msgs):
        if j in fallback:
            continue
        got = {}
        for sid, legs in out[j].items():
            plain = [leg for leg in legs if not leg[0].startswith("$share/")]
            if plain:
                got[sid] = plain
        assert got == probe_loop(broker, m, matched[j], slots[j]), m.topic
        assert BY not in out[j]
        touched += bool(matched[j]) and by_slot in slots[j]
    return touched


def sorted_legs(maps) -> list:
    return [{sid: sorted(legs, key=lambda leg: leg[0])
             for sid, legs in d.items()} for d in maps]


def publish_settled(broker: Broker, results, msgs) -> tuple:
    """A batch with nothing in flight: the walk, the delivery counter and
    the host oracle agree."""
    n0 = delivered(broker)
    out = broker.publish_batch(msgs)
    assert delivered(broker) - n0 == sum(
        len(legs) for d in out for legs in d.values())
    touched = check_walk(broker, msgs, out, results[-1])
    # the host oracle on valid topic names only: on a name with a literal
    # '#' word the route trie returns a '#' filter's route twice
    valid = [j for j, m in enumerate(msgs)
             if "+" not in m.topic and "#" not in m.topic]
    assert sorted_legs(out[j] for j in valid) == sorted_legs(
        broker._route(msgs[j].topic, msgs[j]) for j in valid)
    return out, touched


# name: (n_sub_slots, dense_threshold, changes in flight).  24 sessions and
# the bystander: 2 and 16 slots are shared, 64 unique.
CASES = {
    "slots_2": (2, 64, False),
    "slots_16": (16, 64, False),
    "slots_64": (64, 64, False),
    "dense_pool": (16, 4, False),
    "in_flight_slots_2": (2, 64, True),
    "in_flight_slots_64": (64, 64, True),
    "in_flight_dense_pool": (64, 4, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_filter_first_walk_equals_the_probe_loop(name):
    n_sub_slots, dense_threshold, in_flight = CASES[name]
    rng = np.random.default_rng(2000 + list(CASES).index(name))
    model, broker, results = plane(n_sub_slots, dense_threshold)
    hot = 10 if dense_threshold < 10 else 3
    subs = subscribe_table(broker, rng, hot)
    if dense_threshold < hot:
        # a/+'s slots come from the device's pool row
        assert model.index.filters.index("a/+") in model._dense_row
    out, touched = publish_settled(broker, results, batch(rng, 40))
    # c0's plain leg on a/b and its $share leg, once each
    legs = [f for f, _ in out[-3]["c0"]]
    assert legs.count("a/+") == 1 and legs.count("$share/g/a/+") == 1
    if n_sub_slots < N_SIDS:
        # the bystander shares a slot that some row delivers to
        assert touched > 0
    if in_flight:
        msgs = batch(rng, 40)
        token = broker.publish_batch_submit(msgs)
        broker.subscribe("late", "a/+")       # a new slot, after submit
        for sid, f in subs[:6]:
            broker.unsubscribe(sid, f)
        broker.subscriber_down("c3")
        gone = broker.slots.lookup_slot("c5")
        broker.subscriber_down("c5")          # its slot is freed, if alone
        for f in ("a/+", "#", "a/#"):
            broker.subscribe("fresh", f)
        if n_sub_slots > N_SIDS:
            assert broker.slots.lookup_slot("fresh") == gone
        n0 = delivered(broker)
        out = broker.publish_batch_collect(token)
        assert delivered(broker) - n0 == sum(
            len(legs) for d in out for legs in d.values())
        check_walk(broker, msgs, out, results[-1])
        assert "c3" not in {s for d in out for s in d}
        if dense_threshold < hot:
            # a/+'s slots are its pool row as the step read it
            assert "late" not in out[-3]
        publish_settled(broker, results, batch(rng, 40))


# routes of other nodes beside the table's own: remote forwards (one on a
# filter the node also holds) and a shared group homed on another node
REMOTE = [("a/#", "n2"), ("a/+", "n3"), ("+/+/+", "n2"), ("no/0", "n3"),
          ("$share/h/a/+", None), ("a", "n2")]
PARITY_METRICS = ("messages.forward", "messages.forward.slow",
                  "messages.delivered", "messages.dropped.no_subscribers",
                  "messages.publish")


@pytest.mark.parametrize("seed", range(3))
def test_away_walk_equals_the_full_walk(seed):
    """A broker whose router's home is its node walks the router's away
    index after the step; one handed a router homed elsewhere walks the
    whole table.  Over the same subscriptions, remote routes and batches
    both give the same delivery maps (shared picks included), the same
    ``forward_fn`` calls in the same order and the same counters."""
    runs = []
    for home in ("n1", "elsewhere"):
        router = Router()
        router.set_home(home)
        model, broker, results = plane(16, 64, router)
        rng = np.random.default_rng(5000 + seed)
        subscribe_table(broker, rng, 3)
        for topic, dest in REMOTE:
            if dest is None:               # the group ``h`` on node n2
                broker.router.add_route(topic[len("$share/h/"):],
                                        ("h", "n2"))
            else:
                broker.router.add_route(topic, dest)
        calls, walks = [], []
        broker.forward_fn = lambda node, t, m: calls.append(
            (node, t, m.topic, m.payload))
        away = broker.router.match_away_routes
        broker.router.match_away_routes = lambda t: walks.append(t) or away(t)
        outs = [broker.publish_batch(batch(rng, 40)) for _ in range(3)]
        metrics = broker.metrics.all()
        runs.append(dict(
            maps=[[{sid: [(f, m.topic, m.payload) for f, m in legs]
                    for sid, legs in d.items()} for d in out]
                  for out in outs],
            calls=calls, metrics={k: metrics.get(k, 0)
                                  for k in PARITY_METRICS}))
        assert broker.router.home == home
        # each row the step served (not punted to the host oracle) was
        # walked over the away index where the home is the broker's node
        served = sum(len(res[0]) - len(set(res[3])) for res in results)
        assert served > 60
        assert len(walks) == (served if home == "n1" else 0)
        if home == "n1":
            # the remote routes and the node's own group g's one route
            assert broker.router.away_count == len(REMOTE) + 1
    away, full = runs
    assert away == full
    assert full["calls"] and full["metrics"]["messages.forward"] == len(
        full["calls"])
    # the other node's group and the node's own group both pick
    legs = {f for out in full["maps"] for d in out for ls in d.values()
            for f, *_ in ls}
    assert {"$share/g/a/+"} <= legs


def test_walk_under_concurrent_subscribes(caplog):
    """A thread subscribes and unsubscribes sessions on ``#``, which every
    published topic matches, while a pipeline collects batches: no
    exception reaches the pipeline, and every delivery on ``#`` goes to a
    session that held it at some point in the run."""
    model = RouterModel(TrieIndex(max_levels=LEVELS), device="cpu",
                        n_sub_slots=16)
    broker = Broker(node="n1", router_model=model, metrics=Metrics())
    cm = CM()
    pipe = PublishPipeline(broker, cm, max_batch=32)
    pipe.min_device_batch = 0
    stable = [f"s{i}" for i in range(64)]
    churn = [f"k{i}" for i in range(64)]
    channels = {sid: RecordingChannel()
                for sid in stable + churn + ["never"]}
    for sid, ch in channels.items():
        cm.register_channel(sid, ch)
    for sid in stable:
        broker.subscribe(sid, "#")
    for sid in churn + ["never"]:
        broker.subscribe(sid, "t/none")       # a slot, no match
    stop, errors, ever = threading.Event(), [], set()

    def churner():
        rng = np.random.default_rng(7)
        try:
            while not stop.is_set():
                sid = churn[int(rng.integers(0, len(churn)))]
                if "#" in broker.subscription.get(sid, ()):
                    broker.unsubscribe(sid, "#")
                else:
                    ever.add(sid)
                    broker.subscribe(sid, "#")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    thread = threading.Thread(target=churner, daemon=True)
    thread.start()
    try:
        with caplog.at_level(logging.ERROR):
            for r in range(40):
                for i in range(64):
                    pipe.submit(Message(topic=f"t/{r}/{i}", payload=b"x"))
                pipe.flush()
    finally:
        stop.set()
        thread.join(timeout=10)
        sys.setswitchinterval(interval)
    assert not thread.is_alive() and not errors
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
    assert pipe.published == 40 * 64
    for sid in stable:
        assert len(channels[sid].got) == 40 * 64
    assert channels["never"].got == []
    assert sum(len(channels[s].got) for s in churn) > 0
    for sid, ch in channels.items():
        assert {t for t, *_ in ch.got} <= {"#"}, sid
        assert not ch.got or sid in ever or sid in stable, sid
