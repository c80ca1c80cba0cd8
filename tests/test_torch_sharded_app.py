"""The subscription-sharded trie as a configured deployment (D10): the app
boots it from ``router.device.trie_shards``, routes through it exactly as
the plain reference router does, and a sharded model's traced batches count
how the shards share their matches.

- ``from_config`` builds a flat ``TrieIndex`` for S = 0 (the default) and a
  ``ShardedTrieIndex`` of S tries with the block's ``max_levels`` for S > 0,
  refreshed once at boot; a negative S is refused by the schema.
- A seeded small fleet table (``benchmark/traffic/fleet.py``) routed through
  the app's ``PublishPipeline`` delivers, ``(session, filter)`` by
  ``(session, filter)``, what ``benchmark/reference/router.py`` says, on
  every layout.
- A traced batch of a sharded model carries ``trie_shards``,
  ``matched_fids`` and ``shard_fids_max`` (and ``patch_elems`` /
  ``patch_shards`` where its submit patched the tables); a flat model's
  carries none, and an untraced batch computes none.

Every case runs the port's app over a model on the CPU (the routing step's
plain kernels; ``tests/conftest.py`` pins them)."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from benchmark.manifest import Manifest
from benchmark.reference.router import ReferenceRouter
from emqx_tpu_torch.config.config import Config
from emqx_tpu_torch.config.schema import SchemaError
from emqx_tpu_torch.core.message import Message
from emqx_tpu_torch.router.index import (ShardedTrieIndex, TrieIndex,
                                         shard_of_filter)
from test_torch_harness import cpu_router_models
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

FLEET = Manifest().generator("fleet")
SHARD_COUNTERS = {"trie_shards", "matched_fids", "shard_fids_max"}
PATCH_COUNTERS = {"patch_elems", "patch_shards"}
SUBSCRIPTIONS, SESSIONS, TOPICS, UNMATCHED = 4000, 300, 1024, 64


class Channel:
    """Keeps each delivery as ``(filter, message number)``."""

    def __init__(self) -> None:
        self.got: list = []

    def handle_deliver(self, items):
        return items

    def send(self, items) -> None:
        self.got.extend((filt, int.from_bytes(m.payload, "little"))
                        for filt, m in items)


def boot(monkeypatch, tmp_path, shards=None, batch_max=256):
    cpu_router_models(monkeypatch)
    from emqx_tpu_torch.app import BrokerApp
    conf = Config()
    conf.put("node.data_dir", str(tmp_path))
    conf.put("router.device.enable", True)
    conf.put("router.device.max_levels", 8)
    conf.put("router.device.n_sub_slots", 64)
    conf.put("router.device.min_batch", 0)
    conf.put("router.device.batch_max", batch_max)
    if shards is not None:
        conf.put("router.device.trie_shards", shards)
    return BrokerApp.from_config(conf)


@functools.lru_cache(maxsize=1)
def fleet():
    """The seeded table ``[(session, filter)]`` and the topics: filled
    filters of the table, and topics off the tree that match nothing."""
    rng = np.random.default_rng(2**33 + 21)
    conf = {"subscriptions": SUBSCRIPTIONS, "sessions": SESSIONS}
    table = FLEET.subscriptions(conf, rng)
    topics = FLEET.topic_pool(table, conf,
                              {"topic_pool": TOPICS - UNMATCHED}, rng)
    for i in range(UNMATCHED):
        topics.insert(int(rng.integers(0, len(topics) + 1)),
                      f"fleet/f{i}/truck/v{i}/part/p0/m0" if i % 2
                      else f"$SYS/fleet/f{i}")
    return table, topics


def route(app, table, topics) -> dict:
    """Subscribe the table, publish the topics through the app's pipeline;
    ``{topic number: sorted [(session, filter)]}`` of what was delivered
    (a topic may come twice: each message carries its number)."""
    chans = {}
    for sid, filt in table:
        app.broker.subscribe(sid, filt)
        if sid not in chans:
            chans[sid] = Channel()
            app.cm.register_channel(sid, chans[sid])
    msgs = [Message(topic=t, payload=i.to_bytes(4, "little"))
            for i, t in enumerate(topics)]
    for m in msgs:
        app.pipeline.submit(m)
    app.pipeline.flush()
    out: dict = {}
    for sid, ch in chans.items():
        for filt, i in ch.got:
            out.setdefault(i, []).append((sid, filt))
    return {i: sorted(v) for i, v in out.items()}


@functools.lru_cache(maxsize=1)
def expected() -> dict:
    table, topics = fleet()
    ref = ReferenceRouter(table)
    out = {i: sorted(ref.deliveries(t)) for i, t in enumerate(topics)}
    return {i: v for i, v in out.items() if v}


# ---------------------------------------------------------------------------
# the boot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [None, 0, 1, 4])
def test_from_config_builds_the_configured_layout(shards, monkeypatch,
                                                  tmp_path):
    app = boot(monkeypatch, tmp_path, shards)
    model = app.broker.model
    assert app.config.get("router.device.trie_shards") == (shards or 0)
    if shards:
        assert isinstance(model.index, ShardedTrieIndex)
        assert model.n_shards == model.index.n_shards == shards
        assert all(s.max_levels == 8 for s in model.index.shards)
    else:
        assert type(model.index) is TrieIndex and model.n_shards == 1
    assert model.index.max_levels == 8
    assert (model.n_sub_slots, model.device.type) == (64, "cpu")
    # refreshed once at boot: one upload, no patch
    assert (model.upload_count, model.patch_count) == (1, 0)
    assert app.pipeline.broker is app.broker
    assert model.telemetry is app.device_metrics


@pytest.mark.parametrize("bad", [-1, -4])
def test_negative_shards_are_refused(bad):
    with pytest.raises(SchemaError, match="trie_shards"):
        Config().init_load(f"router.device {{ trie_shards = {bad} }}")
    conf = Config()
    with pytest.raises(SchemaError, match="trie_shards"):
        conf.put("router.device.trie_shards", bad)
    assert conf.get("router.device.trie_shards") == 0


# ---------------------------------------------------------------------------
# the routes against the plain reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat_routes(tmp_path_factory) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        return route(boot(mp, tmp_path_factory.mktemp("flat"), 0), *fleet())


def test_the_table_exercises_the_layouts():
    table, topics = fleet()
    want = expected()
    assert len(table) == SUBSCRIPTIONS and len(topics) == TOPICS
    assert TOPICS - len(want) >= UNMATCHED   # some topics match nothing
    filters = {f for _, f in table}
    assert {shard_of_filter(f, 4) for f in filters} == {0, 1, 2, 3}
    assert any("+" in f for f in filters) and any("#" in f for f in filters)
    assert sum(map(len, want.values())) > len(want)   # overlapping matches


@pytest.mark.parametrize("shards", [0, 1, 4])
def test_routes_equal_the_plain_reference(shards, flat_routes, monkeypatch,
                                         tmp_path):
    app = boot(monkeypatch, tmp_path, shards)
    got = route(app, *fleet())
    want = expected()
    missing = {i: sorted(set(v) - set(got.get(i, ()))) for i, v in
               want.items() if set(v) - set(got.get(i, ()))}
    extra = {i: sorted(set(v) - set(want.get(i, ()))) for i, v in
             got.items() if set(v) - set(want.get(i, ()))}
    assert (missing, extra) == ({}, {})
    assert got == want                          # and none twice
    assert app.broker.model.launch_count >= TOPICS // 256
    if shards:
        assert got == flat_routes


# ---------------------------------------------------------------------------
# the counters of a sharded model's traced batches
# ---------------------------------------------------------------------------


def batch_topics(batch, msgs) -> list:
    by_id = {m.id: m.topic for m in msgs}
    return [by_id[i] for i in batch.msg_ids]


def publish(app, topics) -> list:
    msgs = [Message(topic=t, payload=b"x") for t in topics]
    for m in msgs:
        app.pipeline.submit(m)
    app.pipeline.flush()
    return msgs


def test_sharded_batch_counts_its_matches_by_shard(monkeypatch, tmp_path):
    app = boot(monkeypatch, tmp_path, 4, batch_max=128)
    ring = app.trace_batches(1, 64)
    table, topics = fleet()
    for sid, filt in table:
        app.broker.subscribe(sid, filt)
    msgs = publish(app, topics[:512])
    ref = ReferenceRouter(table)
    index = app.broker.model.index
    batches = ring.batches()
    assert len(batches) == 4
    for bt in batches:
        fids = [index.fid_of(f) for t in batch_topics(bt, msgs)
                for f in ref.match(t)]
        per = np.bincount(np.asarray(fids) % 4, minlength=4)
        assert bt.counters["trie_shards"] == 4
        assert bt.counters["matched_fids"] == per.sum() == len(fids) > 0
        assert bt.counters["shard_fids_max"] == per.max()
    # the first submit uploaded the grown tables whole: no patch counted
    assert not PATCH_COUNTERS & set(batches[0].counters)

    # a few filters more: the next traced submit patches their shards
    model = app.broker.model
    uploads = model.upload_count
    new = [f"fleet/f{i}/vehicle/v{i}/part/p{i % 8}/m{i}" for i in range(3)]
    for f in new:
        app.broker.subscribe("c0", f)
    publish(app, new)
    (bt,) = ring.batches()[4:]
    assert model.upload_count == uploads
    assert any(name == "model.refresh" for name, *_ in bt.spans)
    assert bt.counters["patch_shards"] == len(
        {shard_of_filter(f, 4) for f in new})
    assert bt.counters["patch_elems"] >= len(new)
    assert bt.counters["matched_fids"] == len(new)


def test_flat_batch_carries_no_shard_counters(monkeypatch, tmp_path):
    app = boot(monkeypatch, tmp_path, 0)
    ring = app.trace_batches(1, 16)
    table, topics = fleet()
    for sid, filt in table[:500]:
        app.broker.subscribe(sid, filt)
    publish(app, topics[:64])
    app.broker.subscribe("c0", "fleet/f1/vehicle/v1/part/p1/m1")
    publish(app, ["fleet/f1/vehicle/v1/part/p1/m1"])
    batches = ring.batches()
    assert len(batches) == 2
    assert any(name == "model.refresh" for name, *_ in batches[1].spans)
    for bt in batches:
        assert bt.counters and not (SHARD_COUNTERS | PATCH_COUNTERS) \
            & set(bt.counters)


@pytest.mark.parametrize("every", [0, 3])
def test_untraced_batches_compute_no_shard_counts(every, monkeypatch,
                                                  tmp_path):
    app = boot(monkeypatch, tmp_path, 4, batch_max=64)
    ring = app.trace_batches(every, 64)
    model = app.broker.model
    calls = []
    real = model._count_shards
    monkeypatch.setattr(model, "_count_shards",
                        lambda trace, fids: (calls.append(trace.trace_id),
                                             real(trace, fids)))
    table, topics = fleet()
    for sid, filt in table[:500]:
        app.broker.subscribe(sid, filt)
    publish(app, topics[:64 * 7])
    traced = [bt.trace_id for bt in ring.batches()] if every else []
    assert calls == traced
    assert len(calls) == (0 if not every else 3)       # batches 1, 4, 7
