"""The shard skew reader (``metrics/model.shard_skew.tput.py``) on made-up
batch traces: the window's batches only, S × Σ fullest shard / Σ matched,
and silent where no batch carries the sharded decode's counters."""

from types import SimpleNamespace

import pytest

from benchmark.manifest import Manifest
from conftest import ROOT
from emqx_tpu_torch.observe.trace import BatchTrace, SpanCollector

NAME = "model.shard_skew.tput"
WINDOW = (1_000, 100_000)


def batch(tid, t0, **counters):
    bt = BatchTrace(tid, [tid])
    bt.span("pipeline.assemble", t0, t0 + 10, 1)
    bt.counters.update(counters)
    return bt


def read(*batches, program=True):
    ring = SpanCollector(max_traces=16)
    for b in batches:
        ring.commit(b)
    lo, hi = WINDOW
    rec = SimpleNamespace(program=ring if program else None, trace=None,
                          in_window=lambda t: lo <= t < hi)
    return Manifest(ROOT).reader(NAME)(rec)


def test_skew_over_the_window_batches():
    before = batch(1, 500, trie_shards=4, matched_fids=100,
                   shard_fids_max=100)
    a = batch(2, 2_000, trie_shards=4, matched_fids=40, shard_fids_max=10)
    b = batch(3, 50_000, trie_shards=4, matched_fids=24, shard_fids_max=12)
    flat = batch(4, 60_000, expand_ns=5, deliveries=3)
    after = batch(5, 100_000, trie_shards=4, matched_fids=8,
                  shard_fids_max=8)
    # a: even (10 of 40 in each shard); b: half in one shard
    assert read(before, a, b, flat, after) == pytest.approx(4 * 22 / 64)
    assert read(a) == pytest.approx(1.0)
    assert read(b) == pytest.approx(2.0)


def test_silent_without_sharded_batches():
    assert read(program=False) is None
    assert read(batch(1, 2_000, expand_ns=5, deliveries=3)) is None
    assert read(batch(1, 500, trie_shards=4, matched_fids=8,
                      shard_fids_max=2)) is None
    # a sharded batch that matched nothing has no skew
    assert read(batch(1, 2_000, trie_shards=4, matched_fids=0,
                      shard_fids_max=0)) is None
