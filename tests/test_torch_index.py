"""The port's copies of the JAX-free host modules against the reference's.

``router/index.py``, ``router/trie.py`` and ``core/topic.py`` carry the
contract between the host builder and the device walk (hashes, array
layout, word ids, tokenization), so the port's copies must give the same
bits.  The reference modules import no JAX, so they import directly here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu.core import topic as ref_topic
from emqx_tpu.router import index as ref_index
from emqx_tpu.router.trie import Trie as RefTrie
from emqx_tpu_torch import device_trie
from emqx_tpu_torch.core import topic as port_topic
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router import index as port_index
from emqx_tpu_torch.router.trie import Trie as PortTrie

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import FIELDS
from test_torch_harness import gen_filters as _filters
from test_torch_harness import gen_topics as _topics

def _same_arrays(a, b) -> None:
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(a, n), getattr(b, n), err_msg=n)
    assert (a.n_nodes, a.n_filters, a.max_probes) == \
        (b.n_nodes, b.n_filters, b.max_probes)


def test_edge_hash_and_step_bits():
    rng = np.random.default_rng(7)
    parent = np.concatenate([
        np.array([-1, 0, 1, 2 ** 31 - 1, -2 ** 31], np.int32),
        rng.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64).astype(np.int32)])
    word = rng.integers(-2 ** 31, 2 ** 31, parent.shape[0],
                        dtype=np.int64).astype(np.int32)
    for mask in (63, 2 ** 16 - 1, 2 ** 24 - 1, 2 ** 31 - 1):
        ref_h = ref_index.edge_hash(parent, word, mask)
        ref_s = ref_index.edge_step(parent, word, mask)
        np.testing.assert_array_equal(
            port_index.edge_hash(parent, word, mask), ref_h)
        np.testing.assert_array_equal(
            port_index.edge_step(parent, word, mask), ref_s)
        tp, tw = torch.from_numpy(parent), torch.from_numpy(word)
        np.testing.assert_array_equal(
            tm.edge_hash(tp, tw, mask).numpy(), ref_h)
        np.testing.assert_array_equal(
            tm.edge_step(tp, tw, mask).numpy(), ref_s)


@pytest.mark.parametrize("vectorized", [False, True])
def test_trie_index_arrays_tokenize_and_patch_log(vectorized):
    rng = np.random.default_rng(11 + vectorized)
    filters = _filters(rng, 1500)
    ref, port = ref_index.TrieIndex(max_levels=6), \
        port_index.TrieIndex(max_levels=6)
    if vectorized:      # take the numpy level-synchronous builder
        ref.VECTOR_BUILD_MIN = port.VECTOR_BUILD_MIN = 100
    for ix in (ref, port):
        ix.load(filters)
    _same_arrays(ref.ensure(), port.ensure())
    assert ref.vocab == port.vocab and ref.filters == port.filters
    topics = _topics(rng, 300) + ["$SYS/a", "", "a/b/c/dd/a/b/c/dd"]
    for r, p in zip(ref.tokenize(topics), port.tokenize(topics)):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(p))
    # incremental inserts and deletes: same in-place patches, same log
    live = list(dict.fromkeys(filters))
    for step in range(4):
        adds = _filters(rng, 60)
        dels = [live[i] for i in rng.integers(0, len(live), 40)]
        for ix in (ref, port):
            for f in adds:
                ix.insert(f)
            for f in dels:
                ix.delete(f)
        assert ref.drain_updates() == port.drain_updates()
        assert (ref.needs_rebuild, ref.garbage, ref.n_edges) == \
            (port.needs_rebuild, port.garbage, port.n_edges)
        _same_arrays(ref.ensure(), port.ensure())
        assert ref._free_fids == port._free_fids


def test_inflight_quarantine_matches():
    ref, port = ref_index.TrieIndex(), port_index.TrieIndex()
    for ix in (ref, port):
        ix.load(["a/b", "a/+", "c/#"])
        ix.ensure()
        ix.begin_inflight()
        ix.delete("a/b")
        assert ix.insert("d/e") == 3       # quarantined fid 0 not reused
        ix.end_inflight()
        assert ix.insert("f") == 0
    assert ref.filters == port.filters


def test_topic_algebra_matches():
    rng = np.random.default_rng(3)
    names = _topics(rng, 300) + ["", "$SYS/x", "a//b", "+", "#"]
    filts = _filters(rng, 300) + ["a/#/b", "a+", "#", "+/#"]
    for s in names + filts:
        assert port_topic.words(s) == ref_topic.words(s)
        assert port_topic.validate_filter(s) == ref_topic.validate_filter(s)
        assert port_topic.validate_name(s) == ref_topic.validate_name(s)
        assert port_topic.is_sys(s) == ref_topic.is_sys(s)
        assert port_topic.parse_share(s) == ref_topic.parse_share(s)
    for n in names[:80]:
        for f in filts[:80]:
            assert port_topic.match(n, f) == ref_topic.match(n, f)


def test_host_oracle_trie_matches():
    rng = np.random.default_rng(5)
    ref, port = RefTrie(), PortTrie()
    filters = _filters(rng, 800)
    for f in filters:
        assert ref.insert(f) == port.insert(f)
    for f in filters[::3]:
        assert ref.delete(f) == port.delete(f)
    assert len(ref) == len(port)
    for t in _topics(rng, 400) + ["$SYS/a/b", "$SYS"]:
        assert sorted(ref.match(t)) == sorted(port.match(t))
    assert sorted(ref.filters()) == sorted(port.filters())


def test_device_trie_accepts_reference_arrays():
    ix = ref_index.TrieIndex(max_levels=5)
    ix.load(_filters(np.random.default_rng(2), 400))
    arrays = ix.ensure()
    dev = device_trie(arrays, "cpu")
    for n in FIELDS:
        t = getattr(dev, n)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(arrays, n))
        # a copy: patching the host arrays leaves the device trie alone
        assert t.data_ptr() != getattr(arrays, n).ctypes.data
