"""The port's trie walk and compaction against the JAX reference, exactly.

All seeded cases run through the reference in one child process (see
test_torch_harness); the port runs them on CPU tensors, which takes the
plain-torch versions of the kernels.  Every comparison is exact: the
values are int32 ids and counts.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router.index import TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import arrays_of, gen_filters, gen_topics, \
    run_reference


def _case(index: TrieIndex, topics, *, K: int, M: int) -> dict:
    tokens, lengths, sys_flags, too_long = index.tokenize(topics)
    return dict(trie=arrays_of(index.ensure()), tokens=tokens,
                lengths=lengths, sys=sys_flags, K=K, M=M,
                max_probes=index.max_probes, n_too_long=len(too_long))


def _cases() -> list[dict]:
    rng = np.random.default_rng(20)
    ix = TrieIndex(max_levels=6)
    ix.load(gen_filters(rng, 1500, max_words=6))
    topics = gen_topics(rng, 250, max_words=8) + [
        "$SYS/a/b", "$SYS", "a//b", "", "zz/zz", "a/b/c/dd/a/b/c/dd"]
    base = [_case(ix, topics, K=32, M=128),
            _case(ix, topics, K=4, M=8)]         # K overflow, M truncation
    # garbage paths after deletes, a second trie shape
    ix2 = TrieIndex(max_levels=5)
    filters = gen_filters(rng, 700, max_words=5)
    ix2.load(filters)
    ix2.ensure()
    for f in filters[::4]:
        ix2.delete(f)
    for f in gen_filters(rng, 60, max_words=5):
        ix2.insert(f)
    base.append(_case(ix2, gen_topics(rng, 128, max_words=6), K=8, M=16))
    return base


CASES = _cases()
IDS = ["k32_m128", "k4_m8", "deletes_k8_m16"]


@pytest.fixture(scope="module")
def ref():
    return run_reference({"ref_match": CASES})["ref_match"]


def _port(case):
    trie = tm.device_trie(type("A", (), case["trie"]), "cpu")
    args = (torch.from_numpy(case["tokens"]), torch.from_numpy(
        case["lengths"]), torch.from_numpy(case["sys"]))
    return trie, args


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_match_batch_equals_reference(ref, i):
    case, want = CASES[i], ref[i]
    trie, args = _port(case)
    cand, overflow, mstats = tm.match_batch(
        trie, *args, K=case["K"], max_probes=case["max_probes"])
    np.testing.assert_array_equal(cand.numpy(), want["cand"])
    np.testing.assert_array_equal(overflow.numpy(), want["overflow"])
    assert {k: int(v) for k, v in mstats.items()} == want["mstats"]
    assert all(v.dtype == torch.int32 and v.dim() == 0
               for v in mstats.values())


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_compact_fids_equals_reference(ref, i):
    case, want = CASES[i], ref[i]
    fids, truncated = tm.compact_fids(torch.from_numpy(want["cand"]),
                                      M=case["M"])
    np.testing.assert_array_equal(fids.numpy(), want["fids"])
    np.testing.assert_array_equal(truncated.numpy(), want["truncated"])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_match_counts_equals_reference(ref, i):
    case, want = CASES[i], ref[i]
    trie, args = _port(case)
    counts, overflow = tm.match_counts(trie, *args, K=case["K"],
                                       max_probes=case["max_probes"])
    np.testing.assert_array_equal(counts.numpy(), want["counts"])
    np.testing.assert_array_equal(overflow.numpy(), want["counts_overflow"])


def test_cases_cover_the_edge_rows(ref):
    """The seeded data must reach what the kernels special-case."""
    k32, k4 = ref[0], ref[1]
    assert CASES[0]["sys"].any() and CASES[0]["n_too_long"] > 0
    assert (CASES[0]["lengths"] == 0).any()
    assert not k32["overflow"].all() and k4["overflow"].any()
    assert k4["truncated"].any() and k32["mstats"]["cand_pre"] > 0
    assert k4["mstats"]["frontier_peak"] == 4


def test_wrappers_on_cpu_take_the_plain_version():
    _build.reset_launch_counts()
    case = CASES[1]
    trie, args = _port(case)
    cand, stats = tm.match_batch_stats(trie, *args, K=4, max_probes=8)
    want = tm.match_batch_plain(trie, *args, K=4, max_probes=8)
    assert torch.equal(cand, want[0]) and torch.equal(stats, want[1])
    tm.compact_fids(cand, M=8)
    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import fanout as fo
    rowmap = torch.full((8,), -1, dtype=torch.int32)
    pool = torch.zeros((4, 2), dtype=torch.int32)
    fo.fanout_pool(rowmap, pool, torch.full((3, 5), -1, dtype=torch.int32))
    upd = torch.zeros((rm.PATCH_ROWS, 64), dtype=torch.int32)
    rm.apply_patches(trie, rowmap, pool, upd)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_pack_counters_layout():
    vals = {n: i * 10 for i, n in enumerate(tm.KERNEL_COUNTER_FIELDS)}
    packed = tm.pack_counters(**vals)
    assert packed.dtype == torch.int32
    assert packed.tolist() == [vals[n] for n in tm.KERNEL_COUNTER_FIELDS]
    per_shard = tm.pack_counters(**{n: torch.tensor([1, 2]) for n in vals})
    assert per_shard.shape == (2, len(vals))
    with pytest.raises(TypeError, match="missing"):
        tm.pack_counters(frontier_peak=1)
