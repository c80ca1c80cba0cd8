"""The port's routing step and RouterModel against the JAX reference.

``router_step``'s 5-tuple (fids, fanout, overflow, fan_any, counters) and
a RouterModel driven through one subscribe / unsubscribe / aux / dense-pool
promote-demote / patch / growth sequence must equal the reference's
exactly: the same publish results, counters and device-upload counts.
A churn whose refreshes step through the patch caps, flat and at S=4,
must leave the reference's tables after every refresh.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu_torch import RouterModel
from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import arrays_of, drive_model, gen_filters, \
    gen_topics, run_reference


def _step_case(seed: int, *, K: int, M: int, ret_cap: int) -> dict:
    rng = np.random.default_rng(seed)
    ix = TrieIndex(max_levels=6)
    ix.load(gen_filters(rng, 1200, max_words=6))
    arrays = ix.ensure()
    topics = gen_topics(rng, 120, max_words=7) + ["$SYS/a", "", "a/b"]
    tokens, lengths, sys_flags, _ = ix.tokenize(topics)
    F, P, W = len(ix.filters) + 64, 64, 5
    rowmap = np.full(F, -1, np.int32)
    rowmap[rng.choice(len(ix.filters), 40, replace=False)] = \
        rng.permutation(P)[:40]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    return dict(trie=arrays_of(arrays), rowmap=rowmap, pool=pool,
                tokens=tokens, lengths=lengths, sys=sys_flags, K=K, M=M,
                ret_cap=ret_cap, max_probes=ix.max_probes)


STEP_CASES = [_step_case(30, K=32, M=128, ret_cap=4),
              _step_case(31, K=4, M=8, ret_cap=16)]


def _model_ops() -> list:
    rng = np.random.default_rng(40)
    base = sorted(set(gen_filters(rng, 300, max_words=5)))
    ops = [("sub", f, int(s)) for f, s in
           zip(base, rng.integers(0, 128, len(base)))]
    pubs = [gen_topics(rng, n, max_words=6) + ["$SYS/a/b", "a/b/c/dd/a/b/c"]
            for n in (30, 70, 130, 20, 50, 64)]
    ops += [("pub", pubs[0]), ("counts",)]
    # incremental: new filters, unsubscribes, a second slot, aux filters
    ops += [("sub", f, 3) for f in gen_filters(rng, 15, max_words=5)]
    ops += [("unsub", f, s) for (_, f, s) in ops[:300:7]]
    ops += [("sub", base[1], 9), ("aux", "a/+"), ("aux", base[2]),
            ("unsub", base[2], int(dict((o[1], o[2]) for o in ops
                                        if o[0] == "sub")[base[2]]))]
    ops += [("pub", pubs[1]), ("counts",)]
    # dense pool: promote past dense_threshold (6), then demote below 3
    ops += [("sub", "dd/+", s) for s in range(0, 120, 12)]
    ops += [("sub", "#", s) for s in range(100, 108)]
    ops += [("pub", pubs[2]), ("counts",)]
    ops += [("unsub", "dd/+", s) for s in range(0, 120, 12)]
    ops += [("aux_release", "a/+"), ("pub", pubs[3]), ("counts",)]
    # growth past the node capacity → a full re-upload
    ops += [("sub", f"grow/{i}/x{i % 7}", i % 128) for i in range(400)]
    ops += [("refresh",), ("pub", pubs[4]), ("counts",)]
    ops += [("unsub", f"grow/{i}/x{i % 7}", i % 128) for i in range(0, 400, 3)]
    ops += [("pub", pubs[5] + [f"grow/{i}/x{i % 7}" for i in range(40)]),
            ("counts",)]
    return ops


def _churn_ops() -> list:
    """Refreshes whose update blocks step through the caps 64, 256, 1024
    and 256 (20, 60 and 300 new two-node filters, then unsubscribes), so
    the model's two staging slots are each used twice and grown; the
    tables are read after every refresh."""
    rng = np.random.default_rng(50)
    base = sorted(set(gen_filters(rng, 3000, max_words=6)))
    ops = [("sub", f, int(s)) for f, s in
           zip(base, rng.integers(0, 128, len(base)))]
    ops += [("refresh",), ("tables",)]
    new = [f"churn/w{i}/x{i % 5}" for i in range(380)]
    topics = gen_topics(rng, 40, max_words=6) + new[::7]
    for lo, hi in ((0, 20), (20, 80), (80, 380)):
        ops += [("sub", f, i % 128) for i, f in enumerate(new[lo:hi])]
        if lo == 20:      # promote a filter into the dense pool
            ops += [("sub", "churn/+/x1", s) for s in range(0, 128, 9)]
        ops += [("refresh",), ("tables",), ("pub", topics)]
    ops += [("unsub", f, i % 128) for i, f in enumerate(new) if i % 3 == 0]
    ops += [("refresh",), ("tables",), ("pub", topics), ("counts",)]
    return ops


MODEL_CASES = [dict(max_levels=6, ops=_model_ops(),
                    model_kw=dict(n_sub_slots=128, K=32, M=128, ret_cap=16,
                                  dense_threshold=6, kernel_telemetry=True))]
CHURN_CASES = [dict(max_levels=6, ops=_churn_ops(), shards=S,
                    model_kw=dict(n_sub_slots=128, dense_threshold=6,
                                  kernel_telemetry=True))
               for S in (None, 4)]


@pytest.fixture(scope="module")
def ref():
    out = run_reference({"ref_router_step": STEP_CASES,
                         "ref_model": MODEL_CASES + CHURN_CASES})
    return out["ref_router_step"], out["ref_model"]


@pytest.mark.parametrize("i", range(len(STEP_CASES)))
def test_router_step_equals_reference(ref, i):
    c, want = STEP_CASES[i], ref[0][i]
    trie = tm.device_trie(type("A", (), c["trie"]), "cpu")
    got = rm.router_step(
        trie, torch.from_numpy(c["rowmap"]),
        torch.from_numpy(c["pool"].view(np.int32)),
        torch.from_numpy(c["tokens"]), torch.from_numpy(c["lengths"]),
        torch.from_numpy(c["sys"]), K=c["K"], M=c["M"],
        max_probes=c["max_probes"], ret_cap=c["ret_cap"], with_counters=True)
    fids, fanout, overflow, fan_any, counters = (x.numpy() for x in got)
    np.testing.assert_array_equal(fids, want[0])
    np.testing.assert_array_equal(fanout.view(np.uint32), want[1])
    np.testing.assert_array_equal(overflow, want[2])
    assert bool(fan_any) == bool(want[3])
    np.testing.assert_array_equal(counters, want[4])
    assert counters.dtype == np.int32
    assert fids.shape[1] == min(c["ret_cap"], c["M"]) and overflow.any()


def test_router_model_sequence_equals_reference(ref):
    case = MODEL_CASES[0]
    model = RouterModel(TrieIndex(max_levels=case["max_levels"]),
                        device="cpu", **case["model_kw"])
    got = drive_model(model, case["ops"])
    want = ref[1][0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    counts = [s for s in got if s[0] == "counts"]
    # uploads: the first publish and the growth; patches in between
    assert counts[-1][1] == 2 and counts[-1][2] >= 4
    pubs = [s for s in got if s[0] == "pub"]
    assert any(s[1][3] for s in pubs)              # fallback rows seen
    assert any(any(a) for s in pubs for a in s[1][1])   # aux matches seen
    fid = model.index.fid_of
    assert fid("#") in model._dense_row and fid("dd/+") not in model._dense_row
    assert model.patch_upload_bytes > 0


@pytest.mark.parametrize("k", range(len(CHURN_CASES)), ids=["flat", "S4"])
def test_churn_through_the_staging_ring_equals_reference(ref, k):
    """Each refresh's tables equal the reference's after its
    ``_apply_patches``; the ring's slots alternate and grow to the largest
    cap each has held (64 then 1024, and 256)."""
    case = CHURN_CASES[k]
    index = (ShardedTrieIndex(case["shards"], max_levels=case["max_levels"])
             if case["shards"] else TrieIndex(max_levels=case["max_levels"]))
    model = RouterModel(index, device="cpu", **case["model_kw"])
    got, ring = [], []
    ops = case["ops"]
    while ops:            # one chunk per refresh, the ring read after each
        n = ops.index(("tables",)) + 1 if ("tables",) in ops else len(ops)
        got += drive_model(model, ops[:n])
        ops = ops[n:]
        ring.append([None if b is None else b.numel() // rm.PATCH_ROWS
                     for b in model._patch_ring])
    want = ref[1][len(MODEL_CASES) + k]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        if g[0] != "tables":
            assert g == w
            continue
        assert g[1].keys() == w[1].keys()
        for name in g[1]:
            np.testing.assert_array_equal(g[1][name], w[1][name])
    assert ring[:5] == [[None, None], [64, None], [64, 256], [1024, 256],
                        [1024, 256]]
    assert model._patch_done == [None, None]          # no events on the CPU
    counts = [s for s in got if s[0] == "counts"][-1]
    assert counts[1] == 1 and counts[2] == 4           # one upload, 4 patches
    assert model._dense_row                            # a pool row patched


def test_publish_submit_collect_pipeline_on_cpu():
    model = RouterModel(device="cpu", n_sub_slots=64, dense_threshold=4)
    for s in range(8):
        model.subscribe("t/+", s)
    fid_x = model.subscribe("t/x", 40)
    first = model.publish_batch_submit(["t/x", "t/y"])
    # an unsubscribe racing the pending batch drops its leg, and the freed
    # fid stays quarantined until the batch is collected
    model.unsubscribe("t/x", 40)
    assert model.subscribe("new/f", 41) != fid_x
    second = model.publish_batch_submit(["new/f", "t/x"])
    m1, _, s1, fb1 = model.publish_batch_collect(first)
    m2, _, s2, _ = model.publish_batch_collect(second)
    assert m1 == [["t/+"], ["t/+"]] and s1[0] == list(range(8)) and not fb1
    assert m2 == [["new/f"], ["t/+"]] and s2[0] == [41]
    assert model.launch_count == 2 and model.upload_count == 1
