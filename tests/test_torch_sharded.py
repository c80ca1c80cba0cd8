"""The port's subscription-sharded routing path against the JAX reference.

``ShardedTrieIndex``, ``stacked_device_trie``, ``match_batch_sharded``,
``compact_fids_sharded``, ``router_step_sharded`` (with its per-shard
``[S, C]`` counters) and a ``RouterModel`` on the sharded index must equal
the reference exactly for S ∈ {1, 2, 4}, on full (128) and uneven (77)
batches of seeded tries with '$' topics, too-long topics, K overflow, M
truncation and the ``ret_cap`` spill.  One shard must equal the flat path
bit for bit.  The reference's device functions run in one child process
(see test_torch_harness); its index module imports no JAX and runs here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu.router import index as ref_index
from emqx_tpu_torch import RouterModel, ShardedTrieIndex, TrieIndex
from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router import index as port_index

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import FIELDS, arrays_of, drive_model, gen_filters, \
    gen_topics, run_reference
from test_torch_router_model import _model_ops

SHARDS = (1, 2, 4)
BATCHES = (128, 77)
# full batches take the default widths and trim at ret_cap=4; uneven
# ones a K=4 frontier and M=3 compact (topics here match up to 8
# filters), so both spills are reached
WIDTHS = {128: dict(K=32, M=128, ret_cap=4), 77: dict(K=4, M=3, ret_cap=16)}
EDGE_TOPICS = ["$SYS/a/b", "$SYS", "", "a/b/c/dd/a/b/c/dd", "a//b"]


def _mutations(seed: int):
    """One seeded filter history: a load, deletes (garbage paths) and
    inserts, applied the same way to every index under test."""
    rng = np.random.default_rng(seed)
    filters = gen_filters(rng, 1200, max_words=6)
    dels = filters[::5]
    adds = gen_filters(rng, 80, max_words=6)
    return filters, dels, adds, rng


def _build_index(ix, seed: int = 60):
    filters, dels, adds, rng = _mutations(seed)
    ix.load(filters)
    ix.ensure()
    for f in dels:
        ix.delete(f)
    for f in adds:
        ix.insert(f)
    return rng


def _case(S: int, B: int) -> dict:
    ix = ShardedTrieIndex(S, max_levels=6)
    rng = _build_index(ix)
    shard_arrays = ix.ensure()
    topics = gen_topics(rng, B - len(EDGE_TOPICS), max_words=7) + EDGE_TOPICS
    tokens, lengths, sys_flags, too_long = ix.tokenize(topics)
    F, P, W = len(ix.filters) + 64, 64, 5
    rowmap = np.full(F, -1, np.int32)
    rowmap[rng.choice(len(ix.filters), 40, replace=False)] = \
        rng.permutation(P)[:40]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    return dict(S=S, B=B, shards=[arrays_of(a) for a in shard_arrays],
                tokens=tokens, lengths=lengths, sys=sys_flags,
                n_too_long=len(too_long), rowmap=rowmap, pool=pool,
                max_probes=ix.max_probes, **WIDTHS[B])


GRID = [(S, B) for S in SHARDS for B in BATCHES]
IDS = [f"S{S}-B{B}" for S, B in GRID]
CASES = [_case(S, B) for S, B in GRID]
MODEL_CASES = [dict(shards=S, max_levels=6, ops=_model_ops(),
                    model_kw=dict(n_sub_slots=128, K=32, M=128, ret_cap=16,
                                  dense_threshold=6))
               for S in SHARDS]


@pytest.fixture(scope="module")
def ref():
    return run_reference({"ref_sharded": CASES, "ref_model": MODEL_CASES},
                         timeout=600)


def _stacked(case) -> tm.DeviceTrie:
    return tm.stacked_device_trie(
        [type("A", (), a) for a in case["shards"]], "cpu")


def _args(case):
    return tuple(torch.from_numpy(case[k]) for k in ("tokens", "lengths",
                                                     "sys"))


# -- the index ---------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_index_equals_reference(S):
    filters, dels, adds, _ = _mutations(61)
    for f in filters[:300]:
        assert port_index.shard_of_filter(f, S) == \
            ref_index.shard_of_filter(f, S)
    ref = ref_index.ShardedTrieIndex(S, max_levels=6)
    port = ShardedTrieIndex(S, max_levels=6)
    assert [ref.insert(f) for f in filters] == \
        [port.insert(f) for f in filters]
    ref_arrays, port_arrays = ref.ensure(), port.ensure()
    assert len({a.ht_parent.shape[0] for a in port_arrays}) == 1
    for ra, pa in zip(ref_arrays, port_arrays):
        for n in FIELDS:
            np.testing.assert_array_equal(getattr(ra, n), getattr(pa, n))
    assert port.vocab is port.shards[-1].vocab
    # deletes and inserts: the same global fids, (shard, index) patch
    # pairs and None gaps
    assert [ref.delete(f) for f in dels] == [port.delete(f) for f in dels]
    assert [ref.insert(f) for f in adds] == [port.insert(f) for f in adds]
    assert ref.drain_updates() == port.drain_updates()
    assert list(ref.filters) == list(port.filters)
    assert len(port.filters) == S * max(len(s.filters) for s in port.shards)
    if S > 1:
        assert None in list(port.filters)
    assert (ref.needs_rebuild, ref.garbage) == \
        (port.needs_rebuild, port.garbage)
    # grow one shard past its edge table: ensure() must rebuild the others
    # to the common H (through ht_size_floor)
    grow = [f"grow/{i}/x" for i in range(4000)
            if port_index.shard_of_filter(f"grow/{i}/x", S) == 0][:1500]
    h0, rebuilds = port_arrays[0].ht_parent.shape[0], port.rebuild_count
    for ix in (ref, port):
        for f in grow:
            ix.insert(f)
    hs = {a.ht_parent.shape[0] for a in port.ensure()}
    assert len(hs) == 1 and hs == {a.ht_parent.shape[0]
                                   for a in ref.ensure()}
    assert hs.pop() > h0 and port.rebuild_count >= rebuilds + S
    assert port.rebuild_count == ref.rebuild_count
    for ra, pa in zip(ref.ensure(), port.ensure()):
        for n in FIELDS:
            np.testing.assert_array_equal(getattr(ra, n), getattr(pa, n))
    assert [port.fid_of(f) for f in grow[:20]] == \
        [ref.fid_of(f) for f in grow[:20]]


@pytest.mark.parametrize("S", SHARDS)
def test_stacked_device_trie_equals_reference(ref, S):
    i = GRID.index((S, 128))
    case, want = CASES[i], ref["ref_sharded"][i]
    got = _stacked(case)
    for rec in (got.edges, got.nodes):     # [S, ·, 4] int32 records
        assert rec.dtype == torch.int32 and rec.is_contiguous()
        assert rec.dim() == 3 and rec.shape[0] == S and rec.shape[2] == 4
        assert (rec[..., 3] == -1).all()
    for n in FIELDS:                       # the fields: [S, ·] column views
        t = getattr(got, n)
        assert t.dtype == torch.int32 and t.dim() == 2 and t.stride(1) == 4
        np.testing.assert_array_equal(t.numpy(), want["stacked"][n])
    # the reference's own arrays are accepted too, and unequal H raises
    rix = ref_index.ShardedTrieIndex(S, max_levels=6)
    _build_index(rix)
    again = tm.stacked_device_trie(rix.ensure(), "cpu")
    for n in FIELDS:
        assert torch.equal(getattr(again, n), getattr(got, n))
    small = ref_index.TrieIndex(max_levels=6)
    small.load(["a/b"])
    with pytest.raises(ValueError, match="unequal edge-table sizes"):
        tm.stacked_device_trie(rix.ensure() + [small.ensure()], "cpu")


# -- the device functions ----------------------------------------------------


@pytest.mark.parametrize("i", range(len(GRID)), ids=IDS)
def test_match_batch_sharded_equals_reference(ref, i):
    case, want = CASES[i], ref["ref_sharded"][i]
    cand, overflow, mstats = tm.match_batch_sharded(
        _stacked(case), *_args(case), K=case["K"],
        max_probes=case["max_probes"])
    np.testing.assert_array_equal(cand.numpy(), want["cand"])
    np.testing.assert_array_equal(overflow.numpy(), want["overflow"])
    assert set(mstats) == set(want["mstats"])
    for k, v in mstats.items():
        assert v.dtype == torch.int32 and v.shape == (case["S"],)
        np.testing.assert_array_equal(v.numpy(), want["mstats"][k])


@pytest.mark.parametrize("i", range(len(GRID)), ids=IDS)
def test_compact_fids_sharded_equals_reference(ref, i):
    case, want = CASES[i], ref["ref_sharded"][i]
    cand = torch.from_numpy(want["cand"])
    fids, truncated = tm.compact_fids_sharded(cand, M=case["M"],
                                              n_shards=case["S"])
    np.testing.assert_array_equal(fids.numpy(), want["fids"])
    np.testing.assert_array_equal(truncated.numpy(), want["truncated"])
    _, _, n = tm.compact_sharded(cand, M=case["M"], n_shards=case["S"])
    np.testing.assert_array_equal(n.numpy(), (want["cand"] >= 0).sum(2))


@pytest.mark.parametrize("i", range(len(GRID)), ids=IDS)
def test_router_step_sharded_equals_reference(ref, i):
    case, want = CASES[i], ref["ref_sharded"][i]["step"]
    got = rm.router_step_sharded(
        _stacked(case), torch.from_numpy(case["rowmap"]),
        torch.from_numpy(case["pool"].view(np.int32)), *_args(case),
        n_shards=case["S"], K=case["K"], M=case["M"],
        max_probes=case["max_probes"], ret_cap=case["ret_cap"])
    fids, fanout, overflow, fan_any, counters = (x.numpy() for x in got)
    np.testing.assert_array_equal(fids, want[0])
    np.testing.assert_array_equal(fanout.view(np.uint32), want[1])
    np.testing.assert_array_equal(overflow, want[2])
    assert bool(fan_any) == bool(want[3])
    assert counters.shape == (case["S"], len(tm.KERNEL_COUNTER_FIELDS))
    assert counters.dtype == np.int32
    np.testing.assert_array_equal(counters, want[4])
    assert fids.shape[1] == min(case["ret_cap"], case["M"])


def test_sharded_cases_cover_the_edge_rows(ref):
    """The seeded data must reach what the kernels special-case."""
    outs = ref["ref_sharded"]
    assert all(c["sys"].any() and c["n_too_long"] > 0 for c in CASES)
    assert all((c["lengths"] == 0).any() for c in CASES)
    for c, o in zip(CASES, outs):
        field = dict(zip(tm.KERNEL_COUNTER_FIELDS, o["step"][4].T))
        if c["K"] == 4:             # K overflow and M truncation per shard
            assert o["overflow"].any() and o["truncated"].any()
            assert field["overflow_rows"].sum() > 0
            assert field["trunc_rows"].sum() > 0
        else:                       # the ret_cap spill
            assert o["step"][2].any() and not o["truncated"].all()
            assert (o["fids"] >= 0).sum(1).max() > c["ret_cap"]
        assert o["step"][3]         # some topic reached a dense-pool row


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("j", range(len(SHARDS)), ids=[f"S{S}" for S in
                                                       SHARDS])
def test_router_model_sharded_sequence_equals_reference(ref, j):
    case = MODEL_CASES[j]
    model = RouterModel(ShardedTrieIndex(case["shards"],
                                         max_levels=case["max_levels"]),
                        device="cpu", **case["model_kw"])
    got = drive_model(model, case["ops"])
    want = ref["ref_model"][j]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    counts = [s for s in got if s[0] == "counts"]
    assert counts[-1][2] >= 4 and model.patch_upload_bytes > 0
    pubs = [s for s in got if s[0] == "pub"]
    assert all(np.asarray(s[2]).shape == (case["shards"], 7) for s in pubs)
    assert any(s[1][3] for s in pubs)              # fallback rows seen
    assert any(any(a) for s in pubs for a in s[1][1])   # aux matches seen


def _populate(model, n=600):
    rng = np.random.default_rng(5)
    for i in range(n):
        f = (f"vehicle/v{i}/telemetry/m{i % 8}", f"vehicle/+/telemetry/z{i}",
             f"vehicle/v{i}/#", f"fleet/f{i}/vehicle/+/status/#")[i % 4]
        model.subscribe(f, int(rng.integers(0, 256)))
    for d in range(4):
        for s in range(20):
            model.subscribe(f"broadcast/alerts/region{d}/#", (d * 20 + s))
    model.refresh()


def _fleet_topics(n):
    return [(f"vehicle/v{i * 4 + 2}/telemetry/m{i % 8}",
             f"fleet/f{i * 4 + 3}/vehicle/vX/status/ok",
             f"broadcast/alerts/region{i % 4}/storm",
             "no/subscribers/here")[i % 4] for i in range(n)]


@pytest.mark.parametrize("B", BATCHES, ids=["aligned", "uneven"])
def test_single_shard_degenerates_bit_identical(B):
    """S=1 is the flat layout bit for bit: identity fid translation and a
    no-op second compact — matched order, counters and all."""
    kw = dict(n_sub_slots=256, K=32, M=64, dense_threshold=16, device="cpu")
    flat = RouterModel(TrieIndex(max_levels=8), **kw)
    one = RouterModel(ShardedTrieIndex(1, max_levels=8), **kw)
    for m in (flat, one):
        _populate(m)
    topics = _fleet_topics(B)
    assert flat.publish_batch(topics) == one.publish_batch(topics)
    assert flat._dense_row and one._dense_row
    # the step itself, counters included ([C] against [1, C])
    tok = [torch.from_numpy(x) for x in flat.index.tokenize(topics)[:3]]
    a = rm.router_step(flat._trie_dev, flat._rowmap_dev, flat._pool_dev,
                       *tok, K=32, M=64, ret_cap=16)
    b = rm.router_step_sharded(one._trie_dev, one._rowmap_dev,
                               one._pool_dev, *tok, n_shards=1, K=32, M=64,
                               ret_cap=16)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert torch.equal(a[4], b[4][0]) and b[4].shape == (1, 7)


def test_sharded_incremental_stays_per_shard_patches():
    """Steady-state subscribe/unsubscribe on the stacked layout stays
    per-shard element patches: no full re-upload, while the patch stream
    advances and the new routes serve."""
    model = RouterModel(ShardedTrieIndex(4, max_levels=8), n_sub_slots=256,
                        K=32, M=64, dense_threshold=16, device="cpu")
    _populate(model)
    ups, pats = model.upload_count, model.patch_count
    new = [(f"hotadd/dev{i}/+/m{i % 4}", (37 * i) % 256) for i in range(12)]
    for f, s in new:
        model.subscribe(f, s)
    model.refresh()
    assert model.upload_count == ups, "subscribe forced a full re-upload"
    assert model.patch_count > pats
    shards = {port_index.shard_of_filter(f, 4) for f, _ in new}
    assert len(shards) > 1
    r = model.publish_batch([f"hotadd/dev{i}/y/m{i % 4}" for i in range(12)])
    assert [m for m in r[0]] == [[f] for f, _ in new]
    assert r[2] == [[s] for _, s in new]
    pats2 = model.patch_count
    for f, s in new:
        model.unsubscribe(f, s)
    model.refresh()
    assert model.upload_count == ups, "unsubscribe forced a full re-upload"
    assert model.patch_count > pats2
    assert model.publish_batch(["hotadd/dev3/x/m3"])[0] == [[]]


# -- port-only properties ------------------------------------------------------


def _two_stage(cand: np.ndarray, M: int, n_shards: int):
    """The sharded compact's semantics in numpy, with the two stages'
    widths: per shard min(M, C), merged S·min(M, C), out min(M, merged)."""
    S, B, C = cand.shape
    w = min(M, C)
    merged = np.full((B, S * w), -1, np.int64)
    spill = np.zeros(B, bool)
    for s in range(S):
        for b in range(B):
            v = cand[s, b][cand[s, b] >= 0]
            spill[b] |= len(v) > M
            merged[b, s * w: s * w + min(len(v), w)] = v[:w] * n_shards + s
    out = np.full((B, min(M, S * w)), -1, np.int64)
    for b in range(B):
        v = merged[b][merged[b] >= 0]
        spill[b] |= len(v) > M
        out[b, : min(len(v), out.shape[1])] = v[: out.shape[1]]
    return out, spill


@pytest.mark.parametrize("C,M", [(5, 8), (40, 8), (24, 24)],
                         ids=["c_below_m", "c_above_m", "c_equal_m"])
def test_compact_sharded_width_rule(C, M):
    """The two-stage widths hold where C < M too (the reference's reshape
    to S·M accepts only C ≥ M)."""
    rng = np.random.default_rng(C * 31 + M)
    cand = rng.integers(0, 500, (3, 33, C)).astype(np.int32)
    cand[rng.random(cand.shape) < 0.55] = -1
    cand[:, 1] = -1
    fids, truncated, n = tm.compact_sharded(torch.from_numpy(cand), M=M,
                                            n_shards=3)
    want, spill = _two_stage(cand, M, 3)
    np.testing.assert_array_equal(fids.numpy(), want)
    np.testing.assert_array_equal(truncated.numpy(), spill)
    np.testing.assert_array_equal(n.numpy(), (cand >= 0).sum(2))
    # one shard is compact_fids, bit for bit
    one = torch.from_numpy(cand[:1])
    f1, t1 = tm.compact_fids_sharded(one, M=M, n_shards=1)
    f0, t0 = tm.compact_fids(one[0], M=M)
    assert torch.equal(f1, f0) and torch.equal(t1, t0)


def test_patch_block_checks_each_shard_stride():
    """A stacked field's element index is checked against its shard's
    stride, not only against S·N, and pairs become flat offsets."""
    cap, S, N = 64, 4, 100
    sizes = {n: (S, N) for n in tm.TRIE_FIELDS}
    sizes["rowmap"], sizes["pool"] = 8, (4, 2)
    zero = np.zeros(cap, np.int32)

    def block(sidx, eidx):
        tupd = {n: ((sidx, eidx), zero) for n in tm.TRIE_FIELDS}
        return rm.patch_block(cap, tupd, (zero, zero), (zero, zero, zero),
                              sizes)

    sidx = np.full(cap, 2, np.int32)
    eidx = np.full(cap, 7, np.int32)
    assert (block(sidx, eidx)[0] == 2 * N + 7).all()
    with pytest.raises(ValueError, match="out of range for ht_parent"):
        block(np.zeros(cap, np.int32), np.full(cap, N + 5, np.int32))
    with pytest.raises(ValueError, match="ht_parent shard"):
        block(np.full(cap, S, np.int32), eidx)


def test_sharded_model_arguments():
    with pytest.raises(ValueError, match="conflicts"):
        RouterModel(ShardedTrieIndex(2), trie_shards=4, device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        RouterModel(TrieIndex(), trie_shards=2, device="cpu")
    model = RouterModel(trie_shards=4, device="cpu")
    assert model.n_shards == 4 and isinstance(model.index, ShardedTrieIndex)
    assert RouterModel(device="cpu").n_shards == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RouterModel(trie_shards=4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.stacked_device_trie(model.index.ensure())


def test_sharded_wrappers_on_cpu_take_the_plain_version():
    _build.reset_launch_counts()
    case = CASES[GRID.index((4, 77))]
    trie, args = _stacked(case), _args(case)
    got = tm.match_batch_sharded_stats(trie, *args, K=4, max_probes=8)
    want = tm.match_batch_sharded_plain(trie, *args, K=4, max_probes=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for s in range(4):       # the stacked walk is each shard's flat walk
        flat = tm.match_batch_plain(tm.shard_trie(trie, s), *args, K=4,
                                    max_probes=8)
        assert torch.equal(flat[0], got[0][s])
    tm.compact_sharded(got[0], M=3, n_shards=4)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
