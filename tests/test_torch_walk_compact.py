"""The routing step's walk in its compacted mode against the JAX reference.

``match_compact`` / ``match_compact_sharded`` (the walk appending its
matches to ``[B, M]`` fids as it walks: one kernel where the reference runs
match_batch → compact_fids) and the steps built on them must equal the
reference's ``match_batch`` → ``compact_fids`` / ``compact_fids_sharded``
and ``router_step`` / ``router_step_sharded`` exactly, for S ∈ {1, 2, 4},
with '$' topics, K overflow, M truncation, the ``ret_cap`` spill,
``len == 0``, ``len == L``, too-long topics and C < M (under the port's
width rule where the reference cannot run, ROADMAP.md R2).  The trie's
edge and node records must hold the reference's six fields as column
views, flat and stacked, and patches written through them must leave the
tables the reference's ``_apply_patches`` leaves.  The port runs on CPU
tensors (the plain versions); the reference in one child process (see
test_torch_harness).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu.router import index as ref_index
from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import FIELDS, arrays_of, gen_filters, gen_topics, \
    run_reference

L = 6
# '$' topics, an empty level, len == L, too long (> L), the empty topic
EDGE_TOPICS = ["$SYS/a/b", "$SYS", "a//b", "a/b/c/dd/a/b",
               "dd/dd/dd/dd/dd/dd", "a/b/c/dd/a/b/c", ""]


def _history(ix, seed: int):
    """Load, delete (garbage paths) and insert: one seeded filter history."""
    rng = np.random.default_rng(seed)
    filters = gen_filters(rng, 1200, max_words=L)
    ix.load(filters)
    ix.ensure()
    for f in filters[::5]:
        ix.delete(f)
    for f in gen_filters(rng, 80, max_words=L):
        ix.insert(f)
    return rng


def _batch(ix, rng, n: int) -> dict:
    """A tokenized batch with the edge rows, plus one row of length 0
    without the '$' flag (a root '#' or '+' filter may emit for it)."""
    topics = gen_topics(rng, n, max_words=L + 1) + EDGE_TOPICS
    tokens, lengths, sys_flags, too_long = ix.tokenize(topics)
    return dict(tokens=np.concatenate([tokens, np.zeros((1, L), np.int32)]),
                lengths=np.concatenate([lengths, np.zeros(1, np.int32)]),
                sys=np.concatenate([sys_flags, np.zeros(1, bool)]),
                n_too_long=len(too_long))


def _pool(rng, n_filters: int) -> dict:
    F, P, W = n_filters + 64, 64, 5
    rowmap = np.full(F, -1, np.int32)
    rowmap[rng.choice(n_filters, 40, replace=False)] = \
        rng.permutation(P)[:40]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    return dict(rowmap=rowmap, pool=pool)


# flat widths: defaults with a ret_cap spill, K overflow with M truncation
# (topics here match up to ~10 filters), M truncation alone, and
# C = (L+1)·2K = 56 below M = 128
FLAT_WIDTHS = {"k32_m128": dict(K=32, M=128, ret_cap=4),
               "k4_m4": dict(K=4, M=4, ret_cap=16),
               "k8_m6": dict(K=8, M=6, ret_cap=4),
               "c_below_m": dict(K=4, M=128, ret_cap=16)}


def _flat_case(seed: int, widths: dict) -> dict:
    ix = TrieIndex(max_levels=L)
    rng = _history(ix, seed)
    return dict(trie=arrays_of(ix.ensure()), max_probes=ix.max_probes,
                **_batch(ix, rng, 150), **_pool(rng, len(ix.filters)),
                **widths)


FLAT_IDS = list(FLAT_WIDTHS)
FLAT = [_flat_case(70 + i, w) for i, w in enumerate(FLAT_WIDTHS.values())]

# sharded: where C ≥ M the reference's compact runs; c_below_m (C = 56 <
# M = 128) is held to the two-stage width rule on the reference's walk
SHARDED_WIDTHS = {"k32_m128": dict(K=32, M=128, ret_cap=4),
                  "k4_m3": dict(K=4, M=3, ret_cap=16)}
SHARDS = (1, 2, 4)


def _sharded_case(S: int, widths: dict) -> dict:
    ix = ShardedTrieIndex(S, max_levels=L)
    rng = _history(ix, 80 + S)
    return dict(S=S, shards=[arrays_of(a) for a in ix.ensure()],
                max_probes=ix.max_probes, **_batch(ix, rng, 120),
                **_pool(rng, len(ix.filters)), **widths)


SHARDED_GRID = [(S, w) for S in SHARDS for w in SHARDED_WIDTHS]
SHARDED_IDS = [f"S{S}-{w}" for S, w in SHARDED_GRID]
SHARDED = [_sharded_case(S, SHARDED_WIDTHS[w]) for S, w in SHARDED_GRID]
NARROW = [_sharded_case(S, dict(K=4, M=128, ret_cap=16)) for S in SHARDS]


def _patch_sets(rng, sizes: dict, n_sets: int = 3) -> list:
    """Update sets in patch_block's form (flat indices, or (shard, element)
    pairs where a size is (S, stride)), each padded to one cap by repeating
    its first element; later sets overwrite some of the earlier indices."""
    cap, n = 64, 40
    sets = []
    for _ in range(n_sets):
        tupd = {}
        for name in FIELDS:
            vals = rng.integers(-1, 1 << 20, n).astype(np.int32)
            if isinstance(sizes[name], tuple):
                S, stride = sizes[name]
                flat = rng.choice(S * stride, n, replace=False)
                idx = ((flat // stride).astype(np.int32),
                       (flat % stride).astype(np.int32))
                sidx, v = rm._pad_to(cap, idx[0], vals)
                eidx, _ = rm._pad_to(cap, idx[1], vals)
                tupd[name] = ((sidx, eidx), v)
            else:
                idx = rng.choice(sizes[name], n, replace=False)
                tupd[name] = rm._pad_to(cap, idx.astype(np.int32), vals)
        ridx = rng.choice(sizes["rowmap"], n, replace=False).astype(np.int32)
        rupd = rm._pad_to(cap, ridx, rng.integers(-1, 64, n).astype(np.int32))
        P, W = sizes["pool"]
        cells = rng.choice(P * W, n, replace=False)
        rows, pvals = rm._pad_to(cap, (cells // W).astype(np.int32),
                                 rng.integers(0, 1 << 31, n).astype(np.int32))
        cols, _ = rm._pad_to(cap, (cells % W).astype(np.int32),
                             (cells % W).astype(np.int32))
        sets.append((tupd, rupd, (rows, cols, pvals.view(np.uint32))))
    return sets


def _patch_case(S: int | None) -> dict:
    rng = np.random.default_rng(90 + (S or 0))
    if S is None:
        ix = TrieIndex(max_levels=L)
        _history(ix, 91)
        a = ix.ensure()
        case = dict(trie=arrays_of(a))
        sizes = {n: getattr(a, n).shape[0] for n in FIELDS}
    else:
        ix = ShardedTrieIndex(S, max_levels=L)
        _history(ix, 92)
        shards = ix.ensure()
        case = dict(shards=[arrays_of(a) for a in shards])
        N = max(a.plus_child.shape[0] for a in shards)
        H = shards[0].ht_parent.shape[0]
        sizes = {n: (S, H if n.startswith("ht_") else N) for n in FIELDS}
    F, P, W = len(ix.filters) + 64, 64, 5
    sizes["rowmap"], sizes["pool"] = F, (P, W)
    case.update(rowmap=np.full(F, -1, np.int32),
                pool=rng.integers(0, 1 << 31, (P, W)).astype(np.uint32),
                sizes=sizes, patches=_patch_sets(rng, sizes))
    return case


PATCH_IDS = ["flat", "S2", "S4"]
PATCHES = [_patch_case(S) for S in (None, 2, 4)]


@pytest.fixture(scope="module")
def ref():
    return run_reference({"ref_match": FLAT, "ref_router_step": FLAT,
                          "ref_sharded": SHARDED,
                          "ref_match_sharded": NARROW,
                          "ref_apply_patches": PATCHES}, timeout=600)


def _trie(case) -> tm.DeviceTrie:
    if "shards" in case:
        return tm.stacked_device_trie(
            [type("A", (), a) for a in case["shards"]], "cpu")
    return tm.device_trie(type("A", (), case["trie"]), "cpu")


def _args(case):
    return tuple(torch.from_numpy(case[k]) for k in ("tokens", "lengths",
                                                     "sys"))


def _tables(case):
    return (torch.from_numpy(case["rowmap"]),
            torch.from_numpy(case["pool"].view(np.int32)))


def _step_equal(got, want, ret_cap: int, M: int):
    fids, fanout, overflow, fan_any, counters = (x.numpy() for x in got)
    np.testing.assert_array_equal(fids, want[0])
    np.testing.assert_array_equal(fanout.view(np.uint32), want[1])
    np.testing.assert_array_equal(overflow, want[2])
    assert bool(fan_any) == bool(want[3])
    assert counters.dtype == np.int32
    np.testing.assert_array_equal(counters, want[4])
    assert fids.shape[1] == min(ret_cap, M)


# -- the flat trie -------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(FLAT)), ids=FLAT_IDS)
def test_walk_compact_equals_reference(ref, i):
    case, want = FLAT[i], ref["ref_match"][i]
    fids, stats = tm.match_compact(_trie(case), *_args(case), K=case["K"],
                                   M=case["M"], max_probes=case["max_probes"])
    np.testing.assert_array_equal(fids.numpy(), want["fids"])
    assert fids.shape[1] == min(case["M"], (L + 1) * 2 * case["K"])
    n = stats[:, 2].numpy()
    np.testing.assert_array_equal(n, (want["cand"] >= 0).sum(1))
    np.testing.assert_array_equal(n > case["M"], want["truncated"])
    np.testing.assert_array_equal(stats[:, 3].numpy() != 0,
                                  want["overflow"])
    assert {"frontier_peak": int(stats[:, 0].max()),
            "probe_iters": int(stats[:, 1].sum()),
            "cand_pre": int(n.sum()),
            "overflow_rows": int(stats[:, 3].sum())} == want["mstats"]


@pytest.mark.parametrize("i", range(len(FLAT)), ids=FLAT_IDS)
def test_router_step_on_the_compacting_walk_equals_reference(ref, i):
    case = FLAT[i]
    got = rm.router_step(_trie(case), *_tables(case), *_args(case),
                         K=case["K"], M=case["M"],
                         max_probes=case["max_probes"],
                         ret_cap=case["ret_cap"], with_counters=True)
    _step_equal(got, ref["ref_router_step"][i], case["ret_cap"], case["M"])


def test_device_trie_records_equal_reference_arrays():
    ix = ref_index.TrieIndex(max_levels=L)
    _history(ix, 93)
    arrays = ix.ensure()
    trie = tm.device_trie(arrays, "cpu")
    H, N = arrays.ht_parent.shape[0], arrays.plus_child.shape[0]
    assert trie.edges.shape == (H, 4) and trie.nodes.shape == (N, 4)
    assert trie.edges.is_contiguous() and trie.nodes.is_contiguous()
    assert (trie.edges[:, 3] == -1).all() and (trie.nodes[:, 3] == -1).all()
    for n in FIELDS:
        view = getattr(trie, n)
        assert view.dtype == torch.int32 and view.stride() == (4,)
        np.testing.assert_array_equal(view.numpy(), getattr(arrays, n))
    # a column view writes through to its record
    trie.ht_child[3] = 12345
    assert int(trie.edges[3, 2]) == 12345


# -- the stacked trie ----------------------------------------------------------


@pytest.mark.parametrize("i", range(len(SHARDED)), ids=SHARDED_IDS)
def test_walk_compact_sharded_equals_reference(ref, i):
    case, want = SHARDED[i], ref["ref_sharded"][i]
    S = case["S"]
    fids, stats, truncated = tm.match_compact_sharded(
        _trie(case), *_args(case), n_shards=S, K=case["K"], M=case["M"],
        max_probes=case["max_probes"])
    np.testing.assert_array_equal(fids.numpy(), want["fids"])
    np.testing.assert_array_equal(truncated.numpy(), want["truncated"])
    assert stats.shape == (S, len(case["lengths"]), 4)
    np.testing.assert_array_equal(stats[:, :, 2].numpy(),
                                  (want["cand"] >= 0).sum(2))
    np.testing.assert_array_equal((stats[:, :, 3] != 0).any(0).numpy(),
                                  want["overflow"])
    for k, col in (("frontier_peak", 0), ("probe_iters", 1),
                   ("cand_pre", 2), ("overflow_rows", 3)):
        red = (stats[:, :, col].max(1).values if col == 0
               else stats[:, :, col].sum(1))
        np.testing.assert_array_equal(red.numpy(), want["mstats"][k])


@pytest.mark.parametrize("i", range(len(SHARDED)), ids=SHARDED_IDS)
def test_router_step_sharded_on_the_compacting_walk_equals_reference(ref, i):
    case = SHARDED[i]
    got = rm.router_step_sharded(
        _trie(case), *_tables(case), *_args(case), n_shards=case["S"],
        K=case["K"], M=case["M"], max_probes=case["max_probes"],
        ret_cap=case["ret_cap"], with_counters=True)
    _step_equal(got, ref["ref_sharded"][i]["step"], case["ret_cap"],
                case["M"])
    assert got[4].shape == (case["S"], len(tm.KERNEL_COUNTER_FIELDS))


def _two_stage(cand: np.ndarray, M: int, n_shards: int):
    """Per-shard compact to min(M, C), local → global, shard-major merge,
    second compact to min(M, S·min(M, C)): the port's width rule."""
    S, B, C = cand.shape
    w = min(M, C)
    out = np.full((B, min(M, S * w)), -1, np.int64)
    spill = np.zeros(B, bool)
    for b in range(B):
        merged = []
        for s in range(S):
            v = cand[s, b][cand[s, b] >= 0]
            spill[b] |= len(v) > M
            merged += [int(x) * n_shards + s for x in v[:w]]
        spill[b] |= len(merged) > M
        out[b, : min(len(merged), out.shape[1])] = merged[: out.shape[1]]
    return out, spill


@pytest.mark.parametrize("j", range(len(SHARDS)),
                         ids=[f"S{S}" for S in SHARDS])
def test_walk_compact_sharded_c_below_m_width_rule(ref, j):
    case, want = NARROW[j], ref["ref_match_sharded"][j]
    S, M = case["S"], case["M"]
    assert (L + 1) * 2 * case["K"] < M
    fids, stats, truncated = tm.match_compact_sharded(
        _trie(case), *_args(case), n_shards=S, K=case["K"], M=M,
        max_probes=case["max_probes"])
    want_fids, spill = _two_stage(want["cand"], M, S)
    np.testing.assert_array_equal(fids.numpy(), want_fids)
    np.testing.assert_array_equal(truncated.numpy(), spill)
    np.testing.assert_array_equal(stats[:, :, 2].numpy(),
                                  (want["cand"] >= 0).sum(2))
    np.testing.assert_array_equal(stats[:, :, 1].sum(1).numpy(),
                                  want["mstats"]["probe_iters"])
    # the step on it: the same fids, trimmed at ret_cap, and its spill
    step = rm.router_step_sharded(
        _trie(case), *_tables(case), *_args(case), n_shards=S, K=case["K"],
        M=M, max_probes=case["max_probes"], ret_cap=case["ret_cap"])
    np.testing.assert_array_equal(step[0].numpy(),
                                  want_fids[:, :case["ret_cap"]])
    kept = (want_fids >= 0).sum(1)
    np.testing.assert_array_equal(
        step[2].numpy(), want["overflow"] | spill | (kept > case["ret_cap"]))


@pytest.mark.parametrize("S", SHARDS)
def test_stacked_records_equal_reference(ref, S):
    i = SHARDED_GRID.index((S, "k32_m128"))
    case, want = SHARDED[i], ref["ref_sharded"][i]["stacked"]
    trie = _trie(case)
    assert trie.edges.shape[::2] == (S, 4) and trie.nodes.shape[::2] == (S, 4)
    assert trie.edges.is_contiguous() and trie.nodes.is_contiguous()
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(trie, n).numpy(), want[n])
    for s in range(S):        # a shard's view is that shard's flat trie
        one = tm.shard_trie(trie, s)
        for n in FIELDS:
            assert torch.equal(getattr(one, n), getattr(trie, n)[s])


# -- patches through the records -----------------------------------------------


@pytest.mark.parametrize("k", range(len(PATCHES)), ids=PATCH_IDS)
def test_apply_patches_on_records_equals_reference(ref, k):
    case, want = PATCHES[k], ref["ref_apply_patches"][k]
    trie = _trie(case)
    rowmap = torch.from_numpy(case["rowmap"].copy())
    pool = torch.from_numpy(case["pool"].view(np.int32).copy())
    for tupd, rupd, (rows, cols, vals) in case["patches"]:
        upd = rm.patch_block(64, tupd, rupd, (rows, cols, vals.view(np.int32)),
                             case["sizes"])
        rm.apply_patches(trie, rowmap, pool, torch.from_numpy(upd))
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(trie, n).numpy(),
                                      want["trie"][n])
    assert (trie.edges[..., 3] == -1).all() and (trie.nodes[..., 3] == -1).all()
    np.testing.assert_array_equal(rowmap.numpy(), want["rowmap"])
    np.testing.assert_array_equal(pool.numpy().view(np.uint32), want["pool"])


def _flat_block(case, cap: int = 64) -> np.ndarray:
    tupd, rupd, (rows, cols, vals) = case["patches"][0]
    return rm.patch_block(cap, tupd, rupd, (rows, cols, vals.view(np.int32)),
                          case["sizes"])


def test_apply_patches_on_cpu_tables_takes_the_plain_version():
    """CPU tables take the plain version, whatever the block's memory: no
    kernel launches, and the tables equal apply_patches_plain's."""
    _build.reset_launch_counts()
    case = PATCHES[0]
    upd = torch.from_numpy(_flat_block(case))
    tables = [(_trie(case), torch.from_numpy(case["rowmap"].copy()),
               torch.from_numpy(case["pool"].view(np.int32).copy()))
              for _ in range(2)]
    rm.apply_patches(*tables[0], upd)
    rm.apply_patches_plain(*tables[1], upd)
    (ta, ra, pa), (tb, rb, pb) = tables
    assert torch.equal(ta.edges, tb.edges) and torch.equal(ta.nodes, tb.nodes)
    assert torch.equal(ra, rb) and torch.equal(pa, pb)
    assert not torch.equal(ra, torch.from_numpy(case["rowmap"]))
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


BAD_BLOCKS = {
    "cap_not_a_multiple_of_4": lambda b: b[:, :62],
    "int64": lambda b: b.astype(np.int64),
    "rows": lambda b: b[:16],
}


@pytest.mark.parametrize("bad", [*BAD_BLOCKS, "on_meta"])
def test_apply_patches_refuses_a_block_it_cannot_apply(bad):
    """The block's form is checked before either version runs (the kernel
    takes 4 updates a thread), and CPU tables take only a CPU block."""
    case = PATCHES[0]
    block = _flat_block(case)
    upd = (torch.from_numpy(np.ascontiguousarray(BAD_BLOCKS[bad](block)))
           if bad in BAD_BLOCKS
           else torch.from_numpy(block).to("meta"))
    rowmap = torch.from_numpy(case["rowmap"].copy())
    with pytest.raises(ValueError):
        rm.apply_patches(_trie(case), rowmap,
                         torch.from_numpy(case["pool"].view(np.int32).copy()),
                         upd)
    assert torch.equal(rowmap, torch.from_numpy(case["rowmap"]))


# -- coverage and the CPU path -------------------------------------------------


def test_compacting_walk_cases_cover_the_edge_rows(ref):
    """The seeded data must reach what the compacted mode special-cases."""
    for c in FLAT + SHARDED + NARROW:
        assert c["sys"].any() and c["n_too_long"] > 0
        assert ((c["lengths"] == 0) & ~c["sys"]).any()
        assert (c["lengths"] == L).any()
    k4 = ref["ref_match"][FLAT_IDS.index("k4_m4")]
    assert k4["overflow"].any() and k4["truncated"].any()
    k8 = ref["ref_match"][FLAT_IDS.index("k8_m6")]
    assert k8["truncated"].any() and not k8["overflow"].any()
    spill = ref["ref_router_step"][FLAT_IDS.index("k32_m128")]
    assert spill[2].any() and (ref["ref_match"][0]["fids"] >= 0).sum(1).max() \
        > FLAT[0]["ret_cap"]
    for (S, w), out in zip(SHARDED_GRID, ref["ref_sharded"]):
        if w == "k4_m3":
            assert out["overflow"].any() and out["truncated"].any()
        assert out["step"][3]                  # a dense-pool row reached
    wide = ref["ref_match"][FLAT_IDS.index("c_below_m")]
    assert (wide["cand"] >= 0).sum(1).max() > 0
    assert any((r["cand"] >= 0).sum(2).max() > 0
               for r in ref["ref_match_sharded"])


def test_compacting_walk_wrappers_on_cpu_take_the_plain_version():
    _build.reset_launch_counts()
    case = FLAT[FLAT_IDS.index("k4_m4")]
    trie, args = _trie(case), _args(case)
    fids, stats = tm.match_compact(trie, *args, K=4, M=4, max_probes=8)
    cand, cstats = tm.match_batch_stats(trie, *args, K=4, max_probes=8)
    assert torch.equal(stats, cstats)
    assert torch.equal(fids, tm.compact_fids(cand, M=4)[0])
    case = SHARDED[SHARDED_GRID.index((4, "k4_m3"))]
    trie, args = _trie(case), _args(case)
    got = tm.match_compact_sharded(trie, *args, n_shards=4, K=4, M=3,
                                   max_probes=8)
    scand, sstats = tm.match_batch_sharded_stats(trie, *args, K=4,
                                                 max_probes=8)
    fids, truncated, _ = tm.compact_sharded(scand, M=3, n_shards=4)
    assert torch.equal(got[0], fids) and torch.equal(got[1], sstats)
    assert torch.equal(got[2], truncated)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
