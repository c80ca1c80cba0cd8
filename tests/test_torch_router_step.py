"""The port's two routing steps against the JAX reference, and their packed
result block.

``router_step`` and ``router_step_sharded`` (S ∈ {1, 4}) must return the
reference's five outputs (fids, fanout, overflow, fan_any, counters)
exactly, with ``with_counters=True`` on the reference side, on seeded tries
at the edges: K overflow, M truncation, the ``ret_cap`` spill, ``ret_cap``
None and ≥ M, B = 1 and B not a multiple of 8, '$' topics, too-long
topics, padding rows (length 0 with the sys flag, as ``publish_batch``
pads), and C < M (flat only: the reference's sharded step cannot reshape
there, ROADMAP R2).  On the CPU the steps take their plain composites.

On the card each step is two kernel launches writing one packed block
(``step_layout``): its regions are checked here in pure Python, and the
fused steps against the plain ones where a card is present.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import arrays_of, gen_filters, gen_topics, \
    run_reference

C = len(tm.KERNEL_COUNTER_FIELDS)
EDGE_TOPICS = ["$SYS/a/b", "$SYS", "", "a/b/c/dd/a/b/c/dd", "a//b", "a/b"]
# name: (K, M, ret_cap, B, max_levels, padding rows)
SHAPES = {
    "k_overflow_m_trunc": (4, 8, 4, 77, 6, 5),
    "ret_cap_spill": (32, 128, 4, 128, 6, 5),
    "ret_cap_none": (32, 128, None, 128, 6, 0),
    "ret_cap_eq_m": (8, 16, 16, 64, 6, 3),
    "ret_cap_gt_m": (8, 16, 40, 64, 6, 0),
    "b1": (32, 128, 16, 1, 6, 0),
    "c_lt_m": (4, 128, 16, 77, 5, 2),
}
SHARDED_SHAPES = [n for n in SHAPES if n != "c_lt_m"]


def _topics(rng, B: int, max_levels: int) -> list[str]:
    if B == 1:
        return ["a/b"]
    return (gen_topics(rng, B - len(EDGE_TOPICS), max_words=max_levels + 1)
            + EDGE_TOPICS)


def _tables(rng, n_filters: int):
    F, P, W = n_filters + 64, 64, 5
    rowmap = np.full(F, -1, np.int32)
    rowmap[rng.choice(n_filters, 40, replace=False)] = rng.permutation(P)[:40]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    return rowmap, pool


def _batch(ix, topics, pad: int) -> dict:
    tokens, lengths, sys_flags, _ = ix.tokenize(topics)
    if pad:            # as publish_batch_submit pads a batch
        lengths[-pad:] = 0
        sys_flags[-pad:] = True
    return dict(tokens=tokens, lengths=lengths, sys=sys_flags)


def _flat_case(name: str, seed: int) -> dict:
    K, M, ret_cap, B, levels, pad = SHAPES[name]
    rng = np.random.default_rng(seed)
    ix = TrieIndex(max_levels=levels)
    ix.load(gen_filters(rng, 1200, max_words=levels))
    arrays = ix.ensure()
    rowmap, pool = _tables(rng, len(ix.filters))
    return dict(trie=arrays_of(arrays), rowmap=rowmap, pool=pool, K=K, M=M,
                ret_cap=ret_cap, max_probes=ix.max_probes,
                **_batch(ix, _topics(rng, B, levels), pad))


def _sharded_case(name: str, S: int, seed: int) -> dict:
    K, M, ret_cap, B, levels, pad = SHAPES[name]
    rng = np.random.default_rng(seed)
    ix = ShardedTrieIndex(S, max_levels=levels)
    ix.load(gen_filters(rng, 1200, max_words=levels))
    shard_arrays = ix.ensure()
    rowmap, pool = _tables(rng, len(ix.filters))
    return dict(shards=[arrays_of(a) for a in shard_arrays], S=S,
                rowmap=rowmap, pool=pool, K=K, M=M, ret_cap=ret_cap,
                max_probes=ix.max_probes,
                **_batch(ix, _topics(rng, B, levels), pad))


FLAT = [_flat_case(n, 70 + i) for i, n in enumerate(SHAPES)]
SHARDED_IDS = [f"S{S}-{n}" for S in (1, 4) for n in SHARDED_SHAPES]
SHARDED = [_sharded_case(n, S, 80 + i) for S in (1, 4)
           for i, n in enumerate(SHARDED_SHAPES)]


@pytest.fixture(scope="module")
def ref():
    return run_reference({"ref_router_step": FLAT,
                          "ref_router_step_sharded": SHARDED}, timeout=600)


def _flat_inputs(case, device="cpu"):
    trie = tm.device_trie(type("A", (), case["trie"]), device)
    return trie, *_common_inputs(case, device)


def _sharded_inputs(case, device="cpu"):
    trie = tm.stacked_device_trie(
        [type("A", (), a) for a in case["shards"]], device)
    return trie, *_common_inputs(case, device)


def _common_inputs(case, device):
    return tuple(torch.from_numpy(x).to(device) for x in (
        case["rowmap"], case["pool"].view(np.int32), case["tokens"],
        case["lengths"], case["sys"]))


def _kw(case) -> dict:
    return dict(K=case["K"], M=case["M"], max_probes=case["max_probes"],
                ret_cap=case["ret_cap"], with_counters=True)


def _assert_step_equal(got, want) -> None:
    fids, fanout, overflow, fan_any, counters = (x.cpu().numpy()
                                                 for x in got)
    assert fids.dtype == np.int32 and counters.dtype == np.int32
    assert overflow.dtype == np.bool_ and fan_any.shape == ()
    np.testing.assert_array_equal(fids, want[0])
    np.testing.assert_array_equal(fanout.view(np.uint32), want[1])
    np.testing.assert_array_equal(overflow, want[2])
    assert bool(fan_any) == bool(want[3])
    np.testing.assert_array_equal(counters, want[4])


# -- the reference, on the CPU ----------------------------------------------


@pytest.mark.parametrize("i", range(len(FLAT)), ids=list(SHAPES))
def test_router_step_equals_reference(ref, i):
    _build.reset_launch_counts()
    case, want = FLAT[i], ref["ref_router_step"][i]
    got = rm.router_step(*_flat_inputs(case), **_kw(case))
    _assert_step_equal(got, want)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    name = list(SHAPES)[i]
    counters = want[4]
    if name == "k_overflow_m_trunc":
        assert counters[5] > 0 and counters[6] > 0      # K spill, M trunc
    if name in ("ret_cap_spill", "k_overflow_m_trunc"):
        assert want[0].shape[1] == case["ret_cap"] and want[2].any()
    if name == "c_lt_m":                                # C = 48 < M
        assert want[0].shape[1] == min(case["ret_cap"], 6 * 2 * case["K"])


@pytest.mark.parametrize("i", range(len(SHARDED)), ids=SHARDED_IDS)
def test_router_step_sharded_equals_reference(ref, i):
    _build.reset_launch_counts()
    case, want = SHARDED[i], ref["ref_router_step_sharded"][i]
    got = rm.router_step_sharded(*_sharded_inputs(case),
                                 n_shards=case["S"], **_kw(case))
    _assert_step_equal(got, want)
    assert got[4].shape == (case["S"], C)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    if SHARDED_IDS[i].endswith("k_overflow_m_trunc"):    # K spill, M trunc
        trie, _, _, *args = _sharded_inputs(case)
        truncated = tm.match_compact_sharded_plain(
            trie, *args, n_shards=case["S"], K=case["K"], M=case["M"],
            max_probes=case["max_probes"])[2]
        assert (want[4][:, 5] > 0).any() and bool(truncated.any())


# -- the packed block -------------------------------------------------------


LAYOUTS = [(1, 16, 256, None), (77, 4, 5, None), (16384, 16, 256, 4),
           (64, 128, 7, 1), (3, 3, 1, 32)]


@pytest.mark.parametrize("B,R,W,S", LAYOUTS)
def test_step_layout_regions(B, R, W, S):
    """The int32 regions start on 16-byte boundaries, no two regions
    overlap, the fan_any word follows the counters (one memset zeroes
    both), and the views have today's dtypes and shapes."""
    regions, nbytes = rm.step_layout(B, R, W, S, C)
    assert tuple(regions) == tuple(sorted(regions, key=lambda n:
                                          regions[n][0]))
    assert set(regions) == set(rm.STEP_OUTPUTS) and nbytes % 16 == 0
    spans = []
    for name, (off, dtype, shape) in regions.items():
        if dtype == torch.int32:
            assert off % 16 == 0, name
        size = 4 if name == "fan_any" else math.prod(shape) * dtype.itemsize
        spans.append((off, off + size))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[0][0] == 0 and spans[-1][1] <= nbytes
    cshape = (C,) if S is None else (S, C)
    assert regions["fan_any"][0] == (regions["counters"][0]
                                     + math.prod(cshape) * 4)
    want = {"fids": (torch.int32, (B, R)), "fanout": (torch.int32, (B, W)),
            "overflow": (torch.bool, (B,)), "fan_any": (torch.bool, ()),
            "counters": (torch.int32, cshape)}
    block = torch.zeros(nbytes, dtype=torch.uint8)
    views = rm.step_views(block, regions)
    for name, v in zip(rm.STEP_OUTPUTS, views):
        assert (v.dtype, tuple(v.shape)) == want[name], name
    # every byte a view owns is its own: fill each, then read all back
    for k, v in enumerate(views):
        v.fill_(True if v.dtype == torch.bool else k + 1)
    for k, v in enumerate(views):
        assert bool((v == (True if v.dtype == torch.bool else k + 1)).all())
    # the kernels' fan_any is an int32 store of 1 into its word
    block.zero_()
    at = regions["fan_any"][0]
    block[at:at + 4].view(torch.int32)[0] = 1
    assert bool(views[3]) and not bool(views[4].any())


@pytest.mark.parametrize("B,R,W,S", LAYOUTS)
def test_step_layout_without_counters(B, R, W, S):
    """A step with its counters off: no counters region (its view is
    None), fan_any's word where the counters would start, and every other
    region where it lies with them."""
    regions, nbytes = rm.step_layout(B, R, W, S, 0)
    full, _ = rm.step_layout(B, R, W, S, C)
    assert "counters" not in regions and nbytes % 16 == 0
    assert regions["fan_any"][0] == full["counters"][0]
    for name in ("fanout", "fids"):
        assert regions[name] == full[name]
    off, _, shape = regions["overflow"]
    assert off % 16 == 0 and off >= regions["fan_any"][0] + 4
    assert off + B <= nbytes
    views = rm.step_views(torch.zeros(nbytes, dtype=torch.uint8), regions)
    assert views[4] is None
    assert [tuple(v.shape) for v in views[:4]] == [(B, R), (B, W), (B,), ()]


def test_step_args_take_both_acc_shapes():
    """``acc`` of S·C + 1 words packs the counters, of 1 word (fan_any
    alone) does not; any other length raises."""
    B, cpu = 5, torch.device("cpu")
    for S in (1, 4):
        for words, on in ((S * C + 1, 1), (1, 0)):
            step = tm.StepOut(torch.empty((B, 3), dtype=torch.int32),
                              torch.empty(B, dtype=torch.bool),
                              torch.empty(words, dtype=torch.int32), 3)
            args = tm._step_args(step, B, S, 8, cpu)
            assert args[4] == step.acc.data_ptr() and args[5] == on
        with pytest.raises(ValueError, match="acc"):
            tm._step_args(step._replace(
                acc=torch.empty(S * C, dtype=torch.int32)), B, S, 8, cpu)


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "S4"])
def test_step_outputs_round_trip_through_the_block(sharded):
    """The plain step's five outputs written into a block's views read back
    equal, as publish_batch_collect reads the pinned copy."""
    case = SHARDED[SHARDED_IDS.index("S4-ret_cap_spill")] if sharded \
        else FLAT[list(SHAPES).index("ret_cap_spill")]
    if sharded:
        plain = rm.router_step_sharded_plain(*_sharded_inputs(case),
                                             n_shards=4, **_kw(case))
    else:
        plain = rm.router_step_plain(*_flat_inputs(case), **_kw(case))
    fids, fanout, _, _, counters = plain
    regions, nbytes = rm.step_layout(fids.shape[0], fids.shape[1],
                                     fanout.shape[1],
                                     4 if sharded else None, C)
    views = rm.step_views(torch.empty(nbytes, dtype=torch.uint8), regions)
    for v, x in zip(views, plain):
        v.copy_(x)
    for v, x in zip(views, plain):
        assert v.dtype == x.dtype and torch.equal(v, x)


def test_fused_step_needs_the_card():
    """router_step_block launches kernels: CPU tensors raise, and the
    walk's step outputs are checked before any launch."""
    case = FLAT[0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        rm.router_step_block(*_flat_inputs(case), **_kw(case))
    B = case["tokens"].shape[0]
    step = tm.StepOut(torch.empty((B, 4), dtype=torch.int32),
                      torch.empty(B, dtype=torch.bool),
                      torch.empty(C, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="acc"):
        tm._step_args(step, B, 1, 8, torch.device("cpu"))
    step = step._replace(acc=torch.empty(C + 1, dtype=torch.int32), cap=2)
    with pytest.raises(ValueError, match="min"):
        tm._step_args(step, B, 1, 8, torch.device("cpu"))
    assert tm._step_args(None, B, 1, 8, torch.device("cpu")) == (
        0, 0, None, None, None, 0)


# -- the fused steps on the card --------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused step is two CUDA "
                    "kernels")
    return torch.device("cuda")


def _fused_equals_plain(fused, plain, inputs, kw) -> None:
    _build.reset_launch_counts()
    got = fused(*inputs, **kw)
    counts = _build.launch_counts()
    walks = counts["walk_compact"] + counts["walk_compact_sharded"]
    assert walks == 1 and counts["fanout_pool"] == 1
    assert sum(counts.values()) == 2
    want = plain(*inputs, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(FLAT)), ids=list(SHAPES))
def test_fused_router_step_equals_plain_on_the_card(cuda_device, i):
    case = FLAT[i]
    _fused_equals_plain(rm.router_step, rm.router_step_plain,
                        _flat_inputs(case, cuda_device), _kw(case))


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(SHARDED)), ids=SHARDED_IDS)
def test_fused_router_step_sharded_equals_plain_on_the_card(cuda_device, i):
    case = SHARDED[i]
    _fused_equals_plain(rm.router_step_sharded, rm.router_step_sharded_plain,
                        _sharded_inputs(case, cuda_device),
                        dict(_kw(case), n_shards=case["S"]))
