"""The routing steps' counters switch and the counters contract, against the
JAX reference.

As in the reference, ``router_step`` and ``router_step_sharded`` pack the
kernel counters only with ``with_counters=True`` and return None for them
by default; the other four outputs (fids, fanout, overflow, fan_any) are
the same either way.  ``RouterModel`` asks for them when its
``kernel_telemetry`` is on (its argument, else ``EMQX_TPU_KERNEL_TELEMETRY``,
off for "0", "off" and "false"), and ``publish_batch_collect`` hands
``telemetry.on_batch`` the counters or None.  The reference runs in the
harness's child process; the port on CPU tensors, through the plain
versions.  The port's counters pack is also held to the reference's field
order and decoder (the twins of ``tests/test_kernel_counters_lint.py``).
Tests marked ``cuda`` hold the fused counters-off steps to their plain
versions on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu.observe import device_metrics as dm
from emqx_tpu.observe.metrics import DegradationLedger, Metrics
from emqx_tpu.observe.trace import SpanCollector
from emqx_tpu_torch import RouterModel
from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import arrays_of, gen_filters, gen_topics, \
    run_reference

C = len(tm.KERNEL_COUNTER_FIELDS)
EDGE_TOPICS = ["$SYS/a/b", "$SYS", "", "a/b/c/dd/a/b/c/dd", "a//b", "a/b"]
# name: (K, M, ret_cap, B); the batch's last 3 rows are padding rows
SHAPES = {"k2_m8": (2, 8, 4, 77), "k32_m128": (32, 128, 16, 64)}
LEVELS = 6
# a full exact/plus fan: the frontier doubles every level, so K=2
# overflows on the 4-deep topic
FAN_FILTERS = ["a/b/c/d", "a/b/c/+", "a/b/+/d", "a/b/+/+",
               "a/+/c/d", "a/+/c/+", "a/+/+/d", "a/+/+/+"]


def _case(name: str, S, seed: int, defaults: bool) -> dict:
    """A seeded step case: the flat trie (S None) or S shards, with a
    dense pool that some fids select."""
    K, M, ret_cap, B = SHAPES[name]
    rng = np.random.default_rng(seed)
    ix = (ShardedTrieIndex(S, max_levels=LEVELS) if S
          else TrieIndex(max_levels=LEVELS))
    ix.load(gen_filters(rng, 900, max_words=LEVELS))
    arrays = ix.ensure()
    F, P, W = len(ix.filters) + 64, 64, 5
    rowmap = np.full(F, -1, np.int32)
    rowmap[rng.choice(len(ix.filters), 40, replace=False)] = \
        rng.permutation(P)[:40]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    topics = gen_topics(rng, B - len(EDGE_TOPICS), max_words=LEVELS + 1) \
        + EDGE_TOPICS
    tokens, lengths, sys_flags, _ = ix.tokenize(topics)
    lengths[-3:] = 0                  # as publish_batch_submit pads a batch
    sys_flags[-3:] = True
    case = dict(rowmap=rowmap, pool=pool, tokens=tokens, lengths=lengths,
                sys=sys_flags, K=K, M=M, ret_cap=ret_cap,
                max_probes=ix.max_probes, defaults=defaults)
    if S:
        case.update(shards=[arrays_of(a) for a in arrays], S=S)
    else:
        case.update(trie=arrays_of(arrays))
    return case


IDS = [f"{'S4' if S else 'flat'}-{n}" for S in (None, 4) for n in SHAPES]
GRID = [(S, n, 90 + i) for i, (S, n) in enumerate(
    (S, n) for S in (None, 4) for n in SHAPES)]
DEFAULT = [_case(n, S, seed, True) for S, n, seed in GRID]
COUNTED = [_case(n, S, seed, False) for S, n, seed in GRID]


@pytest.fixture(scope="module")
def ref():
    flat = [c for c in DEFAULT + COUNTED if "S" not in c]
    sharded = [c for c in DEFAULT + COUNTED if "S" in c]
    out = run_reference({"ref_router_step": flat,
                         "ref_router_step_sharded": sharded,
                         "ref_counter_fields": [None]}, timeout=600)
    steps = iter(out["ref_router_step"])
    ssteps = iter(out["ref_router_step_sharded"])
    return dict(steps=[next(ssteps if "S" in c else steps)
                       for c in DEFAULT + COUNTED],
                fields=out["ref_counter_fields"])


def _inputs(case, device="cpu"):
    if "S" in case:
        trie = tm.stacked_device_trie(
            [type("A", (), a) for a in case["shards"]], device)
    else:
        trie = tm.device_trie(type("A", (), case["trie"]), device)
    return trie, *(torch.from_numpy(x).to(device) for x in (
        case["rowmap"], case["pool"].view(np.int32), case["tokens"],
        case["lengths"], case["sys"]))


def _step(case, device="cpu", **kw):
    kw = dict(K=case["K"], M=case["M"], max_probes=case["max_probes"],
              ret_cap=case["ret_cap"], **kw)
    if "S" in case:
        return rm.router_step_sharded(*_inputs(case, device),
                                      n_shards=case["S"], **kw)
    return rm.router_step(*_inputs(case, device), **kw)


def _assert_four_equal(got, want) -> None:
    """fids, fanout, overflow and fan_any equal the reference's."""
    fids, fanout, overflow, fan_any = (x.cpu().numpy() for x in got[:4])
    assert fids.dtype == np.int32 and overflow.dtype == np.bool_
    np.testing.assert_array_equal(fids, want[0])
    np.testing.assert_array_equal(fanout.view(np.uint32), want[1])
    np.testing.assert_array_equal(overflow, want[2])
    assert fan_any.shape == () and bool(fan_any) == bool(want[3])


# -- the steps' switch, against the reference --------------------------------


@pytest.mark.parametrize("i", range(len(DEFAULT)), ids=IDS)
def test_default_step_returns_no_counters(ref, i):
    """Called with its defaults, each step returns ``counters is None``,
    as the reference's does, and the four other outputs are the
    reference's and the counted step's."""
    _build.reset_launch_counts()
    case, want = DEFAULT[i], ref["steps"][i]
    got = _step(case)
    assert want[4] is None and got[4] is None
    _assert_four_equal(got, want)
    counted = _step(case, with_counters=True)
    for g, c in zip(got[:4], counted[:4]):
        assert g.dtype == c.dtype and torch.equal(g, c)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


@pytest.mark.parametrize("i", range(len(COUNTED)), ids=IDS)
def test_step_with_counters_equals_reference(ref, i):
    case, want = COUNTED[i], ref["steps"][len(DEFAULT) + i]
    got = _step(case, with_counters=True)
    _assert_four_equal(got, want)
    counters = got[4].numpy()
    assert counters.dtype == np.int32
    assert counters.shape == ((case["S"], C) if "S" in case else (C,))
    np.testing.assert_array_equal(counters, want[4])
    if case["K"] == 2:                   # the K spill is counted
        assert (want[4][..., 5] > 0).any()


def test_cases_reach_a_dense_row_and_the_overflow_rows(ref):
    for case, want in zip(DEFAULT + COUNTED, ref["steps"]):
        assert want[3] and (want[2].any() or case["K"] != 2)
        assert case["sys"].any() and (case["lengths"] == 0).any()


# -- RouterModel: kernel_telemetry and the collect seam ----------------------


@pytest.mark.parametrize("value,on", [
    ("0", False), ("off", False), ("false", False), ("OFF", False),
    ("False", False), ("1", True), ("on", True), ("yes", True), (None, True)])
def test_kernel_telemetry_env_gates(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("EMQX_TPU_KERNEL_TELEMETRY", raising=False)
    else:
        monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", value)
    for kw in ({}, {"trie_shards": 2}):
        model = RouterModel(device="cpu", **kw)
        assert model.kernel_telemetry is on
        assert model._step.keywords["with_counters"] is on
        assert model._step_block.keywords["with_counters"] is on


@pytest.mark.parametrize("env,arg", [("0", True), ("1", False),
                                     ("off", True), ("true", False)])
def test_explicit_argument_beats_the_env(monkeypatch, env, arg):
    monkeypatch.setenv("EMQX_TPU_KERNEL_TELEMETRY", env)
    model = RouterModel(device="cpu", kernel_telemetry=arg)
    assert model.kernel_telemetry is arg
    assert model._step.keywords["with_counters"] is arg


class _Stub:
    """A recording telemetry hook."""

    def __init__(self) -> None:
        self.counters = []

    def on_batch(self, counters, **_kw) -> None:
        self.counters.append(counters)


def _populate(model) -> list[str]:
    rng = np.random.default_rng(11)
    for i, f in enumerate(sorted(set(gen_filters(rng, 300, max_words=5)))):
        model.subscribe(f, i % 64)
    for s in range(12):                  # a dense-pool row
        model.subscribe("a/+", s)
    return gen_topics(rng, 40, max_words=6) + ["a/b", "$SYS/a"]


@pytest.mark.parametrize("S", [None, 4], ids=["flat", "S4"])
def test_collect_hands_on_batch_none_when_off(S):
    """One collected batch reaches ``on_batch`` with None when telemetry
    is off, with the ``[C]`` / ``[S, C]`` counters when it is on; the
    publish results are the same."""
    got = {}
    for on in (True, False):
        model = RouterModel(device="cpu", n_sub_slots=64, dense_threshold=8,
                            trie_shards=S, kernel_telemetry=on)
        topics = _populate(model)
        model.telemetry = stub = _Stub()
        got[on] = model.publish_batch(topics)
        assert len(stub.counters) == 1
        if on:
            assert stub.counters[0].shape == ((S, C) if S else (C,))
            assert stub.counters[0].dtype == np.int32
        else:
            assert stub.counters[0] is None
    assert got[True] == got[False]
    assert any(got[True][0]) and any(s for s in got[True][2])


@pytest.mark.parametrize("S", [None, 4], ids=["flat", "S4"])
def test_set_kernel_telemetry_switches_a_built_model(S):
    """A model switched off and on again by ``set_kernel_telemetry`` hands
    ``on_batch`` what a model built that way hands it, and routes alike."""
    built = {}
    for on in (True, False):
        model = RouterModel(device="cpu", n_sub_slots=64, dense_threshold=8,
                            trie_shards=S, kernel_telemetry=on)
        topics = _populate(model)
        model.telemetry = stub = _Stub()
        built[on] = (model.publish_batch(topics), stub.counters[0])
    model = RouterModel(device="cpu", n_sub_slots=64, dense_threshold=8,
                        trie_shards=S, kernel_telemetry=True)
    topics = _populate(model)
    model.telemetry = stub = _Stub()
    for on in (False, True, False):
        model.set_kernel_telemetry(on)
        assert model.kernel_telemetry is on
        assert model._step.keywords["with_counters"] is on
        assert model._step_block.keywords["with_counters"] is on
        got = model.publish_batch(topics)
        assert got == built[on][0]
        want = built[on][1]
        assert (stub.counters[-1] is None) if want is None else (
            np.array_equal(stub.counters[-1], want))


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_reference_fold_takes_a_port_batch(on):
    """The reference's DeviceMetricsFold, composed with a port model as the
    reference's app composes it: one batch folds, with no counters when
    telemetry is off, the port's decoded ones when it is on."""
    model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=64,
                        device="cpu", kernel_telemetry=on)
    for f in ("a/+/c", "a/b/#", "d/e"):
        model.subscribe(f, 1)
    metrics = Metrics()
    fold = dm.DeviceMetricsFold(metrics, ledger=DegradationLedger(metrics),
                                spans=SpanCollector(), model=model,
                                node="n1")
    model.telemetry = fold
    assert getattr(model, "kernel_telemetry", False) is on
    model.publish_batch_collect(model.publish_batch_submit(
        ["a/b/c", "d/e", "x/y"]))
    assert fold.batches == 1
    if not on:
        assert fold.last is None
        return
    last = fold.last.as_dict()
    assert fold.last.n_shards == 1
    assert last["cand_pre"] == last["cand_post"] == 3
    assert last["overflow_rows"] == 0 and last["trunc_rows"] == 0
    assert last["frontier_peak"] >= 2 and last["probe_iters"] >= 1


# -- the counters contract (twins of test_kernel_counters_lint) --------------


def test_counter_fields_equal_reference(ref):
    assert tm.KERNEL_COUNTER_FIELDS == ref["fields"]
    assert tm.KERNEL_COUNTER_FIELDS == dm.KERNEL_COUNTER_FIELDS
    assert len(set(tm.KERNEL_COUNTER_FIELDS)) == C


def test_pack_flat_shape_decodes_in_the_reference():
    vals = {n: 100 + i for i, n in enumerate(tm.KERNEL_COUNTER_FIELDS)}
    raw = tm.pack_counters(**vals)
    assert raw.shape == (C,) and raw.dtype == torch.int32
    kc = dm.KernelCounters(raw.numpy())
    assert kc.n_shards == 1
    assert {n: kc.value(n) for n in vals} == vals


def test_pack_sharded_shape_decodes_in_the_reference():
    S = 4
    vals = {n: torch.arange(S, dtype=torch.int32) * (i + 1)
            for i, n in enumerate(tm.KERNEL_COUNTER_FIELDS)}
    raw = tm.pack_counters(**vals)
    assert raw.shape == (S, C) and raw.dtype == torch.int32
    kc = dm.KernelCounters(raw.numpy())
    assert kc.n_shards == S
    for i, n in enumerate(tm.KERNEL_COUNTER_FIELDS):
        assert kc.field(n).tolist() == (np.arange(S) * (i + 1)).tolist()
    assert kc.value("frontier_peak") == S - 1
    assert kc.value("probe_iters") == 2 * sum(range(S))


def test_pack_counters_rejects_drifted_field_set():
    vals = {n: 1 for n in tm.KERNEL_COUNTER_FIELDS}
    with pytest.raises(TypeError, match="extra"):
        tm.pack_counters(**{**vals, "bogus_field": 1})
    missing = dict(vals)
    missing.pop(tm.KERNEL_COUNTER_FIELDS[0])
    with pytest.raises(TypeError, match="missing"):
        tm.pack_counters(**missing)


def _match_stats(filters, topics, K=32, max_levels=8):
    ix = TrieIndex(max_levels=max_levels)
    ix.load(filters)
    trie = tm.device_trie(ix.ensure(), "cpu")
    tok, lens, sysf, too_long = ix.tokenize(topics)
    assert not too_long
    cand, overflow, mstats = tm.match_batch(
        trie, *(torch.from_numpy(x) for x in (tok, lens, sysf)), K=K)
    return cand.numpy(), overflow.numpy(), {k: int(v)
                                            for k, v in mstats.items()}


def test_counters_sane_batch():
    cand, overflow, st = _match_stats(["a/+/c", "a/b/#", "d/e", "a/b/c"],
                                      ["a/b/c", "d/e", "x/y"])
    assert st["cand_pre"] == int((cand >= 0).sum()) == 4
    assert st["overflow_rows"] == 0 and not overflow.any()
    assert st["frontier_peak"] >= 2 and st["probe_iters"] >= 1


def test_counters_overflow_rows_at_k2():
    cand, overflow, st = _match_stats(FAN_FILTERS, ["a/b/c/d"], K=2)
    assert bool(overflow[0])
    assert st["overflow_rows"] == int(overflow.sum()) == 1
    assert st["frontier_peak"] == 2


# -- the fused counters-off steps on the card --------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused step is two CUDA "
                    "kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(DEFAULT)), ids=IDS)
def test_counters_off_fused_step_equals_plain_on_the_card(cuda_device, i):
    case = DEFAULT[i]
    _build.reset_launch_counts()
    got = _step(case, cuda_device)
    counts = _build.launch_counts()
    assert counts["walk_compact"] + counts["walk_compact_sharded"] == 1
    assert counts["fanout_pool"] == 1 and sum(counts.values()) == 2
    trie, rowmap, pool, *args = _inputs(case, cuda_device)
    kw = dict(K=case["K"], M=case["M"], max_probes=case["max_probes"],
              ret_cap=case["ret_cap"])
    if "S" in case:
        want = rm.router_step_sharded_plain(trie, rowmap, pool, *args,
                                            n_shards=case["S"], **kw)
    else:
        want = rm.router_step_plain(trie, rowmap, pool, *args, **kw)
    counted = _step(case, cuda_device, with_counters=True)
    torch.cuda.synchronize()
    assert got[4] is None and want[4] is None
    for g, w, c in zip(got[:4], want[:4], counted[:4]):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, c)


@pytest.mark.cuda
@pytest.mark.parametrize("counters", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("dense", [False, True], ids=["no_row", "rows"])
@pytest.mark.parametrize("S", [None, 4], ids=["flat", "S4"])
def test_fan_any_on_a_dirty_block_on_the_card(cuda_device, S, dense,
                                              counters):
    """The step writes into a block whose every byte was 0xFF first: the
    entry's memset zeroes fan_any (and the counters), so a batch that
    selects no pool row reads fan_any False."""
    case = COUNTED[IDS.index(f"{'S4' if S else 'flat'}-k32_m128")]
    trie, rowmap, pool, *args = _inputs(case, cuda_device)
    if not dense:
        rowmap = torch.full_like(rowmap, -1)
    kw = dict(K=case["K"], M=case["M"], max_probes=case["max_probes"],
              ret_cap=case["ret_cap"], with_counters=counters)
    if S:
        kw["n_shards"] = S
    size = rm.router_step_block(trie, rowmap, pool, *args, **kw)[0].numel()
    dirty = torch.full((size,), 0xFF, dtype=torch.uint8, device=cuda_device)
    block, regions = rm.router_step_block(trie, rowmap, pool, *args,
                                          out=dirty, **kw)
    assert block.data_ptr() == dirty.data_ptr()
    got = rm.step_views(block, regions)
    plain = rm.router_step_sharded_plain if S else rm.router_step_plain
    want = plain(trie, rowmap, pool, *args, **kw)
    torch.cuda.synchronize()
    assert bool(got[3]) is dense and bool(want[3]) is dense
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
