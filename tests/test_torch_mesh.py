"""The port's device mesh (``emqx_tpu_torch/parallel/mesh.py``) and its
routing over it (``RouterModel(mesh=...)``, the steps' ``shardings=``)
against the JAX reference on an 8-device mesh.

The port's mesh here is the CPU eight times (``devices=[cpu] * 8``), the
counterpart of the reference's eight virtual CPU devices
(``--xla_force_host_platform_device_count=8``, in the reference's child
process): every partition, gather, patch route and counter fold runs, in
the kernels' plain versions.  The whole step is integer work, so every
comparison is exact:

- the mesh step's five outputs against the reference's ``router_step`` /
  ``router_step_sharded`` jitted with ``shardings``, both trie layouts, the
  three (dp, tp) splits of 8 devices, the counters on and off, K overflow,
  M truncation and the ``ret_cap`` spill;
- a mesh RouterModel driven through subscribes, publishes of an aligned
  and an uneven batch (with ``$`` topics), a dense-pool promotion and a
  churn whose refreshes step through the patch caps: its publish results,
  counters, upload / patch / launch counts and its tables (assembled from
  the devices' pieces) against the reference's mesh model;
- the reference's dry run (``__graft_entry__.py`` ``dryrun_multichip``)
  at a tier-1 size: both layouts on a 4×2 mesh equal the host oracle;
- the mesh's rules: no card and no devices raises, as do a mesh of mixed
  device types, shapes that do not split evenly and a device that
  disagrees with the mesh.

Tests marked ``cuda`` hold the kernels' mesh forms on a card (one card
four times): they skip here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.models.router_model import RouterModel
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.parallel import mesh as pmesh
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
from emqx_tpu_torch.router.trie import Trie

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import arrays_of, drive_model, gen_filters, \
    gen_topics, run_reference

CPU = torch.device("cpu")
SHAPES = [(8, 1), (4, 2), (2, 4)]
SHAPE_IDS = [f"dp{d}tp{t}" for d, t in SHAPES]
S = 4                      # trie shards: a multiple of every tp extent
# per shape: (K, M, ret_cap): a spilling frontier, M truncation and the
# ret_cap spill at (8, 1) and (2, 4), the defaults at (4, 2)
WIDTHS = [(4, 8, 4), (32, 128, 16), (8, 16, 6)]


def cpu_mesh(shape) -> pmesh.Mesh:
    return pmesh.make_mesh(8, shape=shape, devices=[CPU] * 8)


def _step_case(seed: int, shape, sharded: bool, counters: bool) -> dict:
    rng = np.random.default_rng(seed)
    filters = gen_filters(rng, 900, max_words=6)
    topics = gen_topics(rng, 124, max_words=7) + ["$SYS/a", "", "a/b",
                                                  "$SYS/dd/+"]
    ix = ShardedTrieIndex(S, max_levels=6) if sharded \
        else TrieIndex(max_levels=6)
    ix.load(filters)
    K, M, ret_cap = WIDTHS[SHAPES.index(shape)]
    tokens, lengths, sys_flags, _ = ix.tokenize(topics)
    F, P, W = len(ix.filters) + 64, 64, 8
    rowmap = np.full(F, -1, np.int32)
    rowmap[rng.choice(len(ix.filters), 40, replace=False)] = \
        rng.permutation(P)[:40]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    case = dict(shape=shape, rowmap=rowmap, pool=pool, tokens=tokens,
                lengths=lengths, sys=sys_flags, K=K, M=M, ret_cap=ret_cap,
                max_probes=ix.max_probes, defaults=not counters)
    if sharded:
        case.update(shards=[arrays_of(s) for s in ix.ensure()], S=S)
    else:
        case["trie"] = arrays_of(ix.ensure())
    return case


STEP_CASES = [_step_case(60 + k, shape, sharded, counters)
              for k, (sharded, shape, counters) in enumerate(
                  (sh, shape, c) for sh in (False, True) for shape in SHAPES
                  for c in (True, False))]
STEP_IDS = [f"{'S4' if 'shards' in c else 'flat'}-"
            f"dp{c['shape'][0]}tp{c['shape'][1]}-"
            f"counters_{'off' if c['defaults'] else 'on'}"
            for c in STEP_CASES]


def _model_ops(seed: int) -> list:
    """Subscribes, an uneven (77) and an aligned (128) batch with ``$``
    topics, a dense-pool promotion, then a churn whose refreshes step
    through the patch caps 64, 256 and 1024 (20, 60 and 300 new filters)
    and unsubscribes, the tables read after each refresh."""
    rng = np.random.default_rng(seed)
    base = sorted(set(gen_filters(rng, 400, max_words=5)))
    ops = [("sub", f, int(s)) for f, s in
           zip(base, rng.integers(0, 256, len(base)))]
    ops += [("refresh",), ("tables",)]
    pubs = [gen_topics(rng, n, max_words=6) + ["$SYS/a/b", "$SYS"]
            for n in (75, 126, 60)]
    ops += [("pub", pubs[0]), ("pub", pubs[1]), ("counts",)]
    ops += [("sub", "dd/+", s) for s in range(0, 256, 16)]
    ops += [("sub", "#", s) for s in range(200, 210)]
    new = [f"churn/w{i}/x{i % 5}" for i in range(380)]
    for lo, hi in ((0, 20), (20, 80), (80, 380)):
        ops += [("sub", f, i % 256) for i, f in enumerate(new[lo:hi])]
        ops += [("refresh",), ("tables",), ("pub", pubs[2] + new[lo:hi:9])]
    ops += [("unsub", f, i % 256) for i, f in enumerate(new) if i % 3 == 0]
    ops += [("unsub", "dd/+", s) for s in range(0, 256, 16)]
    ops += [("refresh",), ("tables",), ("pub", pubs[1]), ("counts",)]
    return ops


MODEL_CASES = [dict(shape=shape, shards=sh, max_levels=6,
                    ops=_model_ops(80 + k),
                    model_kw=dict(n_sub_slots=256, K=w[0], M=w[1],
                                  ret_cap=w[2], dense_threshold=6,
                                  kernel_telemetry=shape != (4, 2)))
               for k, (sh, (shape, w)) in enumerate(
                   (sh, sw) for sh in (None, S)
                   for sw in zip(SHAPES, WIDTHS))]
MODEL_IDS = [f"{'S4' if c['shards'] else 'flat'}-dp{c['shape'][0]}"
             f"tp{c['shape'][1]}" for c in MODEL_CASES]


@pytest.fixture(scope="module")
def ref():
    out = run_reference({"ref_mesh_step": STEP_CASES,
                         "ref_mesh_model": MODEL_CASES}, timeout=600,
                        devices=8)
    return out["ref_mesh_step"], out["ref_mesh_model"]


def _placed(case, device=CPU) -> tuple:
    """The case's operands as the port's mesh grids on a mesh of the
    case's shape over ``device`` repeated, placed as RouterModel places
    them; its shardings; its trie as one host DeviceTrie."""
    n = case["shape"][0] * case["shape"][1]
    sh = pmesh.router_shardings(pmesh.make_mesh(
        n, shape=case["shape"], devices=[device] * n))
    if "shards" in case:
        host = tm.stacked_device_trie(
            [type("A", (), a) for a in case["shards"]], "cpu")
        where, batch = sh["trie_sub"], sh["batch_dp"]
    else:
        host = tm.device_trie(type("A", (), case["trie"]), "cpu")
        where, batch = sh["replicated"], sh["batch_full"]
    edges, nodes = where.split(host.edges), where.split(host.nodes)
    trie = [[tm.DeviceTrie(edges=e, nodes=n) for e, n in zip(er, nr)]
            for er, nr in zip(edges, nodes)]
    rowmap = sh["replicated"].split(torch.from_numpy(case["rowmap"]))
    pool = sh["bitmaps"].split(torch.from_numpy(case["pool"].view(np.int32)))
    args = [batch.split(torch.from_numpy(case[k]))
            for k in ("tokens", "lengths", "sys")]
    return (trie, rowmap, pool, *args), sh, host


@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_mesh_step_equals_reference(ref, i):
    """The mesh step's five outputs equal the reference's jitted with the
    same mesh's shardings, and the port's single-device step's."""
    c, want = STEP_CASES[i], ref[0][i]
    grids, sh, host = _placed(c)
    kw = dict(K=c["K"], M=c["M"], max_probes=c["max_probes"],
              ret_cap=c["ret_cap"], with_counters=not c["defaults"])
    if "shards" in c:
        fn = lambda *a, **k: rm.router_step_sharded(*a, n_shards=S, **k)  # noqa: E731
    else:
        fn = rm.router_step
    got = fn(*grids, shardings=sh, **kw)
    single = fn(host, torch.from_numpy(c["rowmap"]),
                torch.from_numpy(c["pool"].view(np.int32)),
                *(torch.from_numpy(c[k]) for k in ("tokens", "lengths",
                                                   "sys")), **kw)
    assert len(got) == len(want) == 5
    for g, s1, w in zip(got, single, want):
        if w is None:
            assert g is None and s1 is None
            continue
        g = g.numpy()
        if g.dtype == np.int32 and w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s1.numpy().view(g.dtype))
    if c["K"] < 32:       # the narrow widths reach the edge rows
        assert got[2].any(), "no overflow row: the case misses its edges"


@pytest.mark.parametrize("k", range(len(MODEL_CASES)), ids=MODEL_IDS)
def test_mesh_model_equals_reference(ref, k):
    """A RouterModel on the CPU mesh equals the reference's on its mesh:
    every publish result and counters block, the upload, patch and launch
    counts and the patch bytes, and its tables after every refresh
    (assembled from the devices' pieces, every replica equal)."""
    c = MODEL_CASES[k]
    index = (ShardedTrieIndex(c["shards"], max_levels=c["max_levels"])
             if c["shards"] else TrieIndex(max_levels=c["max_levels"]))
    model = RouterModel(index, mesh=cpu_mesh(c["shape"]), device="cpu",
                        **c["model_kw"])
    assert model._host_matcher is None
    got, want = drive_model(model, c["ops"]), ref[1][k]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        if g[0] != "tables":
            assert g == w
            continue
        assert g[1].keys() == w[1].keys()
        for name in g[1]:
            np.testing.assert_array_equal(g[1][name], w[1][name])
    counts = [s for s in got if s[0] == "counts"][-1]
    # uploads: the first publish and the churn's growth; patches between
    assert counts[1] == 2 and counts[2] == 3 and counts[3] == 6
    pubs = [s for s in got if s[0] == "pub"]
    if c["model_kw"]["K"] == 4:                    # K spill: fallback rows
        assert any(s[1][3] for s in pubs)
    assert any(any(sl) for s in pubs for sl in s[1][2])
    assert (pubs[0][2] is None) == (not c["model_kw"]["kernel_telemetry"])


def _graft_model(mesh, n_filters: int, n_slots: int, trie_shards=None):
    """``__graft_entry__.py`` ``_build_model`` on the port."""
    rng = np.random.default_rng(0)
    index = (ShardedTrieIndex(trie_shards, max_levels=8)
             if trie_shards else TrieIndex(max_levels=8))
    model = RouterModel(index, n_sub_slots=n_slots, K=32, M=64, mesh=mesh,
                        device="cpu")
    for i in range(n_filters):
        kind = i % 4
        vid, metric = rng.integers(0, 500), rng.integers(0, 8)
        if kind == 0:
            f = f"vehicle/v{i}/telemetry/m{metric}"
        elif kind == 1:
            f = f"vehicle/+/telemetry/m{metric}"
        elif kind == 2:
            f = f"vehicle/v{i}/#"
        else:
            f = f"fleet/f{vid % 32}/vehicle/+/status/#"
        model.subscribe(f, int(rng.integers(0, n_slots)))
    model.refresh()
    return model


@pytest.mark.parametrize("trie_shards", [None, 4], ids=["flat", "S4"])
def test_dryrun_multichip_legs_equal_the_oracle(trie_shards):
    """The reference's dry run at a tier-1 size (4000 filters, 8 devices
    at tp=2): each layout's mesh result equals the host oracle trie on
    every non-fallback topic, and the single-device model's result."""
    tp = 2
    mesh = cpu_mesh((4, tp))
    model = _graft_model(mesh, 4000, 64 * 32 * tp, trie_shards)
    single = _graft_model(None, 4000, 64 * 32 * tp, trie_shards)
    topics = [f"vehicle/v{i}/telemetry/m{i % 8}" for i in range(64)]
    matched, _aux, slots, fallback = model.publish_batch(topics)
    assert (matched, _aux, slots, fallback) == single.publish_batch(topics)
    assert sum(len(m) for m in matched) > 0
    oracle = Trie()
    for f in model.index.filters:
        if f is not None:
            oracle.insert(f)
    fb, checked = set(fallback), 0
    for i, t in enumerate(topics):
        if i in fb:
            continue
        assert set(matched[i]) == set(oracle.match(t)), t
        checked += 1
    assert checked > 0
    assert model.launch_count == 1 and model.upload_count == 1


# -- the mesh's rules ------------------------------------------------------


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh() builds over it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(8, shape=(4, 2))


def test_make_mesh_shapes_and_devices():
    m = pmesh.make_mesh(8, devices=[CPU] * 8)
    assert m.shape == {"dp": 2, "tp": 4} and m.shape[pmesh.TP] == 4
    assert m.devices.shape == (2, 4) and m.axis_names == ("dp", "tp")
    assert pmesh.make_mesh(devices=[CPU] * 6).devices.shape == (3, 2)
    assert pmesh.make_mesh(2, devices=[CPU] * 8).devices.shape == (1, 2)
    with pytest.raises(ValueError, match="mesh shape"):
        pmesh.make_mesh(8, shape=(3, 2), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="need 8 devices"):
        pmesh.make_mesh(8, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="one type"):
        pmesh.make_mesh(2, shape=(1, 2),
                        devices=[CPU, torch.device("cuda", 0)])
    sh = pmesh.router_shardings(m)
    assert sorted(sh) == sorted(["replicated", "batch_full", "batch_dp",
                                 "bitmaps", "fanout_out", "trie_sub"])
    x = torch.arange(16 * 6).view(16, 6)
    sh = pmesh.router_shardings(pmesh.make_mesh(8, shape=(4, 2),
                                                devices=[CPU] * 8))
    pieces = sh["fanout_out"].split(x)
    # block (i, j): rows i over dp, columns j over tp
    assert torch.equal(pieces[1][1], x[4:8, 3:6])
    assert torch.equal(sh["batch_full"].split(x)[2][1], x[10:12])
    assert torch.equal(sh["replicated"].split(x)[3][0], x)
    assert sh["replicated"].split(x)[3][0].data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="does not split evenly"):
        sh["bitmaps"].split(torch.zeros(4, 5))


def test_mesh_model_rules():
    """S over tp, W over tp and B over dp·tp (flat) or dp (sharded) must
    split evenly; a device that disagrees with the mesh raises; the model
    on a mesh serves from the step even on the CPU."""
    with pytest.raises(ValueError, match="multiple of the tp mesh extent"):
        RouterModel(ShardedTrieIndex(3), mesh=cpu_mesh((4, 2)), device="cpu")
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        RouterModel(mesh=cpu_mesh((4, 2)), device="cuda")
    model = RouterModel(mesh=cpu_mesh((4, 2)), n_sub_slots=96)   # W = 3
    assert model.device == CPU
    model.subscribe("a/b", 1)
    with pytest.raises(ValueError, match="does not split evenly"):
        model.refresh()
    odd = pmesh.make_mesh(3, shape=(3, 1), devices=[CPU] * 3)
    for index in (TrieIndex(), ShardedTrieIndex(3)):
        model = RouterModel(index, mesh=odd, device="cpu")
        model.subscribe("a/b", 1)
        with pytest.raises(ValueError, match="does not split evenly"):
            model.publish_batch(["a/b"])   # B = 64 over dp = 3


def test_mesh_model_serves_from_the_step_on_the_cpu(monkeypatch):
    monkeypatch.setenv("EMQX_TPU_CPU_KERNEL", "auto")
    model = RouterModel(mesh=cpu_mesh((4, 2)), device="cpu")
    assert model._host_matcher is None
    model.subscribe("a/+", 3)
    assert model.publish_batch(["a/b", "b"]) == ([["a/+"], []], [[], []],
                                                 [[3], []], [])
    assert model.launch_count == 1 and model.host_match_count == 0
    flat = RouterModel(device="cpu")
    assert flat._host_matcher is not None


def test_counter_fold_is_the_global_reduction():
    """Per-device packs fold as the reference's reductions over all rows:
    max for the two peaks, sum for the other five fields."""
    rng = np.random.default_rng(7)
    packs = [torch.from_numpy(rng.integers(0, 50, (3, 7)).astype(np.int32))
             for _ in range(4)]
    got = rm.fold_counters(packs)
    x = torch.stack(packs)
    for k, name in enumerate(tm.KERNEL_COUNTER_FIELDS):
        want = x[..., k].amax(0) if name in rm.PEAK_FIELDS \
            else x[..., k].sum(0)
        assert torch.equal(got[:, k], want.to(torch.int32))
    assert got.dtype == torch.int32


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the mesh step's kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(STEP_CASES)), ids=STEP_IDS)
def test_mesh_step_on_the_card_equals_the_cpu_mesh(cuda_device, i):
    """The mesh step on one card four times (its kernels: the walks, the
    group walks with shard_base, the merged compact, the fan-out) equals
    the CPU mesh's plain step, and launches each kernel once per device."""
    from emqx_tpu_torch.ops import _build
    c = dict(STEP_CASES[i], shape=(2, 2) if i % 2 else (1, 4))
    grids, sh, _ = _placed(c)
    want = rm.mesh_step(*grids, shardings=sh, n_shards=S, K=c["K"],
                        M=c["M"], max_probes=c["max_probes"],
                        ret_cap=c["ret_cap"],
                        with_counters=not c["defaults"])
    cgrids, csh, _ = _placed(c, cuda_device)
    before = _build.launch_counts()
    got = rm.mesh_step(*cgrids, shardings=csh, n_shards=S, K=c["K"],
                       M=c["M"], max_probes=c["max_probes"],
                       ret_cap=c["ret_cap"], with_counters=not c["defaults"])
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in _build.launch_counts().items()
             if v != before[k]}
    walk = "walk_compact_sharded" if "shards" in c else "walk_compact"
    expect = {walk: 4, "fanout_pool": 4}
    if "shards" in c:
        expect["compact"] = 4
    assert delta == expect
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_group_walk_equals_plain_on_the_card(cuda_device):
    """The stacked walk on a group of shards (``shard_base``) equals its
    plain version: in its stats mode, and launched as the mesh step
    launches it (a step of no fids and cap M), whose overflow is the
    group's K spill or truncation and whose acc holds its counters."""
    c = STEP_CASES[len(STEP_CASES) // 2]
    host = tm.stacked_device_trie([type("A", (), a) for a in c["shards"]],
                                  "cpu")
    args = [torch.from_numpy(c[k]) for k in ("tokens", "lengths", "sys")]
    for S_l in (1, 2):
        for base in range(0, S, S_l):
            part = tm.DeviceTrie(edges=host.edges[base:base + S_l].clone(),
                                 nodes=host.nodes[base:base + S_l].clone())
            kw = dict(n_shards=S, shard_base=base, K=c["K"], M=c["M"],
                      max_probes=c["max_probes"])
            want = tm.match_compact_sharded_plain(part, *args, **kw)
            card = tm.DeviceTrie(edges=part.edges.to(cuda_device),
                                 nodes=part.nodes.to(cuda_device))
            cargs = [a.to(cuda_device) for a in args]
            got = tm.match_compact_sharded(card, *cargs, **kw)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
            fids, stats, trunc = want
            C = len(tm.KERNEL_COUNTER_FIELDS)
            for words in (S_l * C + 1, 1):
                flag = torch.empty(len(trunc), dtype=torch.bool,
                                   device=cuda_device)
                acc = torch.full((words,), 7, dtype=torch.int32,
                                 device=cuda_device)
                got = tm.launch_walk_compact_sharded(
                    card, *cargs, step=tm.StepOut(None, flag, acc, c["M"]),
                    **kw)
                assert got[1] is None and got[2] is None
                assert torch.equal(got[0].cpu(), fids)
                assert torch.equal(flag.cpu(),
                                   (stats[:, :, 3] != 0).any(0) | trunc)
                assert acc[-1].item() == 0
                if words > 1:
                    assert torch.equal(
                        acc[:-1].view(S_l, C).cpu(),
                        rm._shard_counters(stats, c["M"]))


@pytest.mark.cuda
@pytest.mark.parametrize("i", [2, 8], ids=["flat", "S4"])
def test_mesh_step_queues_without_waiting_on_the_card(cuda_device, i):
    """The mesh step on a card queues all its work without waiting on the
    card (no host copy or sync inside it): queued behind a ~0.25 s sleep,
    the sleep is still running when the step returns."""
    c = dict(STEP_CASES[i], shape=(2, 2))
    grids, sh, _ = _placed(c, cuda_device)
    kw = dict(shardings=sh, n_shards=S, K=c["K"], M=c["M"],
              max_probes=c["max_probes"], ret_cap=c["ret_cap"],
              with_counters=True)
    want = rm.mesh_step(*grids, **kw)
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)
    queued = torch.cuda.Event()
    queued.record()
    got = rm.mesh_step(*grids, **kw)
    assert not queued.query(), "the mesh step waited on the card"
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_smoke_mesh_paths_rehearse_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s mesh and mesh_s4 paths at a small size on the
    CPU four times: the clones of the flat and the S=4 model, every batch
    and raw step equal to the single-device model's, the overlay lifted
    and restored, the churn and its undoing (patches, no upload), the
    one-filter patches on the devices that hold its element, the CPU
    mesh's failover, the (1, 4) mesh.  The card runs it at 1M
    subscriptions; the launch counts are the card's alone (here each
    patch call counts as the kernel's launch would)."""
    import gc

    import chip_smoke as cs
    from emqx_tpu_torch.ops import _build
    monkeypatch.setattr(cs, "path_counts", lambda name, counts=None: {})
    monkeypatch.setattr(cs, "mesh_launches", lambda m: {})
    monkeypatch.setattr(cs, "BATCH", 256)
    patch = rm.apply_patches

    def counted(*a, **k):
        _build.KERNELS["patch"].launches += 1
        return patch(*a, **k)

    monkeypatch.setattr(rm, "apply_patches", counted)
    try:
        st = cs.load(6000, 42, "cpu")
        cs.add_broadcast(st)
        st["big"] = [cs.make_topics(st["live"], st["rng"], 256,
                                    st["n_vehicles"])]
        sh = cs.load_sharded(st, S)
        cs.add_broadcast(sh, st["bcast_slots"])
        sh["big"] = [cs.make_topics(st["live"], st["rng"], 256,
                                    st["n_vehicles"])]
        for f, slots in st["bcast_slots"].items():      # as cross_check
            for s in slots:
                st["model"].subscribe(f, s)
        counts, out = cs.mesh_phase(st, sh, device="cpu")
    finally:
        gc.unfreeze()               # the loads froze their heap
    assert counts == {"mesh": {}, "mesh_s4": {}}
    for name in ("mesh", "mesh_s4"):
        o = out[name]
        assert o["dense"]["dense_hits"] > 0 and o["dense_after"]["dense_hits"]
        assert o["plain_256"]["dense_hits"] == 0
        churn = o["churn"]
        assert churn["uploads"] == 1 and churn["patch_launches"] == 4
    assert out["mesh"]["churn"]["one_filter_patch_launches"] == 4
    assert out["mesh_s4"]["churn"]["one_filter_patch_launches"] == 2
    assert out["mesh_s4"]["wide"]["shape"] == [1, 4]
    for name in ("mesh", "mesh_s4"):
        assert set(out[name]["failure"].values()) == {"failed over"}
        assert len(out[name]["failure"]) == 3
    assert st["bcast"] and all(f in st["subs"] for f in st["bcast_slots"])
