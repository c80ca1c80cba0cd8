#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``emqx_tpu_torch``) on one NVIDIA card.

Drives the port's publish routing step through the entry points a broker
calls — ``RouterModel.subscribe / refresh / publish_batch`` — at the
BASELINE config-2 scale (~1M subscriptions of the vehicle-fleet tree,
``bench.py:125-213``), on the flat trie and on the subscription-sharded
trie (``ShardedTrieIndex(4)``), builds the eleven CUDA kernels from
``emqx_tpu_torch/csrc/``, holds every kernel against its plain-torch
version on the card, and checks sampled routing results against the
port's host oracle trie.  Each routing step is two kernel launches: the
trie walk in its compacted mode (``walk_compact``, ``walk_compact_sharded``,
whose epilogue writes the trimmed fids, the overflow flags and, when the
step packs them, the counters, after a memset in the same entry), then
``fanout_pool``, which also sets ``fan_any``; all the outputs lie in one
packed block, copied to the host in one copy.  The walk's candidate-block
mode, its count-only mode (``walk_count``, ``match_counts``) and the two
compact kernels are off the step and are held against their plain
versions in the kernels phase.  The models run with their kernel
telemetry on (the steps pack their counters); the steps with the counters
off are checked and timed beside them.  The serving phase drives the
port's serving plane around a model on the card — ``Broker.publish_batch``
and ``PublishPipeline.submit`` + ``flush``, the entry points the servers
call — with the subscriptions made through ``Broker.subscribe``.

Phases (each one's failure exits non-zero).  Each of the five paths runs
with the launch counts set to 0 just before it and read just after, and
fails if one of its kernels was not launched:

1. device  — print the card's name and power limit (nvidia-smi);
2. build   — nvcc build of the kernels, with its seconds;
3. load    — 1M bench-shape filters, one random slot each, refresh;
4. slice   — (flat path) publish_batch on 8×16384 and 8×64 topics of
             bench.py's plain mix, ≥2048 sampled topics checked against
             the oracle, topics/s and p50/p99 of synchronous steps; then
             24 broadcast filters subscribed to 96 slots each (dense-pool
             rows, which nearly every topic matches), refresh, and the
             same measurements on that dense mix; one step raises the
             launch counts of the walk and of fanout_pool by one each and
             no other, with the counters on and off;
5. churn   — (flat path) 256 subscribes + 256 unsubscribes, one refresh
             through the patch kernel, which reads the update block in
             place from pinned host memory (``refresh_upload_ms`` is the
             host's staging of it); new filters route, removed ones do
             not; then 8 more subscribes and a refresh under
             torch.profiler, whose trace must show the patch kernel and
             no copy;
6. idle    — the card's idle share inside one publish_batch(16384), from a
             torch.profiler trace, which must hold one device-to-host
             copy; then one device step traced between two spin kernels:
             the walk, the fan-out and the memset, and no other kernel,
             with the counters on and off;
7. bitmap  — (bitmap fan-out path) a dense [F, W] subscriber bitmap of
             every (filter, slot) on the card; the dense-mix batches
             published again, their untrimmed [B, 128] fids through
             fanout_bitmaps and bitmap_to_counts, each topic's count equal
             to its decoded slot count outside the fallback rows;
8. sharded — (sharded path) the same subscriptions, broadcast overlay off,
             in RouterModel(ShardedTrieIndex(4)); the slice phases on the
             plain and the dense mix and the churn again, sampled topics
             checked against the oracle and against the flat model; the
             launch counts and the traced steps again;
9. serving — (serving path) the port's Broker over a RouterModel on the
             card, the 1M filters subscribed by 131,072 session ids (16 a
             slot), with a CM holding a recording channel for 4096 of
             them, a PublishPipeline at depth 4 with its knee at its
             default over a model on the card, 0, and a
             DeviceMetricsFold attached as the app attaches it:
             Broker.publish_batch on the plain mix at B=16384 and 64, the
             pipeline flushing on a worker thread while another thread
             subscribes and patches, the fold's cost (telemetry on and
             off in turns), then the dense overlay through the broker at
             B=64 and 16384 and through the pipeline; on ≥2048 sampled
             messages per mix the delivery maps equal the host path's
             (Broker.publish), the channels got what the host path
             routes, in order; no device failover, no host batch, one
             step per device batch, the fold's batches and totals those
             the model handed it; a host-dispatch leg (models on the card
             under EMQX_TPU_CPU_KERNEL=host answer as the step, which auto
             picks; its launches are logged apart and count on no path);
             then (serving_s4 path) the same broker code over
             ShardedTrieIndex(4) at 250,000 filters;
10. kernels — each kernel against its plain version at its path's shapes
             (exact equality), its median time over single launches after
             an L2 flush (``ms``, CUDA events), its time per launch in a
             run of 20 back-to-back launches over 4 rotating copies of its
             batch inputs (``run_ms``), the plain version's time, and the
             bound from this run's bytes and operations, with the walk's
             mean live frontier per level; ``floor_ms``, an empty kernel
             timed as ``ms`` is; the fused routing steps equal their plain
             composites (flat and S=4, B=16384 and 64, ret_cap 16 and
             None), with the counters off too (None, the other four
             outputs those of the counted step, also from a block whose
             bytes were 0xFF first), and a RouterModel with its kernel
             telemetry off hands its telemetry hook None; the steps (with
             the counters on and off) and ``pack_counters`` timed and
             bounded alike on a ``composites`` line; the popcount at
             shapes and an
             alignment that take each path of its kernel, the patch
             kernel from blocks on the card and in pinned memory at caps
             64 to 4096 on the flat and the stacked tables (a pageable
             block must raise); small edge-case tries at S ∈ {1, 4} (K
             and M overflow, '$' topics, C < M, a trie of every {a, +}
             path for wide frontiers) through every walk mode, where one
             shard equals the flat step and each fused step its plain
             composite, and the count-only walk its plain version and the
             candidate walk's count; both fan-outs at shapes and
             alignments that take each path of their gather-OR kernel.

Output: progress lines, then the nvidia-smi line, one JSON line
``{"kernels": [...], "floor_ms": ...}``, and last ``{"ok": true,
"device": {...}}``.  A kernel's ``launches`` is the sum of its launches
over the paths above that list it among their kernels (``PATHS``), each
path's own in ``launches_by_path``.

Run from the root of a checkout, on a machine with one CUDA card and
nvcc::

    python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import functools
import gc
import itertools
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12     # H100 SXM non-tensor float32 peak, the table's
SECTOR = 32                  # bytes of one DRAM sector: what a scattered
                             # 4-byte access really moves (logged beside
                             # the bound, which counts the 4 bytes needed)
SLEEP_CYCLES = 2_000_000     # ~1 ms of idle card ahead of a timed launch
RANK_MAX = 16                # router_kernels.cu kRankMax: next frontiers of
                             # up to this many candidates are ranked

REPLACES = {
    "walk_compact": "emqx_tpu/ops/trie_match.py:213",
    "walk_compact_sharded": "emqx_tpu/ops/trie_match.py:366",
    "trie_walk": "emqx_tpu/ops/trie_match.py:213",
    "compact": "emqx_tpu/ops/trie_match.py:316",
    "fanout_pool": "emqx_tpu/ops/fanout.py:51",
    "patch": "emqx_tpu/models/router_model.py:192",
    "trie_walk_sharded": "emqx_tpu/ops/trie_match.py:366",
    "compact_sharded": "emqx_tpu/ops/trie_match.py:399",
    "fanout_bitmaps": "emqx_tpu/ops/fanout.py:22",
    "bitmap_counts": "emqx_tpu/ops/fanout.py:83",
    "walk_count": "emqx_tpu/ops/trie_match.py:298",
}
# the kernels each path must launch (their counts go on the kernels line)
PATHS = {
    "flat": ("walk_compact", "fanout_pool", "patch"),
    "bitmap": ("fanout_bitmaps", "bitmap_counts"),
    "sharded": ("walk_compact_sharded", "fanout_pool", "patch"),
    "serving": ("walk_compact", "fanout_pool", "patch"),
    "serving_s4": ("walk_compact_sharded", "fanout_pool", "patch"),
}
SOURCE = "emqx_tpu_torch/csrc/router_kernels.cu"
N_FILTERS = 1_000_000        # BASELINE config 2 (~1M subscriptions)
BATCH = 16384                # the step's batch, as bench.py sec_kernel
SHARDS = 4                   # bench.py _tenm_sharded_arm's trie shards
SESSIONS = 131_072           # the serving phase's session ids: 16 a slot
RECORDED = 4096              # of them with a recording channel in the CM
SERVE_S4_FILTERS = 250_000   # the serving phase's S=4 leg, cut in depth


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# the config-2 workload, same shape as bench.py:125-213
# ---------------------------------------------------------------------------


def build_filters(n: int, rng: np.random.Generator) -> list[str]:
    """Vehicle-fleet topic tree, 7 levels deep, ~10% '+' wildcards, a few
    percent '#' (bench.py build_filters)."""
    n_vehicles = max(1000, n // 2)
    kinds = rng.random(n)
    vids = rng.integers(0, n_vehicles, n)
    fleets = rng.integers(0, 512, n)
    metrics = rng.integers(0, 16, n)
    parts = rng.integers(0, 8, n)
    out = []
    for k, v, fl, m, p in zip(kinds.tolist(), vids.tolist(), fleets.tolist(),
                              metrics.tolist(), parts.tolist()):
        if k < 0.80:
            out.append(f"fleet/f{fl}/vehicle/v{v}/part/p{p}/m{m}")
        elif k < 0.90:
            out.append(f"fleet/f{fl}/vehicle/+/part/p{p}/m{m}")
        elif k < 0.95:
            out.append(f"fleet/f{fl}/vehicle/v{v}/part/+/m{m}")
        elif k < 0.98:
            out.append(f"fleet/f{fl}/vehicle/v{v}/#")
        else:
            out.append(f"fleet/+/vehicle/v{v}/part/p{p}/#")
    return out


def make_topics(live: list[str], rng: np.random.Generator, count: int,
                n_vehicles: int) -> list[str]:
    """Publish into the subscribed tree: a random subscribed filter with
    its wildcards instantiated (bench.py make_topics)."""
    picks = rng.integers(0, len(live), count)
    v = rng.integers(0, n_vehicles, count)
    p = rng.integers(0, 8, count)
    m = rng.integers(0, 16, count)
    fl = rng.integers(0, 512, count)
    topics = []
    for i in range(count):
        out = []
        for j, w in enumerate(live[picks[i]].split("/")):
            if w == "+":
                out.append(f"v{v[i]}" if j == 3 else
                           f"p{p[i]}" if j == 5 else f"f{fl[i]}")
            elif w == "#":
                out.extend([f"part/p{p[i]}", f"m{m[i]}"][: 7 - j])
                break
            else:
                out.append(w)
        topics.append("/".join(out))
    return topics


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def pct(xs) -> dict:
    return {"p50_ms": float(np.percentile(xs, 50)),
            "p99_ms": float(np.percentile(xs, 99))}


def time_ms(fn, reps: int, flush=None) -> float:
    """Median device time of ``fn()`` over ``reps`` launches (CUDA events),
    after one warm-up; ``flush()`` runs before each launch, untimed.  A
    sleep kernel queued ahead of the start event keeps the card busy while
    the host queues ``fn``'s launches, so the host's wrapper time stays
    outside the measured window."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def run_ms(fn, inputs: tuple, n: int = 20, copies: int = 4) -> float:
    """Per-launch device time of ``fn(*inputs)`` in a run of ``n``
    back-to-back launches: one CUDA-event pair around the run, divided by
    ``n``, over ``copies`` rotating copies of the batch inputs (the tables
    stay as they are), after one warm-up.  The sleep ahead of the start
    event is lengthened until it outlasts the host's queueing of the run,
    so the card never waits on the host inside the window."""
    import torch

    def copy(x):            # a pinned host input stays pinned
        if not x.is_cuda and x.is_pinned():
            return torch.empty_like(x, pin_memory=True).copy_(x)
        return x.clone()

    sets = [inputs] + [tuple(copy(x) for x in inputs)
                       for _ in range(copies - 1)]
    fn(*inputs)
    cycles = 20 * SLEEP_CYCLES
    while True:
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        a.record()
        for i in range(n):
            fn(*sets[i % copies])
        b.record()
        outran = a.query()          # the sleep ended before the last launch
        b.synchronize()
        if not outran:
            return a.elapsed_time(b) / n
        check(cycles < 1000 * SLEEP_CYCLES, "run_ms: the host cannot queue "
              "the run inside a ~1 s sleep")
        cycles *= 4


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def walk_traffic(tm, trie, tokens, lengths, sys_flags, K: int,
                 max_probes: int) -> dict:
    """What the trie walk needs on these inputs, from a replay of it.

    ``values``: the table values it must read, 4 bytes each in the bound
    (each node field it uses, parent and word per probe round, the child
    on a hit); ``records``: the 16-byte records it loads (a node per live
    lane and level, an edge-table slot per probe round), one 32-byte
    sector each; ``ops``: int32 thread operations (each next-frontier
    selection the kernel makes: ~6 per lane for each of its n live
    candidates and ~6 to place them where n ≤ RANK_MAX, else the 64-wide
    sort network; ~8 per probe round, ~20 per hashed lane); ``ranked`` /
    ``sorts``: the selections made each way; ``live``: the mean live
    frontier per level over all topics and ``walking`` over the topics
    whose frontier is not empty yet."""
    import torch
    B, L = tokens.shape
    toks = torch.cat([tokens, torch.zeros_like(tokens[:, :1])], 1)
    frontier = torch.full((B, K), -1, dtype=torch.int32, device=tokens.device)
    frontier[:, 0] = 0
    last = lengths.clamp(0, L)
    values = records = probes = lanes = ranked = sorts = select_ops = 0
    live, walking = [], []
    for i in range(L + 1):
        valid = frontier >= 0
        n_live = valid.sum(1)
        live.append(float(n_live.float().mean()))
        walking.append(float(n_live[n_live > 0].float().mean())
                       if bool((n_live > 0).any()) else 0.0)
        node = torch.where(valid, frontier, 0).long()
        adv = (i < lengths)[:, None]
        open_ = ~(sys_flags & (i == 0))[:, None]
        values += int((valid & (i <= lengths)[:, None] & open_).sum()
                      + (valid & (i == lengths)[:, None]).sum()
                      + (valid & adv & open_).sum())
        records += int(valid.sum())
        exact, iters = tm._probe_exact(trie, torch.where(adv, frontier, -1),
                                       toks[:, i:i + 1].expand(B, K),
                                       max_probes)
        n_it = int(iters.sum())
        probes += n_it
        records += n_it
        lanes += int((valid & adv).sum())
        values += 2 * n_it + int((exact >= 0).sum())
        plus = torch.where(valid & adv & open_, trie.plus_child[node], -1)
        nxt = torch.cat([exact, plus], 1)
        n_next = (nxt >= 0).sum(1)
        selects = (i < last) & (n_next > 0)
        rank = selects & (n_next <= RANK_MAX)
        ranked += int(rank.sum())
        sorts += int((selects & ~rank).sum())
        select_ops += int((n_next[rank] + 1).sum()) * 32 * 6
        frontier = torch.sort(nxt, dim=1, descending=True).values[:, :K]
    # the network: 21 compare-exchange stages over 64 values (shuffle,
    # compare, select)
    ops = select_ops + sorts * 64 * 21 * 3 + probes * 8 + lanes * 20
    return dict(values=values, records=records, ops=ops, ranked=ranked,
                sorts=sorts, live=live, walking=walking)


def walk_bytes(traffic: dict, B: int, L: int, out_bytes: int,
               inputs: bool = True) -> tuple[int, int]:
    """(needed bytes, bytes with a 32-byte sector per record) of a walk:
    the topic inputs (when ``inputs``), its outputs and its table reads."""
    io = (B * (L * 4 + 4 + 1) if inputs else 0) + out_bytes
    return (io + traffic["values"] * 4,
            io + traffic["records"] * SECTOR)


def fanout_pool_work(rowmap, pool, fids) -> tuple[int, int, int]:
    """(bytes, operations, scattered accesses) that ``fanout_pool`` needs
    on these inputs: the fids, a rowmap word per valid fid, each used pool
    row once and the output; a compare and a select per fid and an OR per
    word of each selected row; a scattered rowmap word per valid fid."""
    import torch
    B, M = fids.shape
    W = pool.shape[1]
    valid = fids >= 0
    prow = rowmap[torch.where(valid, fids, 0).long()]
    dense = valid & (prow >= 0)
    used = torch.unique(prow[dense])
    return (B * M * 4 + int(valid.sum()) * 4 + used.numel() * W * 4
            + B * W * 4, B * M * 2 + int(dense.sum()) * W, int(valid.sum()))


def fanout_bitmaps_work(bitmaps, fids) -> tuple[int, int, int]:
    """The same for ``fanout_bitmaps``: the fids, each used bitmap row once
    and the output; one scattered row per valid fid."""
    import torch
    B, M = fids.shape
    F, W = bitmaps.shape
    valid = (fids >= 0) & (fids < F)
    rows = torch.unique(fids[valid]).numel()
    return (B * M * 4 + rows * W * 4 + B * W * 4,
            B * M * 2 + int(valid.sum()) * W, int(valid.sum()))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def load(n_filters: int, seed: int, device) -> dict:
    from emqx_tpu_torch import RouterModel, TrieIndex
    from emqx_tpu_torch.router.trie import Trie
    rng = np.random.default_rng(seed)
    t0 = time.time()
    filters = build_filters(n_filters, rng)
    slot_of = rng.integers(0, 8192, len(filters)).tolist()
    model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=8192, K=32,
                        M=128, kernel_telemetry=True, device=device)
    subs: dict[str, dict[int, int]] = {}
    for f, s in zip(filters, slot_of):
        model.subscribe(f, s)
        d = subs.setdefault(f, {})
        d[s] = d.get(s, 0) + 1
    t1 = time.time()
    model.refresh()
    torch_sync(device)
    t2 = time.time()
    oracle = Trie()
    for f in subs:
        oracle.insert(f)
    t3 = time.time()
    arrays = model.index.arrays
    trie = model._trie_dev
    log(f"load: {len(subs)} distinct filters, {arrays.n_nodes} nodes, "
        f"H={arrays.ht_parent.shape[0]} N={arrays.plus_child.shape[0]}, "
        f"trie records {(trie.edges.numel() + trie.nodes.numel()) * 4} "
        f"bytes; "
        f"subscribe {t1 - t0:.1f}s, refresh (build + upload) "
        f"{t2 - t1:.1f}s, oracle {t3 - t2:.1f}s")
    live = [f for f in model.index.filters if f is not None]
    # the set-up heap (the oracle's ~7M nodes and dicts above all) is the
    # smoke's, not the router's: freeze it so the cyclic GC does not walk
    # it for seconds inside the timed phases
    gc.collect()
    gc.freeze()
    return dict(model=model, subs=subs, oracle=oracle, rng=rng, live=live,
                n_vehicles=max(1000, n_filters // 2), bcast=set())


def add_broadcast(st: dict, slots: dict | None = None) -> None:
    """Subscribe 24 broadcast filters to 96 slots each (>64: promoted into
    the dense pool) and refresh.  ``fleet/+/vehicle/+/part/+/m{m}`` for all
    16 metrics matches nearly every 7-level topic, so this is the
    heavy-fan-out mix, not bench.py's own.  ``slots`` repeats an earlier
    overlay's slots."""
    model, rng, subs = st["model"], st["rng"], st["subs"]
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)] + [
        f"fleet/f{fl}/#" for fl in range(0, 512, 64)]
    if slots is None:
        slots = {f: rng.choice(8192, 96, replace=False).tolist()
                 for f in bcast}
    for f in bcast:
        check(f not in subs, f"broadcast filter {f!r} is already subscribed")
        st["oracle"].insert(f)
        subs[f] = dict.fromkeys(slots[f], 1)
        for s in slots[f]:
            model.subscribe(f, s)
    model.refresh()
    torch_sync(model.device)
    check(len(model._dense_row) >= 16, "broadcast filters not promoted")
    st["bcast"], st["bcast_slots"] = set(bcast), slots


def remove_broadcast(st: dict) -> None:
    """Take the broadcast overlay off the model, the oracle and the
    subscription table: back to the plain mix's subscriptions."""
    model, subs = st["model"], st["subs"]
    for f in st["bcast"]:
        for s in subs.pop(f):
            model.unsubscribe(f, s)
        st["oracle"].delete(f)
    model.refresh()
    torch_sync(model.device)
    st["bcast"] = set()


def run_step(model, args, ret_cap: int | None, with_counters: bool = True):
    """The model's device step (flat or sharded) on uploaded ``(tokens,
    lengths, sys_flags)``, its counters packed unless ``with_counters`` is
    False."""
    return model._step(
        model._trie_dev, model._rowmap_dev, model._pool_dev, *args,
        K=model.K, M=model.M, max_probes=model.index.max_probes,
        ret_cap=ret_cap, with_counters=with_counters)


def path_counts(name: str) -> dict:
    """Read the launch counts after a path and check that it launched each
    of its kernels."""
    import torch

    from emqx_tpu_torch.ops import _build
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"launches on the {name} path: {json.dumps(counts)}")
    missing = [k for k in PATHS[name] if counts[k] == 0]
    check(not missing, f"the {name} path launched no {missing}: {counts}")
    return {k: counts[k] for k in PATHS[name]}


def step_launches(st: dict) -> dict:
    """One device step on the dense mix's first batch, with the counters
    on and then off: each must raise the launch counts of its walk and of
    fanout_pool by exactly one each, and no other."""
    import torch

    from emqx_tpu_torch.ops import _build
    model = st["model"]
    tok, lens, sysf, _ = model.index.tokenize(st["big"][0])
    args = [torch.from_numpy(x).to(model.device) for x in (tok, lens, sysf)]
    walk = "walk_compact_sharded" if model._sharded else "walk_compact"
    for with_counters in (True, False):
        before = _build.launch_counts()
        run_step(model, args, model.ret_cap, with_counters)
        torch_sync(model.device)
        delta = {k: v - before[k] for k, v in _build.launch_counts().items()
                 if v != before[k]}
        check(delta == {walk: 1, "fanout_pool": 1},
              f"one step (counters {with_counters}) launched {delta}, not "
              f"its walk and fanout_pool once")
    log(f"step launches ({st.get('name', 'flat')} trie, counters on and "
        f"off): {json.dumps(delta)}")
    return delta


def spin_traced(prepare, what: str) -> tuple[list[str], int]:
    """The device events of ``prepare(attempt)()`` under torch.profiler,
    between two spin kernels that bracket it on the card's clock, and the
    sessions it took.  A session that kept fewer than both spins dropped
    device events near its edges (sessions opened minutes into a long
    process have done so) and is repeated with more idle host time around
    the work, at most three times; ``prepare`` runs before each session,
    untraced."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for attempt, pad_s in enumerate((0.2, 1.0, 3.0, 10.0)):
        work = prepare(attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(pad_s)
            work()
            torch.cuda.synchronize()
            time.sleep(pad_s)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == cuda]
        spins = sum("spin_kernel" in n for n in names)
        if spins == 2:
            return [n for n in names if "spin_kernel" not in n], attempt + 1
        log(f"{what}: the trace kept {spins} of its 2 spin kernels with "
            f"{pad_s} s around it; again")
    raise SmokeFailure(f"the profiler kept no whole trace of {what}")


def traced_step(st: dict, with_counters: bool = True) -> dict:
    """One device step on the dense mix's first batch (uploaded), traced
    by :func:`spin_traced`: the device must run the walk, the memset of
    the counters and fan_any (of fan_any alone with the counters off), and
    the fan-out, and no other kernel or copy."""
    import torch
    model, tag = st["model"], st.get("name", "flat")
    tag = f"{tag} trie, counters {'on' if with_counters else 'off'}"
    tok, lens, sysf, _ = model.index.tokenize(st["big"][0])
    args = [torch.from_numpy(x).to(model.device) for x in (tok, lens, sysf)]
    run_step(model, args, model.ret_cap, with_counters)
    work, sessions = spin_traced(
        lambda _: lambda: run_step(model, args, model.ret_cap, with_counters),
        f"traced step ({tag})")
    kinds = [sum(k in n for n in work)
             for k in ("walk_compact_kernel", "Memset", "row_or_kernel<true")]
    check(kinds == [1, 1, 1] and len(work) == 3,
          f"the traced step ({tag}) ran {work}, not the walk, the memset "
          f"and the fan-out once each")
    out = {"device_events": work, "sessions": sessions}
    log(f"traced step ({tag}): " + json.dumps(out))
    return out


def torch_sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_against_oracle(st: dict, topics, result, sample) -> int:
    matched, _aux, slots, fallback = result
    model, oracle, subs = st["model"], st["oracle"], st["subs"]
    fb = set(fallback)
    L = model.index.max_levels
    for b in sample:
        want = set(oracle.match(topics[b]))
        if b in fb:
            check(len(topics[b].split("/")) > L or len(want) > model.ret_cap,
                  f"fallback row {b} ({topics[b]!r}) is neither too long "
                  f"nor over ret_cap")
            continue
        check(set(matched[b]) == want and len(matched[b]) == len(want),
              f"topic {topics[b]!r}: matched {sorted(matched[b])} != oracle "
              f"{sorted(want)}")
        want_slots = sorted({s for f in want for s in subs[f]})
        check(slots[b] == want_slots,
              f"topic {topics[b]!r}: slots differ from the oracle's")
    return len(sample)


def slice_phase(st: dict, batch: int, mix: str, n_big: int = 8,
                n_small: int = 8, lat_big: int = 20,
                lat_small: int = 200) -> dict:
    """publish_batch and the device step at ``batch`` and 64 topics.  Where
    ``st`` holds a ``cross`` list, the checked topics and their results are
    kept there for :func:`cross_check`."""
    import torch
    model, rng = st["model"], st["rng"]
    big = [make_topics(st["live"], rng, batch, st["n_vehicles"])
           for _ in range(n_big)]
    small = [make_topics(st["live"], rng, 64, st["n_vehicles"])
             for _ in range(n_small)]
    checked = 0
    t0 = time.time()
    results = [model.publish_batch(t) for t in big]
    t_big = time.time() - t0
    cross = st.get("cross")          # set on the sharded phase's state
    for topics, res in zip(big, results):
        sample = rng.choice(len(topics), min(len(topics), -(-2048 // n_big)),
                            replace=False).tolist()
        checked += check_against_oracle(st, topics, res, sample)
        if cross is not None:
            cross.append((mix, [topics[b] for b in sample],
                          [tuple(r[b] for r in res[:3]) for b in sample],
                          {sample.index(b) for b in res[3] if b in sample}))
    n_fallback = sum(len(r[3]) for r in results)
    for topics in small:
        checked += check_against_oracle(st, topics, model.publish_batch(
            topics), range(len(topics)))
    check(checked >= 2048, f"only {checked} topics checked")
    dense_hit = sum(bool(set(m) & st["bcast"]) for r in results
                    for m in r[0])
    check(dense_hit > 0 or not st["bcast"],
          "no topic matched a dense-pool filter")
    slots_per_topic = float(np.mean([len(x) for r in results for x in r[2]]))
    del results

    class Stages:           # the model's telemetry hook: per-batch stages
        def __init__(self):
            self.by_b: dict[int, list] = {}

        def on_batch(self, counters, *, n_topics, submit_ns, step_ns,
                     decode_ns, **_):
            self.by_b.setdefault(n_topics, []).append(
                (submit_ns / 1e6, step_ns / 1e6, decode_ns / 1e6))

    stages = Stages()
    model.telemetry = stages

    # synchronous latencies: publish_batch end to end (host clock), and
    # the device step alone on uploaded tokens
    def lat(topics_list, reps):
        ts = []
        for i in range(reps):
            t = time.perf_counter()
            model.publish_batch(topics_list[i % len(topics_list)])
            ts.append((time.perf_counter() - t) * 1e3)
        return ts

    def step_args(topics):
        tok, lens, sysf, _ = model.index.tokenize(topics)
        dev = model.device
        return [torch.from_numpy(x).to(dev) for x in (tok, lens, sysf)]

    def step_lat(args_list, reps):
        ts = []
        for i in range(reps):
            torch_sync(model.device)
            t = time.perf_counter()
            run_step(model, args_list[i % len(args_list)], model.ret_cap)
            torch_sync(model.device)
            ts.append((time.perf_counter() - t) * 1e3)
        return ts

    pub_big, pub_small = lat(big, lat_big), lat(small, lat_small)
    model.telemetry = None
    big_args = [step_args(t) for t in big]
    small_args = [step_args(t) for t in small]
    step_big, step_small = step_lat(big_args, lat_big), \
        step_lat(small_args, lat_small)
    # device-step throughput: 8 launches in flight, synchronised at the end
    torch_sync(model.device)
    t = time.perf_counter()
    for _ in range(4):
        for a in big_args:
            run_step(model, a, model.ret_cap)
    torch_sync(model.device)
    step_tps = 4 * len(big_args) * batch / (time.perf_counter() - t)

    out = {
        "publish_topics_per_s": n_big * batch / t_big,
        "step_topics_per_s": step_tps,
        f"publish_{batch}": pct(pub_big), "publish_64": pct(pub_small),
        f"step_{batch}": pct(step_big), "step_64": pct(step_small),
        "checked_topics": checked, "fallback_rows": n_fallback,
        "dense_matched_topics": dense_hit,
        "slots_per_topic": slots_per_topic,
    }
    # median submit (tokenize + upload + launch), wait (device step and
    # copy back) and decode, in ms, per publish_batch size
    for n, rows in stages.by_b.items():
        med = np.median(np.asarray(rows), axis=0).tolist()
        out[f"publish_{n}_stages_ms"] = dict(zip(
            ("submit", "wait", "decode"), med))
    log(f"slice ({st.get('name', 'flat')} trie, {mix} mix): "
        + json.dumps(out))
    st["big"] = big
    return out


def churn_phase(st: dict) -> dict:
    import torch

    from emqx_tpu_torch.models import router_model as rm
    model, rng, subs, oracle = st["model"], st["rng"], st["subs"], \
        st["oracle"]
    tag = st.get("name", "flat")         # each churn adds its own filters
    new = sorted({f"fleet/f{fl}/vehicle/v{tag}{i}/part/p{i % 8}/m{i % 16}"
                  if i % 4 else
                  f"fleet/f{fl}/vehicle/v{tag}{i}/part/+/m{i % 16}"
                  for i, fl in enumerate(rng.integers(0, 512, 256).tolist())})
    candidates = [f for f, s in subs.items()
                  if "+" not in f and "#" not in f and len(s) == 1]
    gone = [candidates[i] for i in
            rng.choice(len(candidates), 256, replace=False).tolist()]
    uploads, patches = model.upload_count, model.patch_count
    for i, f in enumerate(new):
        model.subscribe(f, i)
        subs[f] = {i: 1}
        oracle.insert(f)
    for f in gone:
        for s, c in subs.pop(f).items():
            for _ in range(c):
                model.unsubscribe(f, s)
        oracle.delete(f)
    shards = getattr(model.index, "shards", [model.index])
    pending = max(sum(len(ix.pending[n]) for ix in shards)
                  for n in shards[0].pending)
    cap = rm._patch_bucket(max(pending, len(model._rowmap_dirty),
                               len(model._pool_dirty)))
    # the refresh's host part and any cyclic-GC pause inside the window
    # are logged beside its total, to tell host, GC and device time apart
    gc_ms = []

    def on_gc(phase, _info, start=[0.0]):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            gc_ms.append((time.perf_counter() - start[0]) * 1e3)

    gc.callbacks.append(on_gc)
    staged_ns = model.patch_upload_ns
    try:
        t = time.perf_counter()
        model.refresh()
        host_ms = (time.perf_counter() - t) * 1e3
        torch_sync(model.device)
        refresh_ms = (time.perf_counter() - t) * 1e3
    finally:
        gc.callbacks.remove(on_gc)
    check(model.upload_count == uploads,
          "churn refresh re-uploaded the tables instead of patching")
    check(model.patch_count == patches + 1, "churn refresh did not patch")
    probe = [f.replace("+", "p3") for f in new] + gone
    matched, _, slots, fallback = model.publish_batch(probe)
    check(not fallback, f"fallback rows in the churn probe: {fallback}")
    for b, f in enumerate(new):
        check(f in matched[b] and b in slots[b],
              f"new filter {f!r} does not route")
    for b, f in enumerate(gone, start=len(new)):
        check(f not in matched[b], f"removed filter {f!r} still routes")
    check_against_oracle(st, probe, (matched, _, slots, fallback),
                         range(len(probe)))
    out = {"subscribed": len(new), "unsubscribed": len(gone),
           "refresh_ms": refresh_ms, "refresh_host_ms": host_ms,
           "refresh_upload_ms": (model.patch_upload_ns - staged_ns) / 1e6,
           "gc_ms_in_refresh": sum(gc_ms), "patch_cap": cap}
    if torch.device(model.device).type == "cuda":
        out["traced_refresh"] = traced_refresh(st)
    log(f"churn ({tag} trie): " + json.dumps(out))
    return out


def traced_refresh(st: dict) -> dict:
    """8 more subscribes, then one refresh traced by :func:`spin_traced`:
    the session must hold the patch kernel and no copy (the kernel reads
    the pinned update block in place), and the new filters must route
    after it."""
    model, tag = st["model"], st.get("name", "flat")
    new = []

    def prepare(attempt):
        new[:] = [f"fleet/f{i}/vehicle/v{tag}t{attempt}{i}/part/p1/m1"
                  for i in range(8)]
        for i, f in enumerate(new):
            model.subscribe(f, 100 + i)
        patches = model.patch_count

        def work():
            model.refresh()
            check(model.patch_count == patches + 1,
                  "traced refresh did not patch")
        return work

    names, sessions = spin_traced(prepare, f"traced refresh ({tag} trie)")
    copies = [n for n in names if "Memcpy" in n or "HtoD" in n]
    check(any("patch_kernel" in n for n in names),
          f"the traced refresh shows no patch kernel: {names}")
    check(not copies, f"the traced refresh copies to the card: {copies}")
    matched, _, slots, _ = model.publish_batch(new)
    for b, f in enumerate(new):
        check(f in matched[b] and 100 + b in slots[b],
              f"new filter {f!r} does not route after the traced refresh")
    return {"device_events": names, "memcpy": len(copies),
            "sessions": sessions}


def dense_bitmaps(model, subs: dict):
    """The dense ``[F, W]`` subscriber bitmap of every (filter, slot) of
    the subscription table, F = the model's fid space, on its device."""
    import torch
    F, W = len(model.index.filters), model.bitmap_words
    fids, slots = [], []
    for f, d in subs.items():
        fid = model.index.fid_of(f)
        check(fid is not None, f"subscribed filter {f!r} has no fid")
        fids += [fid] * len(d)
        slots += list(d)
    fids, slots = np.asarray(fids, np.int64), np.asarray(slots, np.int64)
    key = fids * W + slots // 32
    bit = np.left_shift(np.uint64(1), (slots % 32).astype(np.uint64))
    order = np.argsort(key, kind="stable")
    key, bit = key[order], bit[order]
    uniq, start = np.unique(key, return_index=True)
    words = np.zeros(F * W, np.uint32)
    words[uniq] = np.bitwise_or.reduceat(bit, start).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).reshape(F, W)).to(
        model.device)


def bitmap_phase(st: dict) -> dict:
    """The heavy-fan-out form on the flat model: a dense bitmap row per
    filter, ORed by fanout_bitmaps over each topic's untrimmed [B, M]
    compacted fids and counted by bitmap_to_counts.  The dense-mix batches
    are published again (the churn changed the table since the slice);
    each batch's counts must equal the plain popcount's, and each topic's
    count its decoded slot count outside the fallback rows."""
    import torch

    from emqx_tpu_torch.ops import fanout as fo
    model = st["model"]
    t = time.time()
    bitmaps = dense_bitmaps(model, st["subs"])
    torch_sync(model.device)
    t_build = time.time() - t
    checked = n_fallback = 0
    first = None
    for topics in st["big"]:
        _, _, slots, fallback = model.publish_batch(topics)
        tok, lens, sysf, _ = model.index.tokenize(topics)
        args = [torch.from_numpy(x).to(model.device)
                for x in (tok, lens, sysf)]
        fids = run_step(model, args, ret_cap=None)[0]
        fan = fo.fanout_bitmaps(bitmaps, fids)
        counts = fo.bitmap_to_counts(fan)
        check(torch.equal(counts, fo.bitmap_to_counts_plain(fan)),
              "bitmap_to_counts != plain on a bitmap-path batch")
        counts = counts.cpu().numpy()
        fb = set(fallback)
        for b in range(len(topics)):
            if b in fb:
                continue
            check(counts[b] == len(slots[b]),
                  f"topic {topics[b]!r}: bitmap count {counts[b]} != "
                  f"{len(slots[b])} decoded slots")
            checked += 1
        n_fallback += len(fb)
        if first is None:
            first = dict(bitmaps=bitmaps, fids=fids, fan=fan)
    out = {"filters": bitmaps.shape[0], "words": bitmaps.shape[1],
           "bitmap_bytes": bitmaps.numel() * 4, "build_s": t_build,
           "checked_topics": checked, "fallback_rows": n_fallback,
           "fids_width": first["fids"].shape[1]}
    log("bitmap: " + json.dumps(out))
    check(checked >= 2048, f"only {checked} bitmap counts checked")
    return first


def load_sharded(st: dict, n_shards: int) -> dict:
    """The flat model's subscriptions (broadcast overlay off) in a
    RouterModel on ShardedTrieIndex(n_shards), refreshed; returns its
    phase state, which shares the oracle and the subscription table."""
    from emqx_tpu_torch import RouterModel, ShardedTrieIndex
    remove_broadcast(st)
    t0 = time.time()
    model = RouterModel(ShardedTrieIndex(n_shards, max_levels=8),
                        n_sub_slots=8192, K=32, M=128, kernel_telemetry=True,
                        device=st["model"].device)
    for f, d in st["subs"].items():
        for s, c in d.items():
            for _ in range(c):
                model.subscribe(f, s)
    t1 = time.time()
    model.refresh()
    torch_sync(model.device)
    t2 = time.time()
    trie = model._trie_dev
    info = {
        "shards": n_shards,
        "filters": [sum(f is not None for f in ix.filters)
                    for ix in model.index.shards],
        "nodes": [ix.arrays.n_nodes for ix in model.index.shards],
        "shard_N": [ix.arrays.plus_child.shape[0]
                    for ix in model.index.shards],
        "H": trie.edges.shape[1], "padded_N": trie.nodes.shape[1],
        "stacked_bytes": (trie.edges.numel() + trie.nodes.numel()) * 4,
        "fid_space": len(model.index.filters),
        "rebuilds": model.index.rebuild_count,
        "subscribe_s": t1 - t0, "refresh_s": t2 - t1,
    }
    log("load (sharded trie): " + json.dumps(info))
    gc.collect()
    gc.freeze()
    return dict(st, model=model, flat=st["model"], name=f"s{n_shards}",
                bcast=set(), cross=[])


def cross_check(sh: dict, bcast_slots: dict) -> int:
    """The sharded model's checked topics against the flat model's
    results: the same matched filters (as sets: the sharded merge is
    shard-major) and slots, outside the union of both fallback sets.  The
    flat model holds the plain mix's subscriptions, as the sharded one did
    in its plain slice; it gets the same broadcast overlay before the
    dense mix's topics."""
    flat = sh["flat"]
    n = 0
    for mix, topics, got, fb_sh in sorted(sh["cross"], key=lambda c:
                                          c[0] != "plain"):
        if mix == "dense" and not flat._dense_row:
            for f, slots in bcast_slots.items():
                for s in slots:
                    flat.subscribe(f, s)
            flat.refresh()
        matched, _, slots, fallback = flat.publish_batch(topics)
        skip = fb_sh | set(fallback)
        for i, (m, _aux, sl) in enumerate(got):
            if i in skip:
                continue
            check(sorted(m) == sorted(matched[i]) and sl == slots[i],
                  f"{mix} topic {topics[i]!r}: sharded {sorted(m)} / "
                  f"{len(sl)} slots != flat {sorted(matched[i])} / "
                  f"{len(slots[i])} slots")
            n += 1
    log(f"sharded vs flat: {n} topics agree outside the fallback rows")
    check(n >= 2048, f"only {n} topics cross-checked")
    return n


def idle_phase(st: dict) -> dict:
    """The card's idle share inside one ``publish_batch`` of the dense mix,
    from a torch.profiler trace: 1 - (union of the device's kernel and copy
    intervals that fall inside the call) / the call's span, both on the
    trace's clock.  A trace with no device event is reported as not
    measured, not as an idle card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    model, topics = st["model"], st["big"][0]
    model.publish_batch(topics)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke_publish_batch"):
            model.publish_batch(topics)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the range shows up twice: on the host, and as a device-side
    # annotation that is no device work of its own
    call = [e for e in events if e.name == "smoke_publish_batch"
            and e.device_type != cuda]
    check(len(call) == 1, "the profiler lost the publish_batch span")
    lo, hi = call[0].time_range.start, call[0].time_range.end
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events
                   if e.device_type == cuda and e.name != call[0].name
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    dtoh = sum("DtoH" in e.name for e in events if e.device_type == cuda
               and e.time_range.end > lo and e.time_range.start < hi)
    out = {"batch": len(topics), "call_ms": (hi - lo) / 1e3,
           "device_events": len(spans), "device_busy_ms": busy / 1e3,
           "idle_share": 1 - busy / (hi - lo) if spans else None,
           "dtoh_copies": dtoh if spans else None}
    log(("idle: " if spans else "idle: not measured (no device event in "
         "the trace): ") + json.dumps(out))
    check(not spans or dtoh == 1, f"publish_batch copied its results back "
          f"in {dtoh} copies, not in one")
    return out


def small_tries(tm, fo, device) -> int:
    """Kernel == plain on small random tries that reach the edge rows:
    '$' topics, empty and unknown levels, too-long topics, K=4 overflow,
    M=8 truncation, C < M (K=4, L=5: C=48 < M=128); both walk modes and
    the compacts, and the sharded ones on the same filters at S ∈ {1, 4},
    where one shard's step equals the flat step bit for bit; then a trie
    of every ``{a, +}`` path, whose frontiers double per level, so the
    walk selects next frontiers both ways (ranked and by the sort
    network, checked by replay); the count-only walk against its plain
    version and the candidate walk's count; the fused steps with the
    counters on and off; the bitmap kernels on random bitmaps, and both
    fan-outs at the shapes of :func:`fanout_shapes`."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
    rng = np.random.default_rng(7)
    alphabet = ["a", "b", "c", "", "$SYS", "+", "#"]

    def random_case(levels):
        filters = []
        for _ in range(3000):
            ws = [alphabet[i] for i in rng.integers(0, 7, rng.integers(1, 8))]
            if "#" in ws:
                ws = ws[: ws.index("#") + 1]
            filters.append("/".join(ws))
        # 999 topics: a ragged last block in every launch
        topics = ["/".join(alphabet[i] if i < 5 else "zz" for i in
                           rng.integers(0, 6, rng.integers(1, levels + 3)))
                  for _ in range(999)]
        return filters, topics

    def wide_case(levels):
        paths = [[]]
        for _ in range(levels):
            paths = [p + [w] for p in paths for w in ("a", "+")]
        filters = sorted({"/".join(p[:n]) + tail for p in paths
                          for n in range(1, levels + 1)
                          for tail in ("", "/#")})
        topics = ["/".join(rng.choice(["a", "b"], rng.integers(1, levels + 1),
                                      p=[0.9, 0.1])) for _ in range(999)]
        return filters, topics

    cases = [(random_case, K, M, levels) for K, M, levels in
             [(32, 128, 6), (4, 8, 6), (8, 16, 5), (32, 8, 8), (4, 128, 5)]]
    cases += [(wide_case, 32, 128, 6), (wide_case, 16, 8, 6)]
    n = ranked = sorts = 0
    for make, K, M, levels in cases:
        filters, topics = make(levels)
        ix = TrieIndex(max_levels=levels)
        sharded = {S: ShardedTrieIndex(S, max_levels=levels) for S in (1, 4)}
        for f in filters:
            if f:
                ix.insert(f)
                for six in sharded.values():
                    six.insert(f)
        tok, lens, sysf, _ = ix.tokenize(topics)
        args = [torch.from_numpy(x).to(device) for x in (tok, lens, sysf)]
        trie = tm.device_trie(ix.ensure(), device)
        traffic = walk_traffic(tm, trie, *args, K, ix.max_probes)
        ranked += traffic["ranked"]
        sorts += traffic["sorts"]
        cand, stats = tm.match_batch_stats(trie, *args, K=K,
                                           max_probes=ix.max_probes)
        want = tm.match_batch_plain(trie, *args, K=K,
                                    max_probes=ix.max_probes)
        check(torch.equal(cand, want[0]) and torch.equal(stats, want[1]),
              f"trie walk != plain on a small trie (K={K})")
        fids, trunc = tm.compact_fids(cand, M=M)
        wf, wt = tm.compact_fids_plain(cand, M=M)
        check(torch.equal(fids, wf) and torch.equal(trunc, wt),
              f"compact != plain on a small trie (M={M})")
        got = tm.match_compact(trie, *args, K=K, M=M,
                               max_probes=ix.max_probes)
        want = tm.match_compact_plain(trie, *args, K=K, M=M,
                                      max_probes=ix.max_probes)
        check(all(torch.equal(g, w) for g, w in zip(got, want))
              and torch.equal(got[0], fids),
              f"walk_compact != plain on a small trie (K={K}, M={M})")
        got = tm.match_counts(trie, *args, K=K, max_probes=ix.max_probes)
        want = tm.match_counts_plain(trie, *args, K=K,
                                     max_probes=ix.max_probes)
        check(all(torch.equal(g, w) for g, w in zip(got, want))
              and torch.equal(got[0], (cand >= 0).sum(1, dtype=torch.int32))
              and torch.equal(got[1], stats[:, 3] != 0),
              f"walk_count != plain or the cand walk's count on a small "
              f"trie (K={K})")
        F = len(ix.filters) + 8
        rowmap = torch.full((F,), -1, dtype=torch.int32)
        rowmap[torch.from_numpy(rng.choice(F, 40, replace=False))] = \
            torch.arange(40, dtype=torch.int32)
        pool = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (64, 7))
                                .astype(np.int32))
        rowmap, pool = rowmap.to(device), pool.to(device)
        check(torch.equal(fo.fanout_pool(rowmap, pool, fids),
                          fo.fanout_pool_plain(rowmap, pool, fids)),
              "fanout != plain on a small trie")
        for ret_cap, wc in ((4, True), (None, True), (4, False)):
            kw = dict(K=K, M=M, max_probes=ix.max_probes, ret_cap=ret_cap,
                      with_counters=wc)
            check(steps_equal(rm.router_step(trie, rowmap, pool, *args, **kw),
                              rm.router_step_plain(trie, rowmap, pool, *args,
                                                   **kw)),
                  f"fused step != plain on a small trie (K={K}, M={M}, "
                  f"ret_cap={ret_cap}, counters {wc})")
        if K == 4 and M == 8:
            check(bool(stats[:, 3].any()) and bool(trunc.any()),
                  "small tries reach no overflow or truncation")
        for S, six in sharded.items():
            strie = tm.stacked_device_trie(six.ensure(), device)
            scand, sstats = tm.match_batch_sharded_stats(
                strie, *args, K=K, max_probes=six.max_probes)
            want = tm.match_batch_sharded_plain(strie, *args, K=K,
                                                max_probes=six.max_probes)
            check(torch.equal(scand, want[0]) and torch.equal(sstats, want[1]),
                  f"sharded walk != plain on a small trie (S={S}, K={K})")
            got = tm.compact_sharded(scand, M=M, n_shards=S)
            want = tm.compact_sharded_plain(scand, M=M, n_shards=S)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"sharded compact != plain on a small trie (S={S}, M={M})")
            got = tm.match_compact_sharded(strie, *args, n_shards=S, K=K,
                                           M=M, max_probes=six.max_probes)
            want = tm.match_compact_sharded_plain(
                strie, *args, n_shards=S, K=K, M=M,
                max_probes=six.max_probes)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"walk_compact_sharded != plain on a small trie (S={S}, "
                  f"K={K}, M={M})")
            if K == 4 and M == 8:
                check(bool(got[2].any()),
                      f"small sharded tries reach no truncation (S={S})")
            for ret_cap, wc in ((4, True), (None, True), (4, False)):
                kw = dict(K=K, M=M, max_probes=six.max_probes,
                          ret_cap=ret_cap, n_shards=S, with_counters=wc)
                check(steps_equal(
                    rm.router_step_sharded(strie, rowmap, pool, *args, **kw),
                    rm.router_step_sharded_plain(strie, rowmap, pool, *args,
                                                 **kw)),
                      f"fused sharded step != plain on a small trie (S={S}, "
                      f"K={K}, M={M}, ret_cap={ret_cap}, counters {wc})")
            if S == 1:
                kw = dict(K=K, M=M, max_probes=ix.max_probes, ret_cap=4,
                          with_counters=True)
                flat = rm.router_step(trie, rowmap, pool, *args, **kw)
                one = rm.router_step_sharded(strie, rowmap, pool, *args,
                                             n_shards=1, **kw)
                check(all(torch.equal(a, b) for a, b in zip(flat[:4], one))
                      and torch.equal(flat[4], one[4][0]),
                      f"one-shard step != flat step (K={K}, M={M})")
        n += 1
    check(ranked > 0 and sorts > 0, f"the small tries select next frontiers "
          f"{ranked} times ranked and {sorts} times by the network")
    log(f"small tries: {ranked} ranked and {sorts} network selections")
    bitmaps = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (500, 7))
                               .astype(np.int32)).to(device)
    fids = torch.from_numpy(rng.integers(-1, 500, (300, 40))
                            .astype(np.int32)).to(device)
    fan = fo.fanout_bitmaps(bitmaps, fids)
    check(torch.equal(fan, fo.fanout_bitmaps_plain(bitmaps, fids)),
          "fanout_bitmaps != plain on random bitmaps")
    check(torch.equal(fo.bitmap_to_counts(fan),
                      fo.bitmap_to_counts_plain(fan)),
          "bitmap_to_counts != plain on random bitmaps")
    log(f"fan-out shapes: {fanout_shapes(fo, device, rng)} agree")
    return n


def steps_equal(got, want) -> bool:
    """The five step outputs equal, dtypes and shapes included (counters
    None on both sides where they are off)."""
    import torch
    return all((g is None and w is None) or (
        g is not None and w is not None and g.dtype == w.dtype
        and g.shape == w.shape and torch.equal(g, w))
        for g, w in zip(got, want))


def fused_steps(st: dict, sh: dict) -> int:
    """The fused steps against their plain composites on the card, all five
    outputs exactly: flat and S=4, on the dense mix's first batch (B=16384)
    and its first 64 topics, with the models' ret_cap and with none.  With
    the counters off each step's counters are None and its other four
    outputs those of the counted step, also when it writes into a block
    whose every byte was 0xFF first (fan_any's memset)."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    n = 0
    for s, fused, plain in ((st, rm.router_step, rm.router_step_plain),
                            (sh, rm.router_step_sharded,
                             rm.router_step_sharded_plain)):
        model = s["model"]
        kw = dict(K=model.K, M=model.M, max_probes=model.index.max_probes)
        if model._sharded:
            kw["n_shards"] = model.n_shards
        tables = (model._trie_dev, model._rowmap_dev, model._pool_dev)
        tag = s.get("name", "flat")
        for batch in (s["big"][0], s["big"][0][:64]):
            tok, lens, sysf, _ = model.index.tokenize(batch)
            args = [torch.from_numpy(x).to(model.device)
                    for x in (tok, lens, sysf)]
            for ret_cap in (model.ret_cap, None):
                got = fused(*tables, *args, ret_cap=ret_cap,
                            with_counters=True, **kw)
                want = plain(*tables, *args, ret_cap=ret_cap,
                             with_counters=True, **kw)
                check(steps_equal(got, want),
                      f"fused step != plain ({tag} trie, B={len(batch)}, "
                      f"ret_cap={ret_cap})")
                off = fused(*tables, *args, ret_cap=ret_cap, **kw)
                check(steps_equal(off, plain(*tables, *args, ret_cap=ret_cap,
                                             **kw))
                      and off[4] is None and steps_equal(off[:4], got[:4]),
                      f"counters-off step != its plain composite or the "
                      f"counted step ({tag} trie, B={len(batch)}, "
                      f"ret_cap={ret_cap})")
                size = rm.router_step_block(*tables, *args, ret_cap=ret_cap,
                                            **kw)[0].numel()
                dirty = torch.full((size,), 0xFF, dtype=torch.uint8,
                                   device=model.device)
                block, regions = rm.router_step_block(
                    *tables, *args, ret_cap=ret_cap, out=dirty, **kw)
                check(steps_equal(rm.step_views(block, regions), off),
                      f"counters-off step into a 0xFF block != the step "
                      f"({tag} trie, B={len(batch)}, ret_cap={ret_cap})")
                n += 1
    log(f"fused steps: {n} cases equal their plain composites, counters "
        f"on and off")
    return n


def telemetry_off(st: dict) -> dict:
    """A RouterModel with kernel telemetry off, and its twin with it on,
    on the card with the same 5000 of the load's filters (and 16
    broadcast filters, promoted into the dense pool): one
    ``publish_batch(64)`` through each gives the same results, the host
    oracle's, and hands the recording hook None and the ``[C]`` counters.
    """
    from emqx_tpu_torch import RouterModel, TrieIndex
    from emqx_tpu_torch.ops import trie_match as tm
    from emqx_tpu_torch.router.trie import Trie
    rng = np.random.default_rng(17)
    live = st["live"][:5000]
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)]

    class Hook:
        def __init__(self):
            self.counters = []

        def on_batch(self, counters, **_):
            self.counters.append(counters)

    oracle = Trie()
    for f in live + bcast:
        oracle.insert(f)
    topics = make_topics(live, rng, 64, st["n_vehicles"])
    out = {}
    for on in (True, False):
        model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=8192,
                            kernel_telemetry=on, device=st["model"].device)
        for i, f in enumerate(live):
            model.subscribe(f, i % 8192)
        for f in bcast:
            for s in range(70):
                model.subscribe(f, s)
        model.telemetry = hook = Hook()
        out[on] = model.publish_batch(topics)
        check(len(hook.counters) == 1, "the hook saw no batch")
        c = hook.counters[0]
        check((c is None) if not on else (
            c is not None and c.shape == (len(tm.KERNEL_COUNTER_FIELDS),)),
              f"kernel_telemetry={on}: on_batch got {c!r}")
    check(out[True] == out[False], "telemetry on and off route differently")
    matched, _, _, fallback = out[False]
    for b, t in enumerate(topics):
        check(b in fallback or sorted(matched[b]) == sorted(oracle.match(t)),
              f"telemetry-off model: topic {t!r} matched {matched[b]}")
    res = {"topics": len(topics), "fallback_rows": len(fallback),
           "dense_matched_topics": sum(bool(set(m) & set(bcast))
                                       for m in matched)}
    check(res["dense_matched_topics"] > 0, "no topic reached the dense pool")
    log("telemetry off: on_batch got None, results equal the counted "
        "model's and the oracle's: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# the serving plane: Broker, CM, PublishPipeline and the kernel fold over a
# RouterModel on the card
# ---------------------------------------------------------------------------


class RecordingChannel:
    """A CM channel that keeps, in order, what it is sent.  The parity
    harness (``tests/test_torch_harness.py``) keeps its own, and its own
    :class:`FoldTap`: it keys deliveries by qos too and pickles the blocks
    across processes, and the smoke imports nothing from the tests."""

    def __init__(self) -> None:
        self.got: list[tuple] = []

    def handle_deliver(self, items):
        return items

    def send(self, items) -> None:
        self.got.extend((t, m.topic, bytes(m.payload)) for t, m in items)


class FoldTap:
    """The model's telemetry hook: keeps every counters block and stage
    timing the model hands over, then hands them to the fold."""

    def __init__(self, fold) -> None:
        self.fold = fold
        self.blocks: list = []
        self.stages: list[tuple] = []

    def on_batch(self, counters, **kw) -> None:
        self.blocks.append(None if counters is None else np.array(counters))
        self.stages.append((kw["submit_ns"], kw["step_ns"], kw["decode_ns"]))
        self.fold.on_batch(counters, **kw)

    def on_host_batch(self, n_topics: int) -> None:
        self.fold.on_host_batch(n_topics)


def set_telemetry(sv: dict, on: bool) -> None:
    """Counters packed and the fold attached, or neither: the model and
    the app around it as ``kernel_telemetry`` on or off leaves them."""
    sv["model"].set_kernel_telemetry(on)
    sv["model"].telemetry = sv["tap"] if on else None


def serving_load(n_filters: int, seed: int, device, shards: int | None,
                 sessions: int = SESSIONS, recorded: int = RECORDED) -> dict:
    """The port's Broker over a RouterModel on ``device`` (a flat trie, or
    ``shards`` of them), the bench-shape filters (those :func:`load`
    makes from the same seed) subscribed through
    ``Broker.subscribe`` by ``sessions`` session ids (16 a slot of the
    8192 at the defaults), the model refreshed; a CM with a recording
    channel for ``recorded`` of the session ids, a PublishPipeline at
    depth 4 whose knee over the card's model must default to 0 (every
    batch runs the step, no implicit spill), and a
    DeviceMetricsFold with the broker's Metrics and DegradationLedger,
    attached as the app attaches it (behind a :class:`FoldTap`)."""
    from emqx_tpu_torch import RouterModel, ShardedTrieIndex, TrieIndex
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.cm import CM
    from emqx_tpu_torch.broker.pipeline import PublishPipeline
    from emqx_tpu_torch.observe.device_metrics import DeviceMetricsFold
    from emqx_tpu_torch.observe.metrics import DegradationLedger, Metrics
    from emqx_tpu_torch.observe.trace import SpanCollector
    rng = np.random.default_rng(seed)
    t0 = time.time()
    filters = build_filters(n_filters, rng)
    owners = rng.integers(0, sessions, len(filters)).tolist()
    index = (ShardedTrieIndex(shards, max_levels=8) if shards
             else TrieIndex(max_levels=8))
    model = RouterModel(index, n_sub_slots=8192, K=32, M=128, ret_cap=16,
                        kernel_telemetry=True, device=device)
    check(model._host_matcher is None,
          "a model on the card serves from the host matcher")
    metrics = Metrics()
    ledger = DegradationLedger(metrics)
    broker = Broker(node="n1", router_model=model, metrics=metrics)
    broker.ledger = ledger
    for f, s in zip(filters, owners):
        broker.subscribe(f"c{s}", f)
    t1 = time.time()
    model.refresh()
    torch_sync(device)
    t2 = time.time()
    cm = CM()
    channels = {}
    for s in rng.choice(sessions, min(recorded, sessions // 2),
                        replace=False).tolist():
        channels[f"c{s}"] = RecordingChannel()
        cm.register_channel(f"c{s}", channels[f"c{s}"])
    fold = DeviceMetricsFold(metrics, ledger=ledger, spans=SpanCollector(),
                             model=model, node="n1")
    model.telemetry = tap = FoldTap(fold)
    pipe = PublishPipeline(broker, cm)
    pipe.depth = 4
    check(pipe.min_device_batch == 0 and pipe.device_knee() == 0
          and pipe.spill_deadline_ms() is None,
          f"the pipeline over a model on {device} bypasses batches to the "
          f"host: knee {pipe.device_knee()}, spill "
          f"{pipe.spill_deadline_ms()} ms")
    per_slot = [len(v) for v in broker.slots._sids_of.values()]
    info = {
        "trie": f"s{shards}" if shards else "flat",
        "subscriptions": len(filters),
        "distinct_filters": sum(f is not None for f in model.index.filters),
        "sessions": len(broker.subscription),
        "slots": len(per_slot),
        "sessions_per_slot": {"min": min(per_slot),
                              "mean": float(np.mean(per_slot)),
                              "max": max(per_slot)},
        "recorded_sessions": len(channels),
        "subscribe_s": t1 - t0, "refresh_s": t2 - t1,
    }
    log("serve load: " + json.dumps(info))
    gc.collect()
    gc.freeze()
    return dict(model=model, broker=broker, cm=cm, pipe=pipe, fold=fold,
                tap=tap, metrics=metrics, ledger=ledger, channels=channels,
                rng=rng, live=list(dict.fromkeys(filters)),
                n_vehicles=max(1000, n_filters // 2), sessions=sessions,
                name=info["trie"], batches=0, untapped=0,
                launch0=model.launch_count)


def serve_overlay(sv: dict) -> None:
    """The dense overlay through the broker: 24 broadcast filters (those
    of :func:`add_broadcast`), each subscribed by 96 session ids, then a
    refresh."""
    broker, rng = sv["broker"], sv["rng"]
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)] + [
        f"fleet/f{fl}/#" for fl in range(0, 512, 64)]
    for f in bcast:
        for s in rng.choice(sv["sessions"], 96, replace=False).tolist():
            broker.subscribe(f"c{s}", f)
    sv["model"].refresh()
    torch_sync(sv["model"].device)
    check(len(sv["model"]._dense_row) >= 16,
          "broadcast filters not promoted into the dense pool")
    sv["bcast"] = set(bcast)


def messages(sv: dict, count: int) -> list:
    """``count`` messages of the subscribed tree; the payload is the
    message's place in its list."""
    from emqx_tpu_torch.core.message import Message
    return [Message(topic=t, payload=b"%d" % i) for i, t in enumerate(
        make_topics(sv["live"], sv["rng"], count, sv["n_vehicles"]))]


def sub_topics(deliveries: dict) -> dict:
    """A delivery map as ``{sid: sorted sub_topics}``."""
    return {sid: sorted(t for t, _ in items)
            for sid, items in deliveries.items()}


def serve_mix(sv: dict, mix: str, batch: int, n_batches: int, reps: int,
              n_check: int, card: str) -> dict:
    """``Broker.publish_batch`` on ``n_batches`` batches of ``batch``
    messages: the device path's delivery maps against the host path's
    (``Broker.publish``, the Router's oracle walk) on ``n_check`` sampled
    messages, then ``reps`` timed calls split into the hook fold (the
    broker's submit less the model's), the model's submit, wait and decode
    (its telemetry hook) and the delivery-map build (the broker's collect
    less the model's wait and decode)."""
    broker, rng, tap = sv["broker"], sv["rng"], sv["tap"]
    batches = [messages(sv, batch) for _ in range(n_batches)]
    per = -(-n_check // n_batches)
    checked = deliveries = 0
    for msgs in batches:
        maps = broker.publish_batch(msgs)
        sv["batches"] += 1
        deliveries += sum(len(v) for d in maps for v in d.values())
        for b in rng.choice(len(msgs), min(len(msgs), per),
                            replace=False).tolist():
            got, want = sub_topics(maps[b]), sub_topics(broker.publish(
                msgs[b]))
            check(got == want, f"{sv['name']} {mix} {msgs[b].topic!r}: the "
                  f"device path delivers {got}, the host path {want}")
            checked += 1
    check(checked >= n_check, f"only {checked} messages checked")
    rows = []
    for i in range(reps):
        msgs = batches[i % n_batches]
        n0 = len(tap.stages)
        t0 = time.perf_counter_ns()
        token = broker.publish_batch_submit(msgs)
        t1 = time.perf_counter_ns()
        broker.publish_batch_collect(token)
        t2 = time.perf_counter_ns()
        sv["batches"] += 1
        check(len(tap.stages) == n0 + 1, "the model's hook saw no batch")
        sub, wait, dec = tap.stages[-1]
        rows.append((t2 - t0, t1 - t0 - sub, sub, wait, dec,
                     t2 - t1 - wait - dec))
    ms = np.asarray(rows, dtype=np.float64) / 1e6
    out = {"card": card, "trie": sv["name"], "mix": mix, "batch": batch,
           "calls": reps, "checked_messages": checked,
           "deliveries_per_message": deliveries / (batch * n_batches)}
    for j, name in enumerate(("total", "hook_fold", "model_submit",
                              "model_wait", "model_decode", "map_build")):
        out[name] = pct(ms[:, j])
    log(f"serve_{sv['name']}_{mix}_{batch}: " + json.dumps(out))
    return out


def serve_pipeline(sv: dict, mix: str, n_msgs: int, card: str) -> dict:
    """``PublishPipeline.submit`` of ``n_msgs`` messages, then one
    ``flush`` on a worker thread (as the server's ``asyncio.to_thread``)
    while another thread subscribes 64 new filters in the model and
    refreshes after each (a patch): every batch runs the step on the default
    stream, and each recording channel gets, in submission order, what
    the host path delivers to its session."""
    import threading

    import torch
    model, pipe, broker = sv["model"], sv["pipe"], sv["broker"]
    msgs = messages(sv, n_msgs)
    for ch in sv["channels"].values():
        ch.got.clear()
    b0, h0, l0 = pipe.batches, pipe.host_batches, model.launch_count
    p0 = model.patch_count
    for m in msgs:
        pipe.submit(m)
    cuda = model.device.type == "cuda"
    streams, took = [], []
    # new filters the topics match, in the model only (the broker holds
    # no subscription to them, so they deliver nothing): each refresh
    # patches the trie while the steps run
    rng = sv["rng"]
    churn = [(f"fleet/f{k}/vehicle/+/part/p{q}/+", int(s)) for k, q, s in zip(
        rng.integers(0, 512, 64).tolist(), rng.integers(0, 8, 64).tolist(),
        rng.integers(0, 8192, 64).tolist())]

    def on_stream():
        if cuda:
            streams.append(torch.cuda.current_stream()
                           == torch.cuda.default_stream())

    def flush():
        on_stream()
        t = time.perf_counter()
        took.append((pipe.flush(), time.perf_counter() - t))

    def subscribe():
        on_stream()
        for f, s in churn:
            model.subscribe(f, s)
            model.refresh()

    threads = [threading.Thread(target=flush),
               threading.Thread(target=subscribe)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a worker thread hangs")
    patches = model.patch_count - p0
    check(patches > 0, "the subscribing thread patched nothing")
    for f, s in churn:
        model.unsubscribe(f, s)
    model.refresh()
    check(all(streams), "a worker thread runs on a non-default stream")
    check(took and took[0][0] == n_msgs, f"the flush took {took}")
    n_batches = pipe.batches - b0
    sv["batches"] += n_batches
    check(n_batches == -(-n_msgs // pipe.max_batch),
          f"{n_batches} batches for {n_msgs} messages")
    check(pipe.host_batches == h0, "the pipeline served a batch on the host")
    check(model.launch_count - l0 == n_batches,
          f"{model.launch_count - l0} steps for {n_batches} batches")
    want = {sid: [] for sid in sv["channels"]}
    for m in msgs:
        for sid, items in broker.publish(m).items():
            if sid in want:
                want[sid].extend((t, m.topic, bytes(m.payload))
                                 for t, _ in items)
    got = 0
    for sid, ch in sv["channels"].items():
        check(sorted(ch.got) == sorted(want[sid]),
              f"{sv['name']} {mix}: channel {sid} got {len(ch.got)} "
              f"messages, the host path routes {len(want[sid])}")
        order = [int(p) for _, _, p in ch.got]
        check(order == sorted(order), f"channel {sid}: out of order")
        got += len(ch.got)
    out = {"card": card, "trie": sv["name"], "mix": mix, "depth": pipe.depth,
           "max_batch": pipe.max_batch, "messages": n_msgs,
           "batches": n_batches, "messages_per_s": n_msgs / took[0][1],
           "patches_beside": patches,
           "recorded_deliveries": got}
    log(f"serve_{sv['name']}_{mix}_pipeline: " + json.dumps(out))
    return out


def serve_fold_cost(sv: dict, batch: int, reps: int, card: str) -> dict:
    """The same ``publish_batch`` calls with kernel telemetry on (counters
    packed, the fold attached) and off (neither), in turns."""
    broker = sv["broker"]
    batches = [messages(sv, batch) for _ in range(4)]
    ts = {True: [], False: []}
    for i in range(2 * reps):
        on = i % 2 == 0
        set_telemetry(sv, on)
        t = time.perf_counter()
        broker.publish_batch(batches[(i // 2) % len(batches)])
        ts[on].append((time.perf_counter() - t) * 1e3)
        sv["batches"] += 1
        sv["untapped"] += not on
    set_telemetry(sv, True)
    out = {"card": card, "trie": sv["name"], "batch": batch, "calls": reps,
           "telemetry_on": pct(ts[True]), "telemetry_off": pct(ts[False])}
    log(f"serve_{sv['name']}_fold_cost_{batch}: " + json.dumps(out))
    return out


def serve_checks(sv: dict) -> dict:
    """No device failover, no host batch, one step per device batch, and
    the fold's batches and counter totals those the model handed it."""
    from emqx_tpu_torch.observe.device_metrics import (
        KERNEL_COUNTER_FIELDS, _PEAK_FIELDS)
    model, fold, tap = sv["model"], sv["fold"], sv["tap"]
    failovers = sv["metrics"].val("messages.device_failover")
    check(failovers == 0, f"{failovers} device failovers")
    check(sv["ledger"].totals().get("device_failover", 0) == 0,
          "the ledger holds a device failover")
    check(sv["pipe"].host_batches == 0 and model._host_matcher is None
          and model.host_match_count == 0, "a batch was served on the host")
    launches = model.launch_count - sv["launch0"]
    check(launches == sv["batches"],
          f"{launches} steps for {sv['batches']} device batches")
    check(fold.batches == len(tap.blocks) == launches - sv["untapped"],
          f"the fold saw {fold.batches} batches, the model ran "
          f"{launches} ({sv['untapped']} untapped)")
    blocks = np.stack([b.reshape(-1, len(KERNEL_COUNTER_FIELDS))
                       for b in tap.blocks])
    want = {n: int(blocks[:, :, i].max() if n in _PEAK_FIELDS
                   else blocks[:, :, i].sum())
            for i, n in enumerate(KERNEL_COUNTER_FIELDS)}
    check(fold.totals == want,
          f"fold totals {fold.totals} != the blocks' {want}")
    out = {"trie": sv["name"], "device_batches": sv["batches"],
           "launches": launches, "fold_batches": fold.batches,
           "fold_totals": fold.totals,
           "kernel_overflow_rows": sv["ledger"].totals().get(
               "kernel_overflow", 0),
           "device_failover": failovers}
    log(f"serve_{sv['name']}_checks: " + json.dumps(out))
    return out


def host_dispatch_leg(device, seed: int, card: str) -> dict:
    """RouterModels on ``device`` built under ``EMQX_TPU_CPU_KERNEL=host``
    (the host matcher, no step) and with the variable unset (auto: the
    step, on the card), flat and S=4, on 5000 of the bench-shape filters,
    16 broadcast filters on 70 slots each and aux filters: the host ones
    answer as the step does outside its fallback rows, and as the oracle
    trie on those; ``host_match_count`` is the number of batches and no
    step runs.  The variable is restored afterwards."""
    import os

    import torch

    from emqx_tpu_torch import RouterModel, ShardedTrieIndex, TrieIndex
    from emqx_tpu_torch.router.trie import Trie
    rng = np.random.default_rng(seed)
    live = build_filters(5000, rng)
    bcast = [f"fleet/+/vehicle/+/part/+/m{m}" for m in range(16)]
    aux = ["fleet/+/vehicle/#", "$SYS/#", "+/f1/#"]
    oracle = Trie()
    for f in live + bcast + aux:
        oracle.insert(f)
    batches = [make_topics(live, rng, 64, 2500) for _ in range(3)]
    batches[0][-4:] = ["$SYS/a/b", "$SYS", "fleet/f1", "a/" * 9 + "b"]
    kernel_mode = "auto" if torch.device(device).type == "cuda" else "xla"
    saved = os.environ.get("EMQX_TPU_CPU_KERNEL")
    out = {}
    try:
        for shards in (None, 4):
            res = {}
            for mode in ("host", kernel_mode):
                if mode == "auto":
                    os.environ.pop("EMQX_TPU_CPU_KERNEL", None)
                else:
                    os.environ["EMQX_TPU_CPU_KERNEL"] = mode
                model = RouterModel(
                    ShardedTrieIndex(shards, max_levels=8) if shards
                    else TrieIndex(max_levels=8), n_sub_slots=8192,
                    kernel_telemetry=True, device=device)
                check((model._host_matcher is not None) == (mode == "host"),
                      f"EMQX_TPU_CPU_KERNEL={mode}: host matcher "
                      f"{model._host_matcher}")
                for i, f in enumerate(live):
                    model.subscribe(f, i % 8192)
                for f in bcast:
                    for s in range(70):
                        model.subscribe(f, s)
                for f in aux:
                    model.aux_register(f)
                res[mode] = [model.publish_batch(t) for t in batches]
                want_launches = 0 if mode == "host" else len(batches)
                check(model.launch_count == want_launches
                      and model.host_match_count == len(batches)
                      - want_launches,
                      f"{mode}: {model.launch_count} steps, "
                      f"{model.host_match_count} host batches")
            n = 0
            for topics, h, k in zip(batches, res["host"], res[kernel_mode]):
                check(h[3] == [], "the host matcher has fallback rows")
                for b, t in enumerate(topics):
                    if b in k[3]:      # the step's fallback: the oracle's
                        ok = sorted(set(h[0][b] + h[1][b])) == sorted(
                            oracle.match(t))
                    else:
                        ok = (sorted(h[0][b]) == sorted(k[0][b])
                              and sorted(h[1][b]) == sorted(k[1][b])
                              and h[2][b] == k[2][b])
                    check(ok, f"host matcher, topic {t!r}: {h[0][b]} "
                          f"{h[1][b]} {h[2][b]} != the step's {k[0][b]} "
                          f"{k[1][b]} {k[2][b]}")
                    n += 1
            out[f"s{shards}" if shards else "flat"] = n
    finally:
        if saved is None:
            os.environ.pop("EMQX_TPU_CPU_KERNEL", None)
        else:
            os.environ["EMQX_TPU_CPU_KERNEL"] = saved
    res = {"card": card, "topics_checked": out,
           "kernel_mode": kernel_mode}
    log("serve host dispatch: " + json.dumps(res))
    return res


def serving_phase(seed: int, device, card: str, n_filters: int = N_FILTERS,
                  n_s4: int = SERVE_S4_FILTERS, sessions: int = SESSIONS,
                  big: int = BATCH, n_pipe: int = BATCH) -> dict:
    """The serving plane over a model on the card: the flat leg at the
    smoke's deployment, then the host-dispatch leg, then the S=4 leg at
    ``n_s4`` filters.  Each of the two serving legs is its own
    launch-count path; the host-dispatch leg's launches are logged apart
    and count on no path."""
    from emqx_tpu_torch.ops import _build
    out = {}
    _build.reset_launch_counts()
    sv = serving_load(n_filters, seed, device, None, sessions)
    out["flat"] = [
        serve_mix(sv, "plain", big, 8, 12, 2048, card),
        serve_mix(sv, "plain", 64, 32, 200, 2048, card),
        serve_pipeline(sv, "plain", n_pipe, card),
        serve_fold_cost(sv, big, 4, card),
        serve_fold_cost(sv, 64, 100, card)]
    serve_overlay(sv)
    out["flat"] += [
        serve_mix(sv, "dense", 64, 32, 100, 2048, card),
        # one batch, three calls: the delivery-map loop visits ~98 slots
        # x 16 sessions x the matched filters a message (~30 s a call)
        serve_mix(sv, "dense", big, 1, 2, 512, card),
        serve_pipeline(sv, "dense", 2048, card)]
    out["flat_checks"] = serve_checks(sv)
    out["counts"] = path_counts("serving")
    sv["model"].telemetry = sv["fold"].model = None    # the only cycle
    del sv
    # a check beside the path: its small kernel models' launches are
    # logged on their own and stay off the kernels line
    _build.reset_launch_counts()
    out["host_dispatch"] = host_dispatch_leg(device, seed + 3, card)
    torch_sync(device)
    log("launches of the host-dispatch leg (off the kernels line): "
        + json.dumps(_build.launch_counts()))
    _build.reset_launch_counts()
    sv = serving_load(n_s4, seed, device, SHARDS, sessions)
    out["s4"] = [
        serve_mix(sv, "plain", big, 4, 8, 2048, card),
        serve_mix(sv, "plain", 64, 32, 100, 2048, card),
        serve_pipeline(sv, "plain", n_pipe // 4, card)]
    serve_overlay(sv)
    out["s4"].append(serve_mix(sv, "dense", 64, 32, 50, 2048, card))
    out["s4_checks"] = serve_checks(sv)
    out["s4_counts"] = path_counts("serving_s4")
    return out


def fanout_shapes(fo, device, rng: np.random.Generator) -> int:
    """Both fan-outs against their plain versions at shapes that take each
    path of the gather-OR kernel: 16-byte fids (M % 4 == 0) and rows (W %
    4 == 0), neither, each alone through a contiguous tensor whose data
    starts 4 bytes past a 16-byte boundary, M past one 128-fid chunk, W
    past one 256-word tile, B = 1 and B not a multiple of 8; fids hold
    -1, fids >= F, a topic whose every fid selects one row, and rowmap
    rows >= P."""
    import torch

    def on_card(a: np.ndarray, misaligned: bool) -> torch.Tensor:
        if not misaligned:
            return torch.from_numpy(a).to(device)
        buf = torch.empty(a.size + 4, dtype=torch.int32, device=device)
        t = buf[1:1 + a.size].view(a.shape)
        t.copy_(torch.from_numpy(a))
        check(t.data_ptr() % 16 == 4, "the misaligned tensor is aligned")
        return t

    F, P = 600, 64
    shapes = [  # B, M, W, fids misaligned, table misaligned
        (999, 128, 256, False, False), (999, 77, 5, False, False),
        (999, 128, 256, True, False), (999, 128, 256, False, True),
        (1, 130, 260, False, False), (77, 132, 516, False, False),
        (77, 132, 516, True, True)]
    for B, M, W, mis_f, mis_t in shapes:
        rowmap = np.full(F, -1, np.int32)
        dense = rng.choice(F, 40, replace=False)
        rowmap[dense] = rng.permutation(P)[:40]
        rowmap[rng.choice(np.flatnonzero(rowmap < 0), 5)] = P + 3
        pool = rng.integers(-2 ** 31, 2 ** 31, (P, W)).astype(np.int32)
        bitmaps = rng.integers(-2 ** 31, 2 ** 31, (F, W)).astype(np.int32)
        fids = rng.integers(0, F + 20, (B, M)).astype(np.int32)
        fids[rng.random((B, M)) < 0.5] = -1
        fids[0] = dense[0]                        # every fid, one row
        args = (on_card(rowmap, False), on_card(pool, mis_t),
                on_card(bitmaps, mis_t), on_card(fids, mis_f))
        what = f"B={B} M={M} W={W} misaligned fids {mis_f} table {mis_t}"
        check(torch.equal(fo.fanout_pool(args[0], args[1], args[3]),
                          fo.fanout_pool_plain(args[0], args[1], args[3])),
              f"fanout_pool != plain ({what})")
        check(torch.equal(fo.fanout_bitmaps(args[2], args[3]),
                          fo.fanout_bitmaps_plain(args[2], args[3])),
              f"fanout_bitmaps != plain ({what})")
    return len(shapes)


def bitmap_count_shapes(fo, device, rng: np.random.Generator) -> int:
    """The popcount against its plain version at shapes that take each
    path of its kernel: W % 4 == 0 (16-byte loads) or not, one and more
    than one 256-word tile, W = 1, B = 1, B not a multiple of 8 and the
    bitmap path's B; and a contiguous [16384, 256] tensor whose data
    starts 4 bytes past a 16-byte boundary (the scalar path)."""
    import torch
    shapes = [(B, W, False) for W in (1, 3, 255, 256, 257)
              for B in (1, 33, BATCH)] + [(BATCH, 256, True)]
    for B, W, misaligned in shapes:
        words = rng.integers(-2 ** 31, 2 ** 31, (B, W)).astype(np.int32)
        words[rng.random((B, W)) < 0.3] = 0
        words[0] = -1                              # a full row
        if misaligned:
            buf = torch.empty(B * W + 4, dtype=torch.int32, device=device)
            fan = buf[1:1 + B * W].view(B, W)
            fan.copy_(torch.from_numpy(words))
            check(fan.data_ptr() % 16 == 4, "the misaligned tensor is aligned")
        else:
            fan = torch.from_numpy(words).to(device)
        got = fo.bitmap_to_counts(fan)
        check(torch.equal(got, fo.bitmap_to_counts_plain(fan))
              and int(got[0]) == 32 * W,
              f"bitmap_to_counts != plain (B={B} W={W} misaligned "
              f"{misaligned})")
    return len(shapes)


def patch_blocks(rm, tm, trie, rowmap, pool, cap: int,
                 rng: np.random.Generator) -> np.ndarray:
    """A ``[PATCH_ROWS, cap]`` block of random updates to these tables,
    3/4 of cap unique per target (so every write is defined), padded as
    refresh pads; a stacked trie's fields through (shard, element)
    pairs."""
    n_upd = cap * 3 // 4
    stacked = trie.edges.dim() == 3
    sizes = {n: (tuple(getattr(trie, n).shape) if stacked
                 else getattr(trie, n).shape[0]) for n in tm.TRIE_FIELDS}
    sizes["rowmap"], sizes["pool"] = rowmap.shape[0], tuple(pool.shape)

    def vals():
        return rng.integers(-1, 1 << 20, n_upd).astype(np.int32)

    tupd = {}
    for n in tm.TRIE_FIELDS:
        if stacked:
            S, stride = sizes[n]
            flat = rng.choice(S * stride, n_upd, replace=False)
            v = vals()
            sidx, v = rm._pad_to(cap, (flat // stride).astype(np.int32), v)
            eidx, _ = rm._pad_to(cap, (flat % stride).astype(np.int32), v)
            tupd[n] = ((sidx, eidx), v)
        else:
            tupd[n] = rm._pad_to(cap, rng.choice(
                sizes[n], n_upd, replace=False).astype(np.int32), vals())
    rupd = rm._pad_to(cap, rng.choice(sizes["rowmap"], n_upd,
                                      replace=False).astype(np.int32), vals())
    W = pool.shape[1]
    cells = rng.choice(pool.shape[0] * W, n_upd, replace=False)
    rows, pvals = rm._pad_to(cap, (cells // W).astype(np.int32),
                             rng.integers(0, 1 << 30, n_upd).astype(np.int32))
    cols, _ = rm._pad_to(cap, (cells % W).astype(np.int32),
                         (cells % W).astype(np.int32))
    return rm.patch_block(cap, tupd, rupd, (rows, cols, pvals), sizes)


def table_copies(tm, trie, rowmap, pool) -> tuple:
    return (tm.DeviceTrie(edges=trie.edges.clone(), nodes=trie.nodes.clone()),
            rowmap.clone(), pool.clone())


def tables_equal(a: tuple, b: tuple) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(
        (a[0].edges, a[0].nodes, *a[1:]), (b[0].edges, b[0].nodes, *b[1:])))


def patch_shapes(rm, tm, models, rng: np.random.Generator) -> int:
    """The patch kernel against its plain version on copies of the flat
    and the stacked live tables: a block on the card and a pinned host
    block at caps 64 to 4096; a pageable host block with tables on the
    card must raise."""
    import torch
    n = 0
    for model in models:
        tables = (model._trie_dev, model._rowmap_dev, model._pool_dev)
        ka, kb = table_copies(tm, *tables), table_copies(tm, *tables)
        for cap in (64, 256, 1024, 4096):
            upd = patch_blocks(rm, tm, *tables, cap, rng)
            pinned = torch.from_numpy(upd).pin_memory()
            for block in (torch.from_numpy(upd).to(model.device), pinned):
                rm.apply_patches(*ka, block)
                rm.apply_patches_plain(*kb, torch.from_numpy(upd).to(
                    model.device))
                check(tables_equal(ka, kb),
                      f"patch != plain (cap {cap}, block on "
                      f"{'pinned host' if block is pinned else 'the card'}, "
                      f"{model.n_shards} shard(s))")
                n += 1
            try:
                rm.apply_patches(*ka, torch.from_numpy(upd))
            except ValueError:
                pass
            else:
                raise SmokeFailure("a pageable update block was taken")
        del ka, kb
    return n


def kernels_phase(st: dict, sh: dict, bm: dict, by_path: dict,
                  patch_cap: int) -> tuple[list[dict], float]:
    """One row per kernel at its path's shapes: the flat kernels on the
    flat model's dense mix, the sharded ones on the sharded model's, the
    bitmap ones on the bitmap path's first batch; each with ``launches``,
    its launches summed over the paths of ``by_path`` (path → kernel →
    launches), and ``launches_by_path``, the paths' own; with ``ms`` (one
    launch after an L2 flush, as every earlier run took it) and
    ``run_ms`` (a run of back-to-back launches).  Returns the rows and
    ``floor_ms``, an empty kernel timed as ``ms`` is.  Logs the routing
    steps and ``pack_counters`` timed and bounded the same way."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import fanout as fo
    from emqx_tpu_torch.ops import trie_match as tm
    counts = {}
    for path in by_path.values():
        for k, v in path.items():
            counts[k] = counts.get(k, 0) + v
    model = st["model"]
    dev = model.device
    trie, rowmap, pool = model._trie_dev, model._rowmap_dev, model._pool_dev
    K, M, P = model.K, model.M, model.index.max_probes
    tok, lens, sysf, _ = model.index.tokenize(st["big"][0])
    args = tuple(torch.from_numpy(x).to(dev) for x in (tok, lens, sysf))
    B, L = tok.shape
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    floor_ms = time_ms(lambda: torch.cuda._sleep(1), 20, flush)
    log(f"timing floor: an empty kernel takes {floor_ms} ms as ms is taken")
    rows = []

    def row(name, got, want, fn, inputs, plain_ms, n_bytes, n_ops,
            sector_bytes, library_ms=None):
        """``fn(*inputs)`` launches the kernel on the batch inputs;
        ``sector_bytes``: ``n_bytes`` with a whole 32-byte sector moved for
        each scattered access, logged beside the bound."""
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        check(err == 0, f"{name}: kernel differs from plain (max abs {err})")
        b, by = bound_ms(n_bytes, n_ops)
        ms = time_ms(lambda: fn(*inputs), 20, flush)
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name],
                     "launches": counts.get(name, 0),
                     "launches_by_path": {p: c[name] for p, c in
                                          by_path.items() if name in c},
                     "max_abs_err": err,
                     "ms": ms, "run_ms": run_ms(fn, inputs),
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms})
        sector_ms, _ = bound_ms(sector_bytes, n_ops)
        log(f"kernel {name}: {json.dumps(rows[-1])}; bound with a "
            f"{SECTOR}-byte sector per scattered access {sector_ms} ms")

    def sectored(n_bytes, scattered):
        return n_bytes + scattered * (SECTOR - 4)

    def log_traffic(name, traffic):
        log(f"{name} replay: " + json.dumps({
            k: traffic[k] for k in ("values", "records", "ranked", "sorts",
                                    "live", "walking")}))

    # 1. the step's walk, compacted as it walks (flat)
    traffic = walk_traffic(tm, trie, *args, K, P)
    log_traffic("flat walk", traffic)
    C = (L + 1) * 2 * K
    width = min(M, C)
    fids, fstats = tm.match_compact(trie, *args, K=K, M=M, max_probes=P)
    nb = walk_bytes(traffic, B, L, B * width * 4 + B * 16)
    row("walk_compact", (fids, fstats),
        tm.match_compact_plain(trie, *args, K=K, M=M, max_probes=P),
        lambda *a: tm.match_compact(trie, *a, K=K, M=M, max_probes=P), args,
        time_ms(lambda: tm.match_compact_plain(trie, *args, K=K, M=M,
                                               max_probes=P), 5, flush),
        nb[0], traffic["ops"], nb[1])
    # 2. the walk in its cand mode (match_batch)
    cand, stats = tm.match_batch_stats(trie, *args, K=K, max_probes=P)
    want = tm.match_batch_plain(trie, *args, K=K, max_probes=P)
    nb = walk_bytes(traffic, B, L, B * C * 4 + B * 16)
    row("trie_walk", (cand, stats), want,
        lambda *a: tm.match_batch_stats(trie, *a, K=K, max_probes=P), args,
        time_ms(lambda: tm.match_batch_plain(trie, *args, K=K, max_probes=P),
                5, flush),
        nb[0], traffic["ops"], nb[1])
    # 2b. the walk counted only (match_counts): its plain version and the
    # cand-mode walk's count, exactly
    got = tm.match_counts(trie, *args, K=K, max_probes=P)
    check(torch.equal(got[0], (cand >= 0).sum(1, dtype=torch.int32))
          and torch.equal(got[1], stats[:, 3] != 0),
          "walk_count != the cand-mode walk's counts and overflow")
    nb = walk_bytes(traffic, B, L, B * 5)
    row("walk_count", got,
        tm.match_counts_plain(trie, *args, K=K, max_probes=P),
        lambda *a: tm.match_counts(trie, *a, K=K, max_probes=P), args,
        time_ms(lambda: tm.match_counts_plain(trie, *args, K=K,
                                              max_probes=P), 5, flush),
        nb[0], traffic["ops"], nb[1])
    # 3. compact, from a flushed L2 like the others, so that the HBM rate
    # of its bound holds
    got = tm.compact_fids(cand, M=M)
    row("compact", got, tm.compact_fids_plain(cand, M=M),
        lambda c: tm.compact_fids(c, M=M), (cand,),
        time_ms(lambda: tm.compact_fids_plain(cand, M=M), 5, flush),
        B * C * 4 + B * width * 4 + B, B * C * 4, B * C * 4 + B * width * 4
        + B)
    check(torch.equal(got[0], fids), "walk_compact != trie_walk + compact")
    # 4. fan-out over the live dense pool
    W = pool.shape[1]
    out = fo.fanout_pool(rowmap, pool, fids)
    check(bool((out != 0).any()), "fan-out found no dense-pool row")
    fan_bytes, fan_ops, fan_gathers = fanout_pool_work(rowmap, pool, fids)
    row("fanout_pool", (out,), (fo.fanout_pool_plain(rowmap, pool, fids),),
        lambda f: fo.fanout_pool(rowmap, pool, f), (fids,),
        time_ms(lambda: fo.fanout_pool_plain(rowmap, pool, fids), 5, flush),
        fan_bytes, fan_ops, sectored(fan_bytes, fan_gathers))
    # 5. patch scatter at the churn's update-block size, on copies of the
    # live tables, from a pinned host block as refresh stages it (the time
    # from a block on the card is logged beside it)
    rng = np.random.default_rng(3)
    upd = patch_blocks(rm, tm, trie, rowmap, pool, patch_cap, rng)
    pinned = torch.from_numpy(upd).pin_memory()
    on_card = torch.from_numpy(upd).to(dev)
    ka, kb = table_copies(tm, trie, rowmap, pool), \
        table_copies(tm, trie, rowmap, pool)
    rm.apply_patches(*ka, pinned)
    rm.apply_patches_plain(*kb, on_card)
    got = [ka[0].edges, ka[0].nodes, *ka[1:]]
    want = [kb[0].edges, kb[0].nodes, *kb[1:]]
    plain_ms = time_ms(lambda: rm.apply_patches_plain(*kb, on_card), 20,
                       flush)
    card_ms = time_ms(lambda: rm.apply_patches(*ka, on_card), 20, flush)
    n_upd = patch_cap * 3 // 4
    patch_bytes = rm.PATCH_ROWS * patch_cap * 4 + 8 * n_upd * 4
    row("patch", got, want, lambda u: rm.apply_patches(*ka, u), (pinned,),
        plain_ms, patch_bytes, 8 * patch_cap * 4,
        sectored(patch_bytes, 8 * n_upd), library_ms=plain_ms)
    log(f"patch from a block on the card: {card_ms} ms")
    del ka, kb, want, out, got
    # 6. the sharded step's walk, compacted as it walks, on the sharded
    # model's dense mix; its table reads counted per shard by the same
    # replay, the topic inputs once
    smodel = sh["model"]
    strie = smodel._trie_dev
    S = strie.edges.shape[0]
    stok, slens, ssys, _ = smodel.index.tokenize(sh["big"][0])
    sargs = tuple(torch.from_numpy(x).to(dev) for x in (stok, slens, ssys))
    straffic = [walk_traffic(tm, tm.shard_trie(strie, s), *sargs, K, P)
                for s in range(S)]
    for s, t in enumerate(straffic):
        log_traffic(f"shard {s} walk", t)
    out_w = min(M, S * width)

    def sharded_bytes(out_bytes):
        per = [walk_bytes(t, B, L, 0, inputs=s == 0)
               for s, t in enumerate(straffic)]
        return (sum(p[0] for p in per) + out_bytes,
                sum(p[1] for p in per) + out_bytes)

    sops = sum(t["ops"] for t in straffic)
    got = tm.match_compact_sharded(strie, *sargs, n_shards=S, K=K, M=M,
                                   max_probes=P)
    nb = sharded_bytes(B * out_w * 4 + S * B * 16 + B)
    row("walk_compact_sharded", got,
        tm.match_compact_sharded_plain(strie, *sargs, n_shards=S, K=K, M=M,
                                       max_probes=P),
        lambda *a: tm.match_compact_sharded(strie, *a, n_shards=S, K=K, M=M,
                                            max_probes=P), sargs,
        time_ms(lambda: tm.match_compact_sharded_plain(
            strie, *sargs, n_shards=S, K=K, M=M, max_probes=P), 3, flush),
        nb[0], sops, nb[1])
    sfids = got[0]
    # 7. the sharded walk in its cand mode (match_batch_sharded)
    scand, sstats = tm.match_batch_sharded_stats(strie, *sargs, K=K,
                                                 max_probes=P)
    want = tm.match_batch_sharded_plain(strie, *sargs, K=K, max_probes=P)
    nb = sharded_bytes(S * B * C * 4 + S * B * 16)
    row("trie_walk_sharded", (scand, sstats), want,
        lambda *a: tm.match_batch_sharded_stats(strie, *a, K=K,
                                                max_probes=P), sargs,
        time_ms(lambda: tm.match_batch_sharded_plain(
            strie, *sargs, K=K, max_probes=P), 3, flush),
        nb[0], sops, nb[1])
    del want
    # 8. the sharded compact on that candidate block
    got = tm.compact_sharded(scand, M=M, n_shards=S)
    cs_bytes = S * B * C * 4 + B * out_w * 4 + B + S * B * 4
    row("compact_sharded", got,
        tm.compact_sharded_plain(scand, M=M, n_shards=S),
        lambda c: tm.compact_sharded(c, M=M, n_shards=S), (scand,),
        time_ms(lambda: tm.compact_sharded_plain(scand, M=M, n_shards=S), 5,
                flush),
        cs_bytes, S * B * C * 4, cs_bytes)
    check(torch.equal(got[0], sfids),
          "walk_compact_sharded != trie_walk_sharded + compact_sharded")
    del scand, sstats, got
    # 9. the bitmap fan-out over the dense [F, W] bitmap, on the untrimmed
    # fids of the bitmap path's first batch
    bitmaps, bfids = bm["bitmaps"], bm["fids"]
    Bb = bfids.shape[0]
    Wb = bitmaps.shape[1]
    fan = fo.fanout_bitmaps(bitmaps, bfids)
    bm_bytes, bm_ops, bm_gathers = fanout_bitmaps_work(bitmaps, bfids)
    row("fanout_bitmaps", (fan,), (fo.fanout_bitmaps_plain(bitmaps, bfids),),
        lambda f: fo.fanout_bitmaps(bitmaps, f), (bfids,),
        time_ms(lambda: fo.fanout_bitmaps_plain(bitmaps, bfids), 5, flush),
        bm_bytes, bm_ops, sectored(bm_bytes, bm_gathers))
    # 10. popcount per topic of that fan-out
    row("bitmap_counts", (fo.bitmap_to_counts(fan),),
        (fo.bitmap_to_counts_plain(fan),), fo.bitmap_to_counts, (fan,),
        time_ms(lambda: fo.bitmap_to_counts_plain(fan), 5, flush),
        Bb * Wb * 4 + Bb * 4, Bb * Wb * 2, Bb * Wb * 4 + Bb * 4)
    log("library_ms: none for the walks in all three modes, compact, "
        "fanout_pool, the sharded compact (no PyTorch call computes them), "
        "fanout_bitmaps "
        "(no OR reduction over gathered rows) or bitmap_counts (no "
        "popcount); patch's is its plain version, 8 index_put_ calls")
    fused_steps(st, sh)
    telemetry_off(st)
    composites_line(st, sh, counts, args, sargs, traffic, straffic, flush)
    erng = np.random.default_rng(5)
    n_counts = bitmap_count_shapes(fo, dev, erng)
    n_patch = patch_shapes(rm, tm, (model, smodel), erng)
    log(f"edge shapes: bitmap_to_counts at {n_counts} shapes and patch at "
        f"{n_patch} blocks agree; a pageable block raises")
    log(f"kernels: {small_tries(tm, fo, dev)} small edge-case tries agree")
    return rows, floor_ms


def composites_line(st, sh, counts, args, sargs, traffic, straffic,
                    flush) -> None:
    """The routing steps (flat and S=4: two kernel launches each, the
    walk's with its memset), with the counters on and off, and
    ``pack_counters``, timed as the kernels are (``ms``, ``run_ms``; the
    steps' ``plain_ms`` is their torch composite around the two bare
    kernels, the steps as PRs 1–5 ran them), with bounds from their inputs
    and outputs read or written once, the walk's table values from its
    replay and the fan-out's from its inputs.  ``launches`` are calls on
    the paths: a step per ``walk_compact`` / ``walk_compact_sharded``
    launch, on the counters-on row (the paths' steps pack them; the count
    includes the launch check's counters-off step); the walk's epilogue
    packs the counters, so ``pack_counters`` has none."""
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import trie_match as tm
    out = []
    C = len(tm.KERNEL_COUNTER_FIELDS)
    for (name, s, a, walk), wc in itertools.product(
            (("router_step", st, args, [traffic]),
             ("router_step_sharded", sh, sargs, straffic)), (True, False)):
        model = s["model"]
        plain = (functools.partial(rm.router_step_sharded_plain,
                                   n_shards=model.n_shards)
                 if model._sharded else rm.router_step_plain)
        rowmap, pool = model._rowmap_dev, model._pool_dev
        B, L = a[0].shape
        res = run_step(model, a, model.ret_cap, wc)
        full = run_step(model, a, None, wc)[0]
        fb, fo_ops, _ = fanout_pool_work(rowmap, pool, full)
        W = pool.shape[1]
        n_bytes = (B * (L * 4 + 4 + 1) + sum(t["values"] for t in walk) * 4
                   + fb - B * full.shape[1] * 4 - B * W * 4
                   + sum(x.numel() * x.element_size() for x in res
                         if x is not None))
        n_ops = sum(t["ops"] for t in walk) + fo_ops
        b, by = bound_ms(n_bytes, n_ops)
        walk_name = "walk_compact_sharded" if model.n_shards > 1 \
            else "walk_compact"
        # the paths' steps pack their counters: the walk's count goes on
        # the counters-on row
        out.append({"name": name, "with_counters": wc,
                    **({"launches": counts.get(walk_name, 0)} if wc else {}),
                    "ms": time_ms(lambda: run_step(model, a, model.ret_cap,
                                                   wc), 20, flush),
                    "run_ms": run_ms(lambda *x: run_step(
                        model, x, model.ret_cap, wc), a),
                    "plain_ms": time_ms(lambda: plain(
                        model._trie_dev, rowmap, pool, *a, K=model.K,
                        M=model.M, max_probes=model.index.max_probes,
                        ret_cap=model.ret_cap, with_counters=wc), 20, flush),
                    "bound_ms": b, "bound_by": by})
    # the flat step's counters, as router_step_plain packs them
    model = st["model"]
    trie, M = model._trie_dev, model.M
    kp = dict(K=model.K, max_probes=model.index.max_probes)
    stats = tm.match_compact(trie, *args, M=M, **kp)[1]
    n = stats[:, 2]
    kw = dict(frontier_peak=stats[:, 0].max(),
              probe_iters=stats[:, 1].sum(dtype=torch.int32),
              cand_pre=n.sum(dtype=torch.int32),
              cand_post=n.clamp(max=M).sum(dtype=torch.int32),
              compact_peak=n.clamp(max=M).max(),
              overflow_rows=stats[:, 3].sum(dtype=torch.int32),
              trunc_rows=(n > M).sum(dtype=torch.int32))
    names = list(kw)
    b, by = bound_ms(C * 4 + C * 4, 0)
    out.append({"name": "pack_counters", "launches": 0,
                "ms": time_ms(lambda: tm.pack_counters(**kw), 20, flush),
                "run_ms": run_ms(lambda *v: tm.pack_counters(
                    **dict(zip(names, v))), tuple(kw.values())),
                "bound_ms": b, "bound_by": by})
    log(f"composites ({device_line()}): " + json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42,
                    help="seed of the filters, topics and churn")
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from emqx_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    try:
        t_start = time.time()
        dev_line = device_line()
        log(f"device: {dev_line}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
        t = time.time()
        libs = _build.build_all()
        log(f"build: {time.time() - t:.1f}s ({', '.join(map(str, libs))})")
        st = load(N_FILTERS, a.seed, "cuda")
        # path 1: the flat routing step
        _build.reset_launch_counts()
        slice_phase(st, BATCH, "plain")
        add_broadcast(st)
        slice_phase(st, BATCH, "dense")
        step_launches(st)
        churn_out = churn_phase(st)
        by_path = {"flat": path_counts("flat")}
        idle_phase(st)
        traced_step(st)
        traced_step(st, with_counters=False)
        # path 2: the dense-bitmap fan-out, on the flat model
        _build.reset_launch_counts()
        bm = bitmap_phase(st)
        by_path["bitmap"] = path_counts("bitmap")
        # path 3: the sharded routing step, on the same subscriptions
        bcast_slots = st["bcast_slots"]
        sh = load_sharded(st, SHARDS)
        _build.reset_launch_counts()
        slice_phase(sh, BATCH, "plain")
        add_broadcast(sh, bcast_slots)
        slice_phase(sh, BATCH, "dense")
        step_launches(sh)
        churn_phase(sh)
        by_path["sharded"] = path_counts("sharded")
        traced_step(sh)
        traced_step(sh, with_counters=False)
        cross_check(sh, bcast_slots)
        # path 4: the serving plane (broker, pipeline, CM and the kernel
        # fold around a model on the card), its flat and its S=4 leg
        serve = serving_phase(a.seed, "cuda", dev_line)
        by_path["serving"] = serve["counts"]
        by_path["serving_s4"] = serve["s4_counts"]
        rows, floor_ms = kernels_phase(st, sh, bm, by_path,
                                       churn_out["patch_cap"])
        check(sorted(r["name"] for r in rows) == sorted(_build.KERNELS),
              f"the kernels line lacks "
              f"{sorted(set(_build.KERNELS) - {r['name'] for r in rows})}")
        torch.cuda.synchronize()
        log(f"total {time.time() - t_start:.1f}s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(dev_line)
    print(json.dumps({"kernels": rows, "floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
