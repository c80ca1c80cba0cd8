"""Parity harness for the PyTorch port, plus the port's isolation checks.

The JAX reference's device plane (``emqx_tpu.ops.trie_match`` and what
imports it) does not import on jax 0.9.0: ``_register_barrier_batching``
asks ``optimization_barrier_p in batching.primitive_batchers``, and that
object (a ``PrimitiveBatchersProxy``) has no ``__contains__``.  The reference
stays as it is, so :func:`run_reference` runs it in a child process that
first gives the proxy a ``__contains__`` (jax 0.9.0 already ships the
barrier's batching rule), runs one ``ref_*`` function below over all of a
test module's seeded cases, and returns numpy outputs.  The shim never runs
in the pytest process, so the reference's own device tests keep failing
there the way they do without it.

Run ``python tests/test_torch_harness.py <in.pkl> <out.pkl>`` only
through :func:`run_reference`.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

FIELDS = ("ht_parent", "ht_word", "ht_child", "plus_child", "hash_fid",
          "node_fid")


# seeded generators: small alphabets so wildcards branch and topics repeat
# filter words; '' (empty level), '$SYS' and unknown words ('zz') included
ALPHABET = ["a", "b", "c", "dd", "", "$SYS", "x1"]


def gen_filters(rng: np.random.Generator, n: int,
                max_words: int = 7) -> list[str]:
    """Up to n valid filters ('+'/'#' mixed in; '#' only last)."""
    out = []
    for _ in range(n):
        ws = [ALPHABET[i] if i < len(ALPHABET) else ("+", "#")[i % 2]
              for i in rng.integers(0, len(ALPHABET) + 2,
                                    rng.integers(1, max_words + 1))]
        if "#" in ws:
            ws = ws[: ws.index("#") + 1]
        f = "/".join(ws)
        if f and "#" not in ws[:-1]:
            out.append(f)
    return out


def gen_topics(rng: np.random.Generator, n: int,
               max_words: int = 9) -> list[str]:
    """n topics over the filter alphabet plus an unknown word and literal
    '+'/'#' words (degenerate, unvalidated names)."""
    words = ALPHABET + ["zz", "+", "#"]
    return ["/".join(words[i] for i in rng.integers(
        0, len(words), rng.integers(1, max_words + 1))) for _ in range(n)]


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The port's CPU path is thousands of small torch ops, each of which
    drops and retakes the GIL.  Two things in a shared test worker made a
    test that takes 0.2 s alone take minutes: torch's intra-op thread pools
    oversubscribing the cores beside other workers, and any busy thread an
    earlier test left running, which makes every GIL retake wait out the
    5 ms switch interval.  One intra-op thread and a 10 µs switch interval
    for the module keep these tests at their solo time.  Modules that
    import this fixture get it too."""
    import torch
    n, interval = torch.get_num_threads(), sys.getswitchinterval()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)
        torch.set_num_threads(n)


def run_reference(jobs: dict, timeout: float = 300.0,
                  devices: int = 1) -> dict:
    """Run each ``name(cases)`` of ``jobs`` (``ref_*`` functions of this
    file) against the JAX package in ONE child process; returns name →
    result.  ``devices`` > 1 gives the child that many virtual CPU
    devices (``--xla_force_host_platform_device_count``), for the
    reference's mesh."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", EMQX_TPU_CPU_KERNEL="xla",
               EMQX_TPU_KERNEL_TELEMETRY="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    # one compute thread: the suite runs beside timing-sensitive tests
    env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    if devices > 1:
        env["XLA_FLAGS"] += (f" --xla_force_host_platform_device_count="
                             f"{devices}")
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.pkl", Path(tmp) / "out.pkl"
        src.write_bytes(pickle.dumps(jobs))
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), str(src),
             str(dst)],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"reference child {sorted(jobs)} failed "
                f"({proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        return pickle.loads(dst.read_bytes())


def arrays_of(arrays) -> dict:
    """The six trie fields of a TrieIndexArrays as a picklable dict."""
    return {n: np.asarray(getattr(arrays, n)) for n in FIELDS}


# ---------------------------------------------------------------------------
# reference side (runs only in the child, after the shim)
# ---------------------------------------------------------------------------


def _install_shim() -> None:
    from jax._src.interpreters import batching as _b
    from jax.interpreters import batching

    proxy = type(batching.primitive_batchers)

    class _Contains(proxy):
        def __contains__(self, prim) -> bool:
            return prim in _b.fancy_primitive_batchers

    batching.primitive_batchers.__class__ = _Contains


def _ref_trie(arrs):
    from emqx_tpu.ops import trie_match as tm
    return tm.DeviceTrie(**{n: arrs[n] for n in FIELDS})


def ref_match(cases):
    """Per case: match_batch (cand, overflow, mstats) and compact_fids."""
    from emqx_tpu.ops import trie_match as tm
    out = []
    for c in cases:
        cand, over, mstats = tm.match_batch(
            _ref_trie(c["trie"]), c["tokens"], c["lengths"], c["sys"],
            K=c["K"], max_probes=c["max_probes"])
        fids, trunc = tm.compact_fids(cand, M=c["M"])
        counts, cover = tm.match_counts(
            _ref_trie(c["trie"]), c["tokens"], c["lengths"], c["sys"],
            K=c["K"], max_probes=c["max_probes"])
        out.append(dict(
            cand=np.asarray(cand), overflow=np.asarray(over),
            mstats={k: int(v) for k, v in mstats.items()},
            fids=np.asarray(fids), truncated=np.asarray(trunc),
            counts=np.asarray(counts), counts_overflow=np.asarray(cover)))
    return out


def ref_fanout(cases):
    from emqx_tpu.ops import fanout as fo
    return [np.asarray(fo.fanout_pool(c["rowmap"], c["pool"], c["fids"]))
            for c in cases]


def _counters_kw(c) -> dict:
    """``with_counters=True``, or nothing where the case asks for the
    step's own default (``defaults``)."""
    return {} if c.get("defaults") else {"with_counters": True}


def _outputs(res) -> tuple:
    return tuple(None if x is None else np.asarray(x) for x in res)


def ref_router_step(cases):
    import functools

    import jax

    from emqx_tpu.models import router_model as rm
    out = []
    for c in cases:
        step = jax.jit(functools.partial(
            rm.router_step, K=c["K"], M=c["M"], max_probes=c["max_probes"],
            ret_cap=c["ret_cap"], **_counters_kw(c)))
        res = step(_ref_trie(c["trie"]), c["rowmap"], c["pool"],
                   c["tokens"], c["lengths"], c["sys"])
        out.append(_outputs(res))
    return out


def ref_sharded(cases):
    """Per case: stacked_device_trie, match_batch_sharded,
    compact_fids_sharded and router_step_sharded (with counters) on the
    stacked trie of the case's shard arrays."""
    import functools

    import jax

    from emqx_tpu.models import router_model as rm
    from emqx_tpu.ops import trie_match as tm
    out = []
    for c in cases:
        shards = [tm.DeviceTrie(**{n: a[n] for n in FIELDS})
                  for a in c["shards"]]
        stacked = tm.stacked_device_trie(shards)
        args = (c["tokens"], c["lengths"], c["sys"])
        cand, over, mstats = tm.match_batch_sharded(
            stacked, *args, K=c["K"], max_probes=c["max_probes"])
        fids, trunc = tm.compact_fids_sharded(cand, M=c["M"],
                                              n_shards=c["S"])
        step = jax.jit(functools.partial(
            rm.router_step_sharded, n_shards=c["S"], K=c["K"], M=c["M"],
            max_probes=c["max_probes"], ret_cap=c["ret_cap"],
            with_counters=True))
        res = step(stacked, c["rowmap"], c["pool"], *args)
        out.append(dict(
            stacked={n: np.asarray(getattr(stacked, n)) for n in FIELDS},
            cand=np.asarray(cand), overflow=np.asarray(over),
            mstats={k: np.asarray(v) for k, v in mstats.items()},
            fids=np.asarray(fids), truncated=np.asarray(trunc),
            step=tuple(np.asarray(x) for x in res)))
    return out


def ref_router_step_sharded(cases):
    """Per case: router_step_sharded (with counters, unless the case asks
    for the defaults) alone on the stacked trie of the case's shard
    arrays."""
    import functools

    import jax

    from emqx_tpu.models import router_model as rm
    from emqx_tpu.ops import trie_match as tm
    out = []
    for c in cases:
        stacked = tm.stacked_device_trie(
            [tm.DeviceTrie(**{n: a[n] for n in FIELDS}) for a in c["shards"]])
        step = jax.jit(functools.partial(
            rm.router_step_sharded, n_shards=c["S"], K=c["K"], M=c["M"],
            max_probes=c["max_probes"], ret_cap=c["ret_cap"],
            **_counters_kw(c)))
        res = step(stacked, c["rowmap"], c["pool"], c["tokens"],
                   c["lengths"], c["sys"])
        out.append(_outputs(res))
    return out


def ref_counter_fields(_cases):
    """The reference device plane's KERNEL_COUNTER_FIELDS."""
    from emqx_tpu.ops import trie_match as tm
    return tuple(tm.KERNEL_COUNTER_FIELDS)


def ref_match_sharded(cases):
    """Per case: match_batch_sharded alone on the stacked trie of the
    case's shard arrays — for widths where the reference's sharded compact
    cannot run (C < M: ROADMAP.md R2)."""
    from emqx_tpu.ops import trie_match as tm
    out = []
    for c in cases:
        stacked = tm.stacked_device_trie(
            [tm.DeviceTrie(**{n: a[n] for n in FIELDS}) for a in c["shards"]])
        cand, over, mstats = tm.match_batch_sharded(
            stacked, c["tokens"], c["lengths"], c["sys"], K=c["K"],
            max_probes=c["max_probes"])
        out.append(dict(cand=np.asarray(cand), overflow=np.asarray(over),
                        mstats={k: np.asarray(v) for k, v in mstats.items()}))
    return out


def ref_apply_patches(cases):
    """Per case: the reference's _apply_patches run once per update set of
    the case, in order, on its flat trie (``trie``) or on the stacked trie
    of its shard arrays (``shards``), its rowmap and its pool; returns the
    six fields, rowmap and pool."""
    import jax.numpy as jnp

    from emqx_tpu.models import router_model as rm
    from emqx_tpu.ops import trie_match as tm
    out = []
    for c in cases:
        if "shards" in c:
            host = tm.stacked_device_trie(
                [tm.DeviceTrie(**{n: a[n] for n in FIELDS})
                 for a in c["shards"]])
        else:
            host = tm.DeviceTrie(**{n: c["trie"][n] for n in FIELDS})
        trie = tm.DeviceTrie(**{n: jnp.asarray(getattr(host, n))
                                for n in FIELDS})
        rowmap, pool = jnp.asarray(c["rowmap"]), jnp.asarray(c["pool"])
        for tupd, rupd, pupd in c["patches"]:
            trie, rowmap, pool = rm._apply_patches(trie, rowmap, pool, tupd,
                                                   rupd, pupd)
        out.append(dict(trie={n: np.asarray(getattr(trie, n))
                              for n in FIELDS},
                        rowmap=np.asarray(rowmap), pool=np.asarray(pool)))
    return out


def ref_bitmap_counts(cases):
    from emqx_tpu.ops import fanout as fo
    return [np.asarray(fo.bitmap_to_counts(fan)) for fan in cases]


def ref_fanout_bitmaps(cases):
    from emqx_tpu.ops import fanout as fo
    out = []
    for c in cases:
        fan = fo.fanout_bitmaps(c["bitmaps"], c["fids"])
        out.append((np.asarray(fan), np.asarray(fo.bitmap_to_counts(fan))))
    return out


def ref_graft_entry(_cases):
    """The reference's entry points (``__graft_entry__.py``): its model's
    filters, index arrays and device tables, its example batch, and
    ``jax.jit(fn)(*args)``'s five outputs with the counters off (the
    default) and on."""
    import functools

    import jax

    import __graft_entry__ as g
    model = g._build_model()
    fn, args = g.entry()
    return {"filters": list(model.index.filters),
            "arrays": arrays_of(model.index.arrays),
            "tables": tables_of(model),
            "batch": [np.asarray(x) for x in args[3:]],
            "out": _outputs(jax.jit(fn)(*args)),
            "out_counters": _outputs(jax.jit(functools.partial(
                fn, with_counters=True))(*args))}


def ref_graft_dryrun(cases):
    """``__graft_entry__.dryrun_multichip(n)`` for each ``(n, filters)``
    of ``cases`` (``GRAFT_DRYRUN_FILTERS`` = filters): what it printed and
    the name of the exception it raised (None)."""
    import io

    import __graft_entry__ as g
    out = []
    for n, filters in cases:
        os.environ["GRAFT_DRYRUN_FILTERS"] = str(filters)
        buf, raised = io.StringIO(), None
        try:
            with contextlib.redirect_stdout(buf):
                g.dryrun_multichip(n)
        except Exception as e:      # noqa: BLE001 — compared by type
            raised = type(e).__name__
        out.append((buf.getvalue(), raised))
    return out


def tables_of(model) -> dict:
    """A RouterModel's (either package's) device tables as numpy: the six
    trie fields, rowmap, and pool as uint32 words.  On the port's mesh
    (whose tables are a ``[dp][tp]`` grid of pieces) they are assembled
    from the pieces: the shards and the pool's words concatenated over tp,
    every replica checked equal to the one kept."""
    if isinstance(model._trie_dev, list):
        return _mesh_tables(model)
    out = {n: np.array(getattr(model._trie_dev, n)) for n in FIELDS}
    out["rowmap"] = np.array(model._rowmap_dev)
    out["pool"] = np.array(model._pool_dev).view(np.uint32)
    return out


def _mesh_tables(model) -> dict:
    dp, tp = model.mesh.devices.shape
    sharded = model._trie_dev[0][0].edges.dim() == 3

    def whole(grid, axis):
        """Each dp row's pieces joined over tp along ``axis`` (None: tp
        replicas), the dp rows checked equal."""
        rows = []
        for i in range(dp):
            parts = [np.array(grid(i, j)) for j in range(tp)]
            if axis is None:
                for p in parts[1:]:
                    np.testing.assert_array_equal(p, parts[0])
                rows.append(parts[0])
            else:
                rows.append(np.concatenate(parts, axis))
        for r in rows[1:]:
            np.testing.assert_array_equal(r, rows[0])
        return rows[0]

    out = {n: whole(lambda i, j: getattr(model._trie_dev[i][j], n),
                    0 if sharded else None) for n in FIELDS}
    out["rowmap"] = whole(lambda i, j: model._rowmap_dev[i][j], None)
    out["pool"] = whole(lambda i, j: model._pool_dev[i][j], 1).view(
        np.uint32)
    return out


class _Recorder:
    def __init__(self) -> None:
        self.counters = []
        self.host_batches = []

    def on_batch(self, counters, **_kw) -> None:
        self.counters.append(np.asarray(counters).tolist())

    def on_host_batch(self, n_topics: int) -> None:
        self.host_batches.append(n_topics)


def drive_model(model, ops) -> list:
    """Apply an op sequence to a RouterModel (either package's) and return
    what each observing op saw."""
    rec = _Recorder()
    model.telemetry = rec
    seen = []
    for op, *args in ops:
        if op == "sub":
            model.subscribe(*args)
        elif op == "unsub":
            model.unsubscribe(*args)
        elif op == "aux":
            model.aux_register(*args)
        elif op == "aux_release":
            model.aux_release(*args)
        elif op == "refresh":
            model.refresh()
        elif op == "pub":
            seen.append(("pub", model.publish_batch(args[0]),
                         rec.counters[-1] if rec.counters else None))
        elif op == "tables":
            seen.append(("tables", tables_of(model)))
        elif op == "counts":
            seen.append(("counts", model.upload_count, model.patch_count,
                         model.launch_count, model.patch_upload_bytes))
        elif op == "host_counts":
            seen.append(("host_counts", model.launch_count,
                         model.host_match_count, list(rec.host_batches)))
        else:
            raise ValueError(op)
    return seen


def ref_model(cases):
    """Per case: a RouterModel on a flat TrieIndex, or on a
    ShardedTrieIndex(S) where the case names ``shards``, driven through
    the case's ops."""
    from emqx_tpu.models.router_model import RouterModel
    from emqx_tpu.router.index import ShardedTrieIndex, TrieIndex
    out = []
    for c in cases:
        index = (ShardedTrieIndex(c["shards"], max_levels=c["max_levels"])
                 if c.get("shards") else TrieIndex(max_levels=c["max_levels"]))
        model = RouterModel(index, **c["model_kw"])
        assert model._host_matcher is None
        out.append(drive_model(model, c["ops"]))
    return out


def ref_mesh_step(cases):
    """Per case: the reference's router_step (flat ``trie``) or
    router_step_sharded (``shards``) jitted with the shardings of an
    8-device mesh of the case's ``shape``, its operands placed as
    RouterModel places them."""
    import functools

    import jax

    from emqx_tpu.models import router_model as rm
    from emqx_tpu.ops import trie_match as tm
    from emqx_tpu.parallel.mesh import make_mesh, router_shardings
    out = []
    for c in cases:
        sh = router_shardings(make_mesh(8, shape=tuple(c["shape"])))
        if "shards" in c:
            trie = jax.device_put(tm.stacked_device_trie(
                [tm.DeviceTrie(**{n: a[n] for n in FIELDS})
                 for a in c["shards"]]), sh["trie_sub"])
            fn = functools.partial(rm.router_step_sharded, n_shards=c["S"])
            key = "batch_dp"
        else:
            trie = jax.device_put(_ref_trie(c["trie"]), sh["replicated"])
            fn, key = rm.router_step, "batch_full"
        step = jax.jit(functools.partial(
            fn, K=c["K"], M=c["M"], max_probes=c["max_probes"],
            ret_cap=c["ret_cap"], shardings=sh, **_counters_kw(c)))
        res = step(trie, jax.device_put(c["rowmap"], sh["replicated"]),
                   jax.device_put(c["pool"], sh["bitmaps"]),
                   *jax.device_put((c["tokens"], c["lengths"], c["sys"]),
                                   sh[key]))
        out.append(_outputs(res))
    return out


def ref_mesh_model(cases):
    """Per case: a RouterModel on an 8-device mesh of the case's
    ``shape``, on a flat TrieIndex or on a ShardedTrieIndex(S) where the
    case names ``shards``, driven through the case's ops."""
    from emqx_tpu.models.router_model import RouterModel
    from emqx_tpu.parallel.mesh import make_mesh
    from emqx_tpu.router.index import ShardedTrieIndex, TrieIndex
    out = []
    for c in cases:
        index = (ShardedTrieIndex(c["shards"], max_levels=c["max_levels"])
                 if c.get("shards") else TrieIndex(max_levels=c["max_levels"]))
        model = RouterModel(index, mesh=make_mesh(8, shape=tuple(c["shape"])),
                            **c["model_kw"])
        out.append(drive_model(model, c["ops"]))
    return out


def ref_host_model(cases):
    """Per case: a RouterModel built under ``EMQX_TPU_CPU_KERNEL=host`` (so
    it serves from its host matcher) on a flat TrieIndex, or on a
    ShardedTrieIndex(S) where the case names ``shards``, driven through the
    case's ops."""
    from emqx_tpu.models.router_model import RouterModel
    from emqx_tpu.router.index import ShardedTrieIndex, TrieIndex
    out = []
    for c in cases:
        index = (ShardedTrieIndex(c["shards"], max_levels=c["max_levels"])
                 if c.get("shards") else TrieIndex(max_levels=c["max_levels"]))
        os.environ["EMQX_TPU_CPU_KERNEL"] = "host"
        try:
            model = RouterModel(index, **c["model_kw"])
        finally:
            os.environ["EMQX_TPU_CPU_KERNEL"] = "xla"
        assert model._host_matcher is not None
        out.append(drive_model(model, c["ops"]))
    return out


# ---------------------------------------------------------------------------
# the serving plane (Broker, CM, PublishPipeline, DeviceMetricsFold) of
# either package over either package's RouterModel
# ---------------------------------------------------------------------------


def build_model(pkg: str, case: dict, device="cpu"):
    """``pkg``'s RouterModel for a serving case: on a flat TrieIndex, or on
    a ShardedTrieIndex(S) where the case names ``shards``, built under the
    case's ``cpu_kernel`` mode (``EMQX_TPU_CPU_KERNEL``) where it names
    one; the port's on ``device``."""
    import importlib
    rm = importlib.import_module(f"{pkg}.models.router_model")
    ix = importlib.import_module(f"{pkg}.router.index")
    index = (ix.ShardedTrieIndex(case["shards"], max_levels=case["max_levels"])
             if case.get("shards") else ix.TrieIndex(
                 max_levels=case["max_levels"]))
    kw = dict(case["model_kw"])
    if pkg == "emqx_tpu_torch":
        kw["device"] = device
    mode = os.environ.get("EMQX_TPU_CPU_KERNEL")
    os.environ["EMQX_TPU_CPU_KERNEL"] = case.get("cpu_kernel", "xla")
    try:
        return rm.RouterModel(index, **kw)
    finally:
        if mode is None:
            del os.environ["EMQX_TPU_CPU_KERNEL"]
        else:
            os.environ["EMQX_TPU_CPU_KERNEL"] = mode


def delivery_key(sub_topic: str, msg) -> tuple:
    """What a delivery is, without the message's id and clock stamps."""
    return (sub_topic, msg.topic, bytes(msg.payload), msg.qos)


def delivery_map(deliveries: dict) -> dict:
    """``{sid: [(sub_topic, msg)]}`` as ``{sid: sorted delivery keys}``."""
    return {sid: sorted(delivery_key(t, m) for t, m in items)
            for sid, items in deliveries.items()}


class FoldTap:
    """The model's telemetry hook: keeps each counters block the model
    hands over, then hands it to the fold."""

    def __init__(self, fold) -> None:
        self.fold = fold
        self.blocks = []

    def on_batch(self, counters, **kw) -> None:
        self.blocks.append(None if counters is None
                           else np.asarray(counters).tolist())
        self.fold.on_batch(counters, **kw)

    def on_host_batch(self, n_topics: int) -> None:
        self.fold.on_host_batch(n_topics)


class RecordingChannel:
    """A CM channel that keeps, in order, the deliveries it is sent (a
    shared-subscription pick asks whether it is connected)."""

    def __init__(self) -> None:
        self.got = []
        self.conn_state = "connected"

    def handle_deliver(self, items):
        return list(items)

    def send(self, items) -> None:
        self.got.extend(delivery_key(t, m) for t, m in items)


def serving_plane(pkg: str, model, case: dict) -> dict:
    """``pkg``'s Broker (with a Metrics, a DegradationLedger, a
    deterministic shared dispatch and, where the case names ``drop``, a
    hook that denies topics with that prefix), CM, PublishPipeline and
    DeviceMetricsFold over ``model``, wired as the app wires them (behind
    a :class:`FoldTap`)."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    metrics = mod("observe.metrics").Metrics()
    ledger = mod("observe.metrics").DegradationLedger(metrics)
    broker = mod("broker.broker").Broker(node="n1", router_model=model,
                                         metrics=metrics)
    broker.ledger = ledger

    def shared_dispatch(group, topic, _msg):
        sids = broker.subscriber.get(f"$share/{group}/{topic}", ())
        return [(min(sids), f"$share/{group}/{topic}")] if sids else []

    broker.shared_dispatch = shared_dispatch
    if case.get("drop"):
        prefix = case["drop"]
        broker.hooks.add("message.publish", lambda m: m.set_header(
            "allow_publish", False) if m.topic.startswith(prefix) else m)
    cm = mod("broker.cm").CM()
    pipe = mod("broker.pipeline").PublishPipeline(broker, cm)
    pipe.depth = case.get("depth", 4)
    pipe.max_batch = case.get("max_batch", 512)
    pipe.min_device_batch = case.get("min_batch", 0)
    pipe.spill_ms = case.get("spill_ms", 60_000.0)
    fold = mod("observe.device_metrics").DeviceMetricsFold(
        metrics, ledger=ledger, spans=mod("observe.trace").SpanCollector(),
        model=model, node="n1")
    model.telemetry = tap = FoldTap(fold)
    return dict(metrics=metrics, ledger=ledger, broker=broker, cm=cm,
                pipe=pipe, fold=fold, tap=tap, model=model, channels={},
                message=mod("core.message"), unsub_in_flight=[])


def drive_serving(plane: dict, ops) -> list:
    """Apply a serving op sequence to a :func:`serving_plane` and return
    what each observing op saw.  ``plane["unsub_in_flight"]`` gets the
    place among the model's counters blocks of each batch collected after
    an unsubscribe made while it was in flight."""
    broker, pipe, channels = plane["broker"], plane["pipe"], plane["channels"]
    M = plane["message"]

    def msgs(spec):
        return [M.Message(topic=t, payload=p, qos=q) for t, p, q in spec]

    seen, pending, touched = [], [], []
    for op, *args in ops:
        if op == "sub":
            sid, filt, qos = args
            broker.subscribe(sid, filt, M.SubOpts(qos=qos))
            if sid not in channels:
                channels[sid] = RecordingChannel()
                plane["cm"].register_channel(sid, channels[sid])
        elif op == "unsub":
            broker.unsubscribe(*args)
            touched = [True] * len(pending)
        elif op == "down":
            broker.subscriber_down(args[0])
            touched = [True] * len(pending)
        elif op == "pub":
            seen.append(("pub", [delivery_map(d) for d in
                                 broker.publish_batch(msgs(args[0]))]))
        elif op == "host":
            seen.append(("host", [delivery_map(broker.publish(m))
                                  for m in msgs(args[0])]))
        elif op == "submit":
            pending.append(broker.publish_batch_submit(msgs(args[0])))
            touched.append(False)
        elif op == "collect":
            if touched.pop(0):
                plane["unsub_in_flight"].append(len(plane["tap"].blocks))
            seen.append(("collect", [delivery_map(d) for d in
                                     broker.publish_batch_collect(
                                         pending.pop(0))]))
        elif op == "pipe":
            for m in msgs(args[0]):
                pipe.submit(m)
        elif op == "aged":            # queued ten seconds ago
            for m in msgs(args[0]):
                m.timestamp -= 10_000
                pipe.submit(m)
        elif op == "flush":
            seen.append(("flush", pipe.flush()))
        else:
            raise ValueError(op)
    return seen


def serving_state(plane: dict) -> dict:
    """Every counter of a :func:`serving_plane` after its ops: metric slots,
    ledger totals and events, what each channel got, the pipeline's,
    fold's and model's counts, and the broker's tables."""
    fold, pipe, model, b = (plane["fold"], plane["pipe"], plane["model"],
                            plane["broker"])
    return dict(
        metrics=plane["metrics"].all(),
        ledger=plane["ledger"].totals(),
        events=[(e["reason"], e["count"], e.get("detail"))
                for e in plane["ledger"].recent(256)],
        channels={sid: ch.got for sid, ch in plane["channels"].items()},
        pipeline=(pipe.published, pipe.batches, pipe.host_batches,
                  pipe.spilled_batches, pipe.pending()),
        fold=dict(batches=fold.batches, host_batches=fold.host_batches,
                  host_topics=fold.host_topics, totals=dict(fold.totals),
                  last=None if fold.last is None else fold.last.as_dict(),
                  spans=len(fold.spans),
                  stages={s: h.count for s, h in fold.stage_hists().items()},
                  gauges=fold.gauges()),
        blocks=plane["tap"].blocks,
        unsub_in_flight=plane["unsub_in_flight"],
        model=(model.launch_count, model.host_match_count,
               model.upload_count, model.patch_count),
        tables=(sorted(b.suboption), sorted(b.subscriber),
                sorted(b.slots._slot_of.items())),
    )


def run_serving(pkg: str, model, case: dict) -> dict:
    plane = serving_plane(pkg, model, case)
    seen = drive_serving(plane, case["ops"])
    return dict(seen=seen, state=serving_state(plane))


def ref_serving(cases):
    """Per case: the reference's serving plane over the reference's
    RouterModel, driven through the case's ops."""
    return [run_serving("emqx_tpu", build_model("emqx_tpu", c), c)
            for c in cases]


@contextlib.contextmanager
def _copied_uploads():
    """``jnp.asarray`` that copies a numpy array before it uploads it.  On
    the CPU the reference's uploads of its host tables (trie, rowmap,
    pool) can share their memory, and an unsubscribe between a batch's
    submit and its collect writes those tables in place while the
    asynchronous step may still read them (ROADMAP.md R4).  With copies,
    the step reads the tables as they stood at submit."""
    import jax.numpy as jnp
    orig = jnp.asarray

    def asarray(a, *args, **kw):
        return orig(np.array(a) if isinstance(a, np.ndarray) else a,
                    *args, **kw)

    jnp.asarray = asarray
    try:
        yield
    finally:
        jnp.asarray = orig


def ref_serving_copied(cases):
    """:func:`ref_serving` with every upload a copy (:func:`_copied_uploads`)."""
    with _copied_uploads():
        return ref_serving(cases)


# ---------------------------------------------------------------------------
# the app's services (rules, shared subscriptions, retainer, delayed
# publish, alarms, stats, $SYS) over either package's RouterModel
# ---------------------------------------------------------------------------

# rule columns that read the clock or mint an id
VOLATILE_COLUMNS = ("timestamp", "publish_received_at", "id", "__rule_id")


def drive_services(app, ops, seed: int) -> dict:
    """Apply a services op stream to an :func:`app_class` app and return
    what it saw: per op, the delivery maps it returned, the rules it fired
    as ``(rule id, message topic, selected columns)``, what each channel
    was sent and the retained set after it (the last three sorted within
    the op: rules fire, and so republish, in the iteration order of a set
    of strings, which differs between processes); each ``on_matched``
    call's aux column (None: the host trie) in order; and the metric
    slots and stats at the end.  ``seed`` seeds the shared subscriptions'
    random picks (``sticky``).  The delayed queue orders by due time (its
    clock + the delay): its clock is pinned for the stream, so that order
    is the ops', not the wall clock's, which differs between processes."""
    import random
    M = app.mods.message
    broker, channels = app.broker, {}
    fired, aux, seen = [], [], []
    app.shared._rng = random.Random(seed)
    app.rules.register_action("record", lambda cols, _args: fired.append(
        (cols["__rule_id"], cols.get("topic"), sorted(
            (k, v) for k, v in cols.items() if k not in VOLATILE_COLUMNS))))
    if broker.rules_matched_fn is not None:
        inner = broker.rules_matched_fn

        def on_matched(m, matched):
            aux.append((m.topic, None if matched is None
                        else sorted(matched)))
            inner(m, matched)

        broker.rules_matched_fn = on_matched

    def msgs(spec):
        return [M.Message(topic=t, payload=p, qos=q, from_=c,
                          flags={"retain": r})
                for t, p, q, r, c in spec]

    clock, app.mods.delayed.now_ms = app.mods.delayed.now_ms, lambda: 0
    try:
        for op, *args in ops:
            f0 = len(fired)
            g0 = {sid: len(ch.got) for sid, ch in channels.items()}
            out = None
            if op == "sub":
                sid, filt, qos, rh = args
                if sid not in channels:
                    channels[sid] = RecordingChannel()
                    app.cm.register_channel(sid, channels[sid])
                    g0[sid] = 0
                broker.subscribe(sid, filt, M.SubOpts(qos=qos, rh=rh))
            elif op == "unsub":
                broker.unsubscribe(*args)
            elif op == "down":
                broker.subscriber_down(args[0])
                app.hooks.run("session.terminated", (args[0], "down"))
            elif op == "offline":
                channels[args[0]].conn_state = "disconnected"
            elif op == "rule":
                rid, sql, republish = args
                actions = [{"function": "record"}]
                if republish:
                    actions.append({"function": "republish", "args": {
                        "topic": "$rp/${topic}", "payload": "${payload}"}})
                app.rules.create_rule(rid, sql, actions)
            elif op == "unrule":
                app.rules.delete_rule(args[0])
            elif op == "pub":
                out = [delivery_map(d) for d in broker.publish_batch(
                    msgs(args[0]))]
            elif op == "host":
                out = [delivery_map(broker.publish(m))
                       for m in msgs(args[0])]
            elif op == "tick":
                out = app.delayed.tick(now=1 << 62)
            elif op == "alarm":
                app.alarms.activate(args[0], {"n": 1}, "raised")
            elif op == "sys":
                app.stats.tick()
                app.sys.publish_stats()
                app.sys.publish_metrics()
            else:
                raise ValueError(op)
            seen.append((op, out, sorted(fired[f0:], key=repr), {
                sid: sorted(ch.got[g0[sid]:])
                for sid, ch in channels.items() if len(ch.got) > g0[sid]},
                sorted((t, bytes(m.payload))
                       for t, m, _ in app.retainer.dump())))
    finally:
        app.mods.delayed.now_ms = clock
    app.stats.tick()
    return dict(seen=seen, aux=aux, metrics=app.metrics.all(),
                stats=app.stats.all())


def run_services(pkg: str, model, case: dict) -> dict:
    """``pkg``'s services (``"emqx_tpu"`` or ``"emqx_tpu_torch"``) over
    ``model`` driven through the case's ops."""
    app = app_class({"emqx_tpu": "ref", "emqx_tpu_torch": "port"}[pkg])(
        shared_strategy=case["strategy"], router_model=model)
    return drive_services(app, case["ops"], case["seed"])


def ref_services(cases):
    """Per case: the reference's services over the reference's
    RouterModel, driven through the case's ops."""
    return [run_services("emqx_tpu", build_model("emqx_tpu", c), c)
            for c in cases]


# ---------------------------------------------------------------------------
# the network entry: the reference's own test modules over either package
# ---------------------------------------------------------------------------

PKGS = ("ref", "port")
_PKG_NAME = re.compile(r"\bemqx_tpu\b(?!_torch)")
# the reference's model (and the index it takes) do not import here (R1):
# a "ref" copy gets the port's, as tests/test_torch_serving.py does
_REF_MODEL = re.compile(r"\bemqx_tpu\.(models\.router_model|router\.index)\b")
_APP_IMPORT = re.compile(
    r"^(\s*)from emqx_tpu\.app import BrokerApp\s*(#.*)?$", re.M)
_test_modules: dict = {}


def reference_tests(name: str, pkg: str):
    """A private copy of ``tests/<name>.py``: its source as it stands for
    ``"ref"`` (its ``RouterModel`` and ``TrieIndex`` the port's), and with
    every ``emqx_tpu`` module name pointed at ``emqx_tpu_torch`` for
    ``"port"``.  In both, ``BrokerApp`` is that package's own
    (:func:`app_class`: its ``from_config`` takes a CPU model where the
    config enables the device; the copy's imports of ``emqx_tpu.app``
    become ``pass``).  Each is executed once, as its own module
    object, so a test may set its globals (a server factory) without
    touching the module pytest collected."""
    import types
    key = (name, pkg)
    if key not in _test_modules:
        path = REPO / "tests" / f"{name}.py"
        src = _outside_strings(_APP_IMPORT, r"\1pass", path.read_text())
        src = (_PKG_NAME.sub("emqx_tpu_torch", src) if pkg == "port"
               else _REF_MODEL.sub(r"emqx_tpu_torch.\1", src))
        mod = types.ModuleType(f"_{pkg}_{name}")
        mod.__file__ = str(path)
        mod.BrokerApp = app_class(pkg)
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _test_modules[key] = mod
    return _test_modules[key]


def _outside_strings(pattern, repl: str, src: str) -> str:
    """``pattern.sub(repl, src)`` where the match starts outside every
    string literal of ``src``: a line of a child process's source (a
    string the case runs with ``python -c``) keeps its own import."""
    import io
    import tokenize
    starts = [0]
    for line in io.StringIO(src):
        starts.append(starts[-1] + len(line))
    spans = [(starts[t.start[0] - 1] + t.start[1],
              starts[t.end[0] - 1] + t.end[1])
             for t in tokenize.generate_tokens(io.StringIO(src).readline)
             if t.type == tokenize.STRING]

    def sub(m):
        inside = any(a <= m.start() < b for a, b in spans)
        return m.group(0) if inside else m.expand(repl)
    return pattern.sub(sub, src)


def reference_case_names(name: str) -> list[str]:
    """The names of the ``test_*`` functions of ``tests/<name>.py``."""
    mod = reference_tests(name, "ref")
    return sorted(n for n, v in vars(mod).items()
                  if n.startswith("test_") and callable(v))


def reference_params(fn) -> list[dict]:
    """The keyword sets pytest calls a reference case with: one per
    parameter set of its ``parametrize`` marks (their product, in order),
    or one empty set."""
    import itertools

    from _pytest.mark.structures import ParameterSet
    axes = []
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[:2]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        sets = []
        for v in values:
            if isinstance(v, ParameterSet):     # a pytest.param
                v = v.values
            elif len(names) == 1:
                v = (v,)
            sets.append(dict(zip(names, v)))
        axes.append(sets)
    return [dict(kv for d in combo for kv in d.items())
            for combo in itertools.product(*axes)] if axes else [{}]


def reference_calls(name: str, skip=()) -> list[tuple[str, int]]:
    """``(case, i)`` for every call pytest makes of ``tests/<name>.py``'s
    cases (``i``: the parameter set, :func:`reference_params`), leaving
    out the cases named in ``skip``."""
    mod = reference_tests(name, "ref")
    return [(case, i) for case in reference_case_names(name)
            if case not in skip
            for i in range(len(reference_params(getattr(mod, case))))]


def slow_cases(name: str) -> set:
    """The cases of ``tests/<name>.py`` marked ``slow``: tier-1 runs
    ``-m 'not slow'``, so a port's run of the module leaves them out as
    the reference's own run does."""
    mod = reference_tests(name, "ref")
    return {case for case in reference_case_names(name)
            if any(m.name == "slow"
                   for m in getattr(getattr(mod, case), "pytestmark", []))}


def call_reference(name: str, pkg: str, case: str, i: int, **fixtures):
    """Call parameter set ``i`` of case ``case`` of ``pkg``'s copy of
    ``tests/<name>.py``, with those of ``fixtures`` (pytest fixtures by
    name) that it asks for; a fixture it asks for that the copy defines
    itself (a ``run`` that starts a server) comes from the copy.  A
    fixture of the copy that yields is torn down after the call, as
    pytest tears it down: its code after ``yield`` runs, also when the
    case fails.  A bridge buffer's flusher thread that the case started
    and left running is closed after it: one with ``batch_time_s = 0``
    polls without sleeping, and would slow every later case of the
    process."""
    import inspect
    mod = reference_tests(name, pkg)
    fn = getattr(mod, case)
    kw = dict(reference_params(fn)[i])
    with contextlib.ExitStack() as teardown:
        teardown.callback(_close_flushers, set(threading.enumerate()))
        made: dict = {}

        def fixture(arg):
            """The value of the copy's fixture ``arg``, made once per
            call, its own fixtures first (a ``server`` over an ``app``)."""
            if arg not in made:
                f = getattr(mod, arg)._get_wrapped_function()
                value = f(**args_of(f))
                if inspect.isgenerator(value):
                    gen, value = value, next(value)
                    teardown.callback(next, gen, None)
                made[arg] = value
            return made[arg]

        def args_of(f, given=()) -> dict:
            out = {}
            for arg, param in inspect.signature(f).parameters.items():
                if arg in given:
                    continue
                if arg in fixtures:
                    out[arg] = fixtures[arg]
                elif param.default is param.empty:
                    out[arg] = fixture(arg)
            return out

        return fn(**kw, **args_of(fn, kw))


def _close_flushers(before: set) -> None:
    """Close the ``BufferWorker`` of each flusher thread (either
    package's) started since ``before`` and still running."""
    for t in set(threading.enumerate()) - before:
        worker = getattr(getattr(t, "_target", None), "__self__", None)
        if type(worker).__name__ == "BufferWorker":
            worker.close()


def cpu_router_models(monkeypatch, *mods) -> None:
    """For the length of a test, the port's ``RouterModel`` (the module
    attribute, and the global of each test-module copy in ``mods`` that
    holds one) builds on the CPU unless given a device: the reference's
    device cases build ``RouterModel()`` with no device, which on the port
    needs a card (the port's default stays)."""
    from emqx_tpu_torch.models import router_model as rm

    class RouterModel(rm.RouterModel):
        def __init__(self, *args, device="cpu", **kw) -> None:
            super().__init__(*args, device=device, **kw)

    monkeypatch.setattr(rm, "RouterModel", RouterModel)
    for mod in mods:
        if "RouterModel" in vars(mod):
            monkeypatch.setitem(vars(mod), "RouterModel", RouterModel)


def cpu_meshes(monkeypatch, *mods) -> None:
    """For the length of a test, the port's ``make_mesh`` (the module
    attribute, and the global of each test-module copy in ``mods`` that
    holds one) defaults its devices to the CPU eight times: the
    reference's mesh cases build ``make_mesh(8, ...)`` over its eight
    virtual CPU devices, which on the port would ask for eight cards (the
    port's default stays)."""
    import torch

    from emqx_tpu_torch.parallel import mesh as pm
    orig = pm.make_mesh

    def make_mesh(n_devices=None, shape=None, devices=None):
        if devices is None:
            devices = [torch.device("cpu")] * 8
        return orig(n_devices, shape, devices)

    monkeypatch.setattr(pm, "make_mesh", make_mesh)
    for mod in mods:
        if "make_mesh" in vars(mod):
            monkeypatch.setitem(vars(mod), "make_mesh", make_mesh)


def net(pkg: str):
    """The network entry's modules of one package, by their short names."""
    import importlib
    import types
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    mods = {"P": "mqtt.packet", "frame": "mqtt.frame",
            "client": "mqtt.client", "limiter": "broker.limiter",
            "channel": "broker.channel", "tls": "broker.tls",
            "server": "broker.server", "ws": "broker.ws",
            "broker": "broker.broker", "cm": "broker.cm",
            "message": "core.message", "metrics": "observe.metrics",
            "pipeline": "broker.pipeline"}
    ns = types.SimpleNamespace(
        pkg=pkg, **{k: importlib.import_module(f"{root}.{m}")
                    for k, m in mods.items()})
    ns.Broker, ns.CM = ns.broker.Broker, ns.cm.CM
    ns.Channel, ns.Message = ns.channel.Channel, ns.message.Message
    ns.Parser, ns.serialize = ns.frame.Parser, ns.frame.serialize
    ns.BrokerServer, ns.MqttClient = ns.server.BrokerServer, \
        ns.client.MqttClient
    return ns


def packet_key(pkt) -> tuple:
    """A packet of either package as plain data: its class name and
    fields (the two packages' dataclasses never compare equal)."""
    import dataclasses
    return (type(pkt).__name__, dataclasses.asdict(pkt))


# the reference cases that wait for a later slice ("<test module>::<case>"
# -> the slice of ROADMAP.md §1 and its module); not run.  None waits since
# the native plane came.
APP_CASES: dict = {}


def waiting(name: str) -> set:
    """The cases of ``tests/<name>.py`` that wait for a later slice."""
    return {c.split("::")[1] for c in APP_CASES
            if c.startswith(f"{name}::")}


def services(pkg: str):
    """The app services' modules of one package (``"ref"`` or ``"port"``),
    and the broker's, by their short names."""
    import importlib
    import types
    root = {"ref": "emqx_tpu", "port": "emqx_tpu_torch"}[pkg]
    mods = {"broker": "broker.broker", "cm": "broker.cm",
            "hooks": "broker.hooks", "pipeline": "broker.pipeline",
            "shared_sub": "broker.shared_sub", "topic": "core.topic",
            "message": "core.message", "metrics": "observe.metrics",
            "trace": "observe.trace", "device_metrics":
            "observe.device_metrics", "alarm": "observe.alarm",
            "stats": "observe.stats", "sys": "observe.sys",
            "prometheus": "observe.prometheus", "retainer":
            "services.retainer", "delayed": "services.delayed",
            "engine": "rules.engine", "app": "app",
            "config": "config.config"}
    return types.SimpleNamespace(
        pkg=pkg, **{k: importlib.import_module(f"{root}.{m}")
                    for k, m in mods.items()})


def config_model(conf):
    """The ``RouterModel`` that ``BrokerApp.from_config`` builds for
    ``conf`` (its ``router.device`` knobs), as the port's on the CPU,
    refreshed as the boot refreshes it."""
    from emqx_tpu_torch.models.router_model import RouterModel
    from emqx_tpu_torch.router.index import TrieIndex
    model = RouterModel(
        TrieIndex(max_levels=int(conf.get("router.device.max_levels"))),
        n_sub_slots=int(conf.get("router.device.n_sub_slots")),
        K=int(conf.get("router.device.frontier_k")),
        M=int(conf.get("router.device.match_cap")),
        ret_cap=int(conf.get("router.device.return_cap")), device="cpu")
    model.refresh()
    return model


_app_classes: dict = {}


def app_class(pkg: str):
    """``pkg``'s own ``BrokerApp`` (``"ref"``: the reference's, ``"port"``:
    the port's), with ``mods`` (:func:`services`) beside it.  Its
    ``from_config``, given a config that enables ``router.device`` and no
    ``router_model``, passes :func:`config_model`'s model through
    ``router_model=``: the reference's own model does not import here
    (``ROADMAP.md`` R1), and the port's needs a card."""
    if pkg not in _app_classes:
        mods = services(pkg)

        class BrokerApp(mods.app.BrokerApp):
            @classmethod
            def from_config(cls, conf, node=None, **overrides):
                if (conf.get("router.device.enable")
                        and "router_model" not in overrides):
                    overrides["router_model"] = config_model(conf)
                return super().from_config(conf, node, **overrides)

        BrokerApp.mods = mods
        _app_classes[pkg] = BrokerApp
    return _app_classes[pkg]


def ws_client_class(n):
    """An ``MqttClient`` of package ``n`` that speaks MQTT over RFC 6455
    (masked binary frames, the ``mqtt`` subprotocol) through that
    package's own WS codec."""
    import asyncio
    import base64

    ws = n.ws

    class WsMqttClient(n.MqttClient):
        path = "/mqtt"

        async def connect(self, will_topic=None, will_payload=b"",
                          will_qos=0, timeout: float = 5.0):
            P = n.P
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout)
            key = base64.b64encode(os.urandom(16)).decode()
            self._writer.write((
                f"GET {self.path} HTTP/1.1\r\nHost: localhost\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n"
                "Sec-WebSocket-Protocol: mqtt\r\n\r\n").encode())
            resp = await asyncio.wait_for(
                self._reader.readuntil(b"\r\n\r\n"), timeout)
            assert b" 101 " in resp.split(b"\r\n")[0], resp
            assert ws.accept_key(key).encode() in resp
            self._ws = ws.FrameDecoder(require_mask=False)
            self._recv_task = asyncio.create_task(self._recv_loop())
            await self._send(P.Connect(
                proto_ver=self.proto_ver, clean_start=self.clean_start,
                keepalive=self.keepalive, clientid=self.clientid,
                username=self.username, password=self.password,
                properties=self.properties,
                will_flag=will_topic is not None, will_qos=will_qos,
                will_topic=will_topic, will_payload=will_payload))
            self.connack = await self._expect(P.CONNACK, timeout)
            if self.connack.reason_code != P.RC_SUCCESS:
                await self.close()
                raise ConnectionRefusedError(
                    f"CONNACK reason_code=0x{self.connack.reason_code:02x}")
            return self.connack

        async def _send(self, pkt) -> None:
            self._writer.write(ws.encode_frame(
                ws.OP_BINARY, n.serialize(pkt, self.proto_ver), mask=True))
            await self._writer.drain()

        async def _recv_loop(self) -> None:
            try:
                while True:
                    data = await self._reader.read(65536)
                    if not data:
                        break
                    for op, payload in self._ws.feed(data):
                        if op == ws.OP_CLOSE:
                            return
                        if op == ws.OP_BINARY:
                            for pkt in self._parser.feed(payload):
                                await self._route_in(pkt)
            except (ConnectionError, asyncio.CancelledError):
                pass

    return WsMqttClient


# ---------------------------------------------------------------------------
# the port's isolation from JAX and from the JAX package
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+emqx_tpu\b(?!_torch)"
    r"|from\s+emqx_tpu\b(?!_torch))", re.M)


def _port_sources() -> list[Path]:
    return sorted((REPO / "emqx_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob(
            "*_ablation.py"))


def test_port_sources_import_no_jax():
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in _port_sources()
                 for m in _FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders
    assert len(_port_sources()) >= 10
    # the native plane's bindings and server are scanned too
    port = REPO / "emqx_tpu_torch"
    assert {port / "native" / "__init__.py",
            port / "broker" / "native_server.py"} <= set(_port_sources())


def test_port_imports_with_jax_blocked():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "emqx_tpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['emqx_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'emqx_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_router_model_without_device_raises_when_no_gpu():
    import torch

    from emqx_tpu_torch import RouterModel
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: RouterModel() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RouterModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from emqx_tpu_torch import device_trie, TrieIndex
        ix = TrieIndex()
        ix.load(["a/b"])
        device_trie(ix.ensure())


if __name__ == "__main__":
    _install_shim()
    src, dst = sys.argv[1:3]
    jobs = pickle.loads(Path(src).read_bytes())
    if not all(name.startswith("ref_") for name in jobs):
        raise SystemExit(f"not reference functions: {sorted(jobs)}")
    Path(dst).write_bytes(pickle.dumps(
        {name: globals()[name](cases) for name, cases in jobs.items()}))
