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

import os
import pickle
import re
import subprocess
import sys
import tempfile
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


def run_reference(jobs: dict, timeout: float = 300.0) -> dict:
    """Run each ``name(cases)`` of ``jobs`` (``ref_*`` functions of this
    file) against the JAX package in ONE child process; returns name →
    result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", EMQX_TPU_CPU_KERNEL="xla",
               EMQX_TPU_KERNEL_TELEMETRY="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    # one compute thread: the suite runs beside timing-sensitive tests
    env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
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


def ref_router_step(cases):
    import functools

    import jax

    from emqx_tpu.models import router_model as rm
    out = []
    for c in cases:
        step = jax.jit(functools.partial(
            rm.router_step, K=c["K"], M=c["M"], max_probes=c["max_probes"],
            ret_cap=c["ret_cap"], with_counters=True))
        res = step(_ref_trie(c["trie"]), c["rowmap"], c["pool"],
                   c["tokens"], c["lengths"], c["sys"])
        out.append(tuple(np.asarray(x) for x in res))
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


def tables_of(model) -> dict:
    """A RouterModel's (either package's) device tables as numpy: the six
    trie fields, rowmap, and pool as uint32 words."""
    out = {n: np.array(getattr(model._trie_dev, n)) for n in FIELDS}
    out["rowmap"] = np.array(model._rowmap_dev)
    out["pool"] = np.array(model._pool_dev).view(np.uint32)
    return out


class _Recorder:
    def __init__(self) -> None:
        self.counters = []

    def on_batch(self, counters, **_kw) -> None:
        self.counters.append(np.asarray(counters).tolist())


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
