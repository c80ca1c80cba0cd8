#!/usr/bin/env python3
"""Time variants of the port's trie walk on one CUDA card.

Builds ``emqx_tpu_torch/csrc/router_kernels.cu`` as it is and in rewritten
copies (under ``emqx_tpu_torch/_build/ablation/``, gitignored), then times
the walk's four launches — ``trie_walk`` and ``walk_compact`` on the flat
trie, ``trie_walk_sharded`` and ``walk_compact_sharded`` on the S=4 stack —
in each variant on the same inputs: ``chip_smoke.py``'s 1M-filter
vehicle-fleet tree with its broadcast overlay and one dense-mix batch.

Variants:

- ``records``    the source as committed (16-byte edge and node records,
                 next frontiers of up to 16 live candidates ranked, wider
                 ones through the 64-wide sort network);
- ``network``    every next frontier through the sort network, as before
                 the rank counting;
- ``network_x2`` the same with the selection run twice per level: the
                 second pass selects from a selected frontier, so the
                 output is unchanged and the time difference is one
                 network's cost;
- ``select_x2``  the committed selection run twice per level, likewise;
- ``arrays``     the committed walk reading the six fields from separate
                 arrays, one 4-byte load per field used, as before the
                 records (the tables are passed as ``[4, H]`` / ``[4, N]``
                 per shard);
- ``no_select``  no selection: each lane keeps its exact child, else its
                 plus child (not exact; the frontier differs);
- ``all_levels`` no early stop: every level 0..L is walked.

Every variant but ``no_select`` must equal the plain version exactly.  Prints
one JSON line per variant, the card's name and power limit, and last one
JSON record of the whole run.  Run from the root of a checkout on a machine
with one CUDA card and nvcc::

    python3 tools/walk_ablation.py
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

NODE_RECORD = """    if (valid) {
      const int4 nd = __ldg(nodes + front);
      if (active && !sys_block) h_em = nd.y;
      if (ended) e_em = nd.z;
      if (advancing && !sys_block) plus = nd.x;
    }
"""
NODE_ARRAYS = """    if (valid) {
      const int32_t* f = reinterpret_cast<const int32_t*>(nodes);
      if (active && !sys_block) h_em = __ldg(f + ABL_N + front);
      if (ended) e_em = __ldg(f + 2 * (int64_t)ABL_N + front);
      if (advancing && !sys_block) plus = __ldg(f + front);
    }
"""
EDGE_RECORD = """        const int4 e = __ldg(edges + ((h + (uint32_t)p * step) & hmask));
"""
EDGE_ARRAYS = """        const uint32_t es = (h + (uint32_t)p * step) & hmask;
        const int32_t* f = reinterpret_cast<const int32_t*>(edges);
        const int4 e = make_int4(__ldg(f + es), __ldg(f + ABL_H + es),
                                 __ldg(f + 2 * (int64_t)ABL_H + es), -1);
"""
RANK = "constexpr int kRankMax = 16;\n"
SELECT = "    front = next_frontier(exact, plus, mx, mp, K, pick);\n"
SELECT_AGAIN = ("    front = next_frontier(front, -1, __ballot_sync(kFull, front >= 0),"
                " 0u, K, pick);\n")
STOP = "  const int last = max(0, min(len, L));\n"
EMPTY = "    if (!live) break;  // an empty frontier stays empty\n"


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"walk_ablation: the source no longer holds "
                         f"exactly one {old.strip()[:50]!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    if name == "records":
        return src
    if name.startswith("arrays"):
        return _swap(_swap(src, NODE_RECORD, NODE_ARRAYS), EDGE_RECORD,
                     EDGE_ARRAYS)
    if name == "all_levels":
        return _swap(_swap(src, STOP, "  const int last = L;\n"), EMPTY, "")
    if name == "no_select":
        return _swap(src, SELECT, "    front = lane < K ? (exact >= 0 ? "
                     "exact : plus) : -1;\n")
    if name.startswith("network"):
        src = _swap(src, RANK, "constexpr int kRankMax = 0;\n")
    if name.endswith("_x2"):
        src = _swap(src, SELECT, SELECT + SELECT_AGAIN)
    elif name != "network":
        raise ValueError(name)
    return src


def build(variants: dict, out_dir: Path) -> dict:
    """nvcc every variant in parallel; returns name → (library, ptxas log)."""
    from emqx_tpu_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "router_kernels.cu").read_text()
    procs = {}
    for name, defines in variants.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, name))
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             *(f"-D{k}={v}" for k, v in defines.items()), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        out[name] = (so, log)
    return out


def bind(lib_path: Path) -> None:
    """Point every registered kernel at the variant library."""
    from emqx_tpu_torch.ops import _build
    lib = ctypes.CDLL(str(lib_path))
    for k in _build.KERNELS.values():
        fn = getattr(lib, k.symbol)
        fn.argtypes = k.argtypes
        fn.restype = ctypes.c_int
        k._fn = fn


def split(trie, tm):
    """The same trie as separate field arrays: per shard ``[4, H]`` edge
    and ``[4, N]`` node fields, handed over as ``[·, H, 4]`` /
    ``[·, N, 4]`` views of that memory (the wrappers pass pointers)."""
    def fields(rec):
        return rec.transpose(-1, -2).contiguous().view(rec.shape)
    return tm.DeviceTrie(edges=fields(trie.edges), nodes=fields(trie.nodes))


def ptxas_lines(log: str) -> list[str]:
    keep, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "Used" in line and fn and ("walk" in fn):
            keep.append(f"{fn}: {line.split(': ', 1)[-1].strip()}")
    return keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=cs.N_FILTERS)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("walk_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops import trie_match as tm
    dev_line = cs.device_line()
    cs.log(f"device: {dev_line}")
    st = cs.load(a.filters, a.seed, "cuda")
    cs.add_broadcast(st)
    rng = np.random.default_rng(a.seed + 1)
    topics = cs.make_topics(st["live"], rng, cs.BATCH, st["n_vehicles"])
    flat = st["model"]
    K, M, P = flat.K, flat.M, flat.index.max_probes
    S = cs.SHARDS
    # the flat trie with the overlay, kept: load_sharded takes it off
    trie = tm.DeviceTrie(edges=flat._trie_dev.edges.clone(),
                         nodes=flat._trie_dev.nodes.clone())
    args = [torch.from_numpy(x).cuda() for x in flat.index.tokenize(
        topics)[:3]]
    sh = cs.load_sharded(st, S)
    cs.add_broadcast(sh, st["bcast_slots"])
    smodel = sh["model"]
    sargs = [torch.from_numpy(x).cuda() for x in smodel.index.tokenize(
        topics)[:3]]
    strie = smodel._trie_dev
    H, N = trie.edges.shape[0], trie.nodes.shape[0]
    Hs, Ns = strie.edges.shape[1], strie.nodes.shape[1]

    t = time.time()
    libs = build({"records": {}, "network": {}, "network_x2": {},
                  "select_x2": {}, "arrays_flat": {"ABL_H": H, "ABL_N": N},
                  "arrays_sharded": {"ABL_H": Hs, "ABL_N": Ns},
                  "no_select": {}, "all_levels": {}},
                 _build.BUILD_DIR / "ablation")
    cs.log(f"build: {time.time() - t:.1f}s")
    for line in ptxas_lines(libs["records"][1]):
        cs.log(f"ptxas (records): {line}")

    walks = {
        "trie_walk": lambda tr: tm.match_batch_stats(
            tr, *args, K=K, max_probes=P),
        "walk_compact": lambda tr: tm.match_compact(
            tr, *args, K=K, M=M, max_probes=P),
        "trie_walk_sharded": lambda tr: tm.match_batch_sharded_stats(
            tr, *sargs, K=K, max_probes=P),
        "walk_compact_sharded": lambda tr: tm.match_compact_sharded(
            tr, *sargs, n_shards=S, K=K, M=M, max_probes=P),
    }
    plain = {
        "trie_walk": tm.match_batch_plain(trie, *args, K=K, max_probes=P),
        "walk_compact": tm.match_compact_plain(trie, *args, K=K, M=M,
                                               max_probes=P),
        "trie_walk_sharded": tm.match_batch_sharded_plain(
            strie, *sargs, K=K, max_probes=P),
        "walk_compact_sharded": tm.match_compact_sharded_plain(
            strie, *sargs, n_shards=S, K=K, M=M, max_probes=P),
    }
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    tries = {"records": (trie, strie), "arrays": (split(trie, tm),
                                                  split(strie, tm))}
    results = []
    for variant in ("records", "network", "network_x2", "select_x2",
                    "arrays", "no_select", "all_levels", "records"):
        layout = "arrays" if variant == "arrays" else "records"
        out = {"variant": variant}
        for name, fn in walks.items():
            sharded = "sharded" in name
            lib = (f"arrays_{'sharded' if sharded else 'flat'}"
                   if variant == "arrays" else variant)
            bind(libs[lib][0])
            tr = tries[layout][1 if sharded else 0]
            got = fn(tr)
            exact = all(torch.equal(g, w) for g, w in zip(got, plain[name]))
            if variant != "no_select" and not exact:
                raise SystemExit(f"walk_ablation: {variant} {name} differs "
                                 f"from the plain version")
            out[name] = {"ms": cs.time_ms(lambda: fn(tr), a.reps,
                                          flush_buf.zero_),
                         "exact": exact}
        cs.log(json.dumps(out))
        results.append(out)
    torch.cuda.synchronize()
    record = {"device": dev_line, "filters": a.filters, "batch": cs.BATCH,
              "shards": S, "H": H, "N": N, "shard_H": Hs, "shard_N": Ns,
              "ptxas": ptxas_lines(libs["records"][1]),
              "variants": results}
    print(dev_line)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
