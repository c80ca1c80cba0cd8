#!/usr/bin/env python3
"""Time how a churn refresh hands its update block to the patch kernel.

Loads ``chip_smoke.py``'s 1M-filter vehicle-fleet tree into a flat
``RouterModel`` on one CUDA card, then runs rounds of the smoke's churn (256
new filters subscribed, 256 unsubscribed, one ``refresh`` that patches the
live tables) in one process, alternating three ways of staging the
``[17, cap]`` update block:

- ``zero_copy``    as committed: the block is copied into the model's ring
                   of pinned host blocks and the kernel reads it in place;
- ``pinned_copy``  the same pinned block, then an asynchronous copy to the
                   card, which the kernel reads;
- ``pageable``     the block copied from ordinary host memory to the card
                   (the port before the pinned ring).

Each refresh is checked: the new filters route and the removed ones do not.
Reports, per way, the p50 / p99 of ``refresh_ms`` (host clock around
``refresh()`` and a synchronise) and the p50 of ``refresh_upload_ms`` (the
host's staging of the block, from the model's ``patch_upload_ns``).

Then the kernel alone, on copies of the live tables, from a pinned and from
a card block at caps 64, 1024 and 4096, timed as ``chip_smoke.py`` times
it (``ms`` after an L2 flush, ``run_ms`` back to back), in rewritten copies
of the source (under ``emqx_tpu_torch/_build/patch_ablation/``):

- ``committed``     4 updates a thread, blocks of one warp;
- ``threads_128``   4 updates a thread, blocks of 128 threads;
- ``one_update``    the earlier kernel: one update a thread, 17 scalar
                    loads, blocks of 256 threads.

Every launch must leave the plain version's tables.  Prints the card's
name and power limit, and last one JSON record.  Run from the root of a
checkout on a machine with one CUDA card and nvcc::

    python3 tools/patch_ablation.py
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from tools import fanout_ablation as fa  # noqa: E402
from tools.walk_ablation import bind  # noqa: E402

WAYS = ("zero_copy", "pinned_copy", "pageable")
KERNELS = ("committed", "threads_128", "one_update")
THREADS = "constexpr int kPatchThreads = 32;\n"
# the patch kernel before the redesign, as it was (plain loads through the
# translated pointer, so that it reads a pinned block too)
ONE_UPDATE_KERNEL = """
__global__ void patch_one_update_kernel(
    int32_t* __restrict__ t0, int32_t* __restrict__ t1,
    int32_t* __restrict__ t2, int32_t* __restrict__ t3,
    int32_t* __restrict__ t4, int32_t* __restrict__ t5, int stride,
    int32_t* __restrict__ rowmap, int32_t* __restrict__ pool, int W,
    const int32_t* upd, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  int32_t* const trie[6] = {t0, t1, t2, t3, t4, t5};
#pragma unroll
  for (int t = 0; t < 6; ++t)
    trie[t][(size_t)upd[(2 * t) * cap + i] * stride] =
        upd[(2 * t + 1) * cap + i];
  rowmap[upd[12 * cap + i]] = upd[13 * cap + i];
  pool[(size_t)upd[14 * cap + i] * W + upd[15 * cap + i]] = upd[16 * cap + i];
}

}  // namespace
"""
PATCH_LAUNCH = """  const int quads = cap / 4;
  patch_kernel<<<(quads + kPatchThreads - 1) / kPatchThreads, kPatchThreads,
                 0, (cudaStream_t)stream>>>(
      (int32_t*)t0, (int32_t*)t1, (int32_t*)t2, (int32_t*)t3, (int32_t*)t4,
      (int32_t*)t5, stride, (int32_t*)rowmap, (int32_t*)pool, W,
      (const int4*)src, quads);
"""
ONE_UPDATE_LAUNCH = """  patch_one_update_kernel<<<(cap + 255) / 256, 256, 0,
                            (cudaStream_t)stream>>>(
      (int32_t*)t0, (int32_t*)t1, (int32_t*)t2, (int32_t*)t3, (int32_t*)t4,
      (int32_t*)t5, stride, (int32_t*)rowmap, (int32_t*)pool, W,
      (const int32_t*)src, cap);
"""


def kernel_source(src: str, name: str) -> str:
    if name == "committed":
        return src
    if name == "threads_128":
        return fa._swap(src, THREADS, THREADS.replace("32", "128"))
    if name == "one_update":
        src = fa._swap(src, "}  // namespace\n", ONE_UPDATE_KERNEL)
        return fa._swap(src, PATCH_LAUNCH, ONE_UPDATE_LAUNCH)
    raise ValueError(name)


def load(n_filters: int, seed: int, device="cuda"):
    """The smoke's flat model and its filters, without the host oracle."""
    import numpy as np

    from emqx_tpu_torch import RouterModel, TrieIndex
    rng = np.random.default_rng(seed)
    filters = cs.build_filters(n_filters, rng)
    model = RouterModel(TrieIndex(max_levels=8), n_sub_slots=8192, K=32,
                        M=128, device=device)
    for f, s in zip(filters, rng.integers(0, 8192, len(filters)).tolist()):
        model.subscribe(f, s)
    model.refresh()
    gc.collect()
    gc.freeze()
    once = [f for f, n in zip(*np.unique(filters, return_counts=True))
            if n == 1 and "+" not in f and "#" not in f]
    return model, rng, once


def stagers(model) -> dict:
    """Each way of staging, as a replacement of ``model._stage_patch``."""
    import torch
    committed = model._stage_patch

    def pinned_copy(upd):
        return committed(upd).to(model.device, non_blocking=True)

    def pageable(upd):
        return torch.from_numpy(upd).to(model.device)

    return {"zero_copy": committed, "pinned_copy": pinned_copy,
            "pageable": pageable}


def churn(model, rng, gone: list, tag: str) -> tuple[float, float, list]:
    """256 new filters in, ``gone`` out, one refresh: (refresh_ms,
    refresh_upload_ms, the new filters)."""
    new = [f"fleet/f{fl}/vehicle/v{tag}{i}/part/p{i % 8}/m{i % 16}"
           for i, fl in enumerate(rng.integers(0, 512, 256).tolist())]
    for i, f in enumerate(new):
        model.subscribe(f, i)
    for f, s in gone:
        model.unsubscribe(f, s)
    staged, patches = model.patch_upload_ns, model.patch_count
    cs.torch_sync(model.device)
    t = time.perf_counter()
    model.refresh()
    cs.torch_sync(model.device)
    refresh_ms = (time.perf_counter() - t) * 1e3
    cs.check(model.patch_count == patches + 1, "the refresh did not patch")
    matched = model.publish_batch(new + [f for f, _ in gone])[0]
    for b, f in enumerate(new):
        cs.check(f in matched[b], f"new filter {f!r} does not route")
    for b, (f, _) in enumerate(gone, start=len(new)):
        cs.check(f not in matched[b], f"removed filter {f!r} still routes")
    return refresh_ms, (model.patch_upload_ns - staged) / 1e6, new


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=cs.N_FILTERS)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=30,
                    help="rounds; each churns once per way, the ways' order "
                         "rotating by round")
    a = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("patch_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    dev_line = cs.device_line()
    cs.log(f"device: {dev_line}")
    t = time.time()
    model, rng, once = load(a.filters, a.seed)
    cs.log(f"load: {time.time() - t:.1f}s")
    ways = stagers(model)
    gone = [(f, next(iter(model._subs[model.index.fid_of(f)])))
            for f in once[:256]]
    times = {w: {"refresh_ms": [], "refresh_upload_ms": []} for w in WAYS}
    for r in range(a.rounds):
        for k in range(len(WAYS)):
            w = WAYS[(r + k) % len(WAYS)]
            model._stage_patch = ways[w]
            ms, up, new = churn(model, rng, gone, f"r{r}w{WAYS.index(w)}n")
            times[w]["refresh_ms"].append(ms)
            times[w]["refresh_upload_ms"].append(up)
            gone = list(zip(new, range(256)))
    model._stage_patch = ways["zero_copy"]
    torch.cuda.synchronize()
    out = {w: {k: {"p50": float(np.percentile(v, 50)),
                   "p99": float(np.percentile(v, 99)), "n": len(v)}
               for k, v in by.items()} for w, by in times.items()}
    cs.log("refresh: " + json.dumps(out))
    kernels = kernel_times(model, a.reps)
    print(dev_line)
    print(json.dumps({"device": dev_line, "filters": a.filters,
                      "rounds": a.rounds, "ways": out, "kernels": kernels}))
    return 0


def kernel_times(model, reps: int) -> dict:
    """The patch kernel's variants from a pinned and a card block at caps
    64, 1024 and 4096 on copies of the model's tables, each launch held
    against the plain version's tables."""
    import numpy as np
    import torch

    from emqx_tpu_torch.models import router_model as rm
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops import trie_match as tm
    libs = fa.build(KERNELS, _build.BUILD_DIR / "patch_ablation",
                    kernel_source)
    tables = (model._trie_dev, model._rowmap_dev, model._pool_dev)
    ka, kb = cs.table_copies(tm, *tables), cs.table_copies(tm, *tables)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(3)
    blocks = {}
    for cap in (64, 1024, 4096):
        upd = cs.patch_blocks(rm, tm, *tables, cap, rng)
        blocks[cap] = {"pinned": torch.from_numpy(upd).pin_memory(),
                       "card": torch.from_numpy(upd).cuda()}
    out = {}
    for name in KERNELS:
        bind(libs[name][0])
        for cap, by in blocks.items():
            for where, block in by.items():
                rm.apply_patches(*ka, block)
                rm.apply_patches_plain(*kb, by["card"])
                cs.check(cs.tables_equal(ka, kb), f"patch {name} != plain "
                         f"(cap {cap}, {where} block)")
                key = f"{name}_{cap}_{where}"
                out[key] = {
                    "ms": cs.time_ms(lambda: rm.apply_patches(*ka, block),
                                     reps, flush_buf.zero_),
                    "run_ms": cs.run_ms(lambda u: rm.apply_patches(*ka, u),
                                        (block,))}
                cs.log(f"kernel {key}: {json.dumps(out[key])}")
    bind(libs["committed"][0])
    return out


if __name__ == "__main__":
    sys.exit(main())
