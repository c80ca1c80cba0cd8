#!/usr/bin/env python3
"""Time variants of the port's gather-OR fan-out and popcount on one card.

Builds ``emqx_tpu_torch/csrc/router_kernels.cu`` as it is and in rewritten
copies (under ``emqx_tpu_torch/_build/fanout_ablation/``, gitignored), then
times ``fanout_pool``, ``fanout_bitmaps`` and ``bitmap_to_counts`` in each
variant on the inputs of ``chip_smoke.py``'s kernels phase: the 1M-filter
vehicle-fleet tree with its broadcast overlay, one dense-mix batch of
16384 topics walked to its ``[16384, 128]`` fids, the live ``[64, 256]``
dense pool, the dense ``[F, 256]`` bitmap of every subscription, and the
``[16384, 256]`` output of ``fanout_bitmaps`` for the popcount.
``fanout_pool`` is also timed on the first 64 topics (the synchronous
small batch).

Variants of the fan-out:

- ``committed``   the source as committed (a warp per topic, persistent,
                  the next topic's fids in flight while a topic is ORed
                  and stored, 16-byte accesses);
- ``block``       the earlier kernels: a block per topic, shared-memory
                  atomics and a barrier, 4-byte accesses;
- ``scalar``      the committed kernel on its scalar path only (4-byte
                  fids, rows and stores);
- ``no_pipeline`` nothing in flight ahead: each topic loads its own fids
                  first;
- ``rows_ahead``  a deeper pipeline: the next topic's rowmap gathers and
                  the fids of the one after in flight;
- ``smem_pool``   each block first copies the whole pool into shared
                  memory and reads pool rows there;
- ``stcs``        streaming stores (``__stcs``) for the output;
- ``one_topic``   not persistent: one warp per topic, B/8 blocks.

Variants of the popcount (``scalar`` takes its 4-byte path too):

- ``warp_row``    the earlier kernel: a warp per row, not persistent,
                  4-byte loads, nothing in flight ahead;
- ``one_row``     the committed kernel, not persistent (B/8 blocks);
- ``bulk``        the row stream copied by the Tensor Memory Accelerator:
                  lane 0 of each warp keeps its next two 1 KB tiles in
                  flight with ``cp.async.bulk`` into shared memory, each
                  stage completing on an ``mbarrier``.

Every variant must equal the plain versions exactly, and each time is
also taken as ``run_ms`` (one event pair around 20 back-to-back
launches over 4 rotating copies of the batch input).  Every time is taken
as ``chip_smoke.py`` takes it (after a 256 MB ``zero_`` flush, which
leaves L2 full of dirty lines); ``committed`` and ``block`` are timed
after a read-only flush too (a clean L2).  Beside them, under the same
flush: an empty kernel (the timing's floor), PyTorch's memset of the
``[16384, 256]`` output and its copy of the fids.  Last, the synchronous
routing step (``router_step``, host clock, synchronised) at B = 64 and
16384 with the ``committed`` and the ``block`` fan-out, and the host's
time of one ``fanout_pool`` call at each size, alternating in rounds so
that a drift of the host's speed reaches both.  Prints one JSON line
per variant, the card's name and power limit, and last one JSON record of
the whole run with each kernel's bound.  Run from the root of a checkout
on a machine with one CUDA card and nvcc::

    python3 tools/fanout_ablation.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from tools.walk_ablation import bind  # noqa: E402

VARIANTS = ("committed", "block", "scalar", "no_pipeline", "rows_ahead",
            "smem_pool", "stcs", "one_topic", "warp_row", "one_row", "bulk",
            "committed")

# the block-per-topic kernels the gather-OR kernel replaced, as they were
BLOCK_KERNELS = """
__global__ void fanout_pool_kernel(const int32_t* __restrict__ rowmap, int F,
                                   const int32_t* __restrict__ pool, int P,
                                   int W, const int32_t* __restrict__ fids,
                                   int M, int32_t* __restrict__ out) {
  extern __shared__ int32_t rows[];
  __shared__ int n_rows;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) n_rows = 0;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int32_t f = fids[(size_t)b * M + m];
    const int32_t r = (f >= 0 && f < F) ? rowmap[f] : -1;
    if (r >= 0 && r < P) rows[atomicAdd(&n_rows, 1)] = r;
  }
  __syncthreads();
  const int n = n_rows;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int32_t acc = 0;
    for (int k = 0; k < n; ++k) acc |= pool[(size_t)rows[k] * W + w];
    out[(size_t)b * W + w] = acc;
  }
}

__global__ void fanout_bitmaps_kernel(const int32_t* __restrict__ bitmaps,
                                      int F, int W,
                                      const int32_t* __restrict__ fids, int M,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t rows[];
  __shared__ int n_rows;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) n_rows = 0;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int32_t f = fids[(size_t)b * M + m];
    if (f >= 0 && f < F) rows[atomicAdd(&n_rows, 1)] = f;
  }
  __syncthreads();
  const int n = n_rows;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int32_t acc = 0;
    for (int k = 0; k < n; ++k) acc |= bitmaps[(size_t)rows[k] * W + w];
    out[(size_t)b * W + w] = acc;
  }
}

}  // namespace
"""
POOL_LAUNCH = """  return row_or<true>((const int32_t*)rowmap, F, (const int32_t*)pool, P, W,
                      (const int32_t*)fids, B, M, (int32_t*)out,
                      (cudaStream_t)stream);
"""
BLOCK_POOL_LAUNCH = """  int threads = ((W + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  fanout_pool_kernel<<<B, threads, (size_t)M * sizeof(int32_t),
                       (cudaStream_t)stream>>>(
      (const int32_t*)rowmap, F, (const int32_t*)pool, P, W,
      (const int32_t*)fids, M, (int32_t*)out);
  return (int)cudaGetLastError();
"""
BITMAPS_LAUNCH = """  return row_or<false>(nullptr, F, (const int32_t*)bitmaps, F, W,
                       (const int32_t*)fids, B, M, (int32_t*)out,
                       (cudaStream_t)stream);
"""
BLOCK_BITMAPS_LAUNCH = """  int threads = ((W + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  fanout_bitmaps_kernel<<<B, threads, (size_t)M * sizeof(int32_t),
                          (cudaStream_t)stream>>>(
      (const int32_t*)bitmaps, F, W, (const int32_t*)fids, M,
      (int32_t*)out);
  return (int)cudaGetLastError();
"""
VEC_CHOICE = """  const bool vec_f = M % 4 == 0 && aligned16(fids);
  const bool vec_w = W % 4 == 0 && aligned16(table) && aligned16(out);
"""
FIRST = "  int4 ahead = load_fids<kVecF>(fids, M, B, b, 0, lane);\n"
AHEAD = """    const int4 first = gather_rows<kRowmap>(ahead, rowmap, F);
    ahead = load_fids<kVecF>(fids, M, B, b + stride, 0, lane);
"""
OWN_TOPIC = """    const int4 first = gather_rows<kRowmap>(
        load_fids<kVecF>(fids, M, B, b, 0, lane), rowmap, F);
"""
ROWS_FIRST = """  int4 next = gather_rows<kRowmap>(load_fids<kVecF>(fids, M, B, b, 0, lane),
                                   rowmap, F);
  int4 ahead = load_fids<kVecF>(fids, M, B, b + stride, 0, lane);
"""
ROWS_AHEAD = """    const int4 first = next;
    next = gather_rows<kRowmap>(ahead, rowmap, F);
    ahead = load_fids<kVecF>(fids, M, B, b + 2 * stride, 0, lane);
"""
ROW_LOAD = ("      return __ldg(reinterpret_cast<const int4*>(table + off) "
            "+ q);\n")
OUT_STORE = "    if (q < (W >> 2)) reinterpret_cast<int4*>(row)[q] = v;\n"
KERNEL_TOP = "  int32_t* list = lists[warp];\n"
STAGE_POOL = """  int32_t* list = lists[warp];
  extern __shared__ int4 staged[];
  if (kRowmap && kVecW) {
    const int n4 = P * (W >> 2);
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      staged[i] = __ldg(reinterpret_cast<const int4*>(table) + i);
    __syncthreads();
    table = reinterpret_cast<const int32_t*>(staged);
  }
"""
RESIDENT = """  const auto kernel = row_or_kernel<kRowmap, kVecF, kVecW>;
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, 0, resident, &blocks);
"""
SMEM_RESIDENT = """  const auto kernel = row_or_kernel<kRowmap, kVecF, kVecW>;
  const size_t smem = kRowmap && kVecW ? (size_t)P * W * 4 : 0;
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = resident_blocks(kernel, smem, resident, &blocks);
"""
LAUNCH = "  kernel<<<blocks, kOrWarps * 32, 0, stream>>>(rowmap"
CAP = "  if (blocks > wanted) blocks = wanted;\n"


COUNTS_LAUNCH = """  const bool vec = W % 4 == 0 && aligned16(fan);
  return vec ? launch_bitmap_counts<true>((const int32_t*)fan, B, W,
                                          (int32_t*)counts,
                                          (cudaStream_t)stream)
             : launch_bitmap_counts<false>((const int32_t*)fan, B, W,
                                           (int32_t*)counts,
                                           (cudaStream_t)stream);
"""
COUNTS_CAP = "  if (blocks > row_blocks) blocks = row_blocks;\n"
# the popcount kernel before the redesign, as it was
WARP_ROW_KERNEL = """
__global__ void __launch_bounds__(256)
bitmap_counts_warp_row_kernel(const int32_t* __restrict__ fan, int B, int W,
                              int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int32_t* src = fan + (size_t)b * W;
  unsigned n = 0;
  for (int w = lane; w < W; w += 32) n += __popc((unsigned)src[w]);
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) counts[b] = (int32_t)n;
}

}  // namespace
"""
WARP_ROW_LAUNCH = """  const int warps = 8;
  bitmap_counts_warp_row_kernel<<<(B + warps - 1) / warps, warps * 32, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t*)fan, B, W, (int32_t*)counts);
  return (int)cudaGetLastError();
"""
BULK_KERNEL = r"""
constexpr int kBulkStages = 2;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The vector path's row stream through the Tensor Memory Accelerator: lane
// 0 of each warp keeps the warp's next kBulkStages tiles in flight with
// cp.async.bulk into shared memory, each stage completing on its mbarrier;
// the lanes count a tile there.  No registers or load instructions carry
// the stream.
__global__ void __launch_bounds__(kOrWarps * 32)
bitmap_counts_bulk_kernel(const int32_t* __restrict__ fan, int B, int W,
                          int32_t* __restrict__ counts) {
  __shared__ int4 stage[kOrWarps][kBulkStages][kOrTile / 4];
  __shared__ unsigned long long bar[kOrWarps][kBulkStages];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kOrWarps;
  const int n_tiles = (W + kOrTile - 1) / kOrTile;
  const int b0 = blockIdx.x * kOrWarps + warp;
  const int units = b0 < B ? ((B - 1 - b0) / stride + 1) * n_tiles : 0;
  if (lane == 0) {
    for (int s = 0; s < kBulkStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(shared_addr(&bar[warp][s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  auto issue = [&](int k) {  // lane 0: unit k into stage k % kBulkStages
    const int s = k % kBulkStages, t = k % n_tiles;
    const int32_t* src = fan + (size_t)(b0 + (k / n_tiles) * stride) * W
                         + (size_t)t * kOrTile;
    const unsigned bytes = 4u * (unsigned)min(kOrTile, W - t * kOrTile);
    const unsigned mbar = shared_addr(&bar[warp][s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(mbar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(shared_addr(&stage[warp][s][0])), "l"(src),
                    "r"(bytes), "r"(mbar) : "memory");
  };
  if (lane == 0)
    for (int k = 0; k < kBulkStages && k < units; ++k) issue(k);
  unsigned phases = 0, n = 0;
  for (int k = 0; k < units; ++k) {
    const int s = k % kBulkStages, t = k % n_tiles;
    asm volatile("{\n\t.reg .pred p;\n"
                 "BULK_WAIT:\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
                 "@!p bra BULK_WAIT;\n}"
                 :: "r"(shared_addr(&bar[warp][s])), "r"((phases >> s) & 1u)
                 : "memory");
    phases ^= 1u << s;
    const int quads = min(kOrTile, W - t * kOrTile) >> 2;
    unsigned c = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u * 32 + lane < quads) c += popc4(stage[warp][s][u * 32 + lane]);
    __syncwarp();  // every lane has read the stage before it is refilled
    if (lane == 0 && k + kBulkStages < units) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(k + kBulkStages);
    }
    n += c;
    if (t == n_tiles - 1) {
      n = __reduce_add_sync(kFull, n);
      if (lane == 0) counts[b0 + (k / n_tiles) * stride] = (int32_t)n;
      n = 0;
    }
  }
}

int launch_bitmap_counts_bulk(const int32_t* fan, int B, int W,
                              int32_t* counts, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bitmap_counts_bulk_kernel, kOrWarps * 32, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const int row_blocks = (B + kOrWarps - 1) / kOrWarps;
  bitmap_counts_bulk_kernel<<<resident < row_blocks ? resident : row_blocks,
                              kOrWarps * 32, 0, stream>>>(fan, B, W, counts);
  return (int)cudaGetLastError();
}

}  // namespace
"""
BULK_LAUNCH = """  if (W % 4 == 0 && aligned16(fan))
    return launch_bitmap_counts_bulk((const int32_t*)fan, B, W,
                                     (int32_t*)counts, (cudaStream_t)stream);
  return launch_bitmap_counts<false>((const int32_t*)fan, B, W,
                                     (int32_t*)counts, (cudaStream_t)stream);
"""


def _swap(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"fanout_ablation: the source no longer holds "
                         f"exactly one {old.strip()[:50]!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    if name == "committed":
        return src
    if name == "block":
        src = _swap(src, "}  // namespace\n", BLOCK_KERNELS)
        src = _swap(src, POOL_LAUNCH, BLOCK_POOL_LAUNCH)
        return _swap(src, BITMAPS_LAUNCH, BLOCK_BITMAPS_LAUNCH)
    if name == "scalar":
        src = _swap(src, COUNTS_LAUNCH, COUNTS_LAUNCH.replace(
            "W % 4 == 0 && aligned16(fan)", "false"))
        return _swap(src, VEC_CHOICE, "  const bool vec_f = false, "
                     "vec_w = false;\n")
    if name == "no_pipeline":
        return _swap(_swap(src, FIRST, ""), AHEAD, OWN_TOPIC)
    if name == "rows_ahead":
        return _swap(_swap(src, FIRST, ROWS_FIRST), AHEAD, ROWS_AHEAD)
    if name == "smem_pool":  # a generic load: the row may be in shared memory
        src = _swap(src, ROW_LOAD, ROW_LOAD.replace("__ldg(", "*("))
        src = _swap(src, KERNEL_TOP, STAGE_POOL)
        src = _swap(src, RESIDENT, SMEM_RESIDENT)
        return _swap(src, LAUNCH, LAUNCH.replace(", 0, stream", ", smem, "
                                                 "stream"))
    if name == "stcs":
        return _swap(src, OUT_STORE, "    if (q < (W >> 2)) __stcs("
                     "reinterpret_cast<int4*>(row) + q, v);\n")
    if name == "one_topic":
        return _swap(src, CAP, "  blocks = wanted;\n")
    if name == "warp_row":
        src = _swap(src, "}  // namespace\n", WARP_ROW_KERNEL)
        return _swap(src, COUNTS_LAUNCH, WARP_ROW_LAUNCH)
    if name == "one_row":
        return _swap(src, COUNTS_CAP, "  blocks = row_blocks;\n")
    if name == "bulk":
        src = _swap(src, "}  // namespace\n", BULK_KERNEL)
        return _swap(src, COUNTS_LAUNCH, BULK_LAUNCH)
    raise ValueError(name)


def build(names, out_dir: Path, rewrite=variant_source) -> dict:
    """nvcc every variant (``rewrite(source, name)``) in parallel; returns
    name → (library, ptxas log)."""
    from emqx_tpu_torch.ops import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "router_kernels.cu").read_text()
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(rewrite(src, name))
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        out[name] = (so, log)
    return out


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register and shared-memory lines of the fan-out kernels."""
    keep, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "Used" in line and fn and ("row_or" in fn or "fanout" in fn
                                        or "bitmap_counts" in fn):
            keep.append(f"{fn}: {line.split(': ', 1)[-1].strip()}")
    return keep


def step_ab(model, args, fids, libs: dict, rounds: int,
            reps: int = 25) -> dict:
    """p50 / p99 ms of the synchronous flat step at B = 64 and 16384 with
    the committed and the block fan-out, and of the host's time of one
    ``fanout_pool`` call on that step's fids (wrapper and launch, not
    synchronised): ``reps`` of each per size, variant and round, the
    variants' order alternating by round."""
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import fanout as fo
    rowmap, pool = model._rowmap_dev, model._pool_dev
    sizes = {64: ([x[:64] for x in args], fids[:64].contiguous()),
             len(fids): (args, fids)}
    times = {v: {f"{k}_{n}": [] for n in sizes for k in ("step", "launch")}
             for v in ("committed", "block")}
    for r in range(rounds):
        for v in ("committed", "block")[::1 if r % 2 == 0 else -1]:
            bind(libs[v][0])
            for n, (sargs, f) in sizes.items():
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    cs.run_step(model, sargs, model.ret_cap)
                    torch.cuda.synchronize()
                    times[v][f"step_{n}"].append(
                        (time.perf_counter() - t) * 1e3)
                for _ in range(reps):
                    t = time.perf_counter()
                    fo.fanout_pool(rowmap, pool, f)
                    times[v][f"launch_{n}"].append(
                        (time.perf_counter() - t) * 1e3)
                torch.cuda.synchronize()
    return {v: {k: {"p50_ms": float(np.percentile(ts, 50)),
                    "p99_ms": float(np.percentile(ts, 99)), "n": len(ts)}
                for k, ts in by.items()}
            for v, by in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=cs.N_FILTERS)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=40,
                    help="alternating rounds of the step comparison")
    a = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fanout_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.ops import fanout as fo
    from emqx_tpu_torch.ops import trie_match as tm
    dev_line = cs.device_line()
    cs.log(f"device: {dev_line}")
    st = cs.load(a.filters, a.seed, "cuda")
    cs.add_broadcast(st)
    model = st["model"]
    rng = np.random.default_rng(a.seed + 1)
    topics = cs.make_topics(st["live"], rng, cs.BATCH, st["n_vehicles"])
    args = [torch.from_numpy(x).cuda() for x in model.index.tokenize(
        topics)[:3]]
    fids, _ = tm.match_compact(model._trie_dev, *args, K=model.K, M=model.M,
                               max_probes=model.index.max_probes)
    rowmap, pool = model._rowmap_dev, model._pool_dev
    bitmaps = cs.dense_bitmaps(model, st["subs"])
    small = fids[:64].contiguous()
    cases = {
        "fanout_pool": (lambda f: fo.fanout_pool(rowmap, pool, f), fids,
                        fo.fanout_pool_plain(rowmap, pool, fids)),
        "fanout_pool_64": (lambda f: fo.fanout_pool(rowmap, pool, f), small,
                           fo.fanout_pool_plain(rowmap, pool, small)),
        "fanout_bitmaps": (lambda f: fo.fanout_bitmaps(bitmaps, f), fids,
                           fo.fanout_bitmaps_plain(bitmaps, fids)),
    }
    fan = cases["fanout_bitmaps"][2]
    cases["bitmap_counts"] = (fo.bitmap_to_counts, fan,
                              fo.bitmap_to_counts_plain(fan))
    B, W = fan.shape
    work = {"fanout_pool": cs.fanout_pool_work(rowmap, pool, fids),
            "fanout_pool_64": cs.fanout_pool_work(rowmap, pool, small),
            "fanout_bitmaps": cs.fanout_bitmaps_work(bitmaps, fids),
            "bitmap_counts": (B * W * 4 + B * 4, B * W * 2, 0)}
    bounds = {k: cs.bound_ms(w[0], w[1])[0] for k, w in work.items()}
    info = {"B": fids.shape[0], "M": fids.shape[1], "pool": list(pool.shape),
            "bitmaps": list(bitmaps.shape),
            "valid_fids": int((fids >= 0).sum()),
            "dense_topics": int((cases["fanout_pool"][2] != 0).any(1).sum()),
            "bytes": {k: w[0] for k, w in work.items()}, "bound_ms": bounds}
    cs.log("inputs: " + json.dumps(info))

    t = time.time()
    libs = build(sorted(set(VARIANTS)), _build.BUILD_DIR / "fanout_ablation")
    cs.log(f"build: {time.time() - t:.1f}s")
    ptxas = ptxas_lines(libs["committed"][1]) + [
        f"bulk {line}" for line in ptxas_lines(libs["bulk"][1])
        if "bitmap_counts" in line]
    for line in ptxas:
        cs.log(f"ptxas: {line}")
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush_words = flush_buf.view(torch.int64)

    def clean_flush():
        flush_words.sum()

    out_buf = torch.empty_like(cases["fanout_pool"][2])
    fids_copy = torch.empty_like(fids)
    floors = {
        "empty_kernel": cs.time_ms(lambda: torch.cuda._sleep(1), a.reps,
                                   flush_buf.zero_),
        "empty_kernel_clean_l2": cs.time_ms(lambda: torch.cuda._sleep(1),
                                            a.reps, clean_flush),
        "empty_kernel_run": cs.run_ms(lambda x: torch.cuda._sleep(1),
                                      (fids[:1],)),
        "memset_output": cs.time_ms(out_buf.zero_, a.reps, flush_buf.zero_),
        "copy_fids": cs.time_ms(lambda: fids_copy.copy_(fids), a.reps,
                                flush_buf.zero_)}
    cs.log("floors: " + json.dumps(floors))
    results = []
    for variant in VARIANTS:
        bind(libs[variant][0])
        out = {"variant": variant}
        for name, (fn, f, want) in cases.items():
            if not torch.equal(fn(f), want):
                raise SystemExit(f"fanout_ablation: {variant} {name} differs "
                                 f"from the plain version")
            ms = cs.time_ms(lambda: fn(f), a.reps, flush_buf.zero_)
            out[name] = {"ms": ms, "of_bound": bounds[name] / ms,
                         "run_ms": cs.run_ms(fn, (f,))}
            if (variant in ("committed", "block", "warp_row")
                    and name != "fanout_pool_64"):
                out[name]["clean_l2_ms"] = cs.time_ms(lambda: fn(f), a.reps,
                                                      clean_flush)
        cs.log(json.dumps(out))
        results.append(out)
    steps = step_ab(model, args, fids, libs, a.rounds)
    cs.log("step: " + json.dumps(steps))
    torch.cuda.synchronize()
    record = {"device": dev_line, "filters": a.filters, "inputs": info,
              "ptxas": ptxas, "floors": floors, "variants": results,
              "step": steps}
    print(dev_line)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
