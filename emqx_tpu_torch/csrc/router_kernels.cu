// The publish routing step's device kernels, hand-written for Hopper (sm_90a).
//
// Built by emqx_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Every
// entry point launches on the stream it is given, allocates nothing (the
// Python wrapper allocates outputs with torch.empty) and returns
// cudaGetLastError() so a refused launch raises in the wrapper.
//
// What bounds them on an H100: all of them are gather/scatter kernels with a
// handful of integer operations per element.  The trie walk and the fan-out
// read 4-byte elements at data-dependent addresses in tables far larger than
// the 50 MB L2 (302 MB at 1M subscriptions), so each gather costs a 32-byte
// DRAM sector and, because the walk's levels depend on each other, a full
// memory latency.  They are latency-bound, not bandwidth-bound; their design
// keeps many independent topics in flight (one warp per topic) instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Must stay bit-identical to router/index.py edge_hash / edge_step (uint32
// wrap-around, logical shifts; the raw parent is hashed, -1 included).
__device__ __forceinline__ uint32_t edge_hash(int32_t parent, int32_t word,
                                              uint32_t mask) {
  uint32_t h = (uint32_t)parent * 0x9E3779B1u ^ (uint32_t)word * 0x85EBCA77u;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h & mask;
}

__device__ __forceinline__ uint32_t edge_step(int32_t parent, int32_t word,
                                              uint32_t mask) {
  uint32_t h = (uint32_t)parent * 0xC2B2AE3Du ^ (uint32_t)word * 0x27D4EB2Fu;
  h ^= h >> 13;
  h *= 0x165667B1u;
  h ^= h >> 16;
  return (h | 1u) & mask;
}

// Replaces emqx_tpu/ops/trie_match.py match_batch (with _edge_hash,
// _edge_step, _probe_exact and _pack_frontier): the K-capped frontier walk.
//
// One warp per topic, frontier slot k on lane k (K <= 32).  Per level the
// live lanes gather hash_fid / node_fid, probe the edge table for the exact
// child (the _probe_exact loop: one counted round per live lane until a hit
// or an empty slot), read plus_child, and the warp sorts its 2K next-level
// candidates descending with a 64-wide bitonic network (element e = lane for
// the exact child, lane + 32 for the plus child; shuffles for distances
// below 32) and keeps the top K - the reference's "K largest node ids" rule,
// which fixes the frontier order and with it the candidate layout.
//
// cand [B, (L+1)*2K] is written in the reference's layout: all (L+1)*K hash
// emissions (level-major, then frontier slot), then all (L+1)*K end
// emissions.  stats [B, 4] = (frontier peak, probe rounds, valid candidates,
// overflow) per topic; the wrapper reduces them to the counters.
//
// The same kernel also replaces trie_match.py match_batch_sharded (the walk
// vmapped over a stacked [S, H] / [S, N] trie): blockIdx.y is the shard s,
// whose tables start at s*h_stride / s*n_stride (64-bit offsets: S*H can
// pass 2^31, e.g. 10M subscriptions at S >= 8) and whose outputs are
// cand [S, B, C] and stats [S, B, 4].  Every shard walks every topic.  The
// flat walk is the kStacked = false instantiation, which has no offsets to
// compute.  Node arrays of a shorter shard are padded with -1, and the walk
// never reaches a node id past the shard's own nodes, so the padding is
// never read.
template <bool kStacked>
__global__ void __launch_bounds__(256)
trie_walk_kernel(const int32_t* __restrict__ ht_parent,
                 const int32_t* __restrict__ ht_word,
                 const int32_t* __restrict__ ht_child,
                 const int32_t* __restrict__ plus_child,
                 const int32_t* __restrict__ hash_fid,
                 const int32_t* __restrict__ node_fid, uint32_t hmask,
                 int64_t h_stride, int64_t n_stride,
                 const int32_t* __restrict__ tokens,
                 const int32_t* __restrict__ lengths,
                 const uint8_t* __restrict__ sys_flags, int B, int L, int K,
                 int max_probes, int32_t* __restrict__ cand,
                 int32_t* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp
  size_t row = b;
  if (kStacked) {
    const int64_t shard = blockIdx.y;
    ht_parent += shard * h_stride;
    ht_word += shard * h_stride;
    ht_child += shard * h_stride;
    plus_child += shard * n_stride;
    hash_fid += shard * n_stride;
    node_fid += shard * n_stride;
    row += (size_t)shard * B;
  }
  const size_t C = (size_t)(L + 1) * 2 * K;
  int32_t* hash_out = cand + row * C;
  int32_t* end_out = hash_out + (size_t)(L + 1) * K;
  const int len = lengths[b];
  const bool sys = sys_flags[b] != 0;
  const bool slot = lane < K;

  int32_t front = lane == 0 ? 0 : -1;  // the root
  int peak = 0;
  unsigned probes = 0, n_cand = 0;
  bool over = false;
  for (int i = 0; i <= L; ++i) {
    const bool valid = front >= 0;
    peak = max(peak, __popc(__ballot_sync(kFull, valid)));
    const bool active = i <= len, ended = i == len, advancing = i < len;
    const bool sys_block = sys && i == 0;
    const int32_t tok = i < L ? tokens[(size_t)b * L + i] : 0;  // PAD

    // the node-field gathers and the first probe round are independent:
    // issue them together so a level costs few memory latencies
    int32_t h_em = -1, e_em = -1, plus = -1;
    if (valid && active && !sys_block) h_em = hash_fid[front];
    if (valid && ended) e_em = node_fid[front];
    if (valid && advancing && !sys_block) plus = plus_child[front];

    int32_t exact = -1;
    if (valid && advancing) {
      const uint32_t h = edge_hash(front, tok, hmask);
      const uint32_t st = edge_step(front, tok, hmask);
      for (int p = 0; p < max_probes; ++p) {
        ++probes;
        const uint32_t s = (h + (uint32_t)p * st) & hmask;
        const int32_t sp = ht_parent[s], sw = ht_word[s], sc = ht_child[s];
        if (sp == front && sw == tok) {
          exact = sc;
          break;
        }
        if (sp == -1) break;
      }
    }
    if (slot) {
      hash_out[i * K + lane] = h_em;
      end_out[i * K + lane] = e_em;
    }
    n_cand += (h_em >= 0) + (e_em >= 0);

    const int n_next = __popc(__ballot_sync(kFull, exact >= 0)) +
                       __popc(__ballot_sync(kFull, plus >= 0));
    over |= n_next > K;

    int32_t v0 = exact, v1 = plus;
#pragma unroll
    for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        if (j == 32) {  // only at k == 64, where every block descends
          const int32_t hi = max(v0, v1);
          v1 = min(v0, v1);
          v0 = hi;
        } else {
          const int32_t p0 = __shfl_xor_sync(kFull, v0, j);
          const int32_t p1 = __shfl_xor_sync(kFull, v1, j);
          const bool lower = (lane & j) == 0;
          const bool desc0 = (lane & k) == 0;
          const bool desc1 = ((lane + 32) & k) == 0;
          v0 = lower == desc0 ? max(v0, p0) : min(v0, p0);
          v1 = lower == desc1 ? max(v1, p1) : min(v1, p1);
        }
      }
    }
    front = slot ? v0 : -1;
  }
  probes = __reduce_add_sync(kFull, probes);
  n_cand = __reduce_add_sync(kFull, n_cand);
  if (lane == 0) {
    int32_t* st = stats + row * 4;
    st[0] = peak;
    st[1] = (int32_t)probes;
    st[2] = (int32_t)n_cand;
    st[3] = over ? 1 : 0;
  }
}

// Replaces emqx_tpu/ops/trie_match.py compact_fids: stable compaction of the
// >= 0 entries of each [C] row to its first M, plus truncated = n > M.
// One warp per row, 32 columns at a time: a ballot gives each valid lane its
// rank among the row's valid entries so far.  Bound by streaming the
// candidate block once (B*C*4 bytes read, B*M*4 written).
__global__ void __launch_bounds__(256)
compact_kernel(const int32_t* __restrict__ cand, int B, int C, int M,
               int32_t* __restrict__ fids, uint8_t* __restrict__ truncated) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;
  const int32_t* src = cand + (size_t)row * C;
  int32_t* dst = fids + (size_t)row * M;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const int32_t v = c < C ? src[c] : -1;
    const unsigned m = __ballot_sync(kFull, v >= 0);
    const int pos = base + __popc(m & below);
    if (v >= 0 && pos < M) dst[pos] = v;
    base += __popc(m);
  }
  for (int p = base + lane; p < M; p += 32) dst[p] = -1;
  if (lane == 0) truncated[row] = base > M ? 1 : 0;
}

// Replaces emqx_tpu/ops/fanout.py fanout_pool: fid -> rowmap[fid] (skip -1),
// then the OR of those dense-pool rows.  One block per topic: its threads
// first map the row's M fids and list the dense rows in shared memory (a
// topic has a few), then each thread ORs its bitmap words over the listed
// rows in registers and stores once.
// Bound by writing the [B, W] output (and the pool rows read per match).
__global__ void fanout_pool_kernel(const int32_t* __restrict__ rowmap, int F,
                                   const int32_t* __restrict__ pool, int P,
                                   int W, const int32_t* __restrict__ fids,
                                   int M, int32_t* __restrict__ out) {
  extern __shared__ int32_t rows[];  // [M]: the topic's dense rows, any order
  __shared__ int n_rows;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) n_rows = 0;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int32_t f = fids[(size_t)b * M + m];
    const int32_t r = (f >= 0 && f < F) ? rowmap[f] : -1;
    if (r >= 0 && r < P) rows[atomicAdd(&n_rows, 1)] = r;  // OR commutes
  }
  __syncthreads();
  const int n = n_rows;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int32_t acc = 0;
    for (int k = 0; k < n; ++k) acc |= pool[(size_t)rows[k] * W + w];
    out[(size_t)b * W + w] = acc;
  }
}

// Replaces emqx_tpu/models/router_model.py _apply_patches: one launch writes
// every padded element update into the live tables in place.  upd is
// [17, cap] int32: rows (2t, 2t+1) = (index, value) for the six trie fields
// t in DeviceTrie order, rows 12/13 = rowmap (index, value), rows 14/15/16 =
// pool (row, column, value).  Padding repeats an identical (index, value),
// so duplicate writes agree.  Indices were range-checked on the host.
// Bound by launch latency: cap is small (64..4096 updates).
__global__ void patch_kernel(int32_t* __restrict__ t0, int32_t* __restrict__ t1,
                             int32_t* __restrict__ t2, int32_t* __restrict__ t3,
                             int32_t* __restrict__ t4, int32_t* __restrict__ t5,
                             int32_t* __restrict__ rowmap,
                             int32_t* __restrict__ pool, int W,
                             const int32_t* __restrict__ upd, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  int32_t* const trie[6] = {t0, t1, t2, t3, t4, t5};
#pragma unroll
  for (int t = 0; t < 6; ++t)
    trie[t][upd[(2 * t) * cap + i]] = upd[(2 * t + 1) * cap + i];
  rowmap[upd[12 * cap + i]] = upd[13 * cap + i];
  pool[(size_t)upd[14 * cap + i] * W + upd[15 * cap + i]] = upd[16 * cap + i];
}

// Replaces emqx_tpu/ops/trie_match.py compact_fids_sharded (the per-shard
// compact, local -> global translation, shard-major merge and second compact
// that router_step_sharded inlines) with one pass.  One warp per topic row
// reads the row's S shard segments of cand [S, B, C] in shard order and
// ranks each segment's valid entries by ballot and popc, as compact_kernel
// does.  The first min(n_s, M) of segment s are exactly what the shard's own
// compact keeps, and the shard-major merge's compact keeps the first Mout of
// their concatenation, so entry r of segment s lands at (sum of the earlier
// shards' min(n, M)) + r, as local * n_shards + s, while that is < Mout.
// The whole segment is still counted: n [S, B] gives the step its per-shard
// counters, and truncated = (some n_s > M) | (sum of min(n_s, M) > M).
// Bound by streaming the [S, B, C] candidate block once.
__global__ void __launch_bounds__(256)
compact_sharded_kernel(const int32_t* __restrict__ cand, int S, int B, int C,
                       int M, int Mout, int n_shards,
                       int32_t* __restrict__ fids,
                       uint8_t* __restrict__ truncated,
                       int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  int32_t* dst = fids + (size_t)b * Mout;
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  bool spill = false;
  for (int s = 0; s < S; ++s) {
    const int32_t* src = cand + ((size_t)s * B + b) * C;
    int base = 0;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      const int32_t v = c < C ? src[c] : -1;
      const unsigned m = __ballot_sync(kFull, v >= 0);
      const int r = base + __popc(m & below);
      if (v >= 0 && r < M && total + r < Mout)
        dst[total + r] = v * n_shards + s;
      base += __popc(m);
    }
    if (lane == 0) counts[(size_t)s * B + b] = base;
    spill |= base > M;
    total += min(base, M);
  }
  for (int p = min(total, Mout) + lane; p < Mout; p += 32) dst[p] = -1;
  if (lane == 0) truncated[b] = (spill || total > M) ? 1 : 0;
}

// Replaces emqx_tpu/ops/fanout.py fanout_bitmaps: the OR of the dense
// bitmap rows bitmaps[fid] of each topic's valid fids.  One block per topic,
// laid out as fanout_pool_kernel: list the valid fids in shared memory, then
// each thread ORs its words over them in registers and stores once.
// Bound by reading one W-word row per matched fid and writing [B, W].
__global__ void fanout_bitmaps_kernel(const int32_t* __restrict__ bitmaps,
                                      int F, int W,
                                      const int32_t* __restrict__ fids, int M,
                                      int32_t* __restrict__ out) {
  extern __shared__ int32_t rows[];  // [M]: the topic's valid fids
  __shared__ int n_rows;
  const int b = blockIdx.x;
  if (threadIdx.x == 0) n_rows = 0;
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int32_t f = fids[(size_t)b * M + m];
    if (f >= 0 && f < F) rows[atomicAdd(&n_rows, 1)] = f;  // OR commutes
  }
  __syncthreads();
  const int n = n_rows;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int32_t acc = 0;
    for (int k = 0; k < n; ++k) acc |= bitmaps[(size_t)rows[k] * W + w];
    out[(size_t)b * W + w] = acc;
  }
}

// Replaces emqx_tpu/ops/fanout.py bitmap_to_counts: the popcount of each
// [W] row of bitmap words.  One warp per row, __popc per word and a warp
// sum.  Bound by reading [B, W] once.
__global__ void __launch_bounds__(256)
bitmap_counts_kernel(const int32_t* __restrict__ fan, int B, int W,
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

extern "C" {

const char* router_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int trie_walk(const void* ht_parent, const void* ht_word, const void* ht_child,
              const void* plus_child, const void* hash_fid,
              const void* node_fid, unsigned hmask, const void* tokens,
              const void* lengths, const void* sys_flags, int B, int L, int K,
              int max_probes, void* cand, void* stats, void* stream) {
  const int warps = 8;
  trie_walk_kernel<false><<<(B + warps - 1) / warps, warps * 32, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)ht_parent, (const int32_t*)ht_word,
      (const int32_t*)ht_child, (const int32_t*)plus_child,
      (const int32_t*)hash_fid, (const int32_t*)node_fid, hmask, 0, 0,
      (const int32_t*)tokens, (const int32_t*)lengths,
      (const uint8_t*)sys_flags, B, L, K, max_probes, (int32_t*)cand,
      (int32_t*)stats);
  return (int)cudaGetLastError();
}

int trie_walk_sharded(const void* ht_parent, const void* ht_word,
                      const void* ht_child, const void* plus_child,
                      const void* hash_fid, const void* node_fid,
                      unsigned hmask, long long h_stride, long long n_stride,
                      const void* tokens, const void* lengths,
                      const void* sys_flags, int B, int L, int K,
                      int max_probes, int S, void* cand, void* stats,
                      void* stream) {
  const int warps = 8;
  const dim3 grid((B + warps - 1) / warps, S);
  trie_walk_kernel<true><<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ht_parent, (const int32_t*)ht_word,
      (const int32_t*)ht_child, (const int32_t*)plus_child,
      (const int32_t*)hash_fid, (const int32_t*)node_fid, hmask,
      (int64_t)h_stride, (int64_t)n_stride, (const int32_t*)tokens,
      (const int32_t*)lengths, (const uint8_t*)sys_flags, B, L, K,
      max_probes, (int32_t*)cand, (int32_t*)stats);
  return (int)cudaGetLastError();
}

int compact_sharded(const void* cand, int S, int B, int C, int M, int Mout,
                    int n_shards, void* fids, void* truncated, void* counts,
                    void* stream) {
  const int warps = 8;
  compact_sharded_kernel<<<(B + warps - 1) / warps, warps * 32, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)cand, S, B, C, M, Mout, n_shards, (int32_t*)fids,
      (uint8_t*)truncated, (int32_t*)counts);
  return (int)cudaGetLastError();
}

int fanout_bitmaps(const void* bitmaps, int F, int W, const void* fids,
                   int B, int M, void* out, void* stream) {
  int threads = ((W + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  fanout_bitmaps_kernel<<<B, threads, (size_t)M * sizeof(int32_t),
                          (cudaStream_t)stream>>>(
      (const int32_t*)bitmaps, F, W, (const int32_t*)fids, M,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int bitmap_counts(const void* fan, int B, int W, void* counts,
                  void* stream) {
  const int warps = 8;
  bitmap_counts_kernel<<<(B + warps - 1) / warps, warps * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)fan, B, W, (int32_t*)counts);
  return (int)cudaGetLastError();
}

int compact(const void* cand, int B, int C, int M, void* fids,
            void* truncated, void* stream) {
  const int warps = 8;
  compact_kernel<<<(B + warps - 1) / warps, warps * 32, 0,
                   (cudaStream_t)stream>>>((const int32_t*)cand, B, C, M,
                                           (int32_t*)fids,
                                           (uint8_t*)truncated);
  return (int)cudaGetLastError();
}

int fanout_pool(const void* rowmap, int F, const void* pool, int P, int W,
                const void* fids, int B, int M, void* out, void* stream) {
  int threads = ((W + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  fanout_pool_kernel<<<B, threads, (size_t)M * sizeof(int32_t),
                       (cudaStream_t)stream>>>(
      (const int32_t*)rowmap, F, (const int32_t*)pool, P, W,
      (const int32_t*)fids, M, (int32_t*)out);
  return (int)cudaGetLastError();
}

int patch(void* t0, void* t1, void* t2, void* t3, void* t4, void* t5,
          void* rowmap, void* pool, int W, const void* upd, int cap,
          void* stream) {
  const int threads = 256;
  patch_kernel<<<(cap + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (int32_t*)t0, (int32_t*)t1, (int32_t*)t2, (int32_t*)t3, (int32_t*)t4,
      (int32_t*)t5, (int32_t*)rowmap, (int32_t*)pool, W,
      (const int32_t*)upd, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
