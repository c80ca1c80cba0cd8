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
// read at data-dependent addresses in tables far larger than the 50 MB L2
// (402 MB of trie records at 1M subscriptions), so each gather costs at
// least one 32-byte DRAM sector, and the walk's levels depend on each other.
// The walk is bound by that chain and by the instructions of its per-level
// frontier selection.  It therefore reads each edge-table slot and each node
// as one 16-byte record (one sector where three 4-byte arrays cost three),
// ranks narrow frontiers instead of sorting them, stops at the topic's last
// level, and on the routing step compacts its matches as it walks instead
// of writing a candidate block for a second kernel.  Many topics stay in
// flight (one warp per topic) to cover the latency.

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

// The trie's device layout: edge-table slot s is the int32 record
// edges[s] = (parent, word, child, -1) and node n is nodes[n] = (plus_child,
// hash_fid, node_fid, -1) (ops/trie_match.py DeviceTrie), so each probe round
// and each node is one 16-byte load.  tools/walk_ablation.py rewrites those
// two loads into reads of separate field arrays to time the earlier layout.

struct WalkStats {
  int peak;         // frontier peak over the levels
  unsigned probes;  // probe rounds of the warp's live lanes
  int n;            // valid candidates (uncapped)
  bool over;        // some level's next frontier held more than K
};

// Next-level frontiers of at most this many live candidates are selected
// by rank counting; wider ones by the sort network.
constexpr int kRankMax = 16;

// The K largest live next-level candidates, descending, one per lane (lane
// k gets the k-th largest, -1 past them): the reference's _pack_frontier.
// Candidate e is the exact child on lane e or the plus child on lane
// e - 32; mx / mp are their live-lane ballots, n = popc(mx) + popc(mp) > 0.
//
// Few live lanes (n <= kRankMax, the common case: a fleet topic's frontier
// holds 1-3 nodes): each live candidate's rank is the number of live
// candidates larger than it, from n broadcasts, and rank r < K goes to
// lane r through the warp's 32-int row of pick.  The live node ids of one
// level are distinct (the trie is a tree; equal values would rank by
// candidate index, which gives the same values), so this is the sorted
// order.  Wider frontiers take the 64-wide bitonic network (shuffles for
// distances below 32; at 21 stages per level it was half of the walk's
// time on the card, tools/walk_ablation.py).
__device__ __forceinline__ int32_t next_frontier(int32_t exact, int32_t plus,
                                                 unsigned mx, unsigned mp,
                                                 int K, int32_t* pick) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(mx) + __popc(mp);
  if (n <= kRankMax) {
    int re = 0, rp = 0;  // ranks of this lane's exact and plus candidates
    for (unsigned m = mx; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int32_t x = __shfl_sync(kFull, exact, src);
      re += x > exact || (x == exact && src < lane);
      rp += x >= plus;
    }
    for (unsigned m = mp; m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int32_t x = __shfl_sync(kFull, plus, src);
      re += x > exact;
      rp += x > plus || (x == plus && src < lane);
    }
    if (exact >= 0 && re < K) pick[re] = exact;
    if (plus >= 0 && rp < K) pick[rp] = plus;
    __syncwarp();
    const int32_t front = lane < min(n, K) ? pick[lane] : -1;
    __syncwarp();
    return front;
  }
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
  return lane < K ? v0 : -1;
}

// The K-capped frontier walk of one topic on one warp: frontier slot k on
// lane k (K <= 32).  Replaces emqx_tpu/ops/trie_match.py match_batch (:213,
// with _edge_hash, _edge_step, _probe_exact and _pack_frontier) and, run
// once per shard, match_batch_sharded (:366); in its compacted mode it also
// replaces compact_fids (:316) and compact_fids_sharded (:399) on the
// routing step.
//
// Per level the live lanes read their node record (hash_fid, node_fid and
// plus_child in one load), probe the edge table for the exact child (the
// _probe_exact loop: one counted round per live lane until a hit or an
// empty slot, one record load per round), and the warp keeps the K largest
// of its 2K next-level candidates, descending (next_frontier) - the
// reference's "K largest node ids" rule, which fixes the frontier order and
// with it the output order.
//
// What bounds it on an H100: a chain of dependent gathers per level into
// tables 8x the L2, and the instructions that select each next frontier.
// On the card (tools/walk_ablation.py) the 64-wide sort network was half
// of the walk's time while the frontiers hold 1-3 nodes; next_frontier
// ranks such frontiers in a few broadcasts instead.  The records cut a
// probe round or a node from three 4-byte gathers (three sectors) to one
// 16-byte load.  The walk stops after level min(len, L), or at an empty
// frontier: an end emission needs i == len, a '#' emission i <= len and an
// advance i < len (trie_match.py:253-272), so nothing after that level
// emits or advances and the stop is exact.  The last level's next frontier
// is never read, so it is not selected; its probes still count, as in the
// reference.
//
// kCompact = false writes the reference's cand row at row[0, (L+1)*2K):
// all (L+1)*K hash emissions (level-major, then slot), then all (L+1)*K end
// emissions, -1 for the levels it skipped.  kCompact = true appends each
// valid emission at row[n] while n < width, by ballot and popc, and keeps
// counting past width.  That order is the compacted cand row: end
// emissions happen only at level len, which is also the last level that
// emits '#' fids, so the row is every level's hash fids, then level len's
// end fids, each in slot order, with no staging.
template <bool kCompact>
__device__ __forceinline__ WalkStats walk_topic(
    const int4* __restrict__ edges, const int4* __restrict__ nodes,
    uint32_t hmask, const int32_t* __restrict__ tok, int len, bool sys,
    int L, int K, int max_probes, int32_t* row, int width) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool slot = lane < K;
  const int last = max(0, min(len, L));
  __shared__ int32_t pick_rows[32][32];  // next_frontier's, one per warp
  int32_t* pick = pick_rows[threadIdx.x >> 5];
  int32_t front = lane == 0 ? 0 : -1;  // the root
  WalkStats st = {0, 0u, 0, false};

  // one valid value per lane, appended in lane order
  auto append = [&](int32_t v) {
    const unsigned m = __ballot_sync(kFull, v >= 0);
    const int pos = st.n + __popc(m & below);
    if (v >= 0 && pos < width) row[pos] = v;
    st.n += __popc(m);
  };

  int i = 0;
  for (; i <= last; ++i) {
    const unsigned live = __ballot_sync(kFull, front >= 0);
    if (!live) break;  // an empty frontier stays empty
    st.peak = max(st.peak, __popc(live));
    const bool valid = front >= 0;
    const bool active = i <= len, ended = i == len, advancing = i < len;
    const bool sys_block = sys && i == 0;
    const int32_t word = i < L ? tok[i] : 0;  // PAD

    // the node record and the first probe round are independent: both
    // loads are in flight together
    int32_t h_em = -1, e_em = -1, plus = -1;
    if (valid) {
      const int4 nd = __ldg(nodes + front);
      if (active && !sys_block) h_em = nd.y;
      if (ended) e_em = nd.z;
      if (advancing && !sys_block) plus = nd.x;
    }
    int32_t exact = -1;
    if (valid && advancing) {
      const uint32_t h = edge_hash(front, word, hmask);
      const uint32_t step = edge_step(front, word, hmask);
      for (int p = 0; p < max_probes; ++p) {
        ++st.probes;
        const int4 e = __ldg(edges + ((h + (uint32_t)p * step) & hmask));
        if (e.x == front && e.y == word) {
          exact = e.z;
          break;
        }
        if (e.x == -1) break;
      }
    }
    if constexpr (kCompact) {
      append(h_em);
      if (ended) append(e_em);  // warp-uniform
    } else {
      if (slot) {
        row[i * K + lane] = h_em;
        row[(size_t)(L + 1 + i) * K + lane] = e_em;
      }
      st.n += __popc(__ballot_sync(kFull, h_em >= 0)) +
              __popc(__ballot_sync(kFull, e_em >= 0));
    }

    const unsigned mx = __ballot_sync(kFull, exact >= 0);
    const unsigned mp = __ballot_sync(kFull, plus >= 0);
    const int n_next = __popc(mx) + __popc(mp);
    st.over |= n_next > K;
    if (i == last || n_next == 0) {  // no later level reads it
      front = -1;
      continue;
    }
    front = next_frontier(exact, plus, mx, mp, K, pick);
  }
  if constexpr (!kCompact) {
    for (; i <= L; ++i) {  // the levels after the stop emit nothing
      if (slot) {
        row[i * K + lane] = -1;
        row[(size_t)(L + 1 + i) * K + lane] = -1;
      }
    }
  }
  st.probes = __reduce_add_sync(kFull, st.probes);
  return st;
}

__device__ __forceinline__ void store_stats(int32_t* __restrict__ out,
                                            const WalkStats& st) {
  out[0] = st.peak;
  out[1] = (int32_t)st.probes;
  out[2] = st.n;
  out[3] = st.over ? 1 : 0;
}

// match_batch / match_batch_sharded: the walk in its cand mode.  One warp
// per topic; cand [B, (L+1)*2K] and stats [B, 4] = (frontier peak, probe
// rounds, valid candidates, overflow) per topic, which the wrapper reduces
// to the counters.  The stacked instantiation walks shard blockIdx.y, whose
// records start at s*h_stride / s*n_stride (64-bit offsets: S*H can pass
// 2^31), into cand [S, B, C] and stats [S, B, 4].  Node records of a
// shorter shard are padded with -1, and the walk never reaches a node id
// past the shard's own nodes, so the padding is never read.
template <bool kStacked>
__global__ void __launch_bounds__(256)
trie_walk_kernel(const int4* __restrict__ edges,
                 const int4* __restrict__ nodes, uint32_t hmask,
                 int64_t h_stride, int64_t n_stride,
                 const int32_t* __restrict__ tokens,
                 const int32_t* __restrict__ lengths,
                 const uint8_t* __restrict__ sys_flags, int B, int L, int K,
                 int max_probes, int32_t* __restrict__ cand,
                 int32_t* __restrict__ stats) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp
  size_t row = b;
  if (kStacked) {
    const int64_t shard = blockIdx.y;
    edges += shard * h_stride;
    nodes += shard * n_stride;
    row += (size_t)shard * B;
  }
  const size_t C = (size_t)(L + 1) * 2 * K;
  const WalkStats st = walk_topic<false>(
      edges, nodes, hmask, tokens + (size_t)b * L, lengths[b],
      sys_flags[b] != 0, L, K, max_probes, cand + row * C, 0);
  if ((threadIdx.x & 31) == 0) store_stats(stats + row * 4, st);
}

// The routing step's walk: the walk in its compacted mode, which takes the
// candidate block and the compact kernel off the step.
//
// Flat (kStacked = false): one warp per topic appends straight into its
// fids row [width = min(M, C)] and pads it with -1; stats [B, 4] carries
// the uncapped n, so truncated = n > M.
//
// Stacked: the S warps that walk one topic's S shards sit in one block
// (T topics, blockDim 32*S*T).  Each compacts its shard's matches to
// width = min(M, C) entries in shared memory; after a barrier, shard s's
// first min(n_s, M) entries land after the earlier shards' kept counts, as
// local * n_shards + s, while that is < Mout = min(M, S*width) - exactly
// per-shard compact, shard-major merge and second compact
// (compact_sharded_kernel below).  stats [S, B, 4] carries n_s, and
// truncated = (some n_s > M) | (sum of min(n_s, M) > M).
template <bool kStacked>
__global__ void __launch_bounds__(kStacked ? 1024 : 256)
walk_compact_kernel(const int4* __restrict__ edges,
                    const int4* __restrict__ nodes, uint32_t hmask,
                    int64_t h_stride, int64_t n_stride,
                    const int32_t* __restrict__ tokens,
                    const int32_t* __restrict__ lengths,
                    const uint8_t* __restrict__ sys_flags, int B, int L,
                    int K, int max_probes, int S, int M, int width, int Mout,
                    int n_shards, int32_t* __restrict__ fids,
                    int32_t* __restrict__ stats,
                    uint8_t* __restrict__ truncated) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if constexpr (!kStacked) {
    const int b = blockIdx.x * (blockDim.x >> 5) + w;
    if (b >= B) return;  // uniform per warp
    int32_t* row = fids + (size_t)b * width;
    const WalkStats st = walk_topic<true>(
        edges, nodes, hmask, tokens + (size_t)b * L, lengths[b],
        sys_flags[b] != 0, L, K, max_probes, row, width);
    for (int p = min(st.n, width) + lane; p < width; p += 32) row[p] = -1;
    if (lane == 0) store_stats(stats + (size_t)b * 4, st);
    return;
  }
  extern __shared__ int32_t seg[];  // [S*T, width]: each warp's segment
  __shared__ int count[32];         // each warp's n
  const int t = w / S, s = w % S;
  const int b = blockIdx.x * (blockDim.x / (32 * S)) + t;
  int32_t* mine = seg + (size_t)w * width;
  if (b < B) {  // no return before the barrier
    const WalkStats st = walk_topic<true>(
        edges + s * h_stride, nodes + s * n_stride, hmask,
        tokens + (size_t)b * L, lengths[b], sys_flags[b] != 0, L, K,
        max_probes, mine, width);
    if (lane == 0) {
      count[w] = st.n;
      store_stats(stats + ((size_t)s * B + b) * 4, st);
    }
  }
  __syncthreads();
  if (b >= B) return;
  int off = 0, total = 0;
  bool spill = false;
  for (int r = 0; r < S; ++r) {
    const int c = count[t * S + r];
    if (r < s) off += min(c, M);
    total += min(c, M);
    spill |= c > M;
  }
  int32_t* dst = fids + (size_t)b * Mout;
  const int keep = min(min(count[w], width), Mout - off);
  for (int r = lane; r < keep; r += 32) dst[off + r] = mine[r] * n_shards + s;
  if (s == 0) {
    for (int p = min(total, Mout) + lane; p < Mout; p += 32) dst[p] = -1;
    if (lane == 0) truncated[b] = (spill || total > M) ? 1 : 0;
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

// The gather-OR of both fan-outs: out[b] = the OR of the W-word rows of a
// [P, W] table that topic b's M fids select.  kRowmap = true replaces
// emqx_tpu/ops/fanout.py fanout_pool: fid -> rowmap[fid] (F entries), and
// an entry selects pool row r when 0 <= fid < F and 0 <= r < P.
// kRowmap = false replaces fanout_bitmaps: the fid is the bitmap row,
// selected when 0 <= fid < F.  -1 and out-of-range entries may sit in any
// column; rows are ORed in any order (OR commutes).
//
// What bounds it on an H100: bytes.  The [B, M] fids are read and the
// [B, W] output written once (at the routing width, 512 B and 1 KB per
// topic), plus one rowmap word per valid fid and one W-word row per
// selected entry: pool rows stay in L2, the [F, W] bitmap's rows are DRAM
// gathers.  Each topic is a dependent chain (fids, rowmap, rows, store),
// so the design keeps many loads in flight per SM and moves 16 bytes per
// access (tools/fanout_ablation.py times each point):
//  - one warp per topic, persistent: the launch fills the SMs once and
//    each warp strides over the topics; a topic's rowmap gathers are
//    issued first, then the next topic's fids load, which stays in flight
//    while this topic lists, ORs and stores (a deeper pipeline, with the
//    next topic's rowmap gathers in flight too, gained nothing);
//  - 16-byte accesses: 4 fids per lane (128 per warp), and the rows and
//    the output as int4 where W % 4 == 0 and the pointers are aligned;
//    a scalar path takes any other M, W or alignment;
//  - a lane's (up to 4) rowmap gathers are issued together, the topic's
//    selected rows listed by ballot and popc in a per-warp list with
//    __syncwarp only (no shared atomics, no block barrier);
//  - rows are ORed four at a time, all their loads issued first;
//  - a topic that selects no row stores its zeros without reading a row.
// A warp holds kOrTile output words (8 per lane) and maps kOrChunk fids at
// a time; wider rows and longer fid rows loop over tiles and chunks.
constexpr int kOrWarps = 8;    // warps per block
constexpr int kOrChunk = 128;  // fids mapped at once: 4 per lane
constexpr int kOrTile = 256;   // output words held at once: 8 per lane

__device__ __forceinline__ void or_into(int4& a, const int4& v) {
  a.x |= v.x;
  a.y |= v.y;
  a.z |= v.z;
  a.w |= v.w;
}

// Chunk c of topic b's fids, 4 per lane, -1 past M and for b >= B.  The
// vector path (M % 4 == 0, fids 16-byte aligned) reads fids 4l..4l+3 of
// the chunk as one int4; the scalar path reads fids j*32 + l, coalesced.
template <bool kVecF>
__device__ __forceinline__ int4 load_fids(const int32_t* __restrict__ fids,
                                          int M, int B, int b, int c,
                                          int lane) {
  int4 f = make_int4(-1, -1, -1, -1);
  if (b >= B) return f;
  const int32_t* row = fids + (size_t)b * M;
  const int m0 = c * kOrChunk;
  if constexpr (kVecF) {
    if (m0 + 4 * lane < M)
      f = __ldg(reinterpret_cast<const int4*>(row + m0) + lane);
  } else {
    if (m0 + lane < M) f.x = __ldg(row + m0 + lane);
    if (m0 + 32 + lane < M) f.y = __ldg(row + m0 + 32 + lane);
    if (m0 + 64 + lane < M) f.z = __ldg(row + m0 + 64 + lane);
    if (m0 + 96 + lane < M) f.w = __ldg(row + m0 + 96 + lane);
  }
  return f;
}

// The rowmap words of a lane's 4 entries (kRowmap), -1 for an entry that
// is no fid in [0, F); without a rowmap the fid is the row.  The four
// gathers are independent: all are in flight together.
template <bool kRowmap>
__device__ __forceinline__ int4 gather_rows(int4 f,
                                            const int32_t* __restrict__ rowmap,
                                            int F) {
  const bool v0 = f.x >= 0 && f.x < F, v1 = f.y >= 0 && f.y < F,
             v2 = f.z >= 0 && f.z < F, v3 = f.w >= 0 && f.w < F;
  if constexpr (!kRowmap)
    return make_int4(v0 ? f.x : -1, v1 ? f.y : -1, v2 ? f.z : -1,
                     v3 ? f.w : -1);
  int4 r = make_int4(-1, -1, -1, -1);
  if (v0) r.x = __ldg(rowmap + f.x);
  if (v1) r.y = __ldg(rowmap + f.y);
  if (v2) r.z = __ldg(rowmap + f.z);
  if (v3) r.w = __ldg(rowmap + f.w);
  return r;
}

// The row each entry selects, or -1: a pool row lies in [0, P).
template <bool kRowmap>
__device__ __forceinline__ int4 select_rows(int4 r, int P) {
  if constexpr (!kRowmap) return r;
  return make_int4(r.x >= 0 && r.x < P ? r.x : -1,
                   r.y >= 0 && r.y < P ? r.y : -1,
                   r.z >= 0 && r.z < P ? r.z : -1,
                   r.w >= 0 && r.w < P ? r.w : -1);
}

// Appends the lane's selected rows to the warp's list; returns how many
// the warp listed.
__device__ __forceinline__ int list_rows(int4 r, int32_t* list, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const int32_t v[4] = {r.x, r.y, r.z, r.w};
  int n = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned m = __ballot_sync(kFull, v[j] >= 0);
    if (v[j] >= 0) list[n + __popc(m & below)] = v[j];
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// Word group u (0, 1) of tile t of the row at word offset off, for this
// lane: as an int4, the int4 column t*64 + u*32 + lane (vector path); else
// words t*256 + u*128 + j*32 + lane, j = 0..3.  Zeros past W.
template <bool kVecW>
__device__ __forceinline__ int4 load_words(const int32_t* __restrict__ table,
                                           size_t off, int W, int t, int u,
                                           int lane) {
  if constexpr (kVecW) {
    const int q = t * (kOrTile / 4) + u * 32 + lane;
    if (q < (W >> 2))
      return __ldg(reinterpret_cast<const int4*>(table + off) + q);
    return make_int4(0, 0, 0, 0);
  } else {
    const int w = t * kOrTile + u * 128 + lane;
    const int32_t* p = table + off;
    return make_int4(w < W ? __ldg(p + w) : 0,
                     w + 32 < W ? __ldg(p + w + 32) : 0,
                     w + 64 < W ? __ldg(p + w + 64) : 0,
                     w + 96 < W ? __ldg(p + w + 96) : 0);
  }
}

template <bool kVecW>
__device__ __forceinline__ void store_words(int32_t* __restrict__ row, int W,
                                            int t, int u, int lane, int4 v) {
  if constexpr (kVecW) {
    const int q = t * (kOrTile / 4) + u * 32 + lane;
    if (q < (W >> 2)) reinterpret_cast<int4*>(row)[q] = v;
  } else {
    const int w = t * kOrTile + u * 128 + lane;
    if (w < W) row[w] = v.x;
    if (w + 32 < W) row[w + 32] = v.y;
    if (w + 64 < W) row[w + 64] = v.z;
    if (w + 96 < W) row[w + 96] = v.w;
  }
}

template <bool kRowmap, bool kVecF, bool kVecW>
__global__ void __launch_bounds__(kOrWarps * 32)
row_or_kernel(const int32_t* __restrict__ rowmap, int F,
              const int32_t* __restrict__ table, int P, int W,
              const int32_t* __restrict__ fids, int B, int M,
              int32_t* __restrict__ out) {
  __shared__ int32_t lists[kOrWarps][kOrChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* list = lists[warp];
  const int stride = gridDim.x * kOrWarps;
  const int n_chunks = (M + kOrChunk - 1) / kOrChunk;
  const int n_tiles = (W + kOrTile - 1) / kOrTile;
  int b = blockIdx.x * kOrWarps + warp;  // uniform per warp
  int4 ahead = load_fids<kVecF>(fids, M, B, b, 0, lane);
  for (; b < B; b += stride) {
    // this topic's rowmap gathers, then the next topic's fids, in flight
    // while this one lists, ORs and stores
    const int4 first = gather_rows<kRowmap>(ahead, rowmap, F);
    ahead = load_fids<kVecF>(fids, M, B, b + stride, 0, lane);
    int32_t* dst = out + (size_t)b * W;
    for (int t = 0; t < n_tiles; ++t) {
      int4 acc[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
      for (int c = 0; c < n_chunks; ++c) {
        const int4 r =
            c == 0 ? first
                   : gather_rows<kRowmap>(
                         load_fids<kVecF>(fids, M, B, b, c, lane), rowmap, F);
        const int n = list_rows(select_rows<kRowmap>(r, P), list, lane);
        int k = 0;
        for (; k + 4 <= n; k += 4) {
          int4 v[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < 2; ++u)
              v[i][u] = load_words<kVecW>(table, (size_t)list[k + i] * W, W,
                                          t, u, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < 2; ++u) or_into(acc[u], v[i][u]);
        }
        for (; k < n; ++k)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            or_into(acc[u], load_words<kVecW>(table, (size_t)list[k] * W, W,
                                              t, u, lane));
        __syncwarp();  // the list is rewritten by the next chunk
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        store_words<kVecW>(dst, W, t, u, lane, acc[u]);
    }
  }
}

// Replaces emqx_tpu/models/router_model.py _apply_patches: one launch writes
// every padded element update into the live tables in place.  upd is
// [kPatchRows, cap] int32: rows (2t, 2t+1) = (index, value) for the six trie
// fields t in DeviceTrie order, rows 12/13 = rowmap (index, value), rows
// 14/15/16 = pool (row, column, value).  Field t starts at trie[t] and its
// element i lies at trie[t][i * stride] (the fields are columns of the
// 4-int32 edge and node records, so stride is 4).  Padding repeats an
// identical (index, value), so duplicate writes agree.  Indices were
// range-checked on the host.
//
// What bounds it: latency.  cap is small (64..4096 updates, 8 scattered
// 4-byte writes each), and the routing model's block lies in pinned host
// memory, which the kernel reads in place over PCIe: a refresh is then one
// operation on the stream, with no copy ahead of it.  So each thread takes
// 4 consecutive updates (cap % 4 == 0, the block 16-byte aligned: checked by
// the entry point) and issues its 17 int4 loads together, one PCIe round
// trip, before its 32 writes; blocks of one warp spread the scattered writes
// over as many SMs as the cap allows (8 at the churn's cap of 1024).  No
// pointer is __restrict__: the loads stay plain global loads (not the
// read-only path) of a block the host rewrites between launches.
// tools/patch_ablation.py times the kernel against its earlier form.
constexpr int kPatchRows = 17;
constexpr int kPatchThreads = 32;

__device__ __forceinline__ void scatter4(int32_t* dst, int stride, int4 idx,
                                         int4 val) {
  dst[(size_t)idx.x * stride] = val.x;
  dst[(size_t)idx.y * stride] = val.y;
  dst[(size_t)idx.z * stride] = val.z;
  dst[(size_t)idx.w * stride] = val.w;
}

__global__ void __launch_bounds__(kPatchThreads)
patch_kernel(int32_t* t0, int32_t* t1, int32_t* t2, int32_t* t3, int32_t* t4,
             int32_t* t5, int stride, int32_t* rowmap, int32_t* pool, int W,
             const int4* upd, int quads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // updates 4i..4i+3
  if (i >= quads) return;
  int4 u[kPatchRows];
#pragma unroll
  for (int r = 0; r < kPatchRows; ++r) u[r] = upd[(size_t)r * quads + i];
  int32_t* const trie[6] = {t0, t1, t2, t3, t4, t5};
#pragma unroll
  for (int t = 0; t < 6; ++t)
    scatter4(trie[t], stride, u[2 * t], u[2 * t + 1]);
  scatter4(rowmap, 1, u[12], u[13]);
  const int4 row = u[14], col = u[15], val = u[16];
  pool[(size_t)row.x * W + col.x] = val.x;
  pool[(size_t)row.y * W + col.y] = val.y;
  pool[(size_t)row.z * W + col.z] = val.z;
  pool[(size_t)row.w * W + col.w] = val.w;
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

// Replaces emqx_tpu/ops/fanout.py bitmap_to_counts: the popcount of each
// [W] row of bitmap words.  Bound by reading [B, W] once (16.8 MB at the
// bitmap path's [16384, 256]), so the design keeps that stream in flight,
// as row_or_kernel does (tools/fanout_ablation.py times each point):
//  - one warp per row, persistent: the launch fills the SMs once and each
//    warp strides over the rows;
//  - a row read kOrTile words at a time, as int4 where W % 4 == 0 and the
//    pointer is 16-byte aligned, 4-byte words otherwise (load_words);
//  - the warp's next tile (of this row, or of its next row) loaded before
//    this one is counted, so its loads are in flight while the warp
//    counts, sums and stores.
__device__ __forceinline__ unsigned popc4(int4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

template <bool kVec>
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ fan,
                                          int B, int W, int b, int t,
                                          int lane, int4 (&v)[2]) {
#pragma unroll
  for (int u = 0; u < 2; ++u)
    v[u] = b < B ? load_words<kVec>(fan, (size_t)b * W, W, t, u, lane)
                 : make_int4(0, 0, 0, 0);
}

template <bool kVec>
__global__ void __launch_bounds__(kOrWarps * 32)
bitmap_counts_kernel(const int32_t* __restrict__ fan, int B, int W,
                     int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kOrWarps;
  const int n_tiles = (W + kOrTile - 1) / kOrTile;
  int b = blockIdx.x * kOrWarps + (threadIdx.x >> 5);  // uniform per warp
  int t = 0;
  int4 ahead[2];
  load_tile<kVec>(fan, B, W, b, t, lane, ahead);
  unsigned n = 0;
  while (b < B) {
    const int4 v0 = ahead[0], v1 = ahead[1];
    const int row = b;
    if (++t == n_tiles) {
      t = 0;
      b += stride;
    }
    load_tile<kVec>(fan, B, W, b, t, lane, ahead);
    n += popc4(v0) + popc4(v1);
    if (t == 0) {  // the row's last tile
      n = __reduce_add_sync(kFull, n);
      if (lane == 0) counts[row] = (int32_t)n;
      n = 0;
    }
  }
}

// Blocks of kOrWarps warps that fill every SM once at a kernel's occupancy
// (with smem bytes of dynamic shared memory), read once per device into
// cache: each launcher instantiation passes a cache of its own.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* cache,
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kOrWarps * 32, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

// One launch of an instantiation: the resident blocks, fewer for a small
// batch.
template <bool kRowmap, bool kVecF, bool kVecW>
int launch_row_or(const int32_t* rowmap, int F, const int32_t* table, int P,
                  int W, const int32_t* fids, int B, int M, int32_t* out,
                  cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  const auto kernel = row_or_kernel<kRowmap, kVecF, kVecW>;
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, 0, resident, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int wanted = (B + kOrWarps - 1) / kOrWarps;
  if (blocks > wanted) blocks = wanted;
  kernel<<<blocks, kOrWarps * 32, 0, stream>>>(rowmap, F, table, P, W, fids,
                                               B, M, out);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The gather-OR with its vector paths where the shapes and the pointers
// allow them.
template <bool kRowmap>
int row_or(const int32_t* rowmap, int F, const int32_t* table, int P, int W,
           const int32_t* fids, int B, int M, int32_t* out,
           cudaStream_t stream) {
  const bool vec_f = M % 4 == 0 && aligned16(fids);
  const bool vec_w = W % 4 == 0 && aligned16(table) && aligned16(out);
  if (vec_f && vec_w)
    return launch_row_or<kRowmap, true, true>(rowmap, F, table, P, W, fids,
                                              B, M, out, stream);
  if (vec_f)
    return launch_row_or<kRowmap, true, false>(rowmap, F, table, P, W, fids,
                                               B, M, out, stream);
  if (vec_w)
    return launch_row_or<kRowmap, false, true>(rowmap, F, table, P, W, fids,
                                               B, M, out, stream);
  return launch_row_or<kRowmap, false, false>(rowmap, F, table, P, W, fids,
                                              B, M, out, stream);
}

// One popcount launch: the resident blocks, fewer for a small B.
template <bool kVec>
int launch_bitmap_counts(const int32_t* fan, int B, int W, int32_t* counts,
                         cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  const auto kernel = bitmap_counts_kernel<kVec>;
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, 0, resident, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (B + kOrWarps - 1) / kOrWarps;
  if (blocks > row_blocks) blocks = row_blocks;
  kernel<<<blocks, kOrWarps * 32, 0, stream>>>(fan, B, W, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* router_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int trie_walk(const void* edges, const void* nodes, unsigned hmask,
              const void* tokens, const void* lengths, const void* sys_flags,
              int B, int L, int K, int max_probes, void* cand, void* stats,
              void* stream) {
  const int warps = 8;
  trie_walk_kernel<false><<<(B + warps - 1) / warps, warps * 32, 0,
                            (cudaStream_t)stream>>>(
      (const int4*)edges, (const int4*)nodes, hmask, 0, 0,
      (const int32_t*)tokens, (const int32_t*)lengths,
      (const uint8_t*)sys_flags, B, L, K, max_probes, (int32_t*)cand,
      (int32_t*)stats);
  return (int)cudaGetLastError();
}

int trie_walk_sharded(const void* edges, const void* nodes, unsigned hmask,
                      long long h_stride, long long n_stride,
                      const void* tokens, const void* lengths,
                      const void* sys_flags, int B, int L, int K,
                      int max_probes, int S, void* cand, void* stats,
                      void* stream) {
  const int warps = 8;
  const dim3 grid((B + warps - 1) / warps, S);
  trie_walk_kernel<true><<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const int4*)edges, (const int4*)nodes, hmask, (int64_t)h_stride,
      (int64_t)n_stride, (const int32_t*)tokens, (const int32_t*)lengths,
      (const uint8_t*)sys_flags, B, L, K, max_probes, (int32_t*)cand,
      (int32_t*)stats);
  return (int)cudaGetLastError();
}

int walk_compact(const void* edges, const void* nodes, unsigned hmask,
                 const void* tokens, const void* lengths,
                 const void* sys_flags, int B, int L, int K, int max_probes,
                 int width, void* fids, void* stats, void* stream) {
  const int warps = 8;
  walk_compact_kernel<false><<<(B + warps - 1) / warps, warps * 32, 0,
                               (cudaStream_t)stream>>>(
      (const int4*)edges, (const int4*)nodes, hmask, 0, 0,
      (const int32_t*)tokens, (const int32_t*)lengths,
      (const uint8_t*)sys_flags, B, L, K, max_probes, 1, width, width, width,
      1, (int32_t*)fids, (int32_t*)stats, nullptr);
  return (int)cudaGetLastError();
}

// S <= 32 (checked by the wrapper): T = max(1, 8 / S) topics per block.
int walk_compact_sharded(const void* edges, const void* nodes,
                         unsigned hmask, long long h_stride,
                         long long n_stride, const void* tokens,
                         const void* lengths, const void* sys_flags, int B,
                         int L, int K, int max_probes, int S, int M,
                         int width, int Mout, int n_shards, void* fids,
                         void* stats, void* truncated, void* stream) {
  const int T = S >= 8 ? 1 : 8 / S;
  const size_t smem = (size_t)S * T * width * sizeof(int32_t);
  if (smem > 40 * 1024) {  // beside the walk's 4 KB of static pick rows
    const cudaError_t err = cudaFuncSetAttribute(
        walk_compact_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  walk_compact_kernel<true><<<(B + T - 1) / T, 32 * S * T, smem,
                              (cudaStream_t)stream>>>(
      (const int4*)edges, (const int4*)nodes, hmask, (int64_t)h_stride,
      (int64_t)n_stride, (const int32_t*)tokens, (const int32_t*)lengths,
      (const uint8_t*)sys_flags, B, L, K, max_probes, S, M, width, Mout,
      n_shards, (int32_t*)fids, (int32_t*)stats, (uint8_t*)truncated);
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
  return row_or<false>(nullptr, F, (const int32_t*)bitmaps, F, W,
                       (const int32_t*)fids, B, M, (int32_t*)out,
                       (cudaStream_t)stream);
}

int bitmap_counts(const void* fan, int B, int W, void* counts,
                  void* stream) {
  const bool vec = W % 4 == 0 && aligned16(fan);
  return vec ? launch_bitmap_counts<true>((const int32_t*)fan, B, W,
                                          (int32_t*)counts,
                                          (cudaStream_t)stream)
             : launch_bitmap_counts<false>((const int32_t*)fan, B, W,
                                           (int32_t*)counts,
                                           (cudaStream_t)stream);
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
  return row_or<true>((const int32_t*)rowmap, F, (const int32_t*)pool, P, W,
                      (const int32_t*)fids, B, M, (int32_t*)out,
                      (cudaStream_t)stream);
}

// upd is a [kPatchRows, cap] block on the card or in pinned host memory
// (read in place through its mapped device address); pageable host memory
// is refused.
int patch(void* t0, void* t1, void* t2, void* t3, void* t4, void* t5,
          int stride, void* rowmap, void* pool, int W, const void* upd,
          int cap, void* stream) {
  if (cap < 4 || cap % 4 != 0 || !aligned16(upd))
    return (int)cudaErrorInvalidValue;
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, upd);
  if (err != cudaSuccess) return (int)err;
  void* src = const_cast<void*>(upd);
  if (attr.type == cudaMemoryTypeHost) {
    err = cudaHostGetDevicePointer(&src, const_cast<void*>(upd), 0);
    if (err != cudaSuccess) return (int)err;
  } else if (attr.type != cudaMemoryTypeDevice) {
    return (int)cudaErrorInvalidHostPointer;
  }
  const int quads = cap / 4;
  patch_kernel<<<(quads + kPatchThreads - 1) / kPatchThreads, kPatchThreads,
                 0, (cudaStream_t)stream>>>(
      (int32_t*)t0, (int32_t*)t1, (int32_t*)t2, (int32_t*)t3, (int32_t*)t4,
      (int32_t*)t5, stride, (int32_t*)rowmap, (int32_t*)pool, W,
      (const int4*)src, quads);
  return (int)cudaGetLastError();
}

}  // extern "C"
