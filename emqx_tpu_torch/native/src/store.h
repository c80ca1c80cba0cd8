// Durable-session message store: a segmented append-only log the C++
// host writes BELOW the GIL (host.cc FlushDurables) so a persistent
// session's subscription no longer collapses matching traffic onto the
// asyncio plane — the reference persists every matching publish +
// per-session unconsumed markers (emqx_persistent_session.erl:93-109,
// optionally RocksDB-backed) and replays them on clean_start=false
// resume (:275-310). SURVEY §5's discipline holds: "the HBM trie is a
// pure cache; persistence stays host-side" — this file IS that
// host-side disc slot (session/persistent.py names it), kept off the
// device and off the Python plane.
//
// On-disk format (little-endian), one file per segment
// ("<dir>/NNNNNNNN.seg", fixed-size, mmap-backed, zero-filled tail):
//
//   frame   = [u32 crc32][u32 len][payload: u8 type + body]
//             crc32 (IEEE, reflected) covers the whole payload; len is
//             the payload length. A zeroed/garbled frame header or a
//             crc mismatch ends the segment scan — exactly the torn-
//             tail-drop recovery a kill -9 mid-write needs, since the
//             mmap'd tail past the last full msync is undefined.
//   type 1  = MSG BATCH   [u64 base_guid][u64 ts_ms][u32 n] + n x entry
//             entry = [u64 origin][u8 flags][u16 ntok][u64 tok x ntok]
//                     [u16 tlen][topic]
//                     + (flags bit4 ? [u64 trace_id])
//                     + (flags bit5 ? [u8 cidlen][origin clientid])
//                     + (flags bit0 ? [u32 plen][payload]
//                                   : payload of the PREVIOUS entry)
//             guid of entry i = base_guid + i. flags: bit0 = payload
//             inline (the kind-6 dedup discipline), bits1-2 = qos,
//             bit3 = publisher DUP, bit4 = a sampled trace id follows
//             the topic (round 13: the native tracing plane persists
//             the id so a resume replay can re-join the trace), bit5 =
//             the publisher's clientid follows (round 18: no-local and
//             from_ attribution survive a restart — origin conn ids
//             are meaningless in the next life). The SAME bytes ride
//             up to Python as the kind-10 event payload — one buffer,
//             two sinks.
//   type 2  = CONSUME     [u32 n] + n x ([u64 token][u64 guid])
//   type 3  = REGISTER    [u64 token][u16 len][sid utf-8]
//   type 4  = REWRITE     like MSG BATCH but every entry is prefixed
//             [u64 guid] (explicit ids: GC compaction re-homes LIVE
//             messages from mostly-dead sealed segments, then unlinks
//             them; [u64 ts_ms] header, no base_guid)
//   type 5  = SESSION     [u64 token][u32 blen][body] — the session
//             catalog record (round 18): subscriptions + expiry
//             metadata the Python JSON DiskStore used to hold, keyed
//             by the sid's REGISTER token. blen 0 deletes the entry.
//             Newest record per token wins at recovery.
//   type 6  = UNREGISTER  [u64 token] — retires a REGISTER (session
//             expiry GC): the sid→token mapping, its SESSION record
//             and any leftover markers die with it, so a dead
//             session's records stop pinning segments.
//   type 7  = TRUNK       [u16 nlen][peer name][u64 seq][u8 tflags]
//             [record bytes] — one flushed-but-unacked trunk qos1
//             replay record (round 18: the per-peer unacked ring,
//             store-backed so kill -9 no longer loses it). Keyed by
//             the PEER NODE NAME (peer ids are minted per-process).
//             tflags bit0 = the record carries >= 1 trace id.
//   type 8  = TRUNK ACK   [u16 nlen][peer name][u64 seq] — the peer
//             acked that batch; seq UINT64_MAX drops the whole ring
//             (peer forgotten).
//
// REGISTER / SESSION / TRUNK records are LIVE state, not a log tail:
// they count toward their segment's live total, and GC re-journals the
// survivors forward (meta_rewrites) before unlinking a segment — a
// sid→token mapping must never die with an all-consumed segment.
//
// Recovery replays segments in id order; within a segment it stops at
// the first bad frame (no resync marker — by construction only the
// tail of the NEWEST segment can be torn, and the fuzz test pins that
// a corrupted record drops only itself and what follows it in that
// segment). Consume records for unknown guids are no-ops, which makes
// the segment-unlink GC safe: a message's consumes always live in
// segments >= its own.
//
// Threading: ONE mutex over everything. The host's poll thread appends
// one batch per flush; Python threads fetch/consume/gc concurrently
// (resume replay, ack-driven marker consumption, housekeep GC) — the
// ASan/TSan DRIVER_DURABLE hammers exactly this interleaving.
//
// fsync policy: 0 = never (page cache only), 1 = per append/consume
// (msync MS_SYNC — the PUBACK-after-store ordering in host.cc then
// gives real qos1 durability), 2 = interval (~100ms cadence).
#pragma once

#include <dirent.h>
#include <fcntl.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "fault.h"

namespace emqx_native {
namespace store {

constexpr uint8_t kRecMsgBatch = 1;
constexpr uint8_t kRecConsume = 2;
constexpr uint8_t kRecRegister = 3;
constexpr uint8_t kRecRewrite = 4;
constexpr uint8_t kRecSession = 5;
constexpr uint8_t kRecUnregister = 6;
constexpr uint8_t kRecTrunk = 7;
constexpr uint8_t kRecTrunkAck = 8;

// TRUNK ACK seq sentinel: drop the named peer's whole ring.
constexpr uint64_t kTrunkDropAll = ~0ull;

constexpr int kFsyncNever = 0;
constexpr int kFsyncBatch = 1;
constexpr int kFsyncInterval = 2;
constexpr uint64_t kFsyncIntervalMs = 100;

// stat slots (emqx_store_stat; see native/__init__.py STORE_STAT_NAMES)
enum StoreStat {
  kSsAppends = 0,   // message entries appended
  kSsConsumed,      // (token, guid) markers consumed
  kSsPending,       // live markers right now (gauge)
  kSsMessages,      // live messages right now (gauge)
  kSsSegments,      // segment files right now (gauge)
  kSsGcSegments,    // segments unlinked by GC
  kSsRewrites,      // messages re-homed by GC compaction
  kSsTornDrops,     // records dropped at recovery (bad crc / torn tail)
  kSsBytes,         // payload bytes framed into the log
  kSsDegraded,      // mid-run segment-open/mmap failures: the store
                    // fell back to anonymous (non-durable) segments —
                    // Python warns, since PUBACK-after-store keeps
                    // asserting a durability this segment cannot give
  kSsReplayBytes,   // bytes handed back for replay (Fetch + TrunkFetch)
  kSsSessions,      // live SESSION catalog records (gauge)
  kSsTrunkPending,  // live trunk replay-ring records (gauge)
  kSsMetaRewrites,  // REGISTER/SESSION/TRUNK records re-homed by GC
  kSsStatCount
};

inline uint32_t Crc32(const char* data, size_t len) {
  // IEEE reflected CRC-32, nibble-table variant: small, no zlib dep
  static const uint32_t tbl[16] = {
      0x00000000, 0x1db71064, 0x3b6e20c8, 0x26d930ac,
      0x76dc4190, 0x6b6b51f4, 0x4db26158, 0x5005713c,
      0xedb88320, 0xf00f9344, 0xd6d6a3e8, 0xcb61b38c,
      0x9b64c2b0, 0x86d3d2d4, 0xa00ae278, 0xbdbdf21c};
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) {
    crc ^= static_cast<uint8_t>(data[i]);
    crc = tbl[crc & 0xF] ^ (crc >> 4);
    crc = tbl[crc & 0xF] ^ (crc >> 4);
  }
  return crc ^ 0xFFFFFFFFu;
}

inline uint64_t WallMs() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

struct Segment {
  uint32_t id = 0;
  int fd = -1;          // -1 for anonymous (in-memory) segments
  char* base = nullptr;
  size_t cap = 0;
  size_t end = 0;       // append offset
  uint32_t live = 0;    // live message records homed here
  // when this segment stopped being the active append target (0 =
  // still active / unknown): the age-based compaction trigger's clock
  uint64_t sealed_ms = 0;
};

struct StoredMsg {
  std::string topic;
  std::string payload;
  std::string cid;              // origin clientid ("" = unknown): the
                                // no-local / from_ attribution that
                                // must survive a restart (flags bit5)
  uint64_t origin = 0;
  uint64_t ts_ms = 0;
  uint64_t trace = 0;           // sampled trace id (0 = not sampled)
  uint8_t flags = 0;            // bits1-2 qos, bit3 dup (bit0 meaningless)
  uint32_t seg = 0;             // homing segment (GC bookkeeping)
  std::vector<uint64_t> toks;   // tokens still holding a marker
};

// One persisted trunk replay-ring entry (kRecTrunk).
struct TrunkRec {
  std::string bytes;            // the pre-framed qos1 wire record
  uint8_t flags = 0;            // bit0 = carries >= 1 trace id
  uint32_t seg = 0;             // homing segment (GC bookkeeping)
};

class DurableStore {
 public:
  // dir == "" runs on anonymous mmaps: the full durable PLANE (fast
  // path preserved, kind-10 delivery, replay within the process) minus
  // restart survival — the default when no store_dir is configured.
  // @locked(mu_) — construction precedes any concurrent caller
  DurableStore(std::string dir, size_t seg_bytes, int fsync_policy)
      : dir_(std::move(dir)),
        seg_bytes_(seg_bytes < 64 * 1024 ? 64 * 1024 : seg_bytes),
        fsync_(fsync_policy) {
    if (!dir_.empty()) {
      ::mkdir(dir_.c_str(), 0777);
      Recover();
    }
    if (segs_.empty()) Roll(seg_bytes_);
  }

  // @locked(mu_) — destruction outlives every concurrent caller
  ~DurableStore() {
    for (auto& [id, s] : segs_) {
      if (s.base) {
        if (s.fd >= 0 && fsync_ != kFsyncNever) SyncSeg(s);
        munmap(s.base, s.cap);
      }
      if (s.fd >= 0) close(s.fd);
    }
  }

  DurableStore(const DurableStore&) = delete;
  DurableStore& operator=(const DurableStore&) = delete;

  // Mid-run degradation flag (Roll flips it on the poll thread while
  // Python threads ask): locked like every other mu_-guarded read —
  // the unguarded return nativecheck surfaced was a real data race.
  bool ok() {
    std::lock_guard<std::mutex> lk(mu_);
    return ok_;
  }

  // The store's own faultline injector (fault.h): msync and
  // segment-open sites fire under mu_ like the real failures they
  // model; the host forwards store-site arms here. Thread-safe.
  fault::Injector* injector() { return &fault_; }

  // Age-based compaction trigger (round 15): sealed segments whose
  // live tail has sat past `ms` get re-homed regardless of the
  // thin-tail byte bound. 0 disables the trigger.
  void SetCompactAge(uint64_t ms) {
    std::lock_guard<std::mutex> lk(mu_);
    compact_age_ms_ = ms;
  }

  // sid -> stable token: returns the recovered token when the sid was
  // seen in a previous life (markers key on it), else registers a new
  // one durably. Thread-safe.
  // sid -> token WITHOUT creating one (0 = never registered): the
  // discard/drain paths must not mint-and-journal tokens for sessions
  // that never had durable state.
  uint64_t Lookup(const std::string& sid) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = token_of_.find(sid);
    return it == token_of_.end() ? 0 : it->second;
  }

  uint64_t Register(const std::string& sid) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = token_of_.find(sid);
    if (it != token_of_.end()) return it->second;
    uint64_t tok = next_token_++;
    JournalRegister(tok, sid);
    MaybeSync();
    return tok;
  }

  // Retire a REGISTER token (session-expiry GC): the sid→token
  // mapping, the SESSION catalog record, and any leftover markers die
  // with it — a dead session must not pin segments. Thread-safe.
  void Unregister(uint64_t token) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!sid_of_.count(token)) return;
    std::string body;
    AppendU64(&body, token);
    AppendFrame(kRecUnregister, body.data(), body.size());
    ApplyUnregister(token);
    MaybeSync();
  }

  // -- session catalog (round 18) -----------------------------------------
  // The subscription/expiry metadata the Python JSON DiskStore used to
  // hold: one SESSION record per token, newest wins, deleted with
  // blen 0. Thread-safe.

  void PutSession(uint64_t token, const char* body, uint32_t blen) {
    std::lock_guard<std::mutex> lk(mu_);
    JournalSession(token, body, blen);
    ApplySession(token, body, blen, active_ ? active_->id : 0);
    MaybeSync();
  }

  // All live SESSION records as a malloc'd blob of
  // [u64 token][u16 sidlen][sid][u32 blen][body] entries (the boot
  // walk). Returns the count.
  long FetchSessions(uint8_t** out, size_t* out_len) {
    std::lock_guard<std::mutex> lk(mu_);
    std::string blob;
    long n = 0;
    for (auto& [tok, rec] : sess_) {
      auto sit = sid_of_.find(tok);
      if (sit == sid_of_.end()) continue;
      AppendU64(&blob, tok);
      AppendU16(&blob, static_cast<uint16_t>(sit->second.size()));
      blob += sit->second;
      AppendU32(&blob, static_cast<uint32_t>(rec.body.size()));
      blob += rec.body;
      n++;
    }
    uint8_t* buf =
        static_cast<uint8_t*>(malloc(blob.size() ? blob.size() : 1));
    memcpy(buf, blob.data(), blob.size());
    *out = buf;
    *out_len = blob.size();
    return n;
  }

  // -- trunk replay ring (round 18) ---------------------------------------
  // The per-peer unacked qos1 ring, store-backed: kill -9 of a node no
  // longer loses it. Keyed by peer NODE NAME (peer ids are per-process).
  // Thread-safe (the host's poll thread is the only product caller,
  // but raw tests drive these from Python threads).

  void TrunkPut(const std::string& name, uint64_t seq, uint8_t tflags,
                const char* data, size_t len) {
    std::lock_guard<std::mutex> lk(mu_);
    JournalTrunk(name, seq, tflags, data, len);
    ApplyTrunk(name, seq, tflags, data, len,
               active_ ? active_->id : 0);
    MaybeSync();
  }

  void TrunkAck(const std::string& name, uint64_t seq) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = trunk_.find(name);
    if (it == trunk_.end()) return;
    if (seq != kTrunkDropAll && !it->second.count(seq)) return;
    std::string body;
    body.reserve(10 + name.size());
    AppendU16(&body, static_cast<uint16_t>(name.size()));
    body += name;
    AppendU64(&body, seq);
    AppendFrame(kRecTrunkAck, body.data(), body.size());
    ApplyTrunkAck(name, seq);
    MaybeSync();
  }

  // The named peer's persisted ring in seq order, as a malloc'd blob
  // of [u64 seq][u8 tflags][u32 len][record bytes] entries. Returns
  // the count — the host rebuilds its in-memory ring from this at
  // reconnect after a restart.
  long TrunkFetch(const std::string& name, uint8_t** out,
                  size_t* out_len) {
    std::lock_guard<std::mutex> lk(mu_);
    std::string blob;
    long n = 0;
    auto it = trunk_.find(name);
    if (it != trunk_.end()) {
      for (auto& [seq, rec] : it->second) {
        AppendU64(&blob, seq);
        blob.push_back(static_cast<char>(rec.flags));
        AppendU32(&blob, static_cast<uint32_t>(rec.bytes.size()));
        blob += rec.bytes;
        n++;
      }
    }
    stats_[kSsReplayBytes] += blob.size();
    uint8_t* buf =
        static_cast<uint8_t*>(malloc(blob.size() ? blob.size() : 1));
    memcpy(buf, blob.data(), blob.size());
    *out = buf;
    *out_len = blob.size();
    return n;
  }

  // Forget a peer's whole persisted ring (node left the cluster).
  void TrunkDrop(const std::string& name) { TrunkAck(name, kTrunkDropAll); }

  long TrunkPending(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = trunk_.find(name);
    return it == trunk_.end() ? 0 : static_cast<long>(it->second.size());
  }

  // Reserve n contiguous guids for the batch about to be appended (the
  // host stamps them into the kind-10 event header BEFORE AppendBatch).
  uint64_t AllocGuids(uint32_t n) {
    std::lock_guard<std::mutex> lk(mu_);
    uint64_t base = next_guid_;
    next_guid_ += n;
    return base;
  }

  // Append one MSG BATCH payload ([base_guid][ts][n] + entries, the
  // exact kind-10 event payload) and index its entries. Returns false
  // on a malformed payload (nothing written).
  bool AppendBatch(const char* payload, size_t len) {
    std::lock_guard<std::mutex> lk(mu_);
    if (len < 20) return false;
    uint64_t base_guid = RdU64(payload);
    uint64_t ts = RdU64(payload + 8);
    uint32_t n = RdU32(payload + 16);
    // index first (validates the layout), then frame the bytes
    std::vector<StoredMsg> parsed;
    parsed.reserve(n);
    if (!ParseEntries(payload + 20, len - 20, n, ts,
                      /*explicit_guids=*/false, nullptr, &parsed))
      return false;
    AppendFrame(kRecMsgBatch, payload, len);
    uint32_t seg = active_->id;
    for (uint32_t i = 0; i < n; i++) {
      IndexMsg(base_guid + i, std::move(parsed[i]), seg);
      stats_[kSsAppends]++;
    }
    if (base_guid + n > next_guid_) next_guid_ = base_guid + n;
    MaybeSync();
    return true;
  }

  // Single-message append (test surface + Python-plane callers).
  // ``cid``/``cl`` persist the publisher's clientid (flags bit5) so
  // no-local and from_ attribution survive a restart.
  uint64_t Append(uint64_t origin, uint8_t flags, const uint64_t* toks,
                  uint16_t ntok, const char* topic, uint16_t tlen,
                  const char* payload, uint32_t plen,
                  uint64_t trace = 0, const char* cid = nullptr,
                  uint8_t cl = 0) {
    if (cid == nullptr) cl = 0;
    std::string body;
    body.reserve(20 + 19 + 8 * ntok + tlen + 4 + plen + 1 + cl);
    // reserve the guid properly: a bare next_guid_ read could collide
    // with a concurrent AllocGuids from the host's flush
    AppendU64(&body, AllocGuids(1));
    AppendU64(&body, WallMs());
    AppendU32(&body, 1);
    AppendU64(&body, origin);
    body.push_back(static_cast<char>(flags | 1              // inline
                                     | (trace ? 0x10 : 0)
                                     | (cl ? 0x20 : 0)));
    AppendU16(&body, ntok);
    for (uint16_t i = 0; i < ntok; i++) AppendU64(&body, toks[i]);
    AppendU16(&body, tlen);
    body.append(topic, tlen);
    if (trace) AppendU64(&body, trace);
    if (cl) {
      body.push_back(static_cast<char>(cl));
      body.append(cid, cl);
    }
    AppendU32(&body, plen);
    body.append(payload, plen);
    uint64_t guid = RdU64(body.data());
    return AppendBatch(body.data(), body.size()) ? guid : 0;
  }

  // Consume markers; each hit is journaled. Thread-safe.
  uint32_t Consume(uint64_t token, const uint64_t* guids, uint32_t n) {
    std::lock_guard<std::mutex> lk(mu_);
    std::string body;
    uint32_t hits = 0;
    AppendU32(&body, 0);  // patched below
    for (uint32_t i = 0; i < n; i++) {
      if (ApplyConsume(token, guids[i])) {
        AppendU64(&body, token);
        AppendU64(&body, guids[i]);
        hits++;
      }
    }
    if (hits) {
      memcpy(&body[0], &hits, 4);
      AppendFrame(kRecConsume, body.data(), body.size());
      stats_[kSsConsumed] += hits;
      MaybeSync();
    }
    return hits;
  }

  // Pending messages for a token, guid order (= arrival order), as a
  // malloc'd blob of [u64 guid][u64 origin][u64 ts_ms][u8 flags]
  // [u16 tlen][topic] + (flags bit4 ? [u64 trace_id]) + (flags bit5 ?
  // [u8 cidlen][clientid]) + [u32 plen][payload] entries. Returns the
  // count.
  long Fetch(uint64_t token, uint8_t** out, size_t* out_len) {
    std::lock_guard<std::mutex> lk(mu_);
    std::string blob;
    long n = 0;
    auto pit = pending_.find(token);
    if (pit != pending_.end()) {
      for (auto& [guid, _] : pit->second) {
        auto mit = msgs_.find(guid);
        if (mit == msgs_.end()) continue;
        const StoredMsg& m = mit->second;
        AppendU64(&blob, guid);
        AppendU64(&blob, m.origin);
        AppendU64(&blob, m.ts_ms);
        blob.push_back(static_cast<char>((m.flags & 0x0E)
                                         | (m.trace ? 0x10 : 0)
                                         | (m.cid.empty() ? 0 : 0x20)));
        AppendU16(&blob, static_cast<uint16_t>(m.topic.size()));
        blob += m.topic;
        if (m.trace) AppendU64(&blob, m.trace);
        if (!m.cid.empty()) {
          blob.push_back(static_cast<char>(m.cid.size()));
          blob += m.cid;
        }
        AppendU32(&blob, static_cast<uint32_t>(m.payload.size()));
        blob += m.payload;
        n++;
      }
    }
    stats_[kSsReplayBytes] += blob.size();
    uint8_t* buf = static_cast<uint8_t*>(malloc(blob.size() ? blob.size() : 1));
    memcpy(buf, blob.data(), blob.size());
    *out = buf;
    *out_len = blob.size();
    return n;
  }

  long Pending(uint64_t token) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = pending_.find(token);
    return it == pending_.end() ? 0 : static_cast<long>(it->second.size());
  }

  // GC: unlink sealed all-consumed segments; when several sealed
  // segments hold only a thin live tail, re-home those messages into
  // the active segment (REWRITE record) and unlink the carcasses —
  // the "compaction of consumed markers" half of the contract.
  long Gc() {
    std::lock_guard<std::mutex> lk(mu_);
    long freed = 0;
    // pass 1: zero-live sealed segments go immediately
    for (auto it = segs_.begin(); it != segs_.end();) {
      Segment& s = it->second;
      if (&s != active_ && s.live == 0) {
        DropSeg(s);
        it = segs_.erase(it);
        freed++;
      } else {
        ++it;
      }
    }
    // pass 2: compaction — sealed segments whose combined live payload
    // is small get rewritten forward, then unlinked. Round 15 adds the
    // AGE trigger: a sealed segment whose live tail has sat past
    // compact_age_ms_ re-homes regardless of the thin-tail byte bound,
    // so one huge live message can no longer pin an otherwise-dead
    // segment across gc cycles forever (AppendFrame rolls as needed
    // when the aged rewrite exceeds the current segment's room).
    // Round 18: REGISTER/SESSION/TRUNK metadata counts as live too —
    // a segment whose only live records are metadata re-homes them
    // unconditionally (they are tiny) and unlinks, and any message
    // victim carrying metadata re-journals it before the unlink.
    if (segs_.size() > 1) {
      // hashed victim set: Gc holds the SAME mutex the poll thread's
      // FlushDurables needs (and FlushDirty orders PUBACKs behind it),
      // so these sweeps must stay O(M), never O(M*V)
      std::unordered_set<uint32_t> victims;
      std::unordered_set<uint32_t> aged;
      uint64_t now = WallMs();
      size_t live_bytes = 0, live_msgs = 0;
      // per-sealed-segment live MESSAGE counts: metadata-only segments
      // take the unconditional re-home path, not the thin/age rules
      std::unordered_map<uint32_t, size_t> seg_msgs;
      for (auto& [guid, m] : msgs_) seg_msgs[m.seg]++;
      std::unordered_set<uint32_t> meta_only;
      for (auto& [id, s] : segs_) {
        if (&s == active_ || s.live == 0) continue;
        if (seg_msgs.find(id) == seg_msgs.end()) {
          meta_only.insert(id);
          continue;
        }
        victims.insert(id);
        if (compact_age_ms_ && s.sealed_ms &&
            now >= s.sealed_ms + compact_age_ms_)
          aged.insert(id);
      }
      bool rewrote = false;
      if (!victims.empty()) {
        // per-segment live bytes alongside the combined totals (one
        // O(M) sweep): the age trigger needs each candidate's own
        // dead fraction, not just the pool-wide sum
        std::unordered_map<uint32_t, size_t> seg_live;
        for (auto& [guid, m] : msgs_) {
          if (victims.count(m.seg)) {
            size_t b = m.topic.size() + m.payload.size() + 64;
            live_bytes += b;
            seg_live[m.seg] += b;
            live_msgs++;
          }
        }
        // an aged segment is only a victim if it is MOSTLY DEAD (live
        // tail <= half its used bytes): the trigger exists for "one
        // live record pinning an otherwise-dead segment" — a fully
        // live sealed segment (a persistent subscriber's offline
        // backlog, the store's core workload) must NOT be re-homed
        // once a minute forever, and a freshly re-homed all-live
        // segment must not age straight back into the victim set
        for (auto it = aged.begin(); it != aged.end();) {
          auto sit = segs_.find(*it);
          if (sit == segs_.end() ||
              seg_live[*it] * 2 > sit->second.end)
            it = aged.erase(it);
          else
            ++it;
        }
        bool thin = victims.size() >= 2 && live_msgs &&
                    live_bytes < seg_bytes_ / 2;
        bool age_due = !aged.empty();
        if (!thin && age_due) {
          // age-triggered: re-home ONLY the expired mostly-dead
          // segments (a young sealed segment keeps waiting for the
          // thin-tail rule)
          victims.swap(aged);
          live_msgs = 0;
          for (auto& [guid, m] : msgs_)
            if (victims.count(m.seg)) live_msgs++;
        }
        if ((thin || age_due) && live_msgs) {
          std::string body;
          AppendU64(&body, WallMs());
          AppendU32(&body, static_cast<uint32_t>(live_msgs));
          for (auto& [guid, m] : msgs_) {
            if (!victims.count(m.seg)) continue;
            AppendU64(&body, guid);
            AppendU64(&body, m.origin);
            body.push_back(static_cast<char>(m.flags | 1));
            AppendU16(&body, static_cast<uint16_t>(m.toks.size()));
            for (uint64_t t : m.toks) AppendU64(&body, t);
            AppendU16(&body, static_cast<uint16_t>(m.topic.size()));
            body += m.topic;
            // bit4/bit5 survive in m.flags: recovery's ParseEntries
            // expects the trace id / clientid after the topic for
            // flagged entries
            if (m.flags & 0x10) AppendU64(&body, m.trace);
            if (m.flags & 0x20) {
              body.push_back(static_cast<char>(m.cid.size()));
              body += m.cid;
            }
            AppendU32(&body, static_cast<uint32_t>(m.payload.size()));
            body += m.payload;
          }
          AppendFrame(kRecRewrite, body.data(), body.size());
          uint32_t nseg = active_->id;
          for (auto& [guid, m] : msgs_) {
            if (victims.count(m.seg)) {
              m.seg = nseg;
              active_->live++;
              stats_[kSsRewrites]++;
            }
          }
          rewrote = true;
        } else {
          victims.clear();
        }
      }
      // unified unlink set: message victims (REWRITE written above)
      // plus metadata-only segments; live metadata homed in ANY of
      // them re-journals forward first — a sid→token mapping must
      // never die with its segment
      victims.insert(meta_only.begin(), meta_only.end());
      if (!victims.empty()) {
        rewrote = RehomeMeta(victims) || rewrote;
        // the REWRITE / re-journaled metadata must be ON DISK before
        // the victims are unlinked, regardless of the interval
        // cadence: a crash in the gap would lose records that were
        // already durably acked — strictly worse than the policy's
        // append-lag bound
        if (rewrote && active_ && active_->fd >= 0 &&
            fsync_ != kFsyncNever)
          SyncSeg(*active_);
        for (uint32_t id : victims) {
          auto it = segs_.find(id);
          if (it != segs_.end()) {
            DropSeg(it->second);
            segs_.erase(it);
            freed++;
          }
        }
      }
    }
    return freed;
  }

  int Sync() {
    std::lock_guard<std::mutex> lk(mu_);
    if (active_ && active_->fd >= 0) SyncSeg(*active_);
    return 0;
  }

  long Stat(int slot) {
    std::lock_guard<std::mutex> lk(mu_);
    if (slot < 0 || slot >= kSsStatCount) return -1;
    if (slot == kSsPending) {
      long n = 0;
      for (auto& [tok, m] : pending_) n += static_cast<long>(m.size());
      return n;
    }
    if (slot == kSsMessages) return static_cast<long>(msgs_.size());
    if (slot == kSsSegments) return static_cast<long>(segs_.size());
    if (slot == kSsSessions) return static_cast<long>(sess_.size());
    if (slot == kSsTrunkPending) {
      long n = 0;
      for (auto& [name, ring] : trunk_) n += static_cast<long>(ring.size());
      return n;
    }
    return static_cast<long>(stats_[slot]);
  }

 private:
  // -- little-endian scribblers -------------------------------------------
  static void AppendU16(std::string* b, uint16_t v) {
    b->append(reinterpret_cast<const char*>(&v), 2);
  }
  static void AppendU32(std::string* b, uint32_t v) {
    b->append(reinterpret_cast<const char*>(&v), 4);
  }
  static void AppendU64(std::string* b, uint64_t v) {
    b->append(reinterpret_cast<const char*>(&v), 8);
  }
  static uint16_t RdU16(const char* p) {
    uint16_t v;
    memcpy(&v, p, 2);
    return v;
  }
  static uint32_t RdU32(const char* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
  }
  static uint64_t RdU64(const char* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;
  }

  // Decode n batch entries; explicit_guids covers the REWRITE layout
  // (guids written into *guids). Caller holds mu_; pure parsing into
  // locals, so it carries no lock annotation (nothing guarded is
  // touched — nativecheck's load-bearing contract).
  bool ParseEntries(const char* p, size_t len, uint32_t n, uint64_t ts,
                    bool explicit_guids, std::vector<uint64_t>* guids,
                    std::vector<StoredMsg>* out) {
    size_t pos = 0;
    const char* prev_pl = nullptr;
    uint32_t prev_len = 0;
    for (uint32_t i = 0; i < n; i++) {
      uint64_t guid = 0;
      if (explicit_guids) {
        if (pos + 8 > len) return false;
        guid = RdU64(p + pos);
        pos += 8;
      }
      if (pos + 11 > len) return false;
      StoredMsg m;
      m.origin = RdU64(p + pos);
      m.flags = static_cast<uint8_t>(p[pos + 8]);
      uint16_t ntok = RdU16(p + pos + 9);
      pos += 11;
      if (pos + 8ull * ntok + 2 > len) return false;
      m.toks.reserve(ntok);
      for (uint16_t k = 0; k < ntok; k++) {
        m.toks.push_back(RdU64(p + pos));
        pos += 8;
      }
      uint16_t tlen = RdU16(p + pos);
      pos += 2;
      if (pos + tlen > len) return false;
      m.topic.assign(p + pos, tlen);
      pos += tlen;
      if (m.flags & 0x10) {  // wire-v1 tracing extension (see header)
        if (pos + 8 > len) return false;
        m.trace = RdU64(p + pos);
        pos += 8;
      }
      if (m.flags & 0x20) {  // origin-clientid extension (round 18)
        if (pos + 1 > len) return false;
        uint8_t cl = static_cast<uint8_t>(p[pos]);
        pos += 1;
        if (pos + cl > len) return false;
        m.cid.assign(p + pos, cl);
        pos += cl;
      }
      if (m.flags & 1) {
        if (pos + 4 > len) return false;
        uint32_t pl = RdU32(p + pos);
        pos += 4;
        if (pos + pl > len) return false;
        m.payload.assign(p + pos, pl);
        prev_pl = p + pos;
        prev_len = pl;
        pos += pl;
      } else {
        if (!prev_pl) return false;  // dedup with no reference
        m.payload.assign(prev_pl, prev_len);
      }
      m.ts_ms = ts;
      if (guids) guids->push_back(guid);
      out->push_back(std::move(m));
    }
    return true;
  }

  // @locked(mu_)
  void IndexMsg(uint64_t guid, StoredMsg&& m, uint32_t seg) {
    if (m.toks.empty()) return;            // nothing to replay: skip
    if (msgs_.count(guid)) return;         // recovery: first record wins
    for (uint64_t tok : m.toks) pending_[tok][guid] = 1;
    m.seg = seg;
    auto sit = segs_.find(seg);
    if (sit != segs_.end()) sit->second.live++;
    stats_[kSsBytes] += m.topic.size() + m.payload.size();
    msgs_.emplace(guid, std::move(m));
  }

  // @locked(mu_) — clamped live-record counter delta for one segment
  void SegLive(uint32_t seg, int d) {
    auto it = segs_.find(seg);
    if (it == segs_.end()) return;
    if (d >= 0)
      it->second.live += static_cast<uint32_t>(d);
    else if (it->second.live >= static_cast<uint32_t>(-d))
      it->second.live -= static_cast<uint32_t>(-d);
    else
      it->second.live = 0;
  }

  // @locked(mu_) — journal + index one REGISTER record into the active
  // segment (fresh registration, recovery replays via ApplyRegister,
  // GC re-homes call this again)
  void JournalRegister(uint64_t tok, const std::string& sid) {
    std::string body;
    body.reserve(10 + sid.size());
    AppendU64(&body, tok);
    AppendU16(&body, static_cast<uint16_t>(sid.size()));
    body += sid;
    AppendFrame(kRecRegister, body.data(), body.size());
    ApplyRegister(tok, sid, active_ ? active_->id : 0);
  }

  // @locked(mu_)
  void ApplyRegister(uint64_t tok, const std::string& sid, uint32_t seg) {
    auto rit = reg_seg_.find(tok);
    if (rit != reg_seg_.end()) SegLive(rit->second, -1);
    token_of_[sid] = tok;
    sid_of_[tok] = sid;
    reg_seg_[tok] = seg;
    SegLive(seg, 1);
    if (tok >= next_token_) next_token_ = tok + 1;
  }

  // @locked(mu_)
  void ApplyUnregister(uint64_t tok) {
    auto sit = sid_of_.find(tok);
    if (sit != sid_of_.end()) {
      token_of_.erase(sit->second);
      sid_of_.erase(sit);
    }
    auto rit = reg_seg_.find(tok);
    if (rit != reg_seg_.end()) {
      SegLive(rit->second, -1);
      reg_seg_.erase(rit);
    }
    ApplySession(tok, nullptr, 0, 0);
    auto pit = pending_.find(tok);
    if (pit != pending_.end()) {
      std::vector<uint64_t> guids;
      guids.reserve(pit->second.size());
      for (auto& [g, _] : pit->second) guids.push_back(g);
      for (uint64_t g : guids) ApplyConsume(tok, g);
    }
  }

  // Callers hold mu_ (the AppendFrame caller-holds contract; this
  // helper touches no guarded field directly, so the checker derives
  // nothing from an annotation here). ONE serializer per record type,
  // shared by the fresh-write path and GC's RehomeMeta (a layout
  // change must never diverge between them — review finding).
  void JournalSession(uint64_t tok, const char* body, uint32_t blen) {
    std::string rec;
    rec.reserve(12 + blen);
    AppendU64(&rec, tok);
    AppendU32(&rec, blen);
    if (blen) rec.append(body, blen);
    AppendFrame(kRecSession, rec.data(), rec.size());
  }

  // callers hold mu_ (see JournalSession)
  void JournalTrunk(const std::string& name, uint64_t seq, uint8_t tf,
                    const char* data, size_t len) {
    std::string body;
    body.reserve(11 + name.size() + len);
    AppendU16(&body, static_cast<uint16_t>(name.size()));
    body += name;
    AppendU64(&body, seq);
    body.push_back(static_cast<char>(tf));
    body.append(data, len);
    AppendFrame(kRecTrunk, body.data(), body.size());
  }

  // @locked(mu_)
  void ApplySession(uint64_t tok, const char* body, uint32_t blen,
                    uint32_t seg) {
    auto it = sess_.find(tok);
    if (it != sess_.end()) {
      SegLive(it->second.seg, -1);
      sess_.erase(it);
    }
    if (blen == 0 || body == nullptr) return;
    SessRec r;
    r.body.assign(body, blen);
    r.seg = seg;
    SegLive(seg, 1);
    sess_.emplace(tok, std::move(r));
  }

  // @locked(mu_)
  void ApplyTrunk(const std::string& name, uint64_t seq, uint8_t tf,
                  const char* data, size_t len, uint32_t seg) {
    TrunkRec& r = trunk_[name][seq];
    if (!r.bytes.empty()) SegLive(r.seg, -1);  // superseded (recovery)
    r.bytes.assign(data, len);
    r.flags = tf;
    r.seg = seg;
    SegLive(seg, 1);
  }

  // @locked(mu_)
  void ApplyTrunkAck(const std::string& name, uint64_t seq) {
    auto it = trunk_.find(name);
    if (it == trunk_.end()) return;
    if (seq == kTrunkDropAll) {
      for (auto& [s, r] : it->second) SegLive(r.seg, -1);
      trunk_.erase(it);
      return;
    }
    auto rit = it->second.find(seq);
    if (rit == it->second.end()) return;
    SegLive(rit->second.seg, -1);
    it->second.erase(rit);
    if (it->second.empty()) trunk_.erase(it);
  }

  // @locked(mu_) — re-journal live REGISTER/SESSION/TRUNK records
  // homed in the victim segments into the active one (GC must never
  // unlink a sid→token mapping, a session catalog entry, or a trunk
  // replay record with the segment that happens to hold it). Returns
  // whether anything was journaled.
  bool RehomeMeta(const std::unordered_set<uint32_t>& victims) {
    bool any = false;
    for (auto& [tok, seg] : reg_seg_) {
      if (!victims.count(seg)) continue;
      auto sit = sid_of_.find(tok);
      if (sit == sid_of_.end()) continue;
      // updates reg_seg_'s VALUE in place (no rehash mid-iteration)
      JournalRegister(tok, sit->second);
      stats_[kSsMetaRewrites]++;
      any = true;
    }
    for (auto& [tok, rec] : sess_) {
      if (!victims.count(rec.seg)) continue;
      JournalSession(tok, rec.body.data(),
                     static_cast<uint32_t>(rec.body.size()));
      SegLive(rec.seg, -1);
      rec.seg = active_ ? active_->id : 0;
      SegLive(rec.seg, 1);
      stats_[kSsMetaRewrites]++;
      any = true;
    }
    for (auto& [name, ring] : trunk_) {
      for (auto& [seq, rec] : ring) {
        if (!victims.count(rec.seg)) continue;
        JournalTrunk(name, seq, rec.flags, rec.bytes.data(),
                     rec.bytes.size());
        SegLive(rec.seg, -1);
        rec.seg = active_ ? active_->id : 0;
        SegLive(rec.seg, 1);
        stats_[kSsMetaRewrites]++;
        any = true;
      }
    }
    return any;
  }

  // @locked(mu_)
  bool ApplyConsume(uint64_t token, uint64_t guid) {
    auto pit = pending_.find(token);
    if (pit == pending_.end() || !pit->second.erase(guid)) return false;
    if (pit->second.empty()) pending_.erase(pit);
    auto mit = msgs_.find(guid);
    if (mit != msgs_.end()) {
      auto& toks = mit->second.toks;
      toks.erase(std::remove(toks.begin(), toks.end(), token), toks.end());
      if (toks.empty()) {
        auto sit = segs_.find(mit->second.seg);
        if (sit != segs_.end() && sit->second.live) sit->second.live--;
        msgs_.erase(mit);
      }
    }
    return true;
  }

  // -- segments ------------------------------------------------------------

  // @locked(mu_) @blocking — open/ftruncate/mmap of a fresh segment
  // (amortized over a whole segment of appends; see waivers.py)
  void Roll(size_t min_bytes) {
    size_t cap = std::max(seg_bytes_, min_bytes);
    Segment s;
    s.id = next_seg_id_++;
    if (dir_.empty()) {
      s.base = static_cast<char*>(
          mmap(nullptr, cap, PROT_READ | PROT_WRITE,
               MAP_PRIVATE | MAP_ANONYMOUS, -1, 0));
    } else {
      char name[32];
      snprintf(name, sizeof(name), "/%08u.seg", s.id);
      std::string path = dir_ + name;
      // @fault(store_seg_open) — injected ENOSPC on the segment-open
      // seam: the real disk-full degradation machinery below runs
      bool inject = fault_.armed(fault::kSiteStoreSegOpen) &&
                    fault_.Fire(fault::kSiteStoreSegOpen) != 0;
      if (inject) errno = ENOSPC;
      s.fd = inject ? -1
                    : open(path.c_str(), O_RDWR | O_CREAT | O_CLOEXEC,
                           0644);
      if (s.fd < 0 || ftruncate(s.fd, static_cast<off_t>(cap)) != 0) {
        if (s.fd >= 0) close(s.fd);
        ok_ = false;
        // degrade to an anonymous segment so the plane keeps running —
        // COUNTED: the operator must learn restart survival is gone
        // (disk full etc.), since qos1 PUBACKs keep flowing
        stats_[kSsDegraded]++;
        s.fd = -1;
        s.base = static_cast<char*>(
            mmap(nullptr, cap, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0));
      } else {
        s.base = static_cast<char*>(
            mmap(nullptr, cap, PROT_READ | PROT_WRITE, MAP_SHARED,
                 s.fd, 0));
      }
    }
    if (s.base == MAP_FAILED) {
      s.base = nullptr;
      ok_ = false;
      stats_[kSsDegraded]++;
      return;
    }
    s.cap = cap;
    if (active_ && active_->fd >= 0 && fsync_ != kFsyncNever)
      SyncSeg(*active_);
    // the outgoing active segment is sealed NOW: the age-based
    // compaction clock starts here
    if (active_) active_->sealed_ms = WallMs();
    active_ = &segs_.emplace(s.id, s).first->second;
  }

  // @locked(mu_)
  void DropSeg(Segment& s) {
    if (s.base) munmap(s.base, s.cap);
    if (s.fd >= 0) {
      close(s.fd);
      char name[32];
      snprintf(name, sizeof(name), "/%08u.seg", s.id);
      unlink((dir_ + name).c_str());
    }
    stats_[kSsGcSegments]++;
  }

  // @locked(mu_)
  void AppendFrame(uint8_t type, const char* body, size_t blen) {
    size_t need = 8 + 1 + blen;
    if (!active_ || active_->end + need > active_->cap)
      Roll(need + 4096);
    // re-check the CAP too: a failed Roll (mmap exhaustion) leaves
    // active_ pointing at the old FULL segment, whose non-null base
    // alone would let the memcpy below write past the mapping
    if (!active_ || !active_->base || active_->end + need > active_->cap)
      return;  // allocation failed: drop (ok_/degraded already flag it)
    char* p = active_->base + active_->end;
    std::string payload;
    payload.reserve(1 + blen);
    payload.push_back(static_cast<char>(type));
    payload.append(body, blen);
    uint32_t crc = Crc32(payload.data(), payload.size());
    uint32_t len = static_cast<uint32_t>(payload.size());
    memcpy(p, &crc, 4);
    memcpy(p + 4, &len, 4);
    memcpy(p + 8, payload.data(), payload.size());
    active_->end += 8 + payload.size();
    dirty_ = true;
  }

  // @locked(mu_) @blocking — msync MS_SYNC is the fsync policy's disk
  // wait; the poll-plane path through FlushDurables is the documented
  // PUBACK-after-fsync contract (see waivers.py)
  void SyncSeg(Segment& s) {
    if (s.fd < 0 || !s.base) return;
    size_t pg = static_cast<size_t>(sysconf(_SC_PAGESIZE));
    size_t len = ((s.end + pg - 1) / pg) * pg;
    int rc;
    // @fault(store_msync) — injected EIO on the fsync seam; the REAL
    // msync return was previously ignored, which silently voided the
    // PUBACK-after-fsync contract on an erroring disk (round 15)
    if (fault_.armed(fault::kSiteStoreMsync) &&
        fault_.Fire(fault::kSiteStoreMsync)) {
      rc = -1;
      errno = EIO;
    } else {
      rc = msync(s.base, std::min(len, s.cap), MS_SYNC);
    }
    if (rc != 0) {
      // the durability this segment's PUBACKs assert is gone for the
      // failed stretch: count it (Python warns + folds the ledger) and
      // flip ok_ STICKY — a sealed segment whose sync failed is never
      // re-synced, so a later clean sync of a NEWER segment is no
      // evidence the failed stretch ever reached disk (review
      // finding); Roll's anonymous fallback is sticky the same way
      ok_ = false;
      stats_[kSsDegraded]++;
    }
    dirty_ = false;
  }

  // @locked(mu_)
  void MaybeSync() {
    if (!dirty_ || !active_ || active_->fd < 0) return;
    if (fsync_ == kFsyncBatch) {
      SyncSeg(*active_);
    } else if (fsync_ == kFsyncInterval) {
      uint64_t now = WallMs();
      if (now - last_sync_ms_ >= kFsyncIntervalMs) {
        last_sync_ms_ = now;
        SyncSeg(*active_);
      }
    }
  }

  // -- recovery ------------------------------------------------------------

  // @locked(mu_) @blocking — boot-time directory scan + mmap
  void Recover() {
    std::vector<uint32_t> ids;
    if (DIR* d = opendir(dir_.c_str())) {
      while (dirent* e = readdir(d)) {
        // exactly NNNNNNNN.seg — sscanf alone would accept any 12-char
        // name with a leading digit (its return value counts
        // conversions, not the literal suffix match), and a stray
        // editor backup must never be mmapped as a segment
        size_t nlen = strlen(e->d_name);
        if (nlen != 12 || strcmp(e->d_name + 8, ".seg") != 0) continue;
        bool digits = true;
        for (int i = 0; i < 8; i++)
          if (e->d_name[i] < '0' || e->d_name[i] > '9') digits = false;
        if (digits)
          ids.push_back(
              static_cast<uint32_t>(strtoul(e->d_name, nullptr, 10)));
      }
      closedir(d);
    }
    std::sort(ids.begin(), ids.end());
    for (uint32_t id : ids) {
      char name[32];
      snprintf(name, sizeof(name), "/%08u.seg", id);
      std::string path = dir_ + name;
      int fd = open(path.c_str(), O_RDWR | O_CLOEXEC);
      if (fd < 0) continue;
      struct stat st {};
      if (fstat(fd, &st) != 0 || st.st_size < 16) {
        close(fd);
        unlink(path.c_str());
        continue;
      }
      Segment s;
      s.id = id;
      s.fd = fd;
      s.cap = static_cast<size_t>(st.st_size);
      s.base = static_cast<char*>(
          mmap(nullptr, s.cap, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
      if (s.base == MAP_FAILED) {
        close(fd);
        continue;
      }
      // emplace BEFORE scanning: IndexMsg bumps seg_live through the
      // map, and a recovered segment missing from it would read live=0
      // — Gc() would then unlink segments still holding live messages
      Segment& ref = segs_.emplace(id, s).first->second;
      ScanSeg(&ref);
      if (id >= next_seg_id_) next_seg_id_ = id + 1;
      // the previous newest is sealed by this one arriving; its age
      // clock (compaction trigger) restarts at recovery — conservative
      if (active_) active_->sealed_ms = WallMs();
      active_ = &ref;  // newest scanned segment resumes as active
    }
    // resume appending AFTER the last valid frame of the newest segment
  }

  // @locked(mu_)
  void ScanSeg(Segment* s) {
    size_t pos = 0;
    while (pos + 9 <= s->cap) {
      uint32_t crc = RdU32(s->base + pos);
      uint32_t len = RdU32(s->base + pos + 4);
      if (len == 0 || len > s->cap - pos - 8) {
        // a zeroed header is the clean end of the log; anything else
        // is a torn partial write (e.g. truncation mid-frame)
        if (crc != 0 || len != 0) stats_[kSsTornDrops]++;
        break;
      }
      const char* payload = s->base + pos + 8;
      if (Crc32(payload, len) != crc) {
        stats_[kSsTornDrops]++;
        break;  // torn tail / corruption: drop this and the rest
      }
      ApplyRecord(static_cast<uint8_t>(payload[0]), payload + 1, len - 1,
                  s->id);
      pos += 8 + len;
    }
    s->end = pos;
  }

  // @locked(mu_)
  void ApplyRecord(uint8_t type, const char* body, size_t blen,
                   uint32_t seg) {
    if (type == kRecRegister && blen >= 10) {
      uint64_t tok = RdU64(body);
      uint16_t sl = RdU16(body + 8);
      if (10u + sl <= blen)
        ApplyRegister(tok, std::string(body + 10, sl), seg);
    } else if (type == kRecSession && blen >= 12) {
      uint64_t tok = RdU64(body);
      uint32_t bl = RdU32(body + 8);
      if (12u + bl <= blen) ApplySession(tok, body + 12, bl, seg);
    } else if (type == kRecUnregister && blen >= 8) {
      ApplyUnregister(RdU64(body));
    } else if (type == kRecTrunk && blen >= 11) {
      uint16_t nl = RdU16(body);
      if (2u + nl + 9 <= blen) {
        std::string name(body + 2, nl);
        uint64_t seq = RdU64(body + 2 + nl);
        uint8_t tf = static_cast<uint8_t>(body[2 + nl + 8]);
        ApplyTrunk(name, seq, tf, body + 2 + nl + 9,
                   blen - 2 - nl - 9, seg);
      }
    } else if (type == kRecTrunkAck && blen >= 10) {
      uint16_t nl = RdU16(body);
      if (2u + nl + 8 <= blen)
        ApplyTrunkAck(std::string(body + 2, nl), RdU64(body + 2 + nl));
    } else if (type == kRecMsgBatch && blen >= 20) {
      uint64_t base = RdU64(body);
      uint64_t ts = RdU64(body + 8);
      uint32_t n = RdU32(body + 16);
      std::vector<StoredMsg> parsed;
      if (ParseEntries(body + 20, blen - 20, n, ts, false, nullptr,
                       &parsed)) {
        for (uint32_t i = 0; i < n; i++)
          IndexMsg(base + i, std::move(parsed[i]), seg);
        if (base + n > next_guid_) next_guid_ = base + n;
      } else {
        stats_[kSsTornDrops]++;
      }
    } else if (type == kRecConsume && blen >= 4) {
      uint32_t n = RdU32(body);
      size_t pos = 4;
      for (uint32_t i = 0; i < n && pos + 16 <= blen; i++, pos += 16)
        ApplyConsume(RdU64(body + pos), RdU64(body + pos + 8));
    } else if (type == kRecRewrite && blen >= 12) {
      uint64_t ts = RdU64(body);
      uint32_t n = RdU32(body + 8);
      std::vector<StoredMsg> parsed;
      std::vector<uint64_t> guids;
      if (ParseEntries(body + 12, blen - 12, n, ts, true, &guids,
                       &parsed)) {
        for (uint32_t i = 0; i < n; i++) {
          IndexMsg(guids[i], std::move(parsed[i]), seg);
          if (guids[i] >= next_guid_) next_guid_ = guids[i] + 1;
        }
      }
    }
  }

  std::string dir_;        // immutable after construction
  size_t seg_bytes_;       // immutable after construction
  int fsync_;              // immutable after construction
  // faultline injector (all-atomic: arming never takes mu_; firing
  // happens under it with the syscall it replaces)
  fault::Injector fault_;
  uint64_t compact_age_ms_ = 60000;  // @guards(mu_) — 0 = age trigger off
  bool ok_ = true;         // @guards(mu_) — Roll flips it mid-run
  bool dirty_ = false;             // @guards(mu_)
  uint64_t last_sync_ms_ = 0;      // @guards(mu_)
  uint64_t next_guid_ = 1;         // @guards(mu_)
  uint64_t next_token_ = 1;        // @guards(mu_)
  uint32_t next_seg_id_ = 1;       // @guards(mu_)
  std::mutex mu_;
  // ordered: recovery + GC walk
  std::map<uint32_t, Segment> segs_;                        // @guards(mu_)
  Segment* active_ = nullptr;                               // @guards(mu_)
  std::unordered_map<std::string, uint64_t> token_of_;      // @guards(mu_)
  std::unordered_map<uint64_t, std::string> sid_of_;        // @guards(mu_)
  // token -> segment homing its current REGISTER record (GC re-home)
  std::unordered_map<uint64_t, uint32_t> reg_seg_;          // @guards(mu_)
  // session catalog (round 18): newest SESSION record per token
  struct SessRec {
    std::string body;
    uint32_t seg = 0;
  };
  std::unordered_map<uint64_t, SessRec> sess_;              // @guards(mu_)
  // trunk replay rings (round 18): peer name -> seq-ordered records
  std::unordered_map<std::string,
                     std::map<uint64_t, TrunkRec>> trunk_;  // @guards(mu_)
  std::unordered_map<uint64_t, StoredMsg> msgs_;            // @guards(mu_)
  // token -> ordered guid set (fetch replays in guid = arrival order)
  std::unordered_map<uint64_t,
                     std::map<uint64_t, uint8_t>> pending_; // @guards(mu_)
  uint64_t stats_[kSsStatCount] = {};                       // @guards(mu_)
};

}  // namespace store
}  // namespace emqx_native
