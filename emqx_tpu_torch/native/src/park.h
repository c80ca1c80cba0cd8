// Parked-conn hibernation + accept-storm governance — the per-conn
// memory diet of the conn-scale plane (round 16).
//
// The reference broker reaches 100M conns/cluster by HIBERNATING idle
// connection processes (emqx_connection.erl enters erlang hibernate
// after an idle stretch, dropping the process heap to a continuation).
// Our analogue: an idle conn's full `Conn` struct — framer buffer,
// outbuf, permit set, flight recorder, and above all the lazily-grown
// AckState (20KB of window bitmaps once any QoS1/2 delivery touched
// the conn) — collapses into a `Parked` record of a couple hundred
// bytes holding exactly what re-inflation needs: the fd, the wire
// flags, the keepalive clock, and a SPARSE summary of any mid-flight
// ack window (the flight recorder's lazy-alloc discipline generalized
// to the whole conn). The fd stays registered in epoll under the same
// tag, so the FIRST BYTE from the peer re-inflates the conn before
// any fast-path work — hibernation is invisible on the wire.
//
// Records live in a slab (fixed block pool, stable u32 slots, free
// list) so a million parked conns are a handful of large allocations
// instead of a million heap nodes, and park/inflate churn never
// fragments the poll thread's arena.
//
// The AcceptGovernor is the accept-storm rung of the degradation
// ladder: admission is decided in the accept loop BEFORE any conn
// side effect (id mint, table insert, OPEN event). Backlog pressure
// (per-cycle accept burst) DEFERS — the kernel listen backlog holds
// the remainder for the next cycle, no side effects at all; a parked-
// memory budget breach SHEDS — close-with-ledger, visible as
// `messages.ledger.accept_shed` and the `conns_shed` stat slot.
//
// Ownership: everything here is owned by one shard's poll thread
// (the wheel.h contract); control threads configure it through the
// host Op queue.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <utility>
#include <vector>

namespace emqx_native {
namespace park {

// Fixed-size block pool with stable u32 slots. Free() resets the
// object so its heap (vectors, strings) releases immediately; the
// block spine itself is never returned (parked herds re-grow).
template <typename T>
class Slab {
 public:
  static constexpr size_t kBlock = 1024;

  uint32_t Alloc() {
    if (!free_.empty()) {
      uint32_t i = free_.back();
      free_.pop_back();
      return i;
    }
    if (top_ == blocks_.size() * kBlock)
      blocks_.emplace_back(new T[kBlock]);
    return top_++;
  }

  T& at(uint32_t i) { return blocks_[i / kBlock][i % kBlock]; }

  void Free(uint32_t i) {
    at(i) = T();
    free_.push_back(i);
  }

  size_t live() const { return top_ - free_.size(); }
  size_t spine_bytes() const {
    return blocks_.size() * kBlock * sizeof(T) +
           free_.capacity() * sizeof(uint32_t);
  }

 private:
  std::vector<std::unique_ptr<T[]>> blocks_;
  std::vector<uint32_t> free_;
  size_t top_ = 0;
};

// Parked-record flags.
constexpr uint8_t kPkFast = 1;    // fast path was enabled
constexpr uint8_t kPkWs = 2;      // WebSocket transport (codec was idle)
constexpr uint8_t kPkSynth = 4;   // synthetic conn (fd < 0, bench/test)

// The hibernated conn. The ack-window summary is SPARSE: `infl` packs
// (pid - kNativePidBase) | qos2_bit << 16 | rel_bit << 17 per
// in-flight delivery, `awrel` lists publisher awaiting-rel pids — a
// parked conn with a mid-flight qos1 window re-inflates with the
// window intact (tests/test_native_connscale.py pins the PUBACK after
// park/inflate landing on the right slot).
struct Parked {
  int fd = -1;
  uint8_t flags = 0;
  uint8_t proto_ver = 4;
  uint16_t next_pid = 0;
  uint32_t keepalive_ms = 0;     // effective deadline (1.5x keepalive)
  uint32_t max_inflight = 0;
  uint64_t last_rx_ms = 0;
  // wheel handle — survives hibernation; @gen-handle: flows only into
  // generation-checked wheel consumers (a recycled slot must no-op)
  uint64_t tm_keepalive = 0;
  std::vector<uint32_t> infl;    // sparse in-flight window summary
  std::vector<uint16_t> awrel;   // publisher qos2 awaiting-rel pids
  std::vector<std::string> own_subs;
  std::vector<std::pair<uint64_t, std::string>> own_shared;
};

// The record target is "a few hundred bytes": the struct itself must
// stay small enough that a million parked conns are slab spine + the
// (usually one-element) sub vectors.
static_assert(sizeof(Parked) <= 192, "parked record outgrew its diet");

// Approximate resident bytes of one record (struct + tracked heap) —
// the parked-memory gauge the accept governor budgets against and the
// bench's bytes/conn-parked numerator.
inline size_t RecordBytes(const Parked& p) {
  size_t n = sizeof(Parked);
  n += p.infl.capacity() * sizeof(uint32_t);
  n += p.awrel.capacity() * sizeof(uint16_t);
  for (const std::string& s : p.own_subs)
    n += sizeof(std::string) + s.capacity();
  for (const auto& [tok, s] : p.own_shared)
    n += sizeof(uint64_t) + sizeof(std::string) + s.capacity();
  return n;
}

// Accept-storm governance: the ladder rung decided in the accept loop
// before side effects. Defer = backlog pressure (stop accepting this
// cycle, the kernel backlog queues); shed = memory budget breach
// (close-with-ledger). Poll-thread-owned; configured via the Op queue.
class AcceptGovernor {
 public:
  void Configure(uint32_t burst_max, uint64_t mem_budget_bytes) {
    burst_max_ = burst_max;
    mem_budget_ = mem_budget_bytes;
  }

  void BeginCycle() { cycle_accepts_ = 0; }

  // Backlog pressure: past the per-cycle burst the remainder of the
  // kernel backlog waits for the next cycle — no side effects, no
  // shed. 0 = unlimited.
  bool Defer() const {
    return burst_max_ != 0 && cycle_accepts_ >= burst_max_;
  }

  // The accept-shed admission decision, taken BEFORE any conn side
  // effect; `est_conn_bytes` is the host's current conn-memory
  // estimate (resident + parked). 0 budget = always admit.
  // @admit-check
  bool Admit(uint64_t est_conn_bytes) {
    cycle_accepts_++;
    return mem_budget_ == 0 || est_conn_bytes <= mem_budget_;
  }

  uint32_t burst_max() const { return burst_max_; }
  uint64_t mem_budget() const { return mem_budget_; }

 private:
  uint32_t burst_max_ = 0;
  uint64_t mem_budget_ = 0;
  uint32_t cycle_accepts_ = 0;
};

}  // namespace park
}  // namespace emqx_native
