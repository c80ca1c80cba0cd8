// Hierarchical timer wheel — the conn-scale plane's clock (round 16).
//
// Before this header every native-plane deadline was a SWEEP: the SN
// qos1 retransmit scan walked every tracked conn per poll cycle, the
// trunk ack watchdog walked every peer, and keepalive ran as a Python
// housekeep loop over ALL conns calling conn_idle_ms one by one — an
// O(N)-per-tick cost that is invisible at 10k conns and is THE
// bottleneck at the reference's headline scale (100M conns/cluster,
// PAPER.md § README:16; "1M mostly-idle devices per node" on the
// ROADMAP). This is the classic timing-wheel answer (Varghese &
// Lauck; the Linux timer wheel; Erlang's timer service behind the
// reference's keepalive): arm/cancel are O(1), and a poll cycle pays
// O(expired + cascades) — a million parked-and-silent conns cost the
// cycle nothing.
//
// Shape: kLevels levels of kSlots slots at kTickMs granularity.
// Level 0 spans 64 ticks (~1s at 16ms); each higher level is 64x
// coarser, so the horizon is ~3 days — clamped, never dropped. A
// timer lands in the coarsest-necessary level and CASCADES down one
// level each time the finer wheel completes a revolution; deadlines
// round UP to the next tick, so a timer never fires early and fires
// at most one tick late relative to the Advance() clock
// (tests/test_native_connscale.py pins this against a brute-force
// oracle at 10k timers).
//
// Ownership contract: one Wheel per shard Host, owned by that shard's
// poll thread like the match table — no locks, no atomics; control
// threads reach it only through the host's Op queue (ApplyPending).
// Handles are generation-checked (u32 index | u32 gen) so a stale
// cancel after the slot was recycled is a no-op, never a cross-timer
// cancellation: fire handlers routinely Drop() a conn whose OTHER
// timers expired in the same tick.
#pragma once

#include <cstdint>
#include <vector>

namespace emqx_native {
namespace wheel {

constexpr int kTickShift = 4;              // 16ms ticks
constexpr uint64_t kTickMs = 1ull << kTickShift;
constexpr int kSlotBits = 6;
constexpr int kSlots = 1 << kSlotBits;     // 64 slots per level
constexpr int kLevels = 4;                 // horizon 64^4 ticks ≈ 3.1d

class Wheel {
 public:
  explicit Wheel(uint64_t now_ms) : cur_(now_ms >> kTickShift) {
    for (int l = 0; l < kLevels; l++)
      for (int s = 0; s < kSlots; s++) slots_[l][s] = -1;
  }

  // Arm a timer: fire(key, kind) runs at the first Advance() whose
  // clock passes deadline_ms (never before it). Returns a nonzero
  // handle; the handle is CONSUMED by the fire (re-arm from the
  // handler) or released by Cancel().
  uint64_t Arm(uint64_t key, uint8_t kind, uint64_t deadline_ms) {
    int32_t i = AllocNode();
    Node& nd = pool_[i];
    nd.key = key;
    nd.kind = kind;
    nd.deadline = deadline_ms;
    Place(i, /*min_tick=*/cur_ + 1);
    armed_++;
    return (static_cast<uint64_t>(nd.gen) << 32) |
           (static_cast<uint32_t>(i) + 1);
  }

  // O(1) unlink. Generation-checked: a handle whose timer already
  // fired (or was cancelled) is a no-op even if the slot was reused.
  // @gen-checked
  bool Cancel(uint64_t h) {
    int32_t i = NodeOf(h);
    if (i < 0) return false;
    Unlink(i);
    FreeNode(i);
    armed_--;
    return true;
  }

  // Advance the wheel clock to now_ms, firing every expired timer
  // (handles auto-release before their fire runs, so handlers re-arm
  // freely). Handlers may Arm/Cancel other timers — including ones
  // expiring in this same batch, which then no-op on their lookup.
  template <class F>
  void Advance(uint64_t now_ms, F&& fire) {
    uint64_t target = now_ms >> kTickShift;
    while (cur_ < target) {
      cur_++;
      if ((cur_ & (kSlots - 1)) == 0) Cascade(1);
      int slot = static_cast<int>(cur_ & (kSlots - 1));
      int32_t i = slots_[0][slot];
      if (i < 0) continue;
      slots_[0][slot] = -1;
      scratch_.clear();
      while (i >= 0) {
        Node& nd = pool_[i];
        int32_t nx = nd.next;
        scratch_.push_back({nd.key, nd.kind});
        FreeNode(i);
        armed_--;
        i = nx;
      }
      for (const Due& d : scratch_) fire(d.key, d.kind);
    }
  }

  size_t armed() const { return armed_; }
  size_t pool_bytes() const { return pool_.capacity() * sizeof(Node); }

 private:
  struct Node {
    uint64_t key = 0;
    uint64_t deadline = 0;
    int32_t next = -1, prev = -1;
    int16_t slot = -1;      // level * kSlots + slot, -1 = detached
    uint8_t kind = 0;
    bool live = false;
    uint32_t gen = 1;
  };
  struct Due {
    uint64_t key;
    uint8_t kind;
  };

  // @gen-check — the ONE place a raw handle becomes a slot index:
  // the generation in the handle's high word must match the node's
  int32_t NodeOf(uint64_t h) const {
    if (!h) return -1;
    int32_t i = static_cast<int32_t>(h & 0xFFFFFFFFull) - 1;
    if (i < 0 || i >= static_cast<int32_t>(pool_.size())) return -1;
    const Node& nd = pool_[i];
    if (!nd.live || nd.gen != static_cast<uint32_t>(h >> 32)) return -1;
    return i;
  }

  int32_t AllocNode() {
    if (!free_.empty()) {
      int32_t i = free_.back();
      free_.pop_back();
      pool_[i].live = true;
      return i;
    }
    pool_.push_back(Node{});
    pool_.back().live = true;
    return static_cast<int32_t>(pool_.size() - 1);
  }

  // @gen-bump — recycling a slot MUST advance its generation
  void FreeNode(int32_t i) {
    Node& nd = pool_[i];
    nd.live = false;
    nd.gen++;                 // stale handles die here (ABA guard)
    nd.next = nd.prev = -1;
    nd.slot = -1;
    free_.push_back(i);
  }

  // Deadlines round UP to the owning tick (never early). `min_tick`
  // floors the placement: a fresh Arm cannot land before cur_ + 1
  // (that tick's slot already expired), while a CASCADE may re-place
  // a timer due exactly at cur_ — its level-0 slot expires later in
  // the same Advance step, so clamping it forward would fire one tick
  // late (the oracle caught exactly this off-by-one).
  void Place(int32_t i, uint64_t min_tick) {
    Node& nd = pool_[i];
    uint64_t t = (nd.deadline + kTickMs - 1) >> kTickShift;
    if (t < min_tick) t = min_tick;
    uint64_t delta = t - cur_;
    constexpr uint64_t kHorizon =
        1ull << (kSlotBits * kLevels);  // clamp, never drop
    if (delta >= kHorizon) t = cur_ + kHorizon - 1;
    int level = 0;
    while (level < kLevels - 1 &&
           (t - cur_) >= (1ull << (kSlotBits * (level + 1))))
      level++;
    int slot = static_cast<int>((t >> (kSlotBits * level)) & (kSlots - 1));
    nd.slot = static_cast<int16_t>(level * kSlots + slot);
    nd.prev = -1;
    nd.next = slots_[level][slot];
    if (nd.next >= 0) pool_[nd.next].prev = i;
    slots_[level][slot] = i;
  }

  void Unlink(int32_t i) {
    Node& nd = pool_[i];
    if (nd.slot < 0) return;
    if (nd.prev >= 0)
      pool_[nd.prev].next = nd.next;
    else
      slots_[nd.slot / kSlots][nd.slot % kSlots] = nd.next;
    if (nd.next >= 0) pool_[nd.next].prev = nd.prev;
    nd.slot = -1;
    nd.next = nd.prev = -1;
  }

  // One finer-wheel revolution completed: re-place the coarser level's
  // current slot down (timers now within the finer horizon descend;
  // recursion rolls further up when this level itself wrapped).
  void Cascade(int level) {
    if (level >= kLevels) return;
    int slot = static_cast<int>((cur_ >> (kSlotBits * level)) &
                                (kSlots - 1));
    if (slot == 0 && level + 1 < kLevels) Cascade(level + 1);
    int32_t i = slots_[level][slot];
    slots_[level][slot] = -1;
    while (i >= 0) {
      int32_t nx = pool_[i].next;
      pool_[i].next = pool_[i].prev = -1;
      pool_[i].slot = -1;
      Place(i, /*min_tick=*/cur_);
      i = nx;
    }
  }

  uint64_t cur_;
  size_t armed_ = 0;
  std::vector<Node> pool_;
  std::vector<int32_t> free_;
  std::vector<Due> scratch_;
  int32_t slots_[kLevels][kSlots];
};

// The ctypes parity surface (tests/test_native_connscale.py): runs a
// seeded op script against a fresh Wheel on the CALLER's thread and
// records every arm/cancel/advance/fire so the Python brute-force
// oracle can replay it exactly. Standalone — never touches a Host.
// @plane(control)
inline void SelfTestScript(uint64_t seed, uint32_t n_ops,
                           std::vector<uint8_t>* out) {
  auto put8 = [out](uint64_t v) {
    for (int i = 0; i < 8; i++)
      out->push_back(static_cast<uint8_t>((v >> (8 * i)) & 0xFF));
  };
  uint64_t x = seed ? seed : 0x9E3779B97F4A7C15ull;
  auto rnd = [&x]() {
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    return x * 0x2545F4914F6CDD1Dull;
  };
  uint64_t now = 1000000;
  Wheel w(now);
  std::vector<std::pair<uint64_t, uint64_t>> live;  // (key, handle)
  uint64_t next_key = 1;
  for (uint32_t op = 0; op < n_ops; op++) {
    uint64_t r = rnd();
    int what = static_cast<int>(r % 100);
    if (what < 55 || live.empty()) {
      uint64_t deadline = now + 1 + (rnd() % 200000);  // up to ~3.3min
      uint64_t key = next_key++;
      uint64_t h = w.Arm(key, 1, deadline);
      live.emplace_back(key, h);
      out->push_back(2);  // ARM record
      put8(key);
      put8(deadline);
    } else if (what < 70) {
      size_t pick = rnd() % live.size();
      out->push_back(3);  // CANCEL record
      put8(live[pick].first);
      w.Cancel(live[pick].second);
      live[pick] = live.back();
      live.pop_back();
    } else {
      now += rnd() % 30000;  // jump up to 30s (multi-level cascades)
      out->push_back(1);     // ADVANCE record
      put8(now);
      size_t fired_at = out->size();
      put8(0);  // fire-count placeholder
      uint64_t fired = 0;
      w.Advance(now, [&](uint64_t key, uint8_t) {
        put8(key);
        fired++;
        for (size_t i = 0; i < live.size(); i++)
          if (live[i].first == key) {
            live[i] = live.back();
            live.pop_back();
            break;
          }
      });
      for (int i = 0; i < 8; i++)
        (*out)[fired_at + i] =
            static_cast<uint8_t>((fired >> (8 * i)) & 0xFF);
    }
  }
  // final drain: every script deadline is <= now + 200000ms, so one
  // bounded jump past that flushes everything still armed
  now += 300000;
  out->push_back(1);
  put8(now);
  size_t fired_at = out->size();
  put8(0);
  uint64_t fired = 0;
  w.Advance(now, [&](uint64_t key, uint8_t) {
    put8(key);
    fired++;
  });
  for (int i = 0; i < 8; i++)
    (*out)[fired_at + i] = static_cast<uint8_t>((fired >> (8 * i)) & 0xFF);
}

}  // namespace wheel
}  // namespace emqx_native
