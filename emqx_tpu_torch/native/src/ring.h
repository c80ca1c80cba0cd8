// Multi-core native plane (round 12): the lock-free cross-shard seam.
//
// A sharded host runs N independent epoll loops (one Host instance per
// shard, each with its own poll thread, lanes, ack windows, telemetry
// buffers and outbuf machinery — host.cc stays single-threaded per
// instance). The match table is LOGICALLY shared: every shard holds a
// full replica (Python broadcasts table ops to all shards, each shard
// applies them in its own ApplyPending, serialized with its own
// matching — the existing poll-thread-ownership discipline, N times).
// What crosses shards is DELIVERY: a publish matched on shard S whose
// subscriber connection lives on shard T rides one of these rings.
//
// Ring contract (the "must not take a lock on the hot path" clause):
//   - one SpscRing per ordered shard pair (N^2 rings, each
//     single-producer/single-consumer BY CONSTRUCTION: only S's poll
//     thread pushes on rings[S][T], only T's poll thread pops);
//   - a slot holds one sealed BATCH record in the trunk wire layout
//     (trunk.h AppendEntry pre-parse entries, payload-deduped), with a
//     [u64 target] prefix per entry so the consumer delivers by conn id
//     instead of re-matching — per-topic order per (publisher, target)
//     follows from the FIFO ring + the consumer's sequential decode,
//     exactly like a trunk link;
//   - bounded: when a ring cannot take this publish (free slots < 2 —
//     room for the open batch plus one mid-publish seal), the publish
//     degrades ring-full -> punt -> Python BEFORE any side effect,
//     mirroring the trunk's trunk-down ladder (host.cc TryFast).
//
// Teardown: the group OWNS the doorbell eventfds (a producer must be
// able to ring a shard whose Host died mid-race — writing to a closed,
// possibly-reused fd would be a use-after-close); Hosts only clear
// their alive flag. Python destroys every host BEFORE the group.
#pragma once

#include <sys/eventfd.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <string>

namespace emqx_native {
namespace ring {

constexpr int kMaxShards = 8;
// Slots per ring: each slot is one sealed batch (<= ~192KB, the tap
// flush cap), sealed once per poll cycle per destination plus at the
// byte cap — 256 batches of backlog per pair before the ladder punts.
constexpr size_t kRingSlots = 256;

// Bounded lock-free SPSC ring of sealed batch records. Single producer
// (the source shard's poll thread), single consumer (the destination
// shard's poll thread); head_/tail_ are the only shared state.
class SpscRing {
 public:
  // Producer only. False = full (caller counts shard_ring_full).
  bool Push(std::string&& rec) {
    size_t h = head_.load(std::memory_order_relaxed);
    size_t t = tail_.load(std::memory_order_acquire);
    if (h - t >= kRingSlots) return false;
    slots_[h & (kRingSlots - 1)] = std::move(rec);
    head_.store(h + 1, std::memory_order_release);
    return true;
  }

  // Consumer only.
  bool Pop(std::string* out) {
    size_t t = tail_.load(std::memory_order_relaxed);
    size_t h = head_.load(std::memory_order_acquire);
    if (t == h) return false;
    *out = std::move(slots_[t & (kRingSlots - 1)]);
    tail_.store(t + 1, std::memory_order_release);
    return true;
  }

  // Producer-side free-slot view: exact for the producer (only the
  // consumer ever grows it), which is what the pre-side-effect
  // admission check needs.
  size_t Free() const {
    return kRingSlots - (head_.load(std::memory_order_relaxed) -
                         tail_.load(std::memory_order_acquire));
  }

 private:
  // @published(head_, tail_) — slot data is made visible to the other
  // side ONLY by the index's release store: every slots_ write/read
  // must lexically precede the publish in Push/Pop
  std::string slots_[kRingSlots];
  // @atomic(acq_rel: producer release-publishes filled slots; consumer acquire-loads; own-side reads relaxed)
  alignas(64) std::atomic<size_t> head_{0};
  // @atomic(acq_rel: consumer release-publishes freed slots; producer acquire-loads; own-side reads relaxed)
  alignas(64) std::atomic<size_t> tail_{0};
};

// Shared by every Host of one sharded server. Created by Python before
// any host joins; destroyed after every host is destroyed.
struct ShardGroup {
  explicit ShardGroup(int n_shards) : n(n_shards) {
    for (int i = 0; i < kMaxShards; i++) {
      doorbell[i] = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
      alive[i].store(false, std::memory_order_relaxed);
    }
  }
  ~ShardGroup() {
    for (int i = 0; i < kMaxShards; i++)
      if (doorbell[i] >= 0) close(doorbell[i]);
  }
  ShardGroup(const ShardGroup&) = delete;
  ShardGroup& operator=(const ShardGroup&) = delete;

  // Wake the destination shard's epoll loop after a push. The group
  // owns the fd, so this is safe even when the target Host is gone
  // (the write lands on a live-but-unwatched eventfd).
  void RingDoorbell(int dst) {
    uint64_t one = 1;
    [[maybe_unused]] ssize_t r = write(doorbell[dst], &one, sizeof(one));
  }

  int n;
  SpscRing rings[kMaxShards][kMaxShards];  // [src][dst]
  int doorbell[kMaxShards];
  // set at join, cleared at ~Host
  // @atomic(acq_rel: join release-publishes the shard's readiness; producers acquire-load before pushing; ctor init relaxed)
  std::atomic<bool> alive[kMaxShards];
};

}  // namespace ring
}  // namespace emqx_native
