// faultline (round 15): deterministic fault injection at the native
// plane's syscall seams.
//
// Every failure the plane had ever been tested against was a clean
// kill: SIGKILL closes sockets with a FIN/RST, so the half-open-link
// machinery (HELLO grace, redial backoff, the qos1 replay shadow under
// a link that is up-but-black) shipped unexercised. This header is the
// missing lever: NAMED fault sites compiled into the hot paths, each a
// SINGLE relaxed-atomic load + branch when disarmed, armed from Python
// via ``emqx_host_fault_arm(site, mode, n_or_prob, seed, key)``.
//
// Site catalog (keep in sync with native/__init__.py FAULT_SITES —
// tests/test_stats_lint.py enforces the mechanical mapping, and the
// nativecheck ``fault`` rule enforces that every site below has an
// annotated C++ fire site exercised by at least one test):
//
//   conn_read / conn_write / conn_accept   client-socket recv/send/accept
//   trunk_read / trunk_write / trunk_accept / trunk_connect
//                                          trunk-link syscall seams
//   store_msync / store_seg_open           durable-store fsync + segment
//                                          open (EIO / ENOSPC)
//   ring_seal                              cross-shard ring: forced full
//   ring_doorbell                          cross-shard wakeup suppressed
//   housekeep_clock                        ConnIdleMs reads a skewed clock
//
// Modes (what an armed site does when it fires):
//
//   errno      fail the call with the site's canonical errno
//              (ECONNRESET sockets, EIO msync, ENOSPC segment-open)
//   short      send() writes only a prefix of the requested bytes
//              (the partial-write backlog machinery under test)
//   blackhole  a TCP partition rather than a close: writes claim full
//              success while the bytes vanish; reads drain-and-discard
//              and report "nothing arrived". The socket stays
//              ESTABLISHED — no FIN/RST ever surfaces, which is
//              exactly the half-open shape SIGKILL tests cannot make.
//   full       ring seal: the admission check reports no room
//              (forced ring_full -> punt -> Python ladder)
//   skew       housekeep clock: n_or_prob milliseconds are ADDED to
//              the idle clock (keepalive scans see the future)
//
// Determinism contract: ``n_or_prob`` selects the firing schedule —
//   0        fire on EVERY hit while armed (partitions persist);
//   n >= 1   fire on exactly the next floor(n) hits, then auto-disarm;
//   0 < p <1 fire each hit with probability p drawn from xorshift64
//            seeded by ``seed`` — same seed + same hit order = the
//            bit-identical firing sequence, so chaos runs REPLAY.
// ``key`` scopes a site to one object: conn id for conn_* sites, peer
// id for trunk_* sites (dialer legs — accepted socks have no peer
// identity and never match a scoped arm), destination shard + 1 for
// ring_* sites. key 0 arms the site for every object.
//
// Threading: arming uses only atomics and may race the poll thread
// freely (DRIVER_FAULT hammers exactly that under ASan+TSan); the
// firing decision is single-consumer per site in practice (poll
// thread, or the store mutex for store sites), which is what the
// replay-determinism pin relies on.
#pragma once

#include <atomic>
#include <cstdint>

namespace emqx_native {
namespace fault {

// keep in sync with native/__init__.py FAULT_SITES (stats-lint rule)
enum Site {
  kSiteConnRead = 0,
  kSiteConnWrite,
  kSiteConnAccept,
  kSiteTrunkRead,
  kSiteTrunkWrite,
  kSiteTrunkAccept,
  kSiteTrunkConnect,
  kSiteStoreMsync,
  kSiteStoreSegOpen,
  kSiteRingSeal,
  kSiteRingDoorbell,
  kSiteHousekeepClock,
  kSiteCount
};

// keep in sync with native/__init__.py FAULT_MODES
enum Mode {
  kModeOff = 0,
  kModeErrno,
  kModeShort,
  kModeBlackhole,
  kModeFull,
  kModeSkew,
};

struct SiteState {
  // 0 = disarmed: THE hot branch. Arm publishes the schedule fields
  // below with its release store; Fire's acquire load pairs with it
  // (armed()'s relaxed peek only gates whether to pay Fire at all).
  // @atomic(acq_rel: Arm release-publishes the schedule fields; Fire acquire-loads before reading them)
  std::atomic<uint32_t> mode{0};
  // @atomic(relaxed: written before mode's release publish, read after Fire's acquire) 0 = any object
  std::atomic<uint64_t> key{0};
  // @atomic(relaxed: single consumer per site in practice; -1 = until disarmed) countdown
  std::atomic<int64_t> remaining{-1};
  // @atomic(relaxed: published by mode, read-only after arm) 0 = always; else 2^-32 units
  std::atomic<uint32_t> prob{0};
  // @atomic(relaxed: xorshift64 state, single consumer per site keeps replay deterministic)
  std::atomic<uint64_t> prng{0};
  // @atomic(relaxed: raw n_or_prob magnitude, read by Param for skew ms)
  std::atomic<int64_t> param{0};
  // @atomic(relaxed: monotone fire counter, cross-thread gauge read)
  std::atomic<uint64_t> fired{0};
};

class Injector {
 public:
  // The disarmed fast path: one relaxed atomic load + branch. Call
  // sites gate on this before paying Fire()'s decision cost.
  // -DEMQX_NO_FAULTLINE compiles the whole layer out (constant false
  // folds every branch away) — the bench's "disarmed sites are free"
  // baseline arm (EMQX_NATIVE_NOFAULT=1 builds that variant).
  bool armed(int site) const {
#ifdef EMQX_NO_FAULTLINE
    (void)site;
    return false;
#else
    return sites_[site].mode.load(std::memory_order_relaxed) != 0;
#endif
  }

  // Arm ``site`` (mode kModeOff disarms). See the header comment for
  // the n_or_prob / seed / key contract. Thread-safe; resets the
  // firing schedule (countdown + PRNG) every call.
  void Arm(int site, int mode, double n_or_prob, uint64_t seed,
           uint64_t key) {
    if (site < 0 || site >= kSiteCount) return;
    SiteState& st = sites_[site];
    st.key.store(key, std::memory_order_relaxed);
    st.param.store(static_cast<int64_t>(n_or_prob),
                   std::memory_order_relaxed);
    if (mode == kModeSkew || n_or_prob <= 0.0 || mode == kModeOff) {
      // skew carries its magnitude in n_or_prob: fire every hit
      st.remaining.store(-1, std::memory_order_relaxed);
      st.prob.store(0, std::memory_order_relaxed);
    } else if (n_or_prob >= 1.0) {
      st.remaining.store(static_cast<int64_t>(n_or_prob),
                         std::memory_order_relaxed);
      st.prob.store(0, std::memory_order_relaxed);
    } else {
      st.remaining.store(-1, std::memory_order_relaxed);
      st.prob.store(
          static_cast<uint32_t>(n_or_prob * 4294967296.0),
          std::memory_order_relaxed);
      st.prng.store(seed ? seed : 0x9E3779B97F4A7C15ull,
                    std::memory_order_relaxed);
    }
    st.mode.store(static_cast<uint32_t>(mode < 0 ? 0 : mode),
                  std::memory_order_release);
  }

  // Armed-path decision for one hit: returns the mode when the fault
  // fires (and counts it), 0 otherwise. ``key`` identifies the object
  // at the call site (see the scoping contract above).
  int Fire(int site, uint64_t key = 0) {
    SiteState& st = sites_[site];
    uint32_t m = st.mode.load(std::memory_order_acquire);
    if (m == 0) return 0;
    uint64_t want = st.key.load(std::memory_order_relaxed);
    if (want != 0 && key != want) return 0;
    uint32_t prob = st.prob.load(std::memory_order_relaxed);
    if (prob) {
      // xorshift64*: one consumer per site, so relaxed load/store is
      // a deterministic sequence given the seed and hit order
      uint64_t x = st.prng.load(std::memory_order_relaxed);
      x ^= x >> 12;
      x ^= x << 25;
      x ^= x >> 27;
      st.prng.store(x, std::memory_order_relaxed);
      uint32_t draw =
          static_cast<uint32_t>((x * 0x2545F4914F6CDD1Dull) >> 32);
      if (draw >= prob) return 0;
    }
    int64_t rem = st.remaining.load(std::memory_order_relaxed);
    if (rem >= 0) {
      if (rem == 0) {
        st.mode.store(0, std::memory_order_release);  // spent: disarm
        return 0;
      }
      st.remaining.store(rem - 1, std::memory_order_relaxed);
    }
    st.fired.fetch_add(1, std::memory_order_relaxed);
    return static_cast<int>(m);
  }

  int64_t Param(int site) const {
    return sites_[site].param.load(std::memory_order_relaxed);
  }

  uint64_t FiredCount(int site) const {
    if (site < 0 || site >= kSiteCount) return 0;
    return sites_[site].fired.load(std::memory_order_relaxed);
  }

 private:
  SiteState sites_[kSiteCount];
};

}  // namespace fault
}  // namespace emqx_native
