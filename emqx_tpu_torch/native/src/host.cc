// Native connection host: an epoll event loop owning listener + client
// sockets, doing MQTT framing in C++ and exchanging complete frames with
// the Python protocol layer through a compact event-record stream —
// plus, since round 4, the QoS0/1 PUBLISH fast path: parse → match →
// fan-out entirely in C++ (SURVEY.md §7's "host side in C++" design,
// the emqx_connection.erl:403-440 → emqx_broker.erl:218-232 hot loop
// without a VM in the middle).
//
// Fast-path contract (enforced here, configured by the Python server):
//   - a connection only fast-paths after Python enables it post-CONNACK
//     (clean session, no mountpoint — broker/native_server.py);
//   - a PUBLISH only fast-paths when qos<=2, retain=0, topic is a plain
//     non-$ name, v5 property section is empty, AND Python has granted
//     this (conn, topic) a *permit* — the authz-cache analogue: the
//     first publish runs the full Python path (authorize, hooks, rules)
//     and the server grants the permit only if nothing slow listens;
//   - the match set comes from a mirror of the broker tables
//     (router.h); any matched *punt marker* (shared sub, persistent
//     session, non-native subscriber, subscription id) forwards the
//     frame to Python verbatim — native fan-out only runs when it is
//     provably complete;
//   - native QoS1/2 deliveries allocate packet ids in [32768, 65535];
//     Python sessions stay in [1, 32767] (session/session.py), so a
//     subscriber's PUBACK/PUBREC/PUBCOMP routes unambiguously: high
//     pids are consumed here, low pids forwarded to the Python session;
//   - publisher-side QoS2 exactly-once keys on the *awaiting-rel*
//     bitmap (emqx_session.erl:379-399): the native plane owns a
//     client packet id iff the id is in ITS awaiting-rel set, so a
//     PUBREL routes to whichever plane accepted the PUBLISH and the
//     two planes can never double-publish one id;
//   - window accounting (pid allocation, inflight insert/ack-erase,
//     window-full → pending-queue overflow) lives entirely here; the
//     Python sessions see ONE batched ack record per poll cycle
//     (kind 7, mirroring the rule-tap batching) instead of
//     per-message round trips.
//
// This is the TPU-era answer to the BEAM's role in the reference
// (SURVEY.md §2.4 "[NATIVE] BEAM VM schedulers/ports"): the reference
// relies on the VM's C-level {active,N} socket polling + per-process
// mailboxes (emqx_connection.erl:132); here a C++ epoll loop performs
// accept/read/frame/match/fan-out/write and batches the remaining
// frames up to the driver, which runs the channel FSM and the device
// router.
//
// Threading contract:
//   - exactly ONE thread calls emqx_host_poll (it runs the event loop);
//   - emqx_host_send / emqx_host_close_conn / the fast-path control
//     calls (sub_add/sub_del/permit/enable_fast/...) are thread-safe
//     and may be called from any thread (they enqueue + wake the
//     poller via eventfd; the loop applies them in ApplyPending, so
//     table mutations are serialized with matching);
//   - emqx_host_destroy only after the polling thread has stopped.
//
// Event record wire format (host -> Python), little-endian:
//   u8 kind | u64 conn_id | u32 len | payload[len]
//   kind 1 = OPEN   payload = "ip:port" of the peer ("ws:ip:port" for
//                   connections accepted on the WebSocket listener)
//   kind 2 = FRAME  payload = one complete MQTT frame (verbatim bytes)
//   kind 3 = CLOSED payload = reason string
//   kind 4 = LANE   conn_id = lane seq, payload = topic (device match)
//   kind 6 = TAP    payload = batched rule-tap records, one entry per
//                   tapped publish: [u64 publisher][u8 flags][u16 tlen]
//                   [topic] + (flags bit0 ? [u32 plen][payload] :
//                   payload identical to the PREVIOUS entry in this
//                   batch); flags bits 1-2 = qos, bit 3 = publisher
//                   DUP. Pre-parsed and
//                   payload-deduped so the Python rule worker never
//                   re-parses MQTT (the old full-frame copies were the
//                   rule-tap tax: BENCH_r05 rule_tap_vs_free=0.59)
//   kind 7 = ACKS   payload = one batched ack/window record per poll
//                   cycle: [u32 n] + n x ([u64 conn][u32 acked]
//                   [u32 rel][u32 inflight_now][u32 pending_now])
//   kind 9 = TRUNK  cluster-trunk plane events (trunk.h, round 9):
//                   payload[0] = sub-kind:
//                   [u8 1] link UP    conn_id = peer id (replay done)
//                   [u8 2] link DOWN  conn_id = peer id, rest = reason
//                   [u8 3] receiver-side punts: trunk entries whose
//                     local match set contains punt markers (or shared
//                     groups) — Python runs the local dispatch for
//                     them; entries in the pre-parse layout
//                     ([u64 origin][u8 flags][u16 tlen][topic] +
//                     (flags bit4 ? [u64 trace_id]) + [u32 plen]
//                     [payload]) with payloads always inline
//                     (conn_id = 0)
//   kind 10 = DURABLE  payload = one batched durable-store record per
//                   flush (round 10): [u64 base_guid][u64 ts_ms][u32 n]
//                   + n x pre-parsed entries ([u64 origin][u8 flags]
//                   [u16 ntok][u64 token x ntok][u16 tlen][topic] +
//                   (flags bit4 ? [u64 trace_id]) +
//                   (flags bit5 ? [u8 cidlen][origin clientid]) +
//                   (flags bit0 ? [u32 plen][payload] : payload of the
//                   PREVIOUS entry)) — the EXACT bytes appended to the
//                   store (store.h kRecMsgBatch body), so the store
//                   write and the Python marker-reconciliation event
//                   are one buffer. Flushed BEFORE any socket write of
//                   the same read batch: a qos1 publisher's PUBACK is
//                   only wired after its durable append (+fsync per
//                   policy) landed.
//   kind 11 = HANDOFF  live plane demotion (kDisableFast): the conn's
//                   AckState hands to the Python session instead of
//                   evaporating. conn_id = conn; payload[0] = sub-kind:
//                   [u8 1] window state: [u32 n_aw] + n x [u16 pid]
//                     (publisher awaiting-rel ids we owned) +
//                     [u32 n_if] + n x ([u16 pid][u8 state]) state
//                     bit0 = qos2, bit1 = rel phase (PUBREL sent,
//                     awaiting PUBCOMP); chunked at the tap bound,
//                     fields additive across chunks
//                   [u8 2] pending frames (the window-full mqueue):
//                     [u32 n] + n x ([u32 len][serialized PUBLISH,
//                     pid bytes zero]) — Python re-enqueues them into
//                     the session mqueue (retransmit-on-reconnect)
//   kind 8 = TELEMETRY  payload = concatenated sub-records, chunked at
//                   the tap bound like kinds 6/7:
//                   [u8 1] histogram delta: [u8 stage][u64 count_d]
//                     [u64 sum_d][u16 n] + n x ([u8 bucket][u32 delta])
//                     — deltas vs the last emission (flushed on a
//                     ~100ms cadence, not every cycle: the per-cycle
//                     record + Python decode taxed the blast path);
//                     summing every delta reproduces the totals exactly
//                   [u8 2] flight-recorder dump: [u64 conn][u8 reason]
//                     [u8 n] + n x 16B entries ([u32 ts_ms][u8 event]
//                     [u8 ptype][u16 arg][u32 topic_hash][u32 arg2]),
//                     oldest first; emitted on abnormal close, protocol
//                     error, or trace attach (reason 1/2/3)
//                   [u8 3] slow-ack sample: [u64 conn][u32 rtt_us]
//                     [u8 qos][u16 tlen][topic] — a sampled native
//                     QoS1/2 delivery whose ack RTT crossed the
//                     slow-ack threshold (feeds services/slow_subs.py)
//   kind 12 = TRACE  native distributed-tracing plane (round 13):
//                   payload = concatenated sub-records, chunked at the
//                   tap bound (sub-records never split); the record id
//                   slot carries the PRODUCING SHARD like kinds 7/8/10:
//                   [u8 1] span: [u64 trace_id][u8 stage][u64 t_ns]
//                     [u64 aux] — one point on a sampled publish's
//                     timeline. stage indexes the SpanStage enum
//                     (native/__init__.py SPAN_STAGES); t_ns is
//                     CLOCK_MONOTONIC; aux is stage-specific (ingress =
//                     publisher conn, route = match-set size,
//                     ring_cross = source shard, trunk_flush = peer id,
//                     store_append = durable-token count, deliver_write
//                     = subscriber conn, ack = subscriber conn with the
//                     delivery qos in bits 60-61, replay = guid).
//                   [u8 2] ledger: [u64 count][u64 trace_id][u64 aux]
//                     [u64 t_ns] preceded by [u8 reason] — ONE entry
//                     per degradation reason per poll cycle: count
//                     folds every ladder decision of that cycle
//                     (ring-full→punt, trunk→punt, kHighWater shed),
//                     trace_id is the last sampled publish that hit it
//                     (0 = none sampled), aux the last deciding
//                     peer/shard/conn. Reasons index the LedgerReason
//                     enum (native/__init__.py LEDGER_REASONS prefix).
//   kind 13 = COAP  one CoAP exchange degraded WHOLE to the Python
//                   oracle (round 19): conn_id = the CoAP conn, payload
//                   = the raw datagram verbatim (no fields — the
//                   gateway/coap.py oracle channel parses it itself and
//                   answers through emqx_host_coap_send). Punted for
//                   block-wise transfers, props-carrying retained
//                   reads, and non-/ps paths (the LwM2M seam) — never
//                   a partial exchange.
//
// WebSocket (round 7): a second listener serves MQTT-over-WebSocket
// (RFC6455, ws.h) on the SAME data plane: the upgrade handshake and
// frame codec run below the GIL, decoded payload bytes feed the same
// Framer/TryFast/ack machinery as TCP, and egress wraps each
// serialized span in one binary frame. The asyncio WS server
// (broker/ws.py) stays as the slow-plane oracle.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "coap.h"
#include "fault.h"
#include "frame.h"
#include "park.h"
#include "ring.h"
#include "router.h"
#include "sn.h"
#include "store.h"
#include "trunk.h"
#include "wheel.h"
#include "ws.h"

namespace emqx_native {
namespace {

constexpr size_t kReadChunk = 64 * 1024;
// Per-connection outbound backlog above which fast-path deliveries to
// that subscriber are dropped instead of buffered — the mqueue-full
// drop policy (emqx_mqueue.erl default max_len) applied at the socket.
constexpr size_t kHighWater = 4 * 1024 * 1024;
// Native QoS1 packet ids live in [kNativePidBase, 0xFFFF]; Python
// sessions allocate [1, kNativePidBase-1].
constexpr uint16_t kNativePidBase = 32768;

inline uint64_t NowMs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC_COARSE, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

// Telemetry timestamps need sub-ms resolution (the stages under
// measurement are microseconds); the vDSO CLOCK_MONOTONIC read is
// ~20ns, so every per-message call site is SAMPLED (1-in-8) rather
// than unconditional — see the < 2% overhead budget in bench.py's
// observe_overhead section.
inline uint64_t NowNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

// ---------------------------------------------------------------------------
// Native telemetry plane (round 8): HDR-histogram-style log-bucketed
// latency capture + a per-connection flight recorder, exported as ONE
// batched kind-8 record per poll cycle (the kind-6/7 discipline).
// Everything here is poll-thread-owned plain memory: no locks, no
// atomics, no allocation on the record path.

// Histogram stage order (keep in sync with native/__init__.py
// HIST_STAGES — tests/test_stats_lint.py guards the stat slots; the
// stage list rides the same convention).
enum HistStage {
  kHistIngressRoute = 0,  // sampled: PUBLISH parse -> native fan-out done
  kHistRouteFlush,        // sampled: fan-out done -> socket flush done
  kHistQos1Rtt,           // sampled: qos1 delivery write -> PUBACK
  kHistQos2Rtt,           // sampled: qos2 delivery write -> PUBCOMP
  kHistLaneDwell,         // every lane dequeue: enqueue -> deliver/punt
  kHistGilStint,          // every poll: Poll() return -> next Poll() entry
  kHistWsIngest,          // sampled: WS decode+dispatch per read chunk
  kHistTrunkRtt,          // trunk batch flush -> peer ack (cross-node RTT)
  kHistTrunkBatchN,       // trunk batch occupancy: ENTRIES per flushed
                          // batch (a count, not ns — the one stage whose
                          // axis is not time; bench prints it raw)
  kHistStoreAppend,       // durable store: batch append (+policy fsync)
  kHistReplayDrain,       // resume replay: store fetch+consume+decode
                          // (stamped by Python via emqx_host_note_stage;
                          // poll-thread-only like conn_idle_ms)
  kHistSnIngest,          // sampled: SN datagram decode+dispatch
  kHistRetainDeliver,     // retained snapshot: match+encode+write per
                          // SUBSCRIBE-triggered delivery op
  kHistShardRingN,        // cross-shard ring occupancy: ENTRIES per
                          // applied ring batch (count-valued, the
                          // trunk_batch_n convention)
  kHistCoapIngest,        // sampled: CoAP datagram decode+dispatch
  kHistObserveNotify,     // sampled: observe notify resolve+encode+write
  kHistCount
};

// 64 log-bucketed (~power-of-√2) slots covering [0, ~4.3s): bucket 0
// holds [0,2)ns; a value with MSB position e >= 1 lands at 2e-1 (below
// √2·2^e, approximated as 1448/1024 fixed-point) or 2e; everything
// >= 2^32 ns clamps into bucket 63. Mirrored exactly by
// observe/metrics.py HIST_EDGES_NS / hist_bucket (differential test).
inline int HistBucket(uint64_t ns) {
  if (ns < 2) return 0;
  int e = 63 - __builtin_clzll(ns);
  if (e >= 32) return 63;
  return 2 * e - 1 + ((ns << 10) >= (1448ull << e) ? 1 : 0);
}

struct Hist {
  uint64_t b[64] = {};
  uint64_t cnt = 0;
  uint64_t sum = 0;
};

// Flight-recorder event codes (keep in sync with native/__init__.py
// FR_EVENT_NAMES).
enum FrEvent : uint8_t {
  kFrOpen = 1,   // accepted; arg = 1 for WS conns
  kFrFrame,      // slow-plane inbound frame; ptype, arg = len lo16
  kFrPunt,       // fast-eligible frame forwarded to Python anyway
  kFrFastPub,    // PUBLISH consumed natively; hash = topic hash
  kFrDeliver,    // fast-path delivery written; hash = topic hash
  kFrDrop,       // delivery dropped (backpressure / mqueue overflow)
  kFrAck,        // subscriber ack consumed natively; arg = pid
  // round 13: the recorder used to go blind the moment a publish left
  // its shard — these note the cross-plane legs on the PUBLISHER's
  // recorder so an operator's FR dump shows where the message went
  kFrRingCross,  // publish shipped to other shards; arg = shard count
  kFrTrunk,      // publish enqueued onto a trunk; arg = first peer id
};

// Dump reasons (kind-8 sub-record 2 header).
enum FrReason : uint8_t {
  kFrReasonClose = 1,  // abnormal close (sock_error, oversized, ...)
  kFrReasonError = 2,  // protocol error (frame_error, ws_error, ...)
  kFrReasonTrace = 3,  // trace attach / traced conn teardown
};

struct FrEntry {
  uint32_t ts_ms;  // NowMs() truncated — deltas are what matter
  uint8_t event;   // FrEvent
  uint8_t ptype;   // MQTT packet type where applicable
  uint16_t arg;    // event-specific (frame len, pid, reason)
  uint32_t hash;   // FNV-1a topic hash (0 when n/a)
  uint32_t arg2;
};
static_assert(sizeof(FrEntry) == 16, "kind-8 wire format");

constexpr uint8_t kFrCap = 16;  // entries per conn (256B, lazily alloc'd)

struct FlightRec {
  FrEntry e[kFrCap];
  uint8_t head = 0;  // next overwrite slot
  uint8_t n = 0;     // live entries (<= kFrCap)
};

inline uint32_t TopicHash(std::string_view t) {
  uint32_t h = 2166136261u;  // FNV-1a: cheap, stable across planes
  for (char c : t) {
    h ^= static_cast<uint8_t>(c);
    h *= 16777619u;
  }
  return h;
}

// Per-conn cap on concurrently-tracked ack-RTT samples: delivery
// stamps are taken only while a slot is free, so the steady-state cost
// is a tiny vector scan and the per-sample topic copy is bounded.
constexpr size_t kRttSamples = 4;

struct RttSample {
  uint64_t t0_ns;
  std::string topic;
  uint16_t pid;
  uint8_t qos;
  uint64_t trace = 0;  // sampled trace id: PUBACK closes the ack span
};

// ---------------------------------------------------------------------------
// Native distributed tracing (round 13): a deterministic 1-in-N
// publish sampler tags fast-path publishes with a 64-bit trace id that
// propagates through every native seam (cross-shard ring entries,
// trunk BATCH records on wire-v1 links, durable MSG-BATCH records)
// while the message stays on the fast path; each plane emits compact
// kind-12 span events a Python collector stitches into per-message
// timelines. Everything below is poll-thread-owned plain memory — the
// telemetry-plane discipline.

// Span stages (keep in sync with native/__init__.py SPAN_STAGES —
// tests/test_stats_lint.py parses this enum). kSpanReplay is emitted
// by PYTHON (the resume drain reads the persisted id back from the
// store), so it has no C++ emission site.
enum SpanStage : uint8_t {
  kSpanIngress = 0,   // sampled publish accepted natively; aux = conn
  kSpanRoute,         // native fan-out complete; aux = match-set size
  kSpanRingCross,     // consumer shard applied the ring entry; aux = src
  kSpanTrunkFlush,    // entry enqueued onto a trunk batch; aux = peer
  kSpanTrunkRecv,     // receiver fanned the trunk entry out natively
  kSpanStoreAppend,   // publish joined the durable batch; aux = n toks
  kSpanReplay,        // Python: resume replay re-joined the trace
  kSpanDeliverWrite,  // delivery written to a subscriber; aux = conn
                      // (bit 63 = truncation marker: the 8-per-publish
                      // cap clipped this fan-out — timeline is partial)
  kSpanAck,           // subscriber PUBACK/PUBCOMP closed the delivery
  kSpanCount
};

// Degradation-ledger reasons (a PREFIX of native/__init__.py
// LEDGER_REASONS — device_failover and store_degraded are Python-plane
// decisions folded into the same ledger there).
enum LedgerReason : uint8_t {
  kLrRingFull = 1,   // cross-shard ring full: publish degraded to punt
  kLrTrunkPunt,      // trunk down/ineligible: publish degraded to punt
  kLrShed,           // kHighWater backpressure shed (conn or trunk)
  kLrFault,          // faultline injection fired (aux = the fault site)
  kLrAcceptShed,     // accept-storm shed: admission denied before any
                     // conn side effect (round 16, aux = conn count)
  kLrCoapGiveup,     // CoAP CON-notify retransmit exhaustion: the
                     // unresponsive observer is dropped (RFC 7641
                     // §4.5; aux = the conn id)
  kLrCount
};

// deliver_write spans per sampled publish are capped: a megafan-out
// must not turn one sampled message into a span flood. When the cap
// clips a wide fan-out, ONE extra deliver_write span goes out with
// aux bit 63 set (the truncation bit — conn-id namespaces stop at bit
// 62) so a stitched timeline reads "first 8 of more", never silently
// as the full audience (round 17).
constexpr uint8_t kTraceMaxDeliverSpans = 8;
constexpr uint64_t kSpanTruncBit = 1ull << 63;
// Sampled publishes per POLL CYCLE are capped too (the tick still
// advances, so the 1-in-N ratio stays deterministic; the cap only
// clips extra picks within one cycle). Under blast a cycle drains
// thousands of publishes — 1-in-64 of 1M msg/s would be ~15k traces/s,
// and the Python-side span fold runs on the poll thread's GIL stints,
// which is exactly the plane-stall the telemetry rounds fought.
// Interactive traffic (a cycle per publish) never hits the cap.
constexpr uint32_t kTraceMaxPerCycle = 2;

// elevated-qos mqueue bound per subscriber (emqx_mqueue default
// max_len 1000); overflow drops the NEW message (kStDropsInflight)
constexpr size_t kMaxPending = 1000;
// publisher-side qos2 awaiting-rel cap: past it, NEW packet ids take
// the Python path, whose session enforces max_awaiting_rel quota
// semantics (emqx_session.erl:379-399)
constexpr uint32_t kMaxAwaitingRel = 8192;

inline bool BitTest(const uint64_t* b, uint32_t i) {
  return (b[i >> 6] >> (i & 63)) & 1;
}
inline void BitSet(uint64_t* b, uint32_t i) { b[i >> 6] |= 1ull << (i & 63); }
inline void BitClr(uint64_t* b, uint32_t i) {
  b[i >> 6] &= ~(1ull << (i & 63));
}

// Per-connection elevated-qos window state, allocated lazily on the
// first QoS1/2 interaction so a million idle / qos0-only connections
// pay nothing. Bitmaps replace the round-4 unordered_set bookkeeping:
// pid allocation and ack-erase are test-and-set bit ops, the profiled
// hash/alloc churn on the windowed QoS1 path (BENCH_r05's 641k cap).
struct AckState {
  // broker-allocated delivery pids, bit i = pid kNativePidBase + i;
  // a qos2 delivery holds its bit across the whole
  // PUBREC/PUBREL/PUBCOMP tail (no separate phase bitmap: nothing
  // natively retries mid-exchange, so the slot hold IS the state)
  uint64_t inflight[512] = {};   // allocated, awaiting PUBACK/PUBCOMP
  uint32_t inflight_cnt = 0;
  uint16_t next_pid = kNativePidBase;
  // publisher-side qos2 exactly-once: client pid space, bit = pid
  uint64_t awaiting_rel[1024] = {};
  uint32_t awaiting_cnt = 0;
  // deliveries awaiting an inflight slot — the mqueue analogue
  // (emqx_mqueue.erl): serialized PUBLISH (qos header already final)
  // with zeroed pid bytes + the pid offset to patch at dequeue
  std::deque<std::pair<std::string, size_t>> pending;
  // per-delivery phase bits for the demotion handoff (round 10): a
  // bare inflight bitmap cannot say qos1-vs-qos2 or publish-vs-rel
  // phase, and the Python session needs both to adopt the window.
  // Bit ops only — the round-6 no-hash-churn discipline holds.
  uint64_t infl_qos2[512] = {};  // bit set = the delivery was qos2
  uint64_t infl_rel[512] = {};   // bit set = PUBREL sent (await PUBCOMP)
  // per-poll-cycle ack-record accumulators (flushed as ONE kind-7
  // event per cycle — the rule-tap batching discipline applied to the
  // ack plane)
  uint32_t cyc_acked = 0;   // delivery slots freed (PUBACK + PUBCOMP)
  uint32_t cyc_rel = 0;     // publisher PUBREL exchanges completed
  bool cyc_dirty = false;   // queued on ack_dirty_ this cycle
  // sampled ack-RTT stamps (delivery write -> PUBACK/PUBCOMP); a
  // delivery only stamps while a slot is free, so this never grows
  std::vector<RttSample> rtt;
};

// Per-connection WebSocket transport state, allocated only for conns
// accepted on the WS listener — plain TCP conns pay nothing.
struct WsConnState {
  bool open = false;        // 101 sent; frames flow
  std::string hs_buf;       // HTTP upgrade request accumulation
  ws::WsDecoder dec{/*require_mask=*/true};  // clients MUST mask (§5.3)
};

// One tracked qos1 SN delivery awaiting its SN PUBACK: a full datagram
// copy (resent with DUP set on timeout) + the flags-byte offset to
// patch. The inflight BITMAP stays the authority — this is only the
// bytes needed to retransmit, retired by the same PUBACK that clears
// the bit.
struct SnInflightRx {
  uint16_t pid;
  std::string dgram;
  size_t flags_off;
  uint64_t last_tx_ms;
  uint8_t tries;
};

// Per-connection MQTT-SN transport state (round 11), allocated only
// for datagram peers on the SN listener — TCP/WS conns pay nothing.
// The conn has no socket of its own: egress rides sendto() on the
// shared UDP fd, keyed by `addr`.
struct SnConnState {
  sockaddr_in addr{};
  uint64_t conn_id = 0;     // this conn's id (for egress-side drains)
  bool anon = false;        // the shared QoS -1 publisher (no egress)
  bool connect_sent = false;  // MQTT CONNECT forwarded to Python
  bool connected = false;     // CONNACK rc=0 observed on egress
  bool connack_seen = false;  // any CONNACK observed (accept or reject)
  // messages pipelined into the CONNECT->CONNACK round trip; the
  // oracle connects synchronously so these must succeed, not bounce
  std::deque<sn::SnMsg> preconn;
  std::string clientid;
  bool awake = true;          // sleep mode (§6.14): deliveries park
  uint64_t sleep_until_ms = 0;  // announced wake deadline (keepalive)
  // per-client NORMAL topic-id registry (emqx_sn_registry.erl); the
  // predefined table is gateway-wide and lives on the Host
  std::unordered_map<uint16_t, std::string> topic_of_id;
  std::unordered_map<std::string, uint16_t> id_of_topic;
  uint16_t next_tid = 0;
  uint16_t next_mid = 0;
  // egress-translation context: MQTT msg-id -> the SN fields the SN
  // reply needs but the MQTT packet no longer carries
  std::unordered_map<uint16_t, uint16_t> pub_tid;   // PUBACK topic id
  std::unordered_map<uint16_t, uint32_t> sub_tid;   // (flags<<16)|tid
  // Python-plane egress bytes are an MQTT byte stream; this framer
  // splits them so each packet translates to one SN datagram
  Framer egress{1 << 20};
  std::deque<std::string> sleep_buf;   // parked datagrams, drop-oldest
  std::vector<SnInflightRx> rexmit;    // qos1 deliveries awaiting ack
  // qos1 retransmit wheel handle (round 16): the per-poll
  // SnRexmitScan sweep moved onto the timer wheel — armed when the
  // first rexmit copy is tracked, parked across announced sleep (the
  // retry clock restarts at wake), re-armed from the fire at the
  // conn's next retry deadline; @gen-handle
  uint64_t tm_rexmit = 0;
};

// -- native CoAP gateway state (round 19) -----------------------------------

// Inbound MID dedup entry (RFC 7252 §4.5, the oracle's parity-audited
// TransportManager window): a byte-identical retransmission replays
// the cached response instead of re-executing the request; a DIFFERENT
// token under the same mid is a recycled mid (the client's 16-bit
// counter wrapped inside the lifetime) and evicts the entry.
struct CoapSeen {
  std::string token;
  std::string response;  // "" = response still in flight: dup drops
  uint64_t expire_ms;
};

// One outstanding CON notify awaiting its ACK: resent VERBATIM on the
// RFC 7252 exponential backoff (ACK_TIMEOUT x 1.5, doubling — CoAP has
// no DUP bit; a retransmission is the same bytes), retired by the ACK
// (which also frees the MQTT window slot via a synthesized PUBACK),
// cancelled together with its observation by RST or exhaustion.
struct CoapConRx {
  uint16_t mid;         // CoAP message id (the wire key)
  uint16_t pid;         // MQTT delivery pid (0 = none to settle)
  std::string dgram;    // bare message bytes (no outbuf length prefix)
  std::string filter;   // owning observation (the RST/give-up cancel)
  uint64_t next_ms;     // retransmit deadline
  uint64_t timeout_ms;  // current backoff span (doubles per try)
  uint8_t tries;
};

// One observation (RFC 7641): GET+Observe registered this token on a
// /ps topic; notifications carry the token and the observation's OWN
// rolling 24-bit sequence (the oracle's per-observer counter).
struct CoapObserver {
  std::string filter;
  std::string token;
  uint8_t qos;    // subscription qos: >= 1 notifies as tracked CON
  uint32_t seq;   // 24-bit rolling observe sequence (starts at 1)
};

// Per-connection CoAP transport state, allocated only for datagram
// peers on the CoAP listener — TCP/WS/SN conns pay nothing. Like SN,
// the conn has no socket of its own: egress rides sendmmsg on the
// shared UDP fd keyed by `addr`, and MQTT translation gives the peer a
// real Python channel/session (auth, CM takeover, hooks) on demand.
struct CoapConnState {
  sockaddr_in addr{};
  uint64_t conn_id = 0;
  bool connect_sent = false;   // MQTT CONNECT forwarded to Python
  bool connected = false;      // CONNACK rc=0 observed on egress
  bool connack_seen = false;   // any CONNACK observed (accept or reject)
  bool oracle_used = false;    // ever punted to the Python oracle: an
                               // ACK/RST for an unknown mid routes there
  std::string clientid;        // registered identity (query ?clientid=)
  // requests pipelined into the CONNECT->CONNACK round trip (the
  // oracle registers synchronously, so these must be served, not
  // bounced); parked PARSED — the codec re-serializes byte-exactly
  std::deque<coap::CoapMsg> preconn;
  uint16_t next_mid = 0;       // notify mid allocator (oracle _next_mid)
  uint16_t next_mqtt_mid = 0;  // translated PUBLISH/SUBSCRIBE mid space
  std::unordered_map<uint16_t, CoapSeen> seen;  // inbound MID dedup
  // insertion-order companion for O(1) over-bound eviction: a
  // sustained blast must not pay an O(kCoapSeenMax) sweep per message
  // (may hold mids whose entry was already evicted/recycled — the
  // evictor just skips those)
  std::deque<uint16_t> seen_fifo;
  // MQTT mid -> the CoAP exchange whose response awaits that ack
  struct PendingPub { uint16_t mid; std::string token; bool con; };
  struct PendingSub { uint16_t mid; std::string token; std::string topic;
                      uint8_t qos; bool con; };
  std::unordered_map<uint16_t, PendingPub> pending_pub;
  std::unordered_map<uint16_t, PendingSub> pending_sub;
  std::vector<CoapObserver> observers;
  std::vector<CoapConRx> rexmit;     // CON notifies awaiting ACK
  // recent notify mid -> observing filter: RST cancels the observation
  // for ANY notify type (RFC 7641 §3.6); bounded, never evicting a mid
  // still awaiting its ACK (the oracle's _con_topic discipline)
  std::unordered_map<uint16_t, std::string> notify_obs;
  // Python-plane egress bytes are an MQTT byte stream; this framer
  // splits them so each packet translates to one CoAP message
  Framer egress{1 << 20};
  // CON retransmit wheel handle — armed when the first tracked notify
  // lands, re-armed from the fire at the conn's next backoff deadline
  // (named apart from SnConnState::tm_rexmit so each annotation stays
  // independently load-bearing); @gen-handle
  uint64_t tm_notify = 0;
};

struct Conn {
  int fd = -1;
  Framer framer;
  std::string outbuf;   // unsent bytes (partial-write backlog)
  size_t outpos = 0;
  bool want_close = false;  // close once outbuf drains
  std::unique_ptr<WsConnState> ws;  // non-null = WebSocket transport
  std::unique_ptr<SnConnState> sn;  // non-null = MQTT-SN datagram conn
  std::unique_ptr<CoapConnState> coap;  // non-null = CoAP datagram conn
  // -- fast path ----------------------------------------------------------
  bool fast = false;        // Python enabled the PUBLISH fast path
  uint8_t proto_ver = 4;    // 4 = MQTT 3.1.1, 5 = MQTT 5
  uint32_t max_inflight = 16384;
  bool dirty = false;       // has appended-but-unflushed outbuf bytes
  bool traced = false;      // TraceManager attached: PUBLISHes punt to
                            // Python so the hook fold sees them; the
                            // flight-recorder tail rides the trace log
  uint64_t last_rx_ms = 0;  // any inbound bytes (keepalive feed)
  // -- conn-scale plane (round 16) ----------------------------------------
  // last non-PINGREQ frame: the park-after clock. Keepalive pings are
  // traffic (last_rx_ms) but not WORK — an idle-but-pinging device
  // must still hibernate, and parked pings answer from the parked
  // record without inflation.
  uint64_t last_work_ms = 0;
  uint32_t keepalive_ms = 0;    // effective deadline (1.5x keepalive);
                                // 0 = no native keepalive enforcement
  uint64_t tm_keepalive = 0;    // wheel handles (0 = unarmed; the
                                // park.h twin carries the annotation)
  uint64_t tm_park = 0;         // @gen-handle
  std::unique_ptr<FlightRec> fr;             // telemetry flight recorder
  std::unique_ptr<AckState> ack;             // elevated-qos window state
  std::unordered_set<std::string> permits;   // publisher-side topic grants
  std::vector<std::string> own_subs;         // filters owned by this conn
  // (group token, filter) shared memberships owned by this conn
  std::vector<std::pair<uint64_t, std::string>> own_shared;
};

// Device-lane bounds: past the soft cap, NEW topics take the C++ walk
// (correct, just not device-matched); topics with entries already in
// flight stay on the lane regardless, preserving per-topic order. An
// entry older than the stale deadline means the pump wedged — the lane
// drains to Python in order and disables itself.
constexpr size_t kLaneSoftMax = 65536;
constexpr uint64_t kLaneStaleMs = 3000;
// One topic flooding faster than the pump drains cannot walk (its
// parked predecessors would be overtaken) — past this bound the NEW
// frame is dropped like any backpressured qos0 delivery (the mqueue-
// overflow analogue; an unacked qos1 publish is retried by the client)
constexpr uint32_t kLaneTopicMax = 8192;
// Tap batch record flush threshold — well under the Python-side poll
// buffer (max_packet_size + 64), since an oversized record is dropped.
constexpr size_t kTapFlushBytes = 192 * 1024;

// -- cluster trunk bounds (round 9) -----------------------------------------
// Remote-entry owners live far above conn ids AND the Python punt-token
// space (1 << 48): owner = kTrunkOwnerBase + peer id.
constexpr uint64_t kTrunkOwnerBase = 1ull << 62;
// Durable-entry owners (round 10) get their own namespace too: store
// tokens are small sequential ints EXACTLY like conn ids, and SubTable
// upserts key on (owner, filter) — an un-namespaced token N would
// collide with conn N's real entry on the same filter (the real entry
// would overwrite the durable one, silently un-persisting the session).
constexpr uint64_t kDurableOwnerBase = 1ull << 61;
// Trunk sock epoll tags carry this bit (conn ids are sequential small
// ints; the three listener tags sit at ~0ull and below).
constexpr uint64_t kTrunkSockBit = 1ull << 63;
// Unacked-batch replay ring bound per peer: past it NEW qos1 publishes
// with that remote audience degrade to the Python forward lane (the
// ring itself may overshoot by the in-flight cycle — a soft bound).
constexpr size_t kTrunkUnackedMax = 512;
// HELLO-answer grace (round 14): a fresh link's qos1 replay + UP event
// wait for the negotiated wire version so a replayed batch keeps its
// trace annotation on v1 links; an old peer never answers, so the
// deadline completes the link at v0 — one bounded delay per reconnect
// against old peers, one loopback RTT against current ones.
constexpr uint64_t kTrunkHelloGraceMs = 300;

// -- mqtt-sn gateway bounds (round 11) --------------------------------------
// Datagram conns get their own id range (the ISSUE's "own conn-id
// range"): below the durable-owner (1<<61) and trunk-owner (1<<62)
// namespaces, above any TCP/WS conn id the sequential counter could
// ever reach and above the Python punt-token space (1<<48).
constexpr uint64_t kSnConnBit = 1ull << 59;

// -- coap gateway bounds (round 19) -----------------------------------------
// CoAP datagram conns get their own id namespace too — but every bit
// ABOVE 59 is spoken for in contexts conn ids flow through (ring
// multi-target entries pack min_qos into bits 60-61 of the target word
// and mask conns to (1<<60)-1; durable/trunk owners sit at 61/62), so
// the CoAP discriminator composes bit 59 with bit 55, just below the
// shard field: sequential per-shard counters never approach 2^55, so
// SN ids (bit 55 clear) and CoAP ids can never collide.
constexpr uint64_t kCoapConnBit = (1ull << 59) | (1ull << 55);

// -- multi-core shard bounds (round 12) -------------------------------------
// The owner-namespace scheme extended to SHARDS: conn ids carry their
// shard index in bits 56-58 — above the Python punt-token space
// (tokens mint upward from 1<<48 and can never reach 1<<56), below the
// SN bit (59), so an SN conn on shard k composes as
// kSnConnBit | (k << kShardShift) | seq. Shard 0 ids are numerically
// identical to the unsharded scheme (back-compat by construction).
constexpr int kShardShift = 56;
constexpr uint64_t kShardMask = 7;  // up to ring::kMaxShards shards

inline int ShardOf(uint64_t conn_id) {
  return static_cast<int>((conn_id >> kShardShift) & kShardMask);
}

// Membership append for ONE publish's tiny scratch vectors (trunk
// peers, destination shards): linear scan beats any set at these sizes.
template <typename T>
inline void PushUnique(std::vector<T>* v, T x) {
  for (T e : *v)
    if (e == x) return;
  v->push_back(x);
}
// qos1 delivery retransmit-on-timeout (UDP loses datagrams; TCP conns
// never need this — the transport retransmits): resend with DUP after
// kSnRetryMs, abandon the delivery (freeing its inflight slot like a
// PUBACK would) after kSnMaxRetries attempts.
constexpr uint64_t kSnRetryMs = 1000;
constexpr uint8_t kSnMaxRetries = 3;

// -- conn-scale plane bounds (round 16) --------------------------------------
// Timer kinds on the per-shard wheel (wheel.h): the key is a conn id
// for keepalive/park/rexmit and a trunk peer id for the ack watchdog.
enum TimerKind : uint8_t {
  kTmKeepalive = 1,  // keepalive deadline (lazy-reprogrammed on fire)
  kTmPark,           // park-after check (hibernate idle conns)
  kTmSnRexmit,       // SN qos1 retransmit deadline (per conn)
  kTmTrunkAck,       // trunk silent-link watchdog (per peer)
  kTmCoapRexmit,     // CoAP CON-notify retransmit deadline (per conn)
};
// Default park-after when no keepalive is known (a conn with a
// keepalive parks after 2x its grace deadline = 3x keepalive).
constexpr uint64_t kParkAfterDefaultMs = 30000;
// Resident-conn memory estimate for the accept governor's budget: the
// struct + map node + framer/outbuf/permit steady-state heap. The
// bench measures the real number (RSS/conn); this constant only needs
// the right ORDER for the shed decision.
constexpr uint64_t kConnResidentEstBytes = 1024;

// Fast-path control ops enqueued from Python threads, applied on the
// poll thread (ApplyPending) so they serialize with matching.
struct Op {
  enum Kind : uint8_t {
    kSubAdd, kSubDel, kPermit, kEnableFast, kDisableFast, kPermitsFlush,
    kSharedAdd, kSharedDel, kSetLane, kLaneDeliver, kSetMaxQos,
    kSetInflightCap, kSetTrace, kSetTelemetry,
    kTrunkConnect, kTrunkDisconnect, kTrunkRouteAdd, kTrunkRouteDel,
    kTrunkIdent,
    kDurableAdd, kDurableDel,
    kSnPredef, kRetainSet, kRetainDel, kRetainDeliver, kSetTeleShift,
    kTrunkPeerState, kSetTracing, kSetTrunkWire, kSetTrunkAckTimeout,
    kSetKeepalive, kSetPark, kSynthConns,
    kCoapRetainState, kSetCoapAckTimeout, kCoapSend
  };
  Kind kind;
  uint64_t owner = 0;
  uint64_t token = 0;    // shared-group identity / retained deadline
  std::string str;       // filter / topic
  std::string str2;      // retained payload
  uint8_t qos = 0;
  uint8_t flags = 0;
  uint8_t proto_ver = 4;
  uint32_t max_inflight = 0;
};

// Stats slot order for emqx_host_stats (keep in sync with
// native/__init__.py STAT_NAMES — enforced by tests/test_stats_lint.py,
// which parses this enum and cross-checks names, order, and increment
// sites; slot kStFooBar must be named "foo_bar" on the Python side).
enum StatSlot {
  kStFastIn = 0,       // PUBLISHes fully handled in C++
  kStFastOut,          // PUBLISH deliveries written by the fast path
  kStFastBytesOut,
  kStPunts,            // fast-eligible frames forwarded to Python anyway
  kStDropsBackpressure,
  kStDropsInflight,
  kStNativeAcks,       // QoS1 PUBACKs consumed natively
  kStSharedDispatch,   // shared-group picks served natively
  kStSharedNoMember,   // shared groups with no deliverable member
  kStLaneIn,           // PUBLISHes queued to the device match lane
  kStLaneOut,          // lane messages delivered after a device response
  kStLanePunts,        // lane messages punted (punt filter / spill)
  kStLaneFallback,     // lane soft-cap hits served by the C++ walk
  kStLaneStale,        // stale-head lane shutdowns (pump wedge trips)
  kStTaps,             // rule-tap frame copies forwarded to Python
  kStQos1In,           // native qos1 PUBLISHes (subset of kStFastIn)
  kStQos2In,           // native qos2 PUBLISHes (subset of kStFastIn)
  kStQos2Rel,          // publisher PUBREL→PUBCOMP exchanges completed
  kStLaneTopicOverflow,  // per-topic lane flood drops (was silently
                         // folded into kStDropsBackpressure)
  kStAckBatches,       // batched ack records emitted to Python
  kStWsHandshakes,     // successful RFC6455 upgrades
  kStWsRejects,        // upgrade requests answered 400
  kStWsPings,          // client pings answered with pongs
  kStWsCloses,         // client-initiated close frames honoured
  kStPuntsTrace,       // PUBLISHes punted because the conn is traced
  kStFrDumps,          // flight-recorder dumps emitted (kind 8)
  kStTelemetryBatches,  // batched kind-8 telemetry records emitted
  kStTrunkOut,         // publishes forwarded onto a trunk link
  kStTrunkIn,          // trunk entries received and handled locally
  kStTrunkBatchesOut,  // trunk batch records flushed to peers
  kStTrunkBatchesIn,   // trunk batch records applied from peers
  kStTrunkPunts,       // received trunk entries handed to Python
  kStTrunkReplays,     // qos1 batches replayed after a reconnect
  kStTrunkShed,        // qos0 entries shed under trunk-link backpressure
  kStDurableIn,        // publishes persisted below the GIL (durable
                       // audience matched, fast path preserved)
  kStDurableBatches,   // kind-10 store/event records flushed
  kStStoreAppends,     // message entries appended to the durable store
  kStHandoffs,         // demotion handoffs emitted (kind 11)
  kStSnIn,             // SN PUBLISHes ingested over UDP (any qos >= 0)
  kStSnOut,            // SN PUBLISH deliveries encoded (sent or parked)
  kStSnQosM1,          // QoS -1 publish-without-connect datagrams
  kStSnPings,          // SN PINGREQs handled (wake + keepalive)
  kStSnRegisters,      // client REGISTERs answered with REGACK
  kStSnSleepParked,    // deliveries parked for a sleeping client
  kStSnDropsOversize,  // deliveries exceeding the SN u16 wire limit
  kStRetainSet,        // retained-snapshot entries installed/updated
  kStRetainDel,        // retained-snapshot entries removed
  kStRetainDeliver,    // SUBSCRIBE-triggered native retained lookups
  kStRetainMsgsOut,    // retained messages delivered below the GIL
  kStShardRingOut,     // deliveries shipped to another shard's ring
  kStShardRingIn,      // ring entries applied from other shards
  kStShardRingFull,    // publishes degraded ring-full -> punt -> Python
  kStTracedPubs,       // publishes tagged by the 1-in-N trace sampler
  kStSpanBatches,      // batched kind-12 trace records emitted
  kStFaultsInjected,   // faultline fires on this host (all sites)
  kStConnsParked,      // conns hibernated into parked records
  kStConnsInflated,    // parked conns re-inflated (first byte/delivery)
  kStConnsShed,        // accepts shed (memory budget / max_conns)
  kStParkedPings,      // PINGREQs answered from the parked record
  kStTrunkRingPersisted,  // trunk qos1 ring entries journaled into the
                          // durable store (round 18)
  kStTrunkRingRecovered,  // ring entries rebuilt from store segments
                          // after a restart/reattach
  kStCoapIn,              // CoAP /ps publishes ingested natively
  kStCoapNotifies,        // observe notifications encoded (CON or NON)
  kStCoapPings,           // CoAP pings (CON empty) answered with RST
  kStCoapDedupHits,       // retransmitted requests served from the MID
                          // dedup window (replay, or in-flight drop)
  kStCoapRexmits,         // CON notify retransmissions sent
  kStCoapGiveups,         // CON retransmit exhaustion: observer dropped
  kStCoapPunts,           // exchanges degraded WHOLE to the Python
                          // oracle (block-wise, props, non-/ps paths)
  kStCoapDropsOversize,   // deliveries exceeding the CoAP frame cap
  kStatCount
};

std::string EncodeRecord(uint8_t kind, uint64_t id, const char* data,
                         size_t len) {
  std::string rec;
  rec.reserve(13 + len);
  rec.push_back(static_cast<char>(kind));
  for (int i = 0; i < 8; i++)
    rec.push_back(static_cast<char>((id >> (8 * i)) & 0xFF));
  for (int i = 0; i < 4; i++)
    rec.push_back(static_cast<char>((len >> (8 * i)) & 0xFF));
  rec.append(data, len);
  return rec;
}

int SetNonBlocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  return flags < 0 ? -1 : fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

class Host {
 public:
  Host(uint32_t max_size, uint32_t max_conns)
      : max_size_(max_size), max_conns_(max_conns) {}

  ~Host() {
    // producers in other shards stop shipping to this shard's rings;
    // the doorbell fd stays open (group-owned) so racing doorbell
    // writes never hit a recycled fd
    if (group_)
      group_->alive[shard_id_].store(false, std::memory_order_release);
    for (auto& [id, c] : conns_)
      if (c.fd >= 0) close(c.fd);  // SN conns share the listener fd
    for (auto& [id, slot] : parked_) {
      int pfd = park_slab_.at(slot).fd;
      if (pfd >= 0) close(pfd);
    }
    for (auto& [tag, s] : trunk_socks_) close(s.fd);
    if (listen_fd_ >= 0) close(listen_fd_);
    if (listen_ws_fd_ >= 0) close(listen_ws_fd_);
    if (listen_trunk_fd_ >= 0) close(listen_trunk_fd_);
    if (sn_fd_ >= 0) close(sn_fd_);
    if (coap_fd_ >= 0) close(coap_fd_);
    if (wake_fd_ >= 0) close(wake_fd_);
    if (epoll_fd_ >= 0) close(epoll_fd_);
  }

  // @plane(control) — before the poll thread starts only
  bool Init(const char* bind_addr, uint16_t port, bool reuseport = false) {
    epoll_fd_ = epoll_create1(EPOLL_CLOEXEC);
    wake_fd_ = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    listen_fd_ = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (epoll_fd_ < 0 || wake_fd_ < 0 || listen_fd_ < 0) return false;
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    // SO_REUSEPORT accept sharding (round 12): every shard binds its
    // own listener on the SAME port and the kernel hash-distributes
    // incoming connections across them — no accept lock, no handoff
    if (reuseport)
      setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) return false;
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return false;
    if (listen(listen_fd_, 1024) < 0) return false;
    socklen_t alen = sizeof(addr);
    getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
    port_ = ntohs(addr.sin_port);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kListenTag;
    epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, listen_fd_, &ev);
    ev.events = EPOLLIN;
    ev.data.u64 = kWakeTag;
    epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, wake_fd_, &ev);
    return true;
  }

  int port() const { return port_; }
  int ws_port() const { return ws_port_; }
  int trunk_port() const { return trunk_port_; }

  // Open the WebSocket listener (call BEFORE the poll thread starts —
  // it mutates the epoll set from the caller's thread). Conns accepted
  // here run the RFC6455 handshake + frame codec in front of the MQTT
  // framer; `path` is the required upgrade request-target ("" accepts
  // any). Returns the bound port, or -1.
  // @plane(control)
  int ListenWs(const char* bind_addr, uint16_t port, const char* path,
               bool reuseport = false) {
    if (listen_ws_fd_ >= 0) return -1;  // one WS listener per host
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    if (reuseport)  // per-shard WS listeners on one port (round 12)
      setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1 ||
        bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        listen(fd, 1024) < 0) {
      close(fd);
      return -1;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kListenWsTag;
    if (epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev) < 0) {
      close(fd);
      return -1;
    }
    listen_ws_fd_ = fd;
    ws_port_ = ntohs(addr.sin_port);
    ws_path_ = path ? path : "";
    return ws_port_;
  }

  // Open the cluster-trunk listener (call BEFORE the poll thread
  // starts, like ListenWs — it mutates the epoll set from the caller's
  // thread). Peers' hosts dial this port to forward publishes below
  // the GIL. Returns the bound port, or -1.
  // @plane(control)
  int ListenTrunk(const char* bind_addr, uint16_t port,
                  bool reuseport = false) {
    if (listen_trunk_fd_ >= 0) return -1;  // one trunk listener per host
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    // per-shard trunk listeners on ONE port (round 15, the link-spread
    // satellite): inbound peer links hash across shards like conns do
    if (reuseport)
      setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1 ||
        bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        listen(fd, 64) < 0) {
      close(fd);
      return -1;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kListenTrunkTag;
    if (epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev) < 0) {
      close(fd);
      return -1;
    }
    listen_trunk_fd_ = fd;
    trunk_port_ = ntohs(addr.sin_port);
    return trunk_port_;
  }

  // Open the MQTT-SN/UDP gateway socket (call BEFORE the poll thread
  // starts, like the other listeners — it mutates the epoll set from
  // the caller's thread). One datagram socket serves every SN client;
  // per-peer conns are minted on their first CONNECT. Returns the
  // bound port, or -1.
  // @plane(control)
  int ListenSn(const char* bind_addr, uint16_t port, int gw_id,
               bool reuseport = false) {
    if (sn_fd_ >= 0) return -1;  // one SN listener per host
    int fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    // UDP SO_REUSEPORT (round 12): the kernel source-hash pins each SN
    // peer to ONE shard's socket, so a datagram conversation never
    // splits across poll threads
    if (reuseport)
      setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    // a datagram blast landing between two poll cycles must queue in
    // the kernel, not drop at the default (small) socket buffers
    int buf = 4 << 20;
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
    setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1 ||
        bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
      close(fd);
      return -1;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kListenSnTag;
    if (epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev) < 0) {
      close(fd);
      return -1;
    }
    sn_fd_ = fd;
    sn_port_ = ntohs(addr.sin_port);
    sn_gw_id_ = static_cast<uint8_t>(gw_id);
    return sn_port_;
  }

  int sn_port() const { return sn_port_; }

  // Open the CoAP/UDP gateway socket (call BEFORE the poll thread
  // starts, like the other listeners — it mutates the epoll set from
  // the caller's thread). One datagram socket serves every CoAP peer;
  // per-peer conns are minted on their first request. Returns the
  // bound port, or -1.
  // @plane(control)
  int ListenCoap(const char* bind_addr, uint16_t port,
                 bool reuseport = false) {
    if (coap_fd_ >= 0) return -1;  // one CoAP listener per host
    int fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    // UDP SO_REUSEPORT source-hash (the SN discipline): each CoAP peer
    // pins to ONE shard's socket, so an endpoint's message layer
    // (dedup window, observers, retransmit state) never splits across
    // poll threads
    if (reuseport)
      setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
    int buf = 4 << 20;  // datagram blasts queue in the kernel, not drop
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
    setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1 ||
        bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
      close(fd);
      return -1;
    }
    socklen_t alen = sizeof(addr);
    getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kListenCoapTag;
    if (epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev) < 0) {
      close(fd);
      return -1;
    }
    coap_fd_ = fd;
    coap_port_ = ntohs(addr.sin_port);
    return coap_port_;
  }

  int coap_port() const { return coap_port_; }

  // Thread-safe enqueue of outbound bytes for a connection.
  int Send(uint64_t id, const uint8_t* data, size_t len) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      pending_.emplace_back(id, std::string(
          reinterpret_cast<const char*>(data), len));
    }
    Wake();
    return 0;
  }

  int CloseConn(uint64_t id) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      pending_closes_.push_back(id);
    }
    Wake();
    return 0;
  }

  // Thread-safe fast-path control plane (applied in ApplyPending).
  int Enqueue(Op op) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      pending_ops_.push_back(std::move(op));
    }
    Wake();
    return 0;
  }

  long Stat(int slot) const {
    if (slot < 0 || slot >= kStatCount) return -1;
    return static_cast<long>(stats_[slot].load(std::memory_order_relaxed));
  }

  // Attach the durable-session store (call BEFORE the poll thread
  // starts, like the listeners — store_ is read lock-free on the hot
  // path). The host never owns the store; Python manages its lifetime
  // and must destroy the host first. With shards, EVERY shard attaches
  // the same store: appends are batched per flush and the store's one
  // internal mutex serializes the (rare) concurrent flushes.
  // @plane(control)
  void AttachStore(store::DurableStore* s) { store_ = s; }

  // -- faultline control surface (thread-safe: atomics only) ---------------
  // One arm API covers the whole node: host sites arm this host's
  // injector, the two store_* sites forward to the attached store's
  // (shared across shard hosts — Python arms it once, via shard 0).
  int FaultArm(int site, int mode, double n_or_prob, uint64_t seed,
               uint64_t key) {
    if (site < 0 || site >= fault::kSiteCount) return -1;
    if (site == fault::kSiteStoreMsync ||
        site == fault::kSiteStoreSegOpen) {
      if (store_ == nullptr) return -1;
      store_->injector()->Arm(site, mode, n_or_prob, seed, key);
      return 0;
    }
    fault_.Arm(site, mode, n_or_prob, seed, key);
    return 0;
  }

  long FaultFired(int site) {
    if (site < 0 || site >= fault::kSiteCount) return -1;
    if (site == fault::kSiteStoreMsync ||
        site == fault::kSiteStoreSegOpen)
      return store_ == nullptr
                 ? 0
                 : static_cast<long>(
                       store_->injector()->FiredCount(site));
    return static_cast<long>(fault_.FiredCount(site));
  }

  // Join a shard group (call BEFORE any poll thread starts). This host
  // becomes shard `shard_id` of `g->n`: conn ids gain the shard
  // prefix, cross-shard deliveries ride the group's SPSC rings, and
  // the group's doorbell for this shard wakes our epoll loop.
  // @plane(control)
  int JoinGroup(ring::ShardGroup* g, int shard_id) {
    if (!g || shard_id < 0 || shard_id >= g->n ||
        g->n > ring::kMaxShards)
      return -1;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = kShardWakeTag;
    if (epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, g->doorbell[shard_id],
                  &ev) < 0)
      return -1;  // state untouched: a failed join leaves no group
                  // pointer for ~Host to chase and no alive=true for
                  // producers to ship into
    group_ = g;
    shard_id_ = shard_id;
    g->alive[shard_id].store(true, std::memory_order_release);
    return 0;
  }

  // Record one observation into a telemetry stage from the POLL THREAD
  // only (the native server's resume-replay drain runs there); the
  // wrong-thread refusal mirrors ConnIdleMs.
  // @plane(poll)
  int NoteStage(int stage, uint64_t ns) {
    pthread_t poller = poll_thread_.load(std::memory_order_acquire);
    if (poller != pthread_t{} && !pthread_equal(poller, pthread_self()))
      return -2;
    if (stage < 0 || stage >= kHistCount) return -1;
    if (telemetry_) RecordHist(stage, ns);
    return 0;
  }

  uint64_t LaneBacklog() const {
    return lane_backlog_.load(std::memory_order_relaxed);
  }

  // POLL-THREAD ONLY: walks conns_, which the loop mutates — a
  // cross-thread call races the hashtable structure itself (TSan
  // caught exactly this against Drop's erase). The product calls it
  // from _housekeep inside the poll step; a wrong-thread call fails
  // fast with -2 instead of silently racing.
  // (non-const since round 15: the housekeep_clock fault site counts
  // its fire; the poll-thread contract below already serializes it)
  // @plane(poll)
  long ConnIdleMs(uint64_t id) {
    pthread_t poller = poll_thread_.load(std::memory_order_acquire);
    if (poller != pthread_t{} && !pthread_equal(poller, pthread_self())) {
      // abort-free warn-once: misuse must show up in plain test output
      // and sanitizer runs, not as a silent -2 swallowed by a caller
      if (!idle_misuse_warned_.exchange(true, std::memory_order_relaxed))
        fprintf(stderr,
                "emqx_native: emqx_host_conn_idle_ms called off the poll "
                "thread; refusing (-2). This walks poll-thread-owned "
                "state — call it from the thread driving emqx_host_poll"
                ".\n");
      return -2;  // wrong thread: refuse rather than race conns_
    }
    auto it = conns_.find(id);
    if (it == conns_.end()) {
      auto pit = parked_.find(id);
      if (pit == parked_.end()) return -1;
      // housekeep clock skew applies to hibernating conns too
      uint64_t pnow = NowMs() + FaultSkewMs();
      uint64_t last = park_slab_.at(pit->second).last_rx_ms;
      return static_cast<long>(pnow > last ? pnow - last : 0);
    }
    // housekeep clock skew (faultline): keepalive scans judge conns
    // against a future clock while the site is armed
    uint64_t now = NowMs() + FaultSkewMs();
    const Conn& c = it->second;
    if (c.sn && !c.sn->awake) {
      if (now < c.sn->sleep_until_ms)
        return 0;  // announced sleep (§6.14): expected-silent, not idle
      // past the announced wake deadline the idle clock starts AT the
      // deadline — measuring from last_rx_ms would jump straight to
      // the full sleep span and kill the session with zero grace just
      // as the punctual wake PINGREQ is in flight
      uint64_t due = c.sn->sleep_until_ms;
      return static_cast<long>(now > due ? now - due : 0);
    }
    uint64_t last = c.last_rx_ms;
    return static_cast<long>(now > last ? now - last : 0);
  }

  // Conn-scale gauges (round 16): resident conns, parked conns,
  // parked-record bytes, armed wheel timers. POLL-THREAD ONLY like
  // ConnIdleMs (it reads poll-thread-owned containers); refuses with
  // -2 off thread. parked bytes alone is an atomic a cross-thread
  // caller may read via the stat surface.
  // @plane(poll)
  int ConnCounts(uint64_t out[4]) {
    pthread_t poller = poll_thread_.load(std::memory_order_acquire);
    if (poller != pthread_t{} && !pthread_equal(poller, pthread_self()))
      return -2;
    out[0] = conns_.size();
    out[1] = parked_.size();
    out[2] = parked_bytes_.load(std::memory_order_relaxed);
    out[3] = wheel_.armed();
    return 0;
  }

  // Run one event-loop step on the calling thread; fill `buf` with as
  // many whole event records as fit. Returns bytes written (0 on
  // timeout with no events).
  // @plane(poll) — the nativecheck root: everything reachable from
  // here runs on the poll thread (tools/nativecheck rule 1)
  long Poll(uint8_t* buf, size_t cap, int timeout_ms) {
    poll_thread_.store(pthread_self(), std::memory_order_release);
    trace_cyc_used_ = 0;  // the per-cycle sampler budget (TraceSample)
    if (telemetry_) {
      fr_now_ms_ = NowMs();  // one stamp per cycle for every FrNote
      if (poll_exit_ns_) {
        // the gap since the last Poll return is the caller's GIL
        // stint: time the Python driver held the plane stalled
        RecordHist(kHistGilStint, NowNs() - poll_exit_ns_);
      }
    }
    if (events_.empty()) {
      ApplyPending();
      gov_.BeginCycle();  // accept-burst defer window resets per cycle
      epoll_event evs[256];
      int n = epoll_wait(epoll_fd_, evs, 256, timeout_ms);
      if (n < 0) {
        if (telemetry_) poll_exit_ns_ = NowNs();
        return errno == EINTR ? 0 : -1;
      }
      for (int i = 0; i < n; i++) HandleEvent(evs[i]);
      ApplyPending();
      // inbound cross-shard deliveries apply before this cycle's
      // flushes so their acks/appends ride the same batch records
      if (group_) DrainShardRings();
      if (!lane_pending_.empty()) LaneStaleScan();
      // the timer wheel replaced the per-cycle O(N) deadline sweeps
      // (SN rexmit scan, trunk ack watchdog, the Python keepalive
      // loop): one Advance pays O(expired + cascades) per cycle
      wheel_.Advance(NowMs(), [this](uint64_t key, uint8_t kind) {
        FireTimer(key, kind);
      });
      TrunkHelloScan();  // old-peer HELLO grace deadlines (v0 links)
      FlushDurables();   // catch-all for appends with no dirty socket
      FlushTaps();
      FlushAcks();
      FlushTrunks();
      if (group_) FlushShards();
      // histogram deltas ride a ~100ms cadence, not every cycle: under
      // blast the per-cycle record + its Python-side decode measurably
      // taxed the plane (the observe_overhead budget); flight-recorder
      // dumps and slow-ack records still flush THIS cycle below
      if (telemetry_ && hist_dirty_
          && fr_now_ms_ - last_hist_flush_ms_ >= 100) {
        last_hist_flush_ms_ = fr_now_ms_;
        FlushHistDeltas();
      }
      FlushTelemetry();
      // span events are rare (1-in-N sampled) and timelines stitch
      // best fresh: flush every cycle, no 100ms cadence; the same
      // record carries this cycle's folded ledger entries
      FlushSpans();
    }
    size_t written = 0;
    while (!events_.empty()) {
      const std::string& rec = events_.front();
      if (written + rec.size() > cap) {
        // A record larger than the caller's whole buffer can never be
        // delivered; retaining it would busy-spin Poll forever.  Drop it
        // and close the offending connection with an error event (which
        // is small and will fit on a later call).
        if (written == 0 && rec.size() > cap) {
          uint64_t id;
          memcpy(&id, rec.data() + 1, 8);
          events_.pop_front();
          if (id != kListenTag && id != kWakeTag) Drop(id, "oversized", true);
          continue;
        }
        break;
      }
      memcpy(buf + written, rec.data(), rec.size());
      written += rec.size();
      events_.pop_front();
    }
    if (telemetry_) poll_exit_ns_ = NowNs();
    return static_cast<long>(written);
  }

 private:
  static constexpr uint64_t kListenTag = ~0ull;
  static constexpr uint64_t kWakeTag = ~0ull - 1;
  static constexpr uint64_t kListenWsTag = ~0ull - 2;
  static constexpr uint64_t kListenTrunkTag = ~0ull - 3;
  static constexpr uint64_t kListenSnTag = ~0ull - 4;
  static constexpr uint64_t kShardWakeTag = ~0ull - 5;
  static constexpr uint64_t kListenCoapTag = ~0ull - 6;

  void Wake() {
    uint64_t one = 1;
    [[maybe_unused]] ssize_t r = write(wake_fd_, &one, sizeof(one));
  }

  // Move cross-thread sends/closes/control-ops into loop-owned state.
  void ApplyPending() {
    std::vector<std::pair<uint64_t, std::string>> sends;
    std::vector<uint64_t> closes;
    std::vector<Op> ops;
    {
      std::lock_guard<std::mutex> lk(mu_);
      sends.swap(pending_);
      closes.swap(pending_closes_);
      ops.swap(pending_ops_);
    }
    for (auto& op : ops) ApplyOp(op);
    for (auto& [id, data] : sends) {
      auto it = FindConnInflate(id);  // egress re-inflates a parked conn
      if (it == conns_.end()) continue;
      // one WS binary frame per send() batch on WS conns
      AppendMqtt(it->second, data.data(), data.size());
      // AppendMqtt can rehash conns_ for CoAP conns (a CONNACK drains
      // preconn, and a parked re-register mints a successor conn):
      // never Flush through the pre-append iterator (review finding)
      auto again = conns_.find(id);
      if (again != conns_.end()) Flush(id, again->second);
    }
    for (uint64_t id : closes) {
      auto it = conns_.find(id);
      if (it == conns_.end()) {
        DropParked(id, "closed_by_host", false);  // no inflation to die
        continue;
      }
      it->second.want_close = true;
      if (it->second.outbuf.size() == it->second.outpos)
        Drop(id, "closed_by_host", false);
    }
  }

  void ApplyOp(Op& op) {
    switch (op.kind) {
      case Op::kSubAdd: {
        subs_.Add(op.owner, op.str, op.qos, op.flags);
        if (op.flags & kSubPunt)
          punt_subs_.Add(op.owner, op.str, op.qos, op.flags);
        // real entries (owner == a live conn id) are torn down with the
        // conn; remember them on the conn for that cleanup
        auto it = FindConnInflate(op.owner);
        if (it != conns_.end() && !(op.flags & kSubPunt))
          it->second.own_subs.push_back(op.str);
        break;
      }
      case Op::kSubDel:
        subs_.Remove(op.owner, op.str);
        punt_subs_.Remove(op.owner, op.str);
        break;
      case Op::kPermit: {
        auto it = FindConnInflate(op.owner);
        if (it != conns_.end() && it->second.permits.size() < 4096)
          it->second.permits.insert(op.str);
        break;
      }
      case Op::kEnableFast: {
        auto it = FindConnInflate(op.owner);
        if (it != conns_.end()) {
          it->second.fast = true;
          it->second.proto_ver = op.proto_ver;
          if (op.max_inflight)
            it->second.max_inflight =
                op.max_inflight < 0x7FFFu ? op.max_inflight : 0x7FFFu;
          // the publisher's clientid (round 18): durable appends stamp
          // it into the store (flags bit5) so no-local / from_
          // attribution survive a restart. Side map, not Conn state —
          // it must outlive park/inflate cycles.
          if (!op.str.empty() && op.str.size() <= 255)
            conn_cids_[op.owner] = op.str;
        }
        break;
      }
      case Op::kDisableFast: {
        auto it = FindConnInflate(op.owner);
        if (it != conns_.end()) {
          Conn& c = it->second;
          // live plane demotion (round 10): the AckState HANDS OFF to
          // the Python session (kind 11) instead of evaporating — a
          // qos2 retransmit straddling the demotion must dedup against
          // the awaiting-rel ids we owned, and the window/pending state
          // is the session's to finish. Emitted before the reset, and
          // only when there was a fast plane to demote (a second
          // disable on an already-slow conn is a no-op, not a loop).
          if (c.fast || c.ack) EmitHandoff(op.owner, c);
          c.fast = false;
          c.permits.clear();
          // orphaned native window state would eat acks meant for the
          // Python session once the conn goes slow-only
          c.ack.reset();
        }
        break;
      }
      case Op::kSetInflightCap: {
        // dynamic receive-window split: Python re-divides the client's
        // receive-maximum budget between the planes per ack cycle; the
        // caller guarantees native_cap + python_cap <= budget at every
        // step, so the sum of occupancies can never exceed the budget
        auto it = FindConnInflate(op.owner);
        if (it != conns_.end()) {
          it->second.max_inflight =
              op.max_inflight < 0x7FFFu ? op.max_inflight : 0x7FFFu;
          // a raised cap frees window slots: drain the pending queue
          DrainPending(op.owner, it->second);
          FlushDirty();
        }
        break;
      }
      case Op::kPermitsFlush:
        // topology changed (rule created, authz source changed, trace
        // enabled...): every publisher re-earns its permits through the
        // full Python path
        for (auto& [id, c] : conns_) c.permits.clear();
        break;
      case Op::kSharedAdd: {
        subs_.SharedAdd(op.token, op.owner, op.str, op.qos, op.flags);
        auto it = conns_.find(op.owner);
        if (it != conns_.end()) {
          auto& own = it->second.own_shared;
          bool seen = false;
          for (auto& [tok, filt] : own)
            if (tok == op.token && filt == op.str) {
              seen = true;       // reconcile re-upserts constantly;
              break;             // one bookkeeping entry is enough
            }
          if (!seen) own.emplace_back(op.token, op.str);
        }
        break;
      }
      case Op::kSharedDel: {
        subs_.SharedRemove(op.token, op.owner, op.str);
        auto it = conns_.find(op.owner);
        if (it != conns_.end()) {
          auto& own = it->second.own_shared;
          for (size_t i = 0; i < own.size(); i++)
            if (own[i].first == op.token && own[i].second == op.str) {
              own[i] = std::move(own.back());
              own.pop_back();
              break;
            }
        }
        break;
      }
      case Op::kSetLane:
        lane_enabled_ = op.flags != 0;
        if (!lane_enabled_) LaneDrainToPython();
        break;
      case Op::kLaneDeliver:
        LaneDeliver(op.str);
        break;
      case Op::kSetMaxQos:
        max_qos_allowed_ = op.qos;
        break;
      case Op::kSetTrace: {
        auto it = FindConnInflate(op.owner);
        if (it == conns_.end()) break;
        bool on = op.flags != 0;
        if (on && !it->second.traced) {
          it->second.traced = true;
          // attach the pre-trace tail NOW: the events leading up to
          // trace start are exactly what the operator wants to see
          EmitFlightRec(op.owner, it->second, kFrReasonTrace);
        } else if (!on) {
          it->second.traced = false;
        }
        break;
      }
      case Op::kSetTelemetry:
        telemetry_ = op.flags != 0;
        slow_ack_ns_ = op.token;
        break;
      case Op::kTrunkConnect: {
        trunk::Peer& p = trunk_peers_[op.owner];
        p.addr = op.str;
        p.port = static_cast<uint16_t>(op.token);
        TrunkRingLoad(op.owner, p);
        TrunkDial(op.owner, p);
        break;
      }
      case Op::kTrunkIdent: {
        // bind the peer id to its stable NODE NAME (round 18): the
        // store keys trunk replay rings on it, since peer ids are
        // minted per-process and a restart renumbers them
        trunk::Peer& p = trunk_peers_[op.owner];
        if (p.store_name.empty()) {
          p.store_name = op.str;
        } else if (p.store_name != op.str && p.unacked.empty()) {
          // a name change with NOTHING journaled yet (e.g. a flush
          // that raced ahead load-marked the fallback key): adopt the
          // real name and re-open the one-shot merge, or the previous
          // life's ring under the node name would never replay
          // (review finding). With live ring entries the old key is
          // authoritative — never strand their ack path.
          p.store_name = op.str;
          p.ring_loaded = false;
        }
        TrunkRingLoad(op.owner, p);
        break;
      }
      case Op::kTrunkDisconnect: {
        auto it = trunk_peers_.find(op.owner);
        if (it == trunk_peers_.end()) break;
        if (it->second.sock_tag) TrunkSockDead(it->second.sock_tag, "drop");
        // flags != 0 forgets the peer entirely (node left the cluster:
        // routes are already gone, the replay ring — including its
        // store-backed records — dies with it);
        // flags == 0 keeps the state so a redial replays unacked qos1
        if (op.flags) {
          if (store_) store_->TrunkDrop(TrunkStoreName(op.owner,
                                                       it->second));
          trunk_peers_.erase(op.owner);
        }
        break;
      }
      case Op::kTrunkRouteAdd:
        // the third entry kind: sibling of the punt marker. Mirrored
        // into punt_subs_ too so the DEVICE lane (whose model cannot
        // see remote routes) conservatively punts trunk audiences —
        // the walk path reads the kSubRemote flag straight from subs_.
        subs_.Add(kTrunkOwnerBase + op.owner, op.str, 0, kSubRemote);
        punt_subs_.Add(kTrunkOwnerBase + op.owner, op.str, 0, kSubRemote);
        break;
      case Op::kTrunkRouteDel:
        subs_.Remove(kTrunkOwnerBase + op.owner, op.str);
        punt_subs_.Remove(kTrunkOwnerBase + op.owner, op.str);
        break;
      case Op::kDurableAdd:
        // the FOURTH entry kind (round 10): a persistent session's
        // filter, served by the durable plane — NOT mirrored into
        // punt_subs_ (it must not punt; FanOut persists it, and the
        // device lane's MatchFilter finds it under the named filter).
        // owner namespaced: raw store tokens would collide with conn ids
        subs_.Add(kDurableOwnerBase + op.owner, op.str, op.qos,
                  kSubDurable);
        break;
      case Op::kDurableDel:
        subs_.Remove(kDurableOwnerBase + op.owner, op.str);
        break;
      case Op::kSnPredef:
        // gateway-wide predefined topic-id table (empty topic = forget)
        if (op.str.empty())
          sn_predefined_.erase(static_cast<uint16_t>(op.owner));
        else
          sn_predefined_[static_cast<uint16_t>(op.owner)] = op.str;
        break;
      case Op::kRetainSet:
        retained_.Set(op.str, op.str2, op.qos, op.token);
        stats_[kStRetainSet].fetch_add(1, std::memory_order_relaxed);
        break;
      case Op::kRetainDel:
        if (retained_.Del(op.str))
          stats_[kStRetainDel].fetch_add(1, std::memory_order_relaxed);
        break;
      case Op::kRetainDeliver:
        RetainDeliver(op.owner, op.str, op.qos);
        break;
      case Op::kCoapRetainState:
        // Python's retained mirror is complete (no props-carrying
        // topics excluded) -> plain CoAP GETs may serve from the
        // native snapshot; incomplete -> they degrade to the oracle
        coap_retain_complete_ = op.flags != 0;
        break;
      case Op::kSetCoapAckTimeout:
        // CON retransmit base (tests compress the RFC 7252 clock;
        // 0 restores the default ACK_TIMEOUT x 1.5)
        coap_ack_timeout_ms_ = op.token ? op.token : coap::kAckTimeoutMs;
        break;
      case Op::kCoapSend: {
        // raw oracle-plane response bytes for a CoAP peer (the punt
        // seam's answer path): framed into the conn outbuf verbatim
        auto cit = conns_.find(op.owner);
        if (cit == conns_.end() || !cit->second.coap) break;
        if (op.str.size() <= coap::kMaxMessage) {
          CoapOut(cit->second, op.str);
          Flush(op.owner, cit->second);
        }
        break;
      }
      case Op::kSetTeleShift:
        // EMQX_NATIVE_TELEMETRY_SHIFT: per-message stages sample
        // 1-in-2^shift (default shift 3 = 1-in-8); bench runs widen it
        tele_mask_ = (op.token >= 1 && op.token <= 16)
                         ? static_cast<uint32_t>((1ull << op.token) - 1)
                         : 7u;
        break;
      case Op::kTrunkPeerState:
        // the owner shard's kind-9 UP/DOWN mirrored onto every OTHER
        // shard by Python (round 15 — owners spread as peer % n): the
        // TrunkEligible oracle for ring-forwarded legs; the owner
        // ignores its own mirror entry (OwnsTrunkPeer routes it to
        // the authoritative peer state)
        trunk_peer_up_[op.owner] = op.flags != 0;
        break;
      case Op::kSetTracing:
        // the deterministic 1-in-2^shift publish sampler; seed carries
        // the node/shard prefix Python composed (nonzero — trace id 0
        // means "not sampled" everywhere)
        tracing_ = op.flags != 0;
        trace_mask_ = op.max_inflight <= 16
                          ? (1u << op.max_inflight) - 1
                          : 63u;
        if (op.token) trace_seed_ = op.token;
        break;
      case Op::kSetTrunkWire:
        // cap the advertised/accepted trunk wire version (tests dial
        // this to 0 to exercise the old-peer downshift)
        trunk_wire_max_ = op.qos <= trunk::kWireVersion
                              ? op.qos
                              : trunk::kWireVersion;
        break;
      case Op::kSetKeepalive: {
        // keepalive moves onto the wheel: `token` is the EFFECTIVE
        // deadline (Python passes 1.5x the negotiated keepalive); 0
        // disarms. The park horizon derives from it (2x the grace).
        auto it = FindConnInflate(op.owner);
        if (it == conns_.end()) break;
        Conn& c = it->second;
        c.keepalive_ms = static_cast<uint32_t>(op.token);
        if (c.tm_keepalive) {
          wheel_.Cancel(c.tm_keepalive);
          c.tm_keepalive = 0;
        }
        if (c.keepalive_ms)
          c.tm_keepalive = wheel_.Arm(op.owner, kTmKeepalive,
                                      NowMs() + c.keepalive_ms);
        if (c.tm_park) {
          wheel_.Cancel(c.tm_park);
          c.tm_park = 0;
        }
        // SN conns never park (CanPark rejects them; sleep mode is
        // their hibernation) — don't churn a timer that can't fire
        if (park_enabled_ && !c.sn) {
          uint64_t base = c.last_work_ms ? c.last_work_ms : c.last_rx_ms;
          c.tm_park = wheel_.Arm(op.owner, kTmPark,
                                 base + ParkAfterOf(c));
        }
        break;
      }
      case Op::kSetPark: {
        // conn-scale knobs: flags = park enabled, max_inflight = the
        // no-keepalive park-after fallback (ms, 0 keeps the default),
        // owner = accept burst/cycle, token = conn-memory budget bytes
        bool was = park_enabled_;
        park_enabled_ = op.flags != 0;
        park_after_ms_ = op.max_inflight;  // 0 = the 2x-grace default
        gov_.Configure(static_cast<uint32_t>(op.owner), op.token);
        if (park_enabled_) {
          // (re-)arm park deadlines against each conn's IDLE BASE —
          // not "now": reconfiguring must preserve elapsed idleness,
          // or a periodic set_park would postpone every park forever
          for (auto& [cid, c] : conns_) {
            if (c.sn) continue;
            if (c.tm_park) wheel_.Cancel(c.tm_park);
            uint64_t base = c.last_work_ms ? c.last_work_ms
                                           : c.last_rx_ms;
            c.tm_park = wheel_.Arm(cid, kTmPark, base + ParkAfterOf(c));
          }
        }
        break;
      }
      case Op::kSynthConns:
        SynthConns(static_cast<uint32_t>(op.owner),
                   static_cast<uint32_t>(op.token), op.max_inflight,
                   op.str);
        break;
      case Op::kSetTrunkAckTimeout:
        // silent-link watchdog deadline (round 15); tests tighten it
        // so a blackholed link dies in milliseconds instead of
        // seconds, and 0 DISABLES the watchdog (the store's
        // compact-age convention — a swallowed 0 was a review finding)
        trunk_ack_timeout_ms_ = op.token;
        // the deadline changed: re-arm every peer's wheel entry
        // against it (round 16 — the watchdog rides the wheel now)
        for (auto& [peer_id, p] : trunk_peers_) {
          if (p.tm_ack) {
            wheel_.Cancel(p.tm_ack);
            p.tm_ack = 0;
          }
          if (p.up) TrunkAckWatch(peer_id, p);
        }
        break;
    }
  }

  // -- device match lane --------------------------------------------------

  struct LaneEntry {
    uint64_t publisher = 0;
    uint8_t qos = 0;
    uint16_t pid = 0;
    uint64_t enq_ms = 0;
    std::string frame;  // original PUBLISH bytes (punts forward these)
    uint32_t topic_off = 0, topic_len = 0, payload_off = 0;
  };

  void LaneEnqueue(uint64_t seq, LaneEntry&& le) {
    key_scratch_.assign(le.frame.data() + le.topic_off, le.topic_len);
    lane_topic_pending_[key_scratch_]++;
    lane_pending_.emplace(seq, std::move(le));
    lane_order_.push_back(seq);
    lane_backlog_.store(lane_pending_.size(), std::memory_order_relaxed);
  }

  // Callers invoke this AFTER erasing the entry from lane_pending_, so
  // the backlog gauge reads the true remaining count (an entry-held
  // copy of the topic keeps this valid post-erase).
  void LaneForget(const LaneEntry& le) {
    key_scratch_.assign(le.frame.data() + le.topic_off, le.topic_len);
    auto it = lane_topic_pending_.find(key_scratch_);
    if (it != lane_topic_pending_.end() && --it->second == 0) {
      lane_topic_pending_.erase(it);
      // last parked frame for this topic resolved: the poison window
      // (below) closes — new frames already take the Python path via
      // the revoked permit
      lane_poisoned_.erase(key_scratch_);
    }
    lane_backlog_.store(lane_pending_.size(), std::memory_order_relaxed);
  }

  // Punt one parked frame to Python exactly as the walk path would have
  // BEFORE consuming it: the original bytes go up as a normal frame
  // event and the channel/broker run the whole fan-out.
  //
  // ``revoke_permit`` is the per-(publisher, topic) ordering guard for
  // NON-deterministic punts (pump failure, tokenizer/K-cap fallback,
  // stale drain): the next frame from this publisher must also take
  // the Python path — behind this one in the same FIFO — instead of a
  // native delivery overtaking it. Marker punts don't need it: the
  // marker makes every subsequent verdict punt identically, exactly
  // like the walk path.
  void LanePunt(LaneEntry& le, bool revoke_permit) {
    stats_[kStLanePunts].fetch_add(1, std::memory_order_relaxed);
    stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
    if (revoke_permit) {
      key_scratch_.assign(le.frame.data() + le.topic_off, le.topic_len);
      // poison the topic while same-topic frames remain parked in
      // OTHER in-flight batches: their device verdicts may differ from
      // this one, and a native delivery would overtake this punt in
      // Python's pipeline. Poisoned frames punt unconditionally — same
      // FIFO — until the topic's parked count drains to zero.
      if (lane_topic_pending_.count(key_scratch_))
        lane_poisoned_.insert(key_scratch_);
      auto it = FindConnInflate(le.publisher);
      if (it != conns_.end()) it->second.permits.erase(key_scratch_);
    }
    events_.push_back(
        EncodeRecord(2, le.publisher, le.frame.data(), le.frame.size()));
  }

  // Pump failure / lane shutdown: every parked frame goes to Python in
  // arrival order (Python's pipeline is FIFO, so per-topic order holds
  // within the drained set); permits are revoked so trailing frames
  // queue behind the drained ones instead of overtaking them natively.
  void LaneDrainToPython() {
    for (uint64_t seq : lane_order_) {
      auto it = lane_pending_.find(seq);
      if (it == lane_pending_.end()) continue;
      LaneEntry le = std::move(it->second);
      lane_pending_.erase(it);
      LaneForget(le);
      LanePunt(le, /*revoke_permit=*/true);
    }
    lane_order_.clear();
    lane_backlog_.store(0, std::memory_order_relaxed);
  }

  // A stale head means the Python pump stopped responding (device
  // wedge, thread death): fail the whole lane over to the slow path
  // and turn it off. Python watches the kStLaneStale counter and
  // resyncs its side (and may re-enable once the pump is healthy).
  void LaneStaleScan() {
    if (lane_order_.empty()) return;
    auto it = lane_pending_.find(lane_order_.front());
    while (it == lane_pending_.end() && !lane_order_.empty()) {
      lane_order_.pop_front();  // already answered; trim lazily
      if (lane_order_.empty()) return;
      it = lane_pending_.find(lane_order_.front());
    }
    if (it == lane_pending_.end()) return;
    if (NowMs() - it->second.enq_ms < kLaneStaleMs) return;
    lane_enabled_ = false;
    stats_[kStLaneStale].fetch_add(1, std::memory_order_relaxed);
    LaneDrainToPython();
  }

  // Shared native fan-out tail (TryFast walk path + LaneDeliver): the
  // publisher ack, the per-entry deliveries and the shared-group
  // rotation MUST stay one code path — callers pre-populate
  // match_scratch_/groups_scratch_ and have already ruled out punts.
  // ``count_fast=false`` is the trunk-receiver call shape: the publish
  // arrived over a trunk link (publisher = 0, no local conn to ack) and
  // counts as kStTrunkIn at the call site, not kStFastIn here.
  // @admit-gated — callers run the ladder (ShardAdmit) first
  void FanOut(uint64_t publisher, uint8_t qos, uint16_t pid,
              std::string_view topic, std::string_view payload,
              bool count_fast = true) {
    if (qos) {
      // ack first: the reference PUBACKs (or PUBRECs for qos2) as soon
      // as emqx_broker:publish returns
      auto pit = conns_.find(publisher);
      if (pit != conns_.end()) {
        char ack[4] = {static_cast<char>(qos == 1 ? 0x40 : 0x50), 0x02,
                       static_cast<char>(pid >> 8),
                       static_cast<char>(pid & 0xFF)};
        AppendMqtt(pit->second, ack, 4);
        MarkDirty(publisher, pit->second);
      }
    }
    if (count_fast)
      stats_[kStFastIn].fetch_add(1, std::memory_order_relaxed);
    // shared serialized frames per proto: qos0 frames are reused
    // verbatim; elevated-qos frames are built ONCE per publish with a
    // zero pid, then appended and pid/qos-patched in place per target
    // (the round-5 per-target BuildPublish rebuild was measurable on
    // the windowed qos1 path)
    frame_v4_.clear();
    frame_v5_.clear();
    frame_q_v4_.clear();
    frame_q_v5_.clear();
    dur_tok_scratch_.clear();
    fan_xshipped_ = 0;
    for (const SubEntry* e : match_scratch_) {
      // rule taps never deliver; remote entries forward via the trunk
      // (TryFast enqueues them) or punt — never through a local write;
      // durable entries persist (below) instead of delivering
      if (e->flags & kSubDurable) {
        dur_tok_scratch_.push_back(e->owner - kDurableOwnerBase);
        continue;
      }
      if (e->flags & (kSubRuleTap | kSubRemote)) continue;
      if ((e->flags & kSubNoLocal) && e->owner == publisher) continue;
      if (group_) {
        int ds = ShardOf(e->owner);
        if (ds != shard_id_) {
          // the subscriber's conn lives on another shard: collect it —
          // ONE multi-target ring entry per (publish, shard) ships
          // after the loop (admission already ran in ShardAdmit,
          // BEFORE any side effect of this publish); the target
          // shard's DeliverTo runs its window/backpressure machinery
          // and counts kStFastOut there
          uint8_t oq = qos < e->qos ? qos : e->qos;
          xtgt_scratch_[ds].push_back(
              e->owner | (static_cast<uint64_t>(oq) << 60));
          continue;
        }
      }
      DeliverTo(e->owner, *e, publisher, qos, topic, payload);
    }
    if (group_) {
      for (int ds = 0; ds < group_->n; ds++) {
        if (xtgt_scratch_[ds].empty()) continue;
        // Admitted publishes (TryFast/LaneDeliver ran ShardAdmit this
        // cycle, same thread, nothing pushed since) always pass this
        // re-check. The UNADMITTED caller — the trunk receiver's
        // fan-out, which cannot punt a publish that already left its
        // origin node — degrades ITS deliveries alone to a counted
        // drop here instead of appending to a batch whose seal-time
        // Push failure would discard other publishes' entries too.
        if (RingRoom(ds)) {
          XShipMulti(ds, xtgt_scratch_[ds], publisher, qos, topic,
                     payload);
          fan_xshipped_++;
        } else {
          stats_[kStShardRingFull].fetch_add(1,
                                             std::memory_order_relaxed);
          stats_[kStDropsBackpressure].fetch_add(
              xtgt_scratch_[ds].size(), std::memory_order_relaxed);
          LedgerNote(kLrRingFull, static_cast<uint64_t>(ds));
        }
        xtgt_scratch_[ds].clear();
      }
    }
    if (!dur_tok_scratch_.empty()) {
      // dedup once, O(S log S): two filters of one session yield one
      // marker + one replay (a per-entry linear scan was O(S^2) on the
      // fast path for wide durable audiences)
      std::sort(dur_tok_scratch_.begin(), dur_tok_scratch_.end());
      dur_tok_scratch_.erase(
          std::unique(dur_tok_scratch_.begin(), dur_tok_scratch_.end()),
          dur_tok_scratch_.end());
      if (store_) DurableAppend(publisher, qos, topic, payload);
    }
    // natively served $share groups: one member per group, rotating;
    // skipped members (gone / backpressured / window full) get the
    // redispatch treatment — the next member takes the message
    // (emqx_shared_sub.erl:190-217)
    for (SharedGroup* g : groups_scratch_) {
      size_t nmem = g->members.size();
      bool delivered = false;
      for (size_t k = 0; k < nmem && !delivered; k++) {
        const SubEntry& e = g->members[g->cursor % nmem];
        g->cursor++;
        if ((e.flags & kSubNoLocal) && e.owner == publisher) continue;
        if (group_ && ShardOf(e.owner) != shard_id_) {
          // cross-shard member: a full ring admits the ship; a full
          // one skips this member and the next takes the message —
          // the nack/redispatch shape, not a punt (groups are picked
          // one-member-at-a-time, so per-member degradation is safe)
          int ds = ShardOf(e.owner);
          if (RingRoom(ds)) {
            uint8_t oq = qos < e.qos ? qos : e.qos;
            XShip(ds, e.owner, publisher, oq, false, topic, payload);
            fan_xshipped_++;
            delivered = true;
          } else {
            stats_[kStShardRingFull].fetch_add(1,
                                               std::memory_order_relaxed);
            LedgerNote(kLrRingFull, static_cast<uint64_t>(ds));
          }
          continue;
        }
        delivered = DeliverTo(e.owner, e, publisher, qos, topic, payload);
      }
      stats_[delivered ? kStSharedDispatch : kStSharedNoMember].fetch_add(
          1, std::memory_order_relaxed);
    }
  }

  // Apply one pump response blob:
  //   [u32 count] then per item
  //   [u64 seq][u8 flags][u16 nf] + nf x ([u16 len][filter bytes])
  // flags bit0 = punt (device overflow / tokenizer reject / pump spill).
  void LaneDeliver(const std::string& blob) {
    size_t pos = 0;
    auto need = [&](size_t n) { return pos + n <= blob.size(); };
    auto rd_u16 = [&]() {
      uint16_t v = static_cast<uint8_t>(blob[pos]) |
                   (static_cast<uint8_t>(blob[pos + 1]) << 8);
      pos += 2;
      return v;
    };
    if (!need(4)) return;
    uint32_t count = 0;
    memcpy(&count, blob.data(), 4);
    pos = 4;
    for (uint32_t i = 0; i < count; i++) {
      if (!need(8 + 1 + 2)) return;  // truncated blob: keep rest parked
      uint64_t seq = 0;
      memcpy(&seq, blob.data() + pos, 8);
      pos += 8;
      uint8_t rflags = static_cast<uint8_t>(blob[pos++]);
      uint16_t nf = rd_u16();
      size_t filters_at = pos;
      for (uint16_t k = 0; k < nf; k++) {
        if (!need(2)) return;
        uint16_t fl = rd_u16();
        if (!need(fl)) return;
        pos += fl;
      }
      auto it = lane_pending_.find(seq);
      if (it == lane_pending_.end()) continue;  // drained/stale already
      LaneEntry le = std::move(it->second);
      lane_pending_.erase(it);
      if (telemetry_) {
        // lane dwell (enqueue -> device verdict applied): ms-scale by
        // nature (a device round trip), so the coarse clock suffices
        uint64_t now_ms = NowMs();
        RecordHist(kHistLaneDwell,
                   (now_ms > le.enq_ms ? now_ms - le.enq_ms : 0)
                       * 1000000ull);
      }
      std::string_view topic(le.frame.data() + le.topic_off, le.topic_len);
      std::string_view payload(le.frame.data() + le.payload_off,
                               le.frame.size() - le.payload_off);
      if (telemetry_) cur_hash_ = TopicHash(topic);  // for FanOut notes
      // poison must be read BEFORE LaneForget: forgetting the LAST
      // parked frame of a poisoned topic erases the poison, and the
      // pre-fix order let exactly that frame deliver natively —
      // overtaking the punted earlier frame still queued in Python's
      // FIFO (same-topic reorder)
      key_scratch_.assign(topic.data(), topic.size());
      bool poisoned = lane_poisoned_.count(key_scratch_) != 0;
      LaneForget(le);
      if (poisoned) {
        // an earlier same-topic frame was nondeterministically punted;
        // this one must follow it through Python, not overtake it
        LanePunt(le, /*revoke_permit=*/true);
        continue;
      }
      if (rflags & 1) {
        // pump failure / tokenizer reject / K-cap overflow: a verdict
        // the NEXT message may not repeat — revoke the permit so
        // per-publisher order survives the switch to the Python path
        LanePunt(le, /*revoke_permit=*/true);
        continue;
      }
      // the device model only sees broker-table subscriptions; punt
      // markers it cannot know about (remote routes, flips raced with
      // this batch) are re-checked against the punt-only trie. Remote
      // entries no longer punt wholesale (round 12, the lane+trunk
      // coexistence edge): an eligible trunk audience collects here
      // and the remote leg is enqueued AFTER the device-matched local
      // fan-out — only real punt shapes (or a down/ineligible trunk)
      // still force the Python path.
      punt_scratch_.clear();
      punt_subs_.Match(topic, &punt_scratch_);
      trunk_scratch_.clear();
      bool lane_punt = false;
      for (const SubEntry* pe : punt_scratch_) {
        if (!(pe->flags & kSubRemote)) {
          lane_punt = true;
          break;
        }
        uint64_t peer = pe->owner - kTrunkOwnerBase;
        if (!TrunkEligible(peer, le.qos,
                           15 + topic.size() + payload.size())) {
          LedgerNote(kLrTrunkPunt, peer);
          lane_punt = true;
          break;
        }
        PushUnique(&trunk_scratch_, peer);
      }
      if (lane_punt) {
        LanePunt(le, /*revoke_permit=*/false);
        continue;
      }
      match_scratch_.clear();
      groups_scratch_.clear();
      size_t fpos = filters_at;
      for (uint16_t k = 0; k < nf; k++) {
        uint16_t fl = static_cast<uint8_t>(blob[fpos]) |
                      (static_cast<uint8_t>(blob[fpos + 1]) << 8);
        fpos += 2;
        subs_.MatchFilter(std::string_view(blob.data() + fpos, fl),
                          &match_scratch_, &groups_scratch_);
        fpos += fl;
      }
      bool punt = false, tapped = false;
      for (const SubEntry* e : match_scratch_) {
        if (e->flags & kSubPunt) {
          punt = true;
          break;
        }
        if (e->flags & kSubRuleTap) tapped = true;
      }
      if (punt) {
        LanePunt(le, /*revoke_permit=*/false);
        continue;
      }
      if (!ShardAdmit()) {
        // a destination shard's ring cannot take this fan-out: the
        // walk path's ring-full -> punt -> Python ladder, through the
        // lane's punt seam (BEFORE the tap/ack side effects)
        LanePunt(le, /*revoke_permit=*/false);
        continue;
      }
      bool ldup = (static_cast<uint8_t>(le.frame[0]) & 0x08) != 0;
      // lane deliveries are native-consumed publishes too: same
      // sampling commit point as the walk path (shared ticker)
      TraceSample(le.publisher);
      if (tapped) EmitTap(le.publisher, le.qos, ldup, topic, payload);
      stats_[kStLaneOut].fetch_add(1, std::memory_order_relaxed);
      if (le.qos == 1)
        stats_[kStQos1In].fetch_add(1, std::memory_order_relaxed);
      cur_dup_ = ldup;
      FanOut(le.publisher, le.qos, le.pid, topic, payload);
      if (cur_trace_) SpanNote(kSpanRoute, match_scratch_.size());
      // the remote legs collected above (lane+trunk coexistence): the
      // trunk enqueue next to the device-matched local fan-out — the
      // TryFast walk path's two-halves discipline
      for (uint64_t peer : trunk_scratch_) {
        if (OwnsTrunkPeer(peer))
          TrunkEnqueue(peer, le.publisher, le.qos, ldup, topic, payload);
        else
          XShip(TrunkShardOf(peer), kTrunkOwnerBase + peer,
                le.publisher, le.qos, ldup, topic, payload);
      }
      cur_trace_ = 0;  // this frame's trace context ends here
      if (telemetry_ && (fan_xshipped_ || !trunk_scratch_.empty())) {
        auto pit = FindConnInflate(le.publisher);
        if (pit != conns_.end()) {
          if (fan_xshipped_)
            FrNote(pit->second, kFrRingCross, 3,
                   static_cast<uint16_t>(fan_xshipped_), cur_hash_);
          if (!trunk_scratch_.empty())
            FrNote(pit->second, kFrTrunk, 3,
                   static_cast<uint16_t>(trunk_scratch_[0] & 0xFFFF),
                   cur_hash_);
        }
      }
    }
    FlushDirty();
  }

  void HandleEvent(const epoll_event& ev) {
    if (ev.data.u64 == kWakeTag) {
      uint64_t junk;
      while (read(wake_fd_, &junk, sizeof(junk)) > 0) {}
      return;
    }
    if (ev.data.u64 == kShardWakeTag) {
      // another shard pushed onto our inbound rings; the drain itself
      // runs once per poll cycle (DrainShardRings) — just clear the
      // doorbell here
      uint64_t junk;
      while (read(group_->doorbell[shard_id_], &junk, sizeof(junk)) > 0) {}
      return;
    }
    if (ev.data.u64 == kListenTag || ev.data.u64 == kListenWsTag) {
      Accept(ev.data.u64 == kListenWsTag);
      return;
    }
    if (ev.data.u64 == kListenTrunkTag) {
      TrunkAccept();
      return;
    }
    if (ev.data.u64 == kListenSnTag) {
      // checked BEFORE the trunk-bit test: the listener tags live at
      // the top of the u64 space and carry bit 63 too
      SnRead();
      return;
    }
    if (ev.data.u64 == kListenCoapTag) {
      CoapRead();
      return;
    }
    if (ev.data.u64 & kTrunkSockBit) {
      TrunkEvent(ev);
      return;
    }
    uint64_t id = ev.data.u64;
    auto it = conns_.find(id);
    if (it == conns_.end()) {
      // hibernating conns keep their fd registered under the same tag:
      // the first byte (or HUP) lands here and is served from — or
      // re-inflates — the parked record before any fast-path work
      auto pit = parked_.find(id);
      if (pit == parked_.end()) return;
      if (ev.events & (EPOLLHUP | EPOLLERR)) {
        DropParked(id, "sock_error", true);
        return;
      }
      if (ev.events & EPOLLIN) ParkedRead(id, pit->second);
      return;
    }
    if (ev.events & (EPOLLHUP | EPOLLERR)) {
      Drop(id, "sock_error", true);
      return;
    }
    if (ev.events & EPOLLOUT) {
      Flush(id, it->second);
      it = conns_.find(id);
      if (it == conns_.end()) return;
    }
    if (ev.events & EPOLLIN) Read(id, it->second);
  }

  void Accept(bool is_ws) {
    int lfd = is_ws ? listen_ws_fd_ : listen_fd_;
    for (;;) {
      // backlog-pressure rung: past the per-cycle burst the kernel
      // listen backlog keeps the remainder for the next cycle — a
      // connect storm is paced, not serviced at the expense of every
      // established conn's poll latency (no side effects, no shed)
      if (gov_.Defer()) return;
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int fd = accept4(lfd, reinterpret_cast<sockaddr*>(&peer), &plen,
                       SOCK_NONBLOCK | SOCK_CLOEXEC);
      if (fd < 0) return;
      // @fault(conn_accept) — the accepted conn is torn down on the
      // spot (the client sees an RST: an accept-storm shed)
      if (FaultHit(fault::kSiteConnAccept, 0)) {
        close(fd);
        continue;
      }
      // accept-shed rung: admission (memory budget, esockd max-conn
      // limiting) is decided BEFORE any conn side effect — no id, no
      // table entry, no OPEN event for a shed accept; the close is
      // ledger-visible instead of silent
      // the estimate INCLUDES the conn under admission: crossing the
      // budget sheds the conn that would cross it, not the one after
      bool admit = gov_.Admit(ConnMemEstimate() + kConnResidentEstBytes);
      if (!admit || conns_.size() + parked_.size() >= max_conns_) {
        close(fd);
        stats_[kStConnsShed].fetch_add(1, std::memory_order_relaxed);
        LedgerNote(kLrAcceptShed, conns_.size() + parked_.size());
        continue;
      }
      AcceptConn(fd, peer, is_ws);
    }
  }

  // Accept side effects: id mint, conn-table insert, epoll
  // registration, the OPEN event. Accept() calls this only after the
  // governor's admit check (the ladder contract — nativecheck rule 3).
  // @admit-gated
  void AcceptConn(int fd, const sockaddr_in& peer, bool is_ws) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    uint64_t id = MintConnId();
    Conn c;
    c.fd = fd;
    c.framer = Framer(max_size_);
    c.last_rx_ms = c.last_work_ms = NowMs();
    if (is_ws) c.ws = std::make_unique<WsConnState>();
    auto& cref = conns_.emplace(id, std::move(c)).first->second;
    if (park_enabled_)
      cref.tm_park =
          wheel_.Arm(id, kTmPark, cref.last_rx_ms + ParkAfterOf(cref));
    FrNote(cref, kFrOpen, 0, is_ws ? 1 : 0);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = id;
    epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev);
    char ip[INET_ADDRSTRLEN] = "?";
    inet_ntop(AF_INET, &peer.sin_addr, ip, sizeof(ip));
    std::string info = std::string(is_ws ? "ws:" : "") + ip + ":" +
                       std::to_string(ntohs(peer.sin_port));
    events_.push_back(EncodeRecord(1, id, info.data(), info.size()));
  }

  // -- conn-scale plane (round 16): timer-wheel fires + hibernation -------
  // The per-shard wheel replaced every per-cycle deadline sweep; these
  // handlers run on the poll thread from wheel_.Advance and re-arm
  // themselves (handles are consumed by the fire — wheel.h contract).

  uint64_t ParkAfterOf(const Conn& c) const {
    // configured override wins; the DEFAULT is "2x keepalive grace
    // passed" (grace = the 1.5x-keepalive deadline), falling back to
    // a flat horizon for keepalive-less conns
    if (park_after_ms_) return park_after_ms_;
    return c.keepalive_ms ? 2ull * c.keepalive_ms : kParkAfterDefaultMs;
  }

  uint64_t ConnMemEstimate() const {
    return conns_.size() * kConnResidentEstBytes +
           parked_bytes_.load(std::memory_order_relaxed);
  }

  void FireTimer(uint64_t key, uint8_t kind) {
    switch (kind) {
      case kTmKeepalive: FireKeepalive(key); break;
      case kTmPark: FirePark(key); break;
      case kTmSnRexmit: FireSnRexmit(key); break;
      case kTmTrunkAck: FireTrunkAck(key); break;
      case kTmCoapRexmit: FireCoapRexmit(key); break;
    }
  }

  // Keepalive is lazy-reprogrammed: traffic never touches the wheel;
  // the fire re-checks the real idle clock and either closes the conn
  // or re-arms at the earliest possible expiry. Parked conns are
  // judged (and closed) WITHOUT inflation.
  void FireKeepalive(uint64_t id) {
    // housekeep clock skew (faultline): the wheel judges conns against
    // a future clock while the site is armed, exactly like ConnIdleMs
    uint64_t now = NowMs() + FaultSkewMs();
    auto it = conns_.find(id);
    if (it != conns_.end()) {
      Conn& c = it->second;
      c.tm_keepalive = 0;
      if (!c.keepalive_ms) return;
      uint64_t base = c.last_rx_ms;
      if (c.sn && !c.sn->awake) {
        if (now < c.sn->sleep_until_ms) {
          // announced sleep: expected-silent until the wake deadline;
          // the idle clock restarts AT the deadline (PR 6 grace rule)
          c.tm_keepalive = wheel_.Arm(
              id, kTmKeepalive, c.sn->sleep_until_ms + c.keepalive_ms);
          return;
        }
        if (c.sn->sleep_until_ms > base) base = c.sn->sleep_until_ms;
      }
      if (now - base >= c.keepalive_ms) {
        Drop(id, "keepalive_timeout", true);
        return;
      }
      c.tm_keepalive = wheel_.Arm(id, kTmKeepalive, base + c.keepalive_ms);
      return;
    }
    auto pit = parked_.find(id);
    if (pit == parked_.end()) return;
    park::Parked& p = park_slab_.at(pit->second);
    p.tm_keepalive = 0;
    if (!p.keepalive_ms) return;
    if (now - p.last_rx_ms >= p.keepalive_ms) {
      DropParked(id, "keepalive_timeout", true);
      return;
    }
    p.tm_keepalive =
        wheel_.Arm(id, kTmKeepalive, p.last_rx_ms + p.keepalive_ms);
  }

  void FirePark(uint64_t id) {
    auto it = conns_.find(id);
    if (it == conns_.end()) return;  // gone, or already parked
    Conn& c = it->second;
    c.tm_park = 0;
    if (!park_enabled_) return;
    uint64_t now = NowMs();
    uint64_t after = ParkAfterOf(c);
    uint64_t base = c.last_work_ms ? c.last_work_ms : c.last_rx_ms;
    if (now - base >= after && CanPark(c)) {
      Park(id, it);
      return;
    }
    // not idle enough (or mid-flight state blocks the diet): re-check
    // at the earliest possible park point
    c.tm_park = wheel_.Arm(
        id, kTmPark, (now - base >= after ? now : base) + after);
  }

  // Hibernation preconditions: everything the compact record cannot
  // carry must be empty/at-rest. Mid-flight ack windows ARE carried
  // (sparse summary); a queued-pending window or half-written outbuf
  // is not.
  bool CanPark(const Conn& c) const {
    // datagram conns never park: SN sleep mode already parks
    // deliveries, and a CoAP endpoint's message-layer state (dedup
    // window, observers, retransmit copies) has no compact summary
    if (c.sn || c.coap || c.traced || c.want_close || c.dirty)
      return false;
    if (!c.outbuf.empty() || c.outpos) return false;
    if (!c.framer.idle()) return false;
    if (c.ws && (!c.ws->open || !c.ws->dec.idle() || !c.ws->hs_buf.empty()))
      return false;
    if (c.ack && (!c.ack->pending.empty() || c.ack->cyc_dirty))
      return false;
    return true;
  }

  void Park(uint64_t id, std::unordered_map<uint64_t, Conn>::iterator it) {
    Conn& c = it->second;
    uint32_t slot = park_slab_.Alloc();
    park::Parked& p = park_slab_.at(slot);
    p.fd = c.fd;
    p.flags = (c.fast ? park::kPkFast : 0) |
              (c.ws ? park::kPkWs : 0) |
              (c.fd < 0 ? park::kPkSynth : 0);
    p.proto_ver = c.proto_ver;
    p.max_inflight = c.max_inflight;
    p.keepalive_ms = c.keepalive_ms;
    p.last_rx_ms = c.last_rx_ms;
    p.tm_keepalive = c.tm_keepalive;  // survives hibernation
    p.next_pid = kNativePidBase;
    if (c.ack) {
      // the 20KB bitmap AckState collapses to a sparse summary; the
      // window is INTACT across park/inflate (pids, qos2/rel phase,
      // publisher awaiting-rel, pid allocator position)
      AckState& a = *c.ack;
      p.next_pid = a.next_pid;
      if (a.inflight_cnt) {
        p.infl.reserve(a.inflight_cnt);
        for (uint32_t w = 0; w < 512; w++) {
          uint64_t bits = a.inflight[w];
          while (bits) {
            uint32_t b = static_cast<uint32_t>(__builtin_ctzll(bits));
            bits &= bits - 1;
            uint32_t bi = w * 64 + b;
            uint32_t e = bi;
            if (BitTest(a.infl_qos2, bi)) e |= 1u << 16;
            if (BitTest(a.infl_rel, bi)) e |= 1u << 17;
            p.infl.push_back(e);
          }
        }
      }
      if (a.awaiting_cnt) {
        p.awrel.reserve(a.awaiting_cnt);
        for (uint32_t w = 0; w < 1024; w++) {
          uint64_t bits = a.awaiting_rel[w];
          while (bits) {
            uint32_t b = static_cast<uint32_t>(__builtin_ctzll(bits));
            bits &= bits - 1;
            p.awrel.push_back(static_cast<uint16_t>(w * 64 + b));
          }
        }
      }
    }
    // subscriptions stay LIVE in the match table (a delivery to a
    // parked conn re-inflates it); only the teardown bookkeeping moves
    p.own_subs = std::move(c.own_subs);
    p.own_shared = std::move(c.own_shared);
    // permits are a cache: dropped here, re-earned through one punt
    // after the conn wakes (the authz-cache-miss path, always correct)
    parked_bytes_.fetch_add(park::RecordBytes(p),
                            std::memory_order_relaxed);
    parked_.emplace(id, slot);
    conns_.erase(it);
    stats_[kStConnsParked].fetch_add(1, std::memory_order_relaxed);
  }

  // Re-inflate a hibernating conn (first byte, delivery, control op).
  // Returns conns_.end() when the id is not parked either.
  std::unordered_map<uint64_t, Conn>::iterator InflateParked(uint64_t id) {
    auto pit = parked_.find(id);
    if (pit == parked_.end()) return conns_.end();
    uint32_t slot = pit->second;
    park::Parked& p = park_slab_.at(slot);
    size_t rec_bytes = park::RecordBytes(p);
    Conn c;
    c.fd = p.fd;
    c.framer = Framer(max_size_);
    c.fast = (p.flags & park::kPkFast) != 0;
    c.proto_ver = p.proto_ver;
    if (p.max_inflight) c.max_inflight = p.max_inflight;
    c.keepalive_ms = p.keepalive_ms;
    c.tm_keepalive = p.tm_keepalive;
    c.last_rx_ms = p.last_rx_ms;
    c.last_work_ms = NowMs();  // inflation IS work: no instant re-park
    if (p.flags & park::kPkWs) {
      c.ws = std::make_unique<WsConnState>();
      c.ws->open = true;
    }
    if (!p.infl.empty() || !p.awrel.empty() ||
        (p.next_pid && p.next_pid != kNativePidBase)) {
      c.ack = std::make_unique<AckState>();
      AckState& a = *c.ack;
      a.next_pid = p.next_pid ? p.next_pid : kNativePidBase;
      for (uint32_t e : p.infl) {
        uint32_t bi = e & 0xFFFFu;
        BitSet(a.inflight, bi);
        if (e & (1u << 16)) BitSet(a.infl_qos2, bi);
        if (e & (1u << 17)) BitSet(a.infl_rel, bi);
        a.inflight_cnt++;
      }
      for (uint16_t pidv : p.awrel) {
        BitSet(a.awaiting_rel, pidv);
        a.awaiting_cnt++;
      }
    }
    c.own_subs = std::move(p.own_subs);
    c.own_shared = std::move(p.own_shared);
    parked_bytes_.fetch_sub(rec_bytes, std::memory_order_relaxed);
    park_slab_.Free(slot);
    parked_.erase(pit);
    auto it = conns_.emplace(id, std::move(c)).first;
    if (park_enabled_)
      it->second.tm_park =
          wheel_.Arm(id, kTmPark, NowMs() + ParkAfterOf(it->second));
    stats_[kStConnsInflated].fetch_add(1, std::memory_order_relaxed);
    return it;
  }

  // Inflate-on-demand lookup: delivery/egress/control paths resolve a
  // conn that may be hibernating.
  std::unordered_map<uint64_t, Conn>::iterator FindConnInflate(uint64_t id) {
    auto it = conns_.find(id);
    if (it != conns_.end()) return it;
    return InflateParked(id);
  }

  // Tear a parked conn down without inflating it (keepalive expiry,
  // close_conn, socket death while hibernating).
  void DropParked(uint64_t id, const char* reason, bool notify) {
    auto pit = parked_.find(id);
    if (pit == parked_.end()) return;
    park::Parked& p = park_slab_.at(pit->second);
    for (const std::string& filt : p.own_subs) subs_.Remove(id, filt);
    for (const auto& [token, filt] : p.own_shared)
      subs_.SharedRemove(token, id, filt);
    if (p.tm_keepalive) wheel_.Cancel(p.tm_keepalive);
    if (p.fd >= 0) {
      epoll_ctl(epoll_fd_, EPOLL_CTL_DEL, p.fd, nullptr);
      close(p.fd);
    }
    parked_bytes_.fetch_sub(park::RecordBytes(p),
                            std::memory_order_relaxed);
    park_slab_.Free(pit->second);
    parked_.erase(pit);
    conn_cids_.erase(id);
    if (notify)
      events_.push_back(EncodeRecord(3, id, reason, strlen(reason)));
  }

  // Inbound bytes on a hibernating conn. The keepalive fast path —
  // reads that are nothing but whole PINGREQs — answers from the
  // parked record and STAYS parked, so a million idle-but-pinging
  // devices never churn the park plane; anything else re-inflates
  // before a single fast-path byte is processed.
  void ParkedRead(uint64_t id, uint32_t slot) {
    park::Parked& p = park_slab_.at(slot);
    if (p.fd < 0) return;  // synthetic conns have no socket
    if (p.flags & park::kPkWs) {
      // WS pings arrive framed — not worth a parked-path codec; the
      // inflation cost is one WsConnState + a fresh decoder
      auto it = InflateParked(id);
      if (it != conns_.end()) Read(id, it->second);
      return;
    }
    uint8_t buf[512];
    for (;;) {
      // @fault(conn_read) — the same read seam as Read(): park-during-
      // storm chaos hits hibernating conns too
      ssize_t n = FaultRecv(fault::kSiteConnRead, id, p.fd, buf,
                            sizeof(buf));
      if (n == 0) {
        DropParked(id, "sock_closed", true);
        return;
      }
      if (n < 0) {
        if (errno == EINTR) continue;
        if (errno != EAGAIN && errno != EWOULDBLOCK)
          DropParked(id, "sock_error", true);
        return;
      }
      p.last_rx_ms = NowMs();
      bool all_ping = (n % 2) == 0;
      for (ssize_t i = 0; all_ping && i < n; i += 2)
        all_ping = buf[i] == 0xC0 && buf[i + 1] == 0x00;
      if (!all_ping) {
        // real work: inflate FIRST, then run the normal ingest over
        // these bytes and drain whatever else the kernel holds
        auto it = InflateParked(id);
        if (it == conns_.end()) return;
        if (!IngestMqtt(id, it->second, buf, static_cast<size_t>(n))) {
          Drop(id, "frame_error", true);
          return;
        }
        auto again = conns_.find(id);
        if (again != conns_.end()) Read(id, again->second);
        return;
      }
      size_t k = static_cast<size_t>(n) / 2;
      std::string pong(k * 2, '\0');
      for (size_t i = 0; i < k; i++)
        pong[2 * i] = static_cast<char>(0xD0);
      size_t off = 0;
      while (off < pong.size()) {
        // @fault(conn_write) — the parked egress seam
        ssize_t w = FaultSend(fault::kSiteConnWrite, id, p.fd,
                              pong.data() + off, pong.size() - off);
        if (w > 0) {
          off += static_cast<size_t>(w);
          continue;
        }
        if (w < 0 && errno == EINTR) continue;
        if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          // slow reader: inflate and let the outbuf machinery own it
          auto it = InflateParked(id);
          if (it == conns_.end()) return;
          it->second.outbuf.append(pong, off, std::string::npos);
          MarkDirty(id, it->second);
          Flush(id, it->second);
          return;
        }
        DropParked(id, "sock_error", true);
        return;
      }
      stats_[kStParkedPings].fetch_add(k, std::memory_order_relaxed);
      if (n < static_cast<ssize_t>(sizeof(buf))) return;
    }
  }

  // Bench/test surface (raw host only): conjure n resident conns with
  // no socket (fd < 0; egress is discarded) so the conn-scale
  // structures — wheel, park plane, match table — run at 10^6 scale
  // inside a 20k-fd container. Every conn takes the REAL park
  // machinery; none emits OPEN events (the Python server never sees
  // these ids — this is not a product path).
  void SynthConns(uint32_t n, uint32_t keepalive_ms, uint32_t sub_every,
                  const std::string& prefix) {
    uint64_t now = NowMs();
    std::string filt;
    for (uint32_t i = 0; i < n; i++) {
      // the synthetic herd respects the same admission budget
      if (!gov_.Admit(ConnMemEstimate() + kConnResidentEstBytes)) {
        stats_[kStConnsShed].fetch_add(1, std::memory_order_relaxed);
        LedgerNote(kLrAcceptShed, conns_.size() + parked_.size());
        continue;
      }
      uint64_t id = MintConnId();
      Conn c;
      c.fd = -1;
      c.framer = Framer(max_size_);
      c.fast = true;
      c.last_rx_ms = c.last_work_ms = now;
      c.keepalive_ms = keepalive_ms;
      auto& cref = conns_.emplace(id, std::move(c)).first->second;
      if (keepalive_ms)
        cref.tm_keepalive =
            wheel_.Arm(id, kTmKeepalive, now + keepalive_ms);
      if (park_enabled_)
        cref.tm_park = wheel_.Arm(id, kTmPark, now + ParkAfterOf(cref));
      if (sub_every && (i % sub_every) == 0) {
        filt = prefix;
        filt += '/';
        filt += std::to_string(id & 0xFFFFFFFFFFFFull);
        subs_.Add(id, filt, 0, 0);
        cref.own_subs.push_back(filt);
      }
    }
  }

  // Per-conn qos1-over-UDP retransmit: the old SnRexmitScan body for
  // ONE conn, driven by its wheel deadline instead of a per-cycle
  // sweep over every tracked conn.
  void FireSnRexmit(uint64_t id) {
    auto cit = conns_.find(id);
    if (cit == conns_.end() || !cit->second.sn) return;
    Conn& c = cit->second;
    c.sn->tm_rexmit = 0;
    if (c.sn->rexmit.empty()) return;
    if (!c.sn->awake) {
      // announced sleep (§6.14): the radio is off, so neither the
      // retry timer nor the abandonment counter may advance — the
      // parked sleep_buf copy is this delivery's FIRST transmission,
      // sent at wake, and the wake flush re-arms this timer there
      // (the PR 6 retry-clock lesson)
      return;
    }
    uint64_t now = NowMs();
    uint64_t next_due = 0;
    bool resent = false;
    auto& rx = c.sn->rexmit;
    for (size_t i = 0; i < rx.size();) {
      SnInflightRx& r = rx[i];
      if (now - r.last_tx_ms < kSnRetryMs) {
        uint64_t due = r.last_tx_ms + kSnRetryMs;
        if (!next_due || due < next_due) next_due = due;
        i++;
        continue;
      }
      if (r.tries >= kSnMaxRetries) {
        if (c.ack) {
          AckState& a = *c.ack;
          uint32_t bi = r.pid - kNativePidBase;
          if (BitTest(a.inflight, bi)) {
            BitClr(a.inflight, bi);
            a.inflight_cnt--;
            a.cyc_acked++;
            AckNote(id, a);
          }
        }
        stats_[kStDropsInflight].fetch_add(1, std::memory_order_relaxed);
        rx[i] = std::move(rx.back());
        rx.pop_back();
        continue;
      }
      r.dgram[r.flags_off] = static_cast<char>(
          static_cast<uint8_t>(r.dgram[r.flags_off]) | sn::kFDup);
      c.outbuf += r.dgram;
      MarkDirty(id, c);
      resent = true;
      r.last_tx_ms = now;
      r.tries++;
      uint64_t due = now + kSnRetryMs;
      if (!next_due || due < next_due) next_due = due;
      i++;
    }
    if (c.ack) DrainPending(id, c);  // abandoned slots pull the queue
    // DrainPending may have tracked a fresh delivery (SnRexmitTrack
    // arms the timer it found zeroed): never double-arm over it
    if (!rx.empty() && next_due && !c.sn->tm_rexmit)
      c.sn->tm_rexmit = wheel_.Arm(id, kTmSnRexmit, next_due);
    if (resent) FlushDirty();
  }

  // Trunk silent-link watchdog: the old per-cycle TrunkAckScan sweep,
  // now fired per peer from the wheel against the live ring front.
  void FireTrunkAck(uint64_t peer_id) {
    auto it = trunk_peers_.find(peer_id);
    if (it == trunk_peers_.end()) return;
    trunk::Peer& p = it->second;
    p.tm_ack = 0;
    if (!trunk_ack_timeout_ms_ || !p.up || !p.sock_tag ||
        p.unacked.empty())
      return;  // re-armed by the next flush/replay re-stamp
    uint64_t due = p.unacked.front().flush_ms + trunk_ack_timeout_ms_;
    uint64_t now = NowMs();
    if (now >= due) {
      TrunkSockDead(p.sock_tag, "ack_timeout");
      return;
    }
    p.tm_ack = wheel_.Arm(peer_id, kTmTrunkAck, due);
  }

  // Arm the watchdog when the ring front (re)gains its reference
  // stamp; a fire against a younger front simply re-arms.
  void TrunkAckWatch(uint64_t peer_id, trunk::Peer& p) {
    if (!trunk_ack_timeout_ms_ || p.tm_ack || p.unacked.empty()) return;
    p.tm_ack = wheel_.Arm(
        peer_id, kTmTrunkAck,
        p.unacked.front().flush_ms + trunk_ack_timeout_ms_);
  }

  void Read(uint64_t id, Conn& c) {
    uint8_t chunk[kReadChunk];
    c.last_rx_ms = NowMs();
    for (;;) {
      // @fault(conn_read) — errno/blackhole injection on the conn recv
      ssize_t n = FaultRecv(fault::kSiteConnRead, id, c.fd, chunk,
                            sizeof(chunk));
      if (n > 0) {
        bool ok;
        if (c.ws) {
          ok = WsIngest(id, c, chunk, static_cast<size_t>(n));
        } else {
          ok = IngestMqtt(id, c, chunk, static_cast<size_t>(n));
          if (!ok) Drop(id, "frame_error", true);
        }
        if (!ok) break;  // conn dropped (or closing); c is dead
        if (static_cast<size_t>(n) < sizeof(chunk)) break;
      } else if (n == 0) {
        Drop(id, "sock_closed", true);
        break;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        if (errno == EINTR) continue;
        Drop(id, "sock_error", true);
        break;
      }
    }
    FlushDirty();
  }

  // Feed post-transport MQTT bytes into the frame scanner + fast path.
  // Returns false on a framing error (poisoned framer state). Does NOT
  // Drop: the WS path calls this from inside WsDecoder::Feed, and a
  // Drop there would destroy the decoder whose stack frame is still
  // live — callers drop AFTER the codec has unwound.
  bool IngestMqtt(uint64_t id, Conn& c, const uint8_t* data, size_t len) {
    std::vector<std::string> frames;
    FrameStatus st = c.framer.Feed(data, len, &frames);
    for (auto& f : frames) {
      // park-after clock: any frame but PINGREQ is WORK (keepalive
      // pings keep the conn alive without keeping it resident)
      if ((static_cast<uint8_t>(f[0]) >> 4) != 12)
        c.last_work_ms = c.last_rx_ms;
      if (!c.fast || !TryFast(id, c, f)) {
        // flight recorder: a frame bound for Python is a PUNT when the
        // conn was fast-eligible, a plain slow-plane FRAME otherwise
        FrNote(c, c.fast ? kFrPunt : kFrFrame,
               static_cast<uint8_t>(f[0]) >> 4,
               static_cast<uint16_t>(f.size() & 0xFFFF));
        events_.push_back(EncodeRecord(2, id, f.data(), f.size()));
      }
    }
    return st == FrameStatus::kOk;
  }

  // WS transport ingest: HTTP upgrade first, then the RFC6455 codec in
  // front of IngestMqtt (`data` is mutable: masked payloads unmask in
  // place). Returns false when the conn is gone.
  bool WsIngest(uint64_t id, Conn& c, uint8_t* data, size_t len) {
    WsConnState& w = *c.ws;
    if (!w.open) {
      w.hs_buf.append(reinterpret_cast<const char*>(data), len);
      size_t hdr_end = w.hs_buf.find("\r\n\r\n");
      if (hdr_end == std::string::npos) {
        if (w.hs_buf.size() > 16384) {  // runaway pre-upgrade request
          Drop(id, "ws_handshake_overflow", true);
          return false;
        }
        return true;
      }
      std::string key, path;
      bool mqtt_proto = false;
      bool ok = ws::ParseUpgradeRequest(
          std::string_view(w.hs_buf).substr(0, hdr_end + 4), &key, &path,
          &mqtt_proto);
      if (!ok || (!ws_path_.empty() && path != ws_path_)) {
        // same terminal answer as the asyncio oracle: 400, close. A
        // non-/mqtt target is NOT served here — deployments keep the
        // asyncio WS listener for any other endpoint.
        stats_[kStWsRejects].fetch_add(1, std::memory_order_relaxed);
        c.outbuf += ws::Build400();
        Flush(id, c);
        if (conns_.count(id)) Drop(id, "ws_handshake", true);
        return false;
      }
      c.outbuf += ws::BuildUpgradeResponse(ws::AcceptKey(key), mqtt_proto);
      MarkDirty(id, c);
      stats_[kStWsHandshakes].fetch_add(1, std::memory_order_relaxed);
      w.open = true;
      // a client may pipeline its first frames behind the request
      std::string leftover = w.hs_buf.substr(hdr_end + 4);
      w.hs_buf.clear();
      w.hs_buf.shrink_to_fit();
      if (leftover.empty()) return true;
      return WsDecode(id, c,
                      reinterpret_cast<uint8_t*>(&leftover[0]),
                      leftover.size());
    }
    return WsDecode(id, c, data, len);
  }

  // Sampled WS-ingest overhead: the decode+dispatch cost one read
  // chunk pays on the WS transport (the TCP path feeds IngestMqtt
  // directly, so this stage is what RFC6455 adds to the plane).
  bool WsDecode(uint64_t id, Conn& c, uint8_t* data, size_t len) {
    if (telemetry_ && ((++tele_tick_ws_ & tele_mask_) == 0)) {
      uint64_t t0 = NowNs();
      bool ok = WsDecodeInner(id, c, data, len);
      RecordHist(kHistWsIngest, NowNs() - t0);
      return ok;
    }
    return WsDecodeInner(id, c, data, len);
  }

  bool WsDecodeInner(uint64_t id, Conn& c, uint8_t* data, size_t len) {
    bool mqtt_err = false, closing = false;
    ws::WsStatus st = c.ws->dec.Feed(
        data, len,
        [&](const char* p, size_t n) {
          // data payload bytes ARE the MQTT byte stream (packets need
          // not align with WS frames — MQTT 5 §6.0); fragments
          // reassemble by arriving here in order. A framing error only
          // FLAGS here: the Drop must wait until Feed has unwound (it
          // would destroy the decoder running this very callback).
          if (n && !IngestMqtt(id, c,
                               reinterpret_cast<const uint8_t*>(p), n)) {
            mqtt_err = true;
            return false;
          }
          return true;
        },
        [&](uint8_t op, const char* p, size_t n) {
          if (op == ws::kOpPing) {  // pong echoes the ping payload
            ws::AppendFrameHeader(&c.outbuf, ws::kOpPong, n);
            c.outbuf.append(p, n);
            MarkDirty(id, c);
            stats_[kStWsPings].fetch_add(1, std::memory_order_relaxed);
            return true;
          }
          if (op == ws::kOpClose) {
            // echo the close (status code included) and tear down
            ws::AppendFrameHeader(&c.outbuf, ws::kOpClose, n);
            c.outbuf.append(p, n);
            stats_[kStWsCloses].fetch_add(1, std::memory_order_relaxed);
            closing = true;
            return false;
          }
          return true;  // pong: keepalive evidence only
        });
    if (mqtt_err) {  // decoder is off the stack now: safe to tear down
      Drop(id, "frame_error", true);
      return false;
    }
    if (closing || st != ws::WsStatus::kOk) {
      if (!closing) {
        // protocol error: best-effort close frame with the oracle's
        // codes (1002 protocol error / 1009 too big), then drop
        uint16_t code = st == ws::WsStatus::kCtrlTooBig ? 1009 : 1002;
        char body[2] = {static_cast<char>(code >> 8),
                        static_cast<char>(code & 0xFF)};
        ws::AppendFrameHeader(&c.outbuf, ws::kOpClose, 2);
        c.outbuf.append(body, 2);
      }
      Flush(id, c);  // may itself Drop on sock_error
      if (conns_.count(id))
        Drop(id, closing ? "ws_close" : "ws_error", true);
      return false;
    }
    return true;
  }

  // Flush every connection the fast path appended to during this read
  // batch — one send() per touched subscriber instead of one per
  // delivered message.
  void FlushDirty() {
    // durable batch FIRST: the qos1 publisher's PUBACK (and every
    // fast delivery of this read batch) reaches the wire only after
    // the matching store append — and its policy fsync — landed, so a
    // kill -9 can never ack a message the store lost
    FlushDurables();
    // the SAME discipline for trunk-routed qos1 (round 18): a dirty
    // peer batch holding elevated entries seals NOW — its replay
    // record journals into the store (TrunkPut + policy fsync) before
    // any socket write of this read batch, so the publisher's PUBACK
    // can never outrun the ring record a post-kill replay needs.
    // qos0-only batches keep the cheaper cycle-end seal (nothing to
    // replay, nothing a crash could lose that the contract covers).
    if (store_ && !trunk_dirty_.empty()) {
      for (uint64_t peer_id : trunk_dirty_) {
        auto it = trunk_peers_.find(peer_id);
        if (it != trunk_peers_.end() && it->second.q1_n) {
          FlushTrunks();
          break;
        }
      }
    }
    if (dirty_.empty()) {
      flush_t0_ = 0;  // sampled publish had no targets: no flush stage
      return;
    }
    std::vector<uint64_t> dirty;
    dirty.swap(dirty_);
    for (uint64_t id : dirty) {
      auto it = conns_.find(id);
      if (it == conns_.end()) continue;
      it->second.dirty = false;
      Flush(id, it->second);
      // a stalled SN outbuf (sendmmsg EAGAIN on the shared UDP fd) has
      // no per-conn EPOLLOUT to re-arm the way TCP's Flush does —
      // re-queue it so the next poll cycle retries, or a want_close
      // teardown would wait forever on unrelated traffic. Re-find: the
      // Flush may have Dropped the conn.
      auto rt = conns_.find(id);
      if (rt != conns_.end() && rt->second.sn &&
          rt->second.outpos < rt->second.outbuf.size())
        MarkDirty(id, rt->second);
    }
    if (flush_t0_) {
      RecordHist(kHistRouteFlush, NowNs() - flush_t0_);
      flush_t0_ = 0;
    }
  }

  // -- fast path ----------------------------------------------------------

  // Returns true when the frame was fully handled natively (consumed);
  // false forwards it to Python (the slow path), which is always safe.
  bool TryFast(uint64_t id, Conn& c, const std::string& f) {
    // per-frame trace context: an ack frame's DrainPending (and any
    // other delivery this frame triggers) must not inherit the LAST
    // publish's sampled id
    cur_trace_ = 0;
    uint8_t h = static_cast<uint8_t>(f[0]);
    uint8_t type = h >> 4;
    if (type == 4) return TryFastPuback(id, c, f);
    if (type == 5) return TryFastPubrec(id, c, f);
    if (type == 6) return TryFastPubrel(id, c, f);
    if (type == 7) return TryFastPubcomp(id, c, f);
    if (type != 3) return false;  // PUBLISH + the four ack types only
    // sampled ingress->route stamp (1-in-8): a NowNs per message would
    // be a measurable tax at 7 figures/s; the ticker is global so a
    // deterministic share of walk-path publishes lands in the histogram
    uint64_t t_in = 0;
    if (telemetry_ && ((++tele_tick_ & tele_mask_) == 0)) t_in = NowNs();
    uint8_t qos = (h >> 1) & 3;
    bool retain = h & 1;
    if (qos > 2 || retain) return false;  // malformed qos / retained
    if (qos > max_qos_allowed_) return false;  // over-cap publish must
    // reach the channel, which answers with DISCONNECT 0x9B
    // ([MQTT-3.2.2-11]) instead of a native ack
    // parse: [h][varint remaining][topic u16][pid? u16][props? varint][payload]
    size_t pos = 1;
    while (pos < f.size() && (static_cast<uint8_t>(f[pos]) & 0x80)) pos++;
    pos++;  // last varint byte (framer already validated the length)
    if (pos + 2 > f.size()) return false;
    uint16_t tlen = (static_cast<uint8_t>(f[pos]) << 8) |
                    static_cast<uint8_t>(f[pos + 1]);
    pos += 2;
    if (pos + tlen > f.size() || tlen == 0) return false;
    std::string_view topic(f.data() + pos, tlen);
    pos += tlen;
    if (topic[0] == '$') return false;  // $SYS / $delayed / ...: Python
    for (char ch : topic)
      if (ch == '+' || ch == '#' || ch == '\0') return false;  // invalid name
    uint16_t pid = 0;
    if (qos >= 1) {
      if (pos + 2 > f.size()) return false;
      pid = (static_cast<uint8_t>(f[pos]) << 8) |
            static_cast<uint8_t>(f[pos + 1]);
      pos += 2;
    }
    if (c.proto_ver == 5) {
      // fast path requires an empty property section: a topic alias,
      // message expiry or response topic needs the Python channel
      if (pos >= f.size() || f[pos] != 0) return false;
      pos++;
    }
    std::string_view payload(f.data() + pos, f.size() - pos);
    // one hash per publish, shared by every FrNote it triggers (the
    // per-delivery rehash was part of the telemetry tax)
    if (telemetry_) cur_hash_ = TopicHash(topic);
    if (qos == 2) {
      if (c.ack && BitTest(c.ack->awaiting_rel, pid)) {
        // retransmit of an exchange WE own (dup while awaiting PUBREL):
        // re-answer PUBREC, no second delivery [MQTT-4.3.3]. Checked
        // before the permit so a mid-exchange permit flush cannot hand
        // the id to Python for a double publish.
        char rec[4] = {0x50, 0x02, static_cast<char>(pid >> 8),
                       static_cast<char>(pid & 0xFF)};
        AppendMqtt(c, rec, 4);
        MarkDirty(id, c);
        return true;
      }
      if (h & 0x08) {
        // DUP retransmit of an exchange we do NOT own: the original
        // ran on the Python plane (e.g. it earned this very permit),
        // whose session holds the awaiting-rel state — fast-pathing it
        // as a fresh publish would deliver a second copy. Forward, and
        // the session re-answers PUBREC from its own dedup.
        return false;
      }
    }
    if (c.traced) {
      // TraceManager attached to this client: every publish must run
      // the Python plane so the hook fold (and the trace log) sees it.
      // Checked AFTER the awaiting-rel dedup above — a mid-exchange
      // trace must not hand an owned qos2 id to Python — and BEFORE
      // the permit, which may still be installed when the trace races
      // the permit flush.
      stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
      stats_[kStPuntsTrace].fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    key_scratch_.assign(topic.data(), topic.size());  // no per-msg alloc
    if (c.permits.find(key_scratch_) == c.permits.end())
      return false;  // unpermitted topic: full Python path (authz, rules)
    if (lane_enabled_ && qos == 2) {
      // qos2 never parks on the lane (its exchange state lives here);
      // with same-topic frames already parked, a walk delivery would
      // overtake them — poison the topic so the parked frames punt and
      // everything for it serializes through the Python FIFO
      auto tp = lane_topic_pending_.find(key_scratch_);
      if (tp != lane_topic_pending_.end()) {
        lane_poisoned_.insert(key_scratch_);
        c.permits.erase(key_scratch_);
        stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
        return false;
      }
      // no parked frames: fall through to the per-message walk below
    } else if (lane_enabled_) {
      // device lane: park the frame, ship the topic to the batched
      // device matcher. A topic with entries already in flight MUST
      // stay on the lane (a walk here would overtake them); new topics
      // spill to the walk once the lane is soft-capped.
      auto tp = lane_topic_pending_.find(key_scratch_);
      bool topic_in_flight = tp != lane_topic_pending_.end();
      if (topic_in_flight && tp->second >= kLaneTopicMax) {
        // distinct counter (NOT folded into drops_backpressure):
        // operators must be able to tell inbound per-topic lane
        // overload from subscriber delivery backpressure; Python logs
        // on every advance (native_server._merge_fast_metrics)
        stats_[kStLaneTopicOverflow].fetch_add(1,
                                               std::memory_order_relaxed);
        if (telemetry_)
          FrNote(c, kFrDrop, 3, qos, cur_hash_);
        return true;  // consumed: dropped under per-topic lane overload
      }
      if (!topic_in_flight && !punt_subs_.Empty()) {
        // known punt audience: the device verdict can only be "punt" —
        // skip the round trip and punt synchronously like the walk.
        // Topics with entries in flight stay on the lane (ordering).
        punt_scratch_.clear();
        punt_subs_.Match(topic, &punt_scratch_);
        bool must_punt = false;
        for (const SubEntry* pe : punt_scratch_) {
          // lane+trunk coexistence (round 12, carried edge): an
          // ELIGIBLE remote audience no longer forces the Python
          // path — the frame parks on the lane and LaneDeliver trunks
          // the remote leg next to the device-matched local fan-out.
          // Anything else in the punt trie (real punt markers, a down
          // trunk, qos2) still punts like before.
          if (!(pe->flags & kSubRemote)) {
            must_punt = true;
            break;
          }
          uint64_t peer = pe->owner - kTrunkOwnerBase;
          if (!TrunkEligible(peer, qos,
                             15 + topic.size() + payload.size())) {
            LedgerNote(kLrTrunkPunt, peer);
            must_punt = true;
            break;
          }
        }
        if (must_punt) {
          stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
          return false;
        }
      }
      if (topic_in_flight || lane_pending_.size() < kLaneSoftMax) {
        uint64_t seq = lane_seq_++;
        LaneEntry le;
        le.publisher = id;
        le.qos = qos;
        le.pid = pid;
        le.enq_ms = NowMs();
        le.topic_off = static_cast<uint32_t>(topic.data() - f.data());
        le.topic_len = static_cast<uint32_t>(topic.size());
        le.payload_off = static_cast<uint32_t>(pos);
        le.frame = f;
        stats_[kStLaneIn].fetch_add(1, std::memory_order_relaxed);
        if (telemetry_)  // arg2=1 marks a lane park, not a walk
          FrNote(c, kFrFastPub, 3, qos, cur_hash_, 1);
        events_.push_back(
            EncodeRecord(4, seq, topic.data(), topic.size()));
        LaneEnqueue(seq, std::move(le));
        return true;
      }
      stats_[kStLaneFallback].fetch_add(1, std::memory_order_relaxed);
      // fall through: the per-message walk serves this one
    }
    match_scratch_.clear();
    groups_scratch_.clear();
    subs_.Match(topic, &match_scratch_, &groups_scratch_);
    bool tapped = false;
    trunk_scratch_.clear();
    for (const SubEntry* e : match_scratch_) {
      if (e->flags & kSubPunt) {
        // a mixed/foreign shared group / persistent session /
        // non-native subscriber matched: Python must run the WHOLE
        // fan-out (it re-matches and delivers natively-served
        // subscribers too — and its hook fold runs the rules, so no
        // tap copy is emitted for punted frames)
        stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
        return false;
      }
      if (e->flags & kSubDurable) {
        // durable audience: FanOut persists the publish below the GIL
        // and the fast path proceeds. No attached store means Python
        // misconfigured the flip — degrade to a punt (always correct).
        if (!store_) {
          stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
          return false;
        }
        continue;
      }
      if (e->flags & kSubRuleTap) {
        tapped = true;
        continue;
      }
      if (e->flags & kSubRemote) {
        // remote entry (round 9): the peer's trunk carries this leg —
        // unless the trunk is down, the qos1 replay ring is full, or
        // the publish is qos2 (exactly-once spans two nodes' session
        // state), in which case the entry degrades to a punt marker
        // and Python's forward_fn lane carries the message. Decided
        // BEFORE any side effect: a partial native fan-out followed by
        // a punt would double-deliver the local audience. Non-trunk
        // shards consult their link-state mirror; the leg itself rides
        // the ring to shard 0 (TrunkEligible).
        uint64_t peer = e->owner - kTrunkOwnerBase;
        if (!TrunkEligible(peer, qos,
                           15 + topic.size() + payload.size())) {
          stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
          LedgerNote(kLrTrunkPunt, peer);
          return false;
        }
        PushUnique(&trunk_scratch_, peer);
        continue;
      }
    }
    if (!ShardAdmit()) {
      // a destination shard's ring cannot take this publish: the whole
      // fan-out degrades ring-full -> punt -> Python BEFORE any side
      // effect (the trunk-down ladder; ordering across the boundary is
      // best-effort, same as the trunk's)
      stats_[kStPunts].fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    if (qos == 2) {
      AckState& a = EnsureAck(c);
      if (a.awaiting_cnt >= kMaxAwaitingRel)
        return false;  // table full: Python enforces the quota answer
      // record BEFORE the fan-out: the exchange is owned from the
      // moment we decide to deliver (a dup racing the fan-out must
      // dedup against it)
      BitSet(a.awaiting_rel, pid);
      a.awaiting_cnt++;
      AckNote(id, a);
      stats_[kStQos2In].fetch_add(1, std::memory_order_relaxed);
    } else if (qos == 1) {
      stats_[kStQos1In].fetch_add(1, std::memory_order_relaxed);
    }
    // the sampling commit point: every punt decision is behind us, so
    // the tick counts exactly the natively-consumed publishes
    TraceSample(id);
    if (tapped) EmitTap(id, qos, (h & 0x08) != 0, topic, payload);
    cur_dup_ = (h & 0x08) != 0;  // durable entries keep the DUP bit
    FanOut(id, qos, pid, topic, payload);
    if (cur_trace_) SpanNote(kSpanRoute, match_scratch_.size());
    // remote legs last: the local fan-out above and the trunk enqueue
    // below are the two halves of emqx_broker:publish's route loop.
    // Non-owner shards ship the leg to the peer's OWNER shard over the
    // ring (target = the trunk owner-namespace id, the scheme the conn
    // prefix reuses; round 15 spread the owners across shards).
    for (uint64_t peer : trunk_scratch_) {
      if (OwnsTrunkPeer(peer))
        TrunkEnqueue(peer, id, qos, (h & 0x08) != 0, topic, payload);
      else
        XShip(TrunkShardOf(peer), kTrunkOwnerBase + peer, id, qos,
              (h & 0x08) != 0, topic, payload);
    }
    if (telemetry_) {
      FrNote(c, kFrFastPub, 3, qos, cur_hash_);
      // cross-plane legs on the publisher's recorder (round 13): the
      // FR used to go blind once a publish left its shard
      if (fan_xshipped_)
        FrNote(c, kFrRingCross, 3,
               static_cast<uint16_t>(fan_xshipped_), cur_hash_);
      if (!trunk_scratch_.empty())
        FrNote(c, kFrTrunk, 3,
               static_cast<uint16_t>(trunk_scratch_[0] & 0xFFFF),
               cur_hash_);
      if (t_in) {
        uint64_t t1 = NowNs();
        RecordHist(kHistIngressRoute, t1 - t_in);
        // the same sampled message anchors the route->flush stage;
        // FlushDirty closes it when this read batch hits the socket
        if (!flush_t0_) flush_t0_ = t1;
      }
    }
    return true;
  }

  // Hand a natively-served publish to the rule runtime (kSubRuleTap
  // matched): delivery already happened in C++; Python only evaluates
  // the rules against it, asynchronously. Entries BATCH into one event
  // record per poll cycle — a per-message record made Python's event
  // decode the data-plane bottleneck (measured: 1.7M -> 0.3M msg/s
  // under a FROM '#' rule). Round 7 copy elision (the remaining
  // rule-tap tax, BENCH_r05 rule_tap_vs_free=0.59): entries carry the
  // PRE-PARSED fields ([u64 publisher][u8 flags][u16 tlen][topic]
  // [u32 plen][payload]) instead of whole-frame copies, so the Python
  // worker never re-parses MQTT while the blast is live, and a payload
  // identical to the previous entry's is elided (flags bit0 = 0) — the
  // shared delivery frames were already built once per publish; the tap
  // plane now follows the same discipline. flags: bit0 = payload
  // inline, bits1-2 = qos, bit3 = publisher DUP.
  // @admit-gated — a tap copy is a side effect of an ADMITTED publish
  // @bounded(tap_buf_)
  void EmitTap(uint64_t publisher, uint8_t qos, bool dup_flag,
               std::string_view topic, std::string_view payload) {
    stats_[kStTaps].fetch_add(1, std::memory_order_relaxed);
    // flush BEFORE an append that would overflow the cap: the Python
    // poll buffer is max_size_+65600, and Poll silently drops any record
    // larger than the caller's whole buffer — a lost batch would be
    // hundreds of rule messages with no accounting. With this
    // discipline a record never exceeds max(cap, one max-size entry)
    // + 13, which always fits (framer bounds frames at max_size_).
    size_t cap = kTapFlushBytes;
    if (cap > max_size_ / 2) cap = max_size_ / 2 + 1;
    size_t entry_max = 15 + topic.size() + payload.size();
    if (tap_buf_.size() > 13 && tap_buf_.size() - 13 + entry_max > cap)
      FlushTaps();
    // header slot AFTER the flush check: a mid-batch flush empties the
    // buffer, and appending into it headerless would let FlushTaps
    // stamp the record header over the first entry (corrupt batch)
    if (tap_buf_.empty()) tap_buf_.assign(13, '\0');
    bool dup = tap_have_prev_ && payload == tap_prev_payload_;
    char hdr[11];
    memcpy(hdr, &publisher, 8);
    hdr[8] = static_cast<char>((dup ? 0 : 1) | (qos << 1)
                               | (dup_flag ? 8 : 0));
    uint16_t tl = static_cast<uint16_t>(topic.size());
    memcpy(hdr + 9, &tl, 2);
    tap_buf_.append(hdr, 11);
    tap_buf_.append(topic.data(), topic.size());
    if (!dup) {
      uint32_t pl = static_cast<uint32_t>(payload.size());
      tap_buf_.append(reinterpret_cast<const char*>(&pl), 4);
      tap_buf_.append(payload.data(), payload.size());
      tap_prev_payload_.assign(payload.data(), payload.size());
      tap_have_prev_ = true;
    }
    if (tap_buf_.size() - 13 > cap) FlushTaps();
  }

  void FlushTaps() {
    if (tap_buf_.size() <= 13) return;
    // patch the record header in place and MOVE the buffer out: the
    // batch is copied once (into the poll buffer), not re-copied
    // through EncodeRecord first
    tap_buf_[0] = 6;
    uint64_t id = 0;
    memcpy(&tap_buf_[1], &id, 8);
    uint32_t plen = static_cast<uint32_t>(tap_buf_.size() - 13);
    memcpy(&tap_buf_[9], &plen, 4);
    events_.push_back(std::move(tap_buf_));
    tap_buf_.clear();
    tap_have_prev_ = false;  // dedup never crosses a record boundary
  }

  AckState& EnsureAck(Conn& c) {
    if (!c.ack) c.ack = std::make_unique<AckState>();
    return *c.ack;
  }

  // Queue the conn for this cycle's batched ack record.
  void AckNote(uint64_t id, AckState& a) {
    if (!a.cyc_dirty) {
      a.cyc_dirty = true;
      ack_dirty_.push_back(id);
    }
  }

  // Write one PUBLISH to `owner` (qos = min(pub, sub)); returns whether
  // a delivery (or an elevated-qos queue admit) happened.
  bool DeliverTo(uint64_t owner, const SubEntry& e, uint64_t publisher,
                 uint8_t qos, std::string_view topic,
                 std::string_view payload) {
    // a delivery to a hibernating subscriber re-inflates it first
    auto it = FindConnInflate(owner);
    if (it == conns_.end()) return false;  // stale entry (conn mid-close)
    Conn& t = it->second;
    if (t.outbuf.size() - t.outpos > kHighWater) {
      stats_[kStDropsBackpressure].fetch_add(1, std::memory_order_relaxed);
      LedgerNote(kLrShed, owner);
      if (telemetry_) FrNote(t, kFrDrop, 3, 0, cur_hash_);
      return false;
    }
    uint8_t out_qos = qos < e.qos ? qos : e.qos;
    if (t.coap) {
      // observe notifies cap at qos1 (CON) and at the CoAP frame
      // limit; the oversize decision lands BEFORE any window slot is
      // allocated (the SN discipline — a slot with no deliverable
      // bytes would leak until conn death)
      if (out_qos > 1) out_qos = 1;
      if (payload.size() > coap::kMaxPayload) {
        stats_[kStCoapDropsOversize].fetch_add(1,
                                               std::memory_order_relaxed);
        return false;
      }
    }
    if (t.sn) {
      // SN subscribers take SN framing but the SAME window machinery;
      // deliveries cap at qos1 (the oracle's handle_deliver cap)
      if (out_qos == 0) {
        if (telemetry_) FrNote(t, kFrDeliver, 3, 0, cur_hash_);
        SnDeliverPublish(t, topic, payload, 0, false, false, 0);
      } else {
        int r = SnDeliverElevated(owner, t, topic, payload, false);
        if (r == 0) return false;
        if (r == 2) return true;  // parked; kStFastOut counts at dequeue
      }
      TraceDeliverNote(owner);
      stats_[kStFastOut].fetch_add(1, std::memory_order_relaxed);
      MarkDirty(owner, t);
      return true;
    }
    if (out_qos == 0) {
      std::string& shared = t.proto_ver == 5 ? frame_v5_ : frame_v4_;
      if (shared.empty())
        BuildPublish(&shared, topic, payload, 0, 0, t.proto_ver == 5);
      AppendMqtt(t, shared.data(), shared.size());
      stats_[kStFastBytesOut].fetch_add(shared.size(),
                                        std::memory_order_relaxed);
      if (telemetry_) FrNote(t, kFrDeliver, 3, 0, cur_hash_);
      TraceDeliverNote(owner);
    } else {
      AckState& a = EnsureAck(t);
      std::string& sq = t.proto_ver == 5 ? frame_q_v5_ : frame_q_v4_;
      size_t& qoff = t.proto_ver == 5 ? qpid_off_v5_ : qpid_off_v4_;
      if (sq.empty()) {
        // built once per publish: qos1 header, zero pid; per-target
        // the header qos bits and pid bytes are patched in place.
        // pid offset = header(1) + varint + topic len field(2) + topic
        BuildPublish(&sq, topic, payload, 1, 0, t.proto_ver == 5);
        size_t var_len = 1;
        while (static_cast<uint8_t>(sq[var_len]) & 0x80) var_len++;
        qoff = var_len + 1 + 2 + topic.size();
      }
      if (a.inflight_cnt >= t.max_inflight) {
        // receive window full: queue (the mqueue), drop on overflow
        if (a.pending.size() >= kMaxPending) {
          stats_[kStDropsInflight].fetch_add(1, std::memory_order_relaxed);
          if (telemetry_) FrNote(t, kFrDrop, 3, 1, cur_hash_);
          return false;
        }
        a.pending.emplace_back(sq, qoff);
        a.pending.back().first[0] =
            static_cast<char>(0x30 | (out_qos << 1));
        AckNote(owner, a);
        return true;   // admitted; kStFastOut counts at dequeue
      }
      uint16_t tp = NextPid(a);
      if (out_qos == 2) BitSet(a.infl_qos2, tp - kNativePidBase);
      if (telemetry_) {
        // ack-RTT sample (delivery write -> PUBACK/PUBCOMP): stamped
        // only while a slot is free, closed out in TeleAckRtt — it
        // also carries the active trace id so the ack span can close
        // the sampled publish's timeline
        if (a.rtt.size() < kRttSamples)
          a.rtt.push_back({NowNs(), std::string(topic), tp, out_qos,
                           cur_trace_});
        FrNote(t, kFrDeliver, 3, tp, cur_hash_);
        TraceDeliverNote(owner);
      }
      if (t.coap) {
        // CoAP conns cannot take raw MQTT bytes in the outbuf: patch
        // the shared frame in a scratch and run the egress translation
        // (-> a tracked CON notify carrying this pid)
        coap_pub_scratch_.assign(sq);
        coap_pub_scratch_[0] = static_cast<char>(0x30 | (out_qos << 1));
        coap_pub_scratch_[qoff] = static_cast<char>(tp >> 8);
        coap_pub_scratch_[qoff + 1] = static_cast<char>(tp & 0xFF);
        AppendMqtt(t, coap_pub_scratch_.data(), coap_pub_scratch_.size());
      } else {
        if (t.ws)  // frame header first so `at` lands on the MQTT bytes
          ws::AppendFrameHeader(&t.outbuf, ws::kOpBinary, sq.size());
        size_t at = t.outbuf.size();
        t.outbuf += sq;
        t.outbuf[at] = static_cast<char>(0x30 | (out_qos << 1));
        t.outbuf[at + qoff] = static_cast<char>(tp >> 8);
        t.outbuf[at + qoff + 1] = static_cast<char>(tp & 0xFF);
      }
      stats_[kStFastBytesOut].fetch_add(sq.size(),
                                        std::memory_order_relaxed);
      AckNote(owner, a);
    }
    stats_[kStFastOut].fetch_add(1, std::memory_order_relaxed);
    MarkDirty(owner, t);
    return true;
  }

  // [h][varint][pid u16][...]: the shared pid parse for the four ack
  // packet types (the framer already validated the length varint)
  static bool ParsePid(const std::string& f, uint16_t* pid) {
    size_t pos = 1;
    while (pos < f.size() && (static_cast<uint8_t>(f[pos]) & 0x80)) pos++;
    pos++;
    if (pos + 2 > f.size()) return false;
    *pid = (static_cast<uint8_t>(f[pos]) << 8) |
           static_cast<uint8_t>(f[pos + 1]);
    return true;
  }

  // Freed window slots pull queued deliveries in (mqueue dequeue).
  // SN conns park whole SN datagrams (always qos1): the dequeue
  // patches the msg-id field and registers the retransmit copy.
  void DrainPending(uint64_t id, Conn& c) {
    if (!c.ack) return;
    AckState& a = *c.ack;
    while (!a.pending.empty() && a.inflight_cnt < c.max_inflight) {
      auto [frame, pid_off] = std::move(a.pending.front());
      a.pending.pop_front();
      uint16_t np = NextPid(a);
      if (!c.sn && ((static_cast<uint8_t>(frame[0]) >> 1) & 3) == 2)
        BitSet(a.infl_qos2, np - kNativePidBase);
      frame[pid_off] = static_cast<char>(np >> 8);
      frame[pid_off + 1] = static_cast<char>(np & 0xFF);
      stats_[kStFastOut].fetch_add(1, std::memory_order_relaxed);
      stats_[kStFastBytesOut].fetch_add(frame.size(),
                                        std::memory_order_relaxed);
      if (c.sn) {
        stats_[kStSnOut].fetch_add(1, std::memory_order_relaxed);
        SnOut(c, frame);
        // msg-id offset sits 3 bytes past the flags byte (sn.h layout)
        SnRexmitTrack(id, c, np, std::move(frame), pid_off - 3);
      } else {
        AppendMqtt(c, frame.data(), frame.size());
      }
      AckNote(id, a);
      MarkDirty(id, c);
    }
  }

  bool TryFastPuback(uint64_t id, Conn& c, const std::string& f) {
    // pids >= kNativePidBase belong to the native inflight set; lower
    // pids are the Python session's and are forwarded
    uint16_t pid;
    if (!ParsePid(f, &pid) || pid < kNativePidBase) return false;
    if (c.ack) {
      AckState& a = *c.ack;
      uint32_t i = pid - kNativePidBase;
      if (BitTest(a.inflight, i)) {
        BitClr(a.inflight, i);
        a.inflight_cnt--;
        a.cyc_acked++;
        AckNote(id, a);
        stats_[kStNativeAcks].fetch_add(1, std::memory_order_relaxed);
        if (!a.rtt.empty()) TeleAckRtt(id, a, pid);
        FrNote(c, kFrAck, 4, pid);
        DrainPending(id, c);
      }
    }
    return true;  // native pid space: consumed even when already freed
  }

  // Subscriber answered a native qos2 delivery with PUBREC: answer
  // PUBREL (emqx_session.erl:466-476); the inflight bit stays held
  // until PUBCOMP — the exactly-once hold-across IS the slot hold.
  bool TryFastPubrec(uint64_t id, Conn& c, const std::string& f) {
    uint16_t pid;
    if (!ParsePid(f, &pid) || pid < kNativePidBase) return false;
    // phase advance for the demotion handoff: PUBREL is on the wire,
    // the exchange now awaits PUBCOMP
    if (c.ack && BitTest(c.ack->inflight, pid - kNativePidBase))
      BitSet(c.ack->infl_rel, pid - kNativePidBase);
    // answer PUBREL even for an already-freed pid (a retransmitted
    // PUBREC must still complete the client's flow); Python can never
    // own a pid in this space, so consuming is always safe
    char rel[4] = {0x62, 0x02, static_cast<char>(pid >> 8),
                   static_cast<char>(pid & 0xFF)};
    AppendMqtt(c, rel, 4);
    MarkDirty(id, c);
    return true;
  }

  // Subscriber completed a native qos2 delivery: free the slot.
  bool TryFastPubcomp(uint64_t id, Conn& c, const std::string& f) {
    uint16_t pid;
    if (!ParsePid(f, &pid) || pid < kNativePidBase) return false;
    if (c.ack) {
      AckState& a = *c.ack;
      uint32_t i = pid - kNativePidBase;
      if (BitTest(a.inflight, i)) {
        BitClr(a.inflight, i);
        a.inflight_cnt--;
        a.cyc_acked++;
        AckNote(id, a);
        stats_[kStNativeAcks].fetch_add(1, std::memory_order_relaxed);
        if (!a.rtt.empty()) TeleAckRtt(id, a, pid);
        FrNote(c, kFrAck, 7, pid);
        DrainPending(id, c);
      }
    }
    return true;
  }

  // Publisher released a qos2 exchange the native plane owns (its pid
  // sits in OUR awaiting-rel set): complete with PUBCOMP. Ids we do
  // not own forward to the Python session, which owns their state.
  bool TryFastPubrel(uint64_t id, Conn& c, const std::string& f) {
    uint16_t pid;
    if (!ParsePid(f, &pid)) return false;
    if (!c.ack || !BitTest(c.ack->awaiting_rel, pid)) return false;
    AckState& a = *c.ack;
    BitClr(a.awaiting_rel, pid);
    a.awaiting_cnt--;
    a.cyc_rel++;
    AckNote(id, a);
    stats_[kStQos2Rel].fetch_add(1, std::memory_order_relaxed);
    char comp[4] = {0x70, 0x02, static_cast<char>(pid >> 8),
                    static_cast<char>(pid & 0xFF)};
    AppendMqtt(c, comp, 4);
    MarkDirty(id, c);
    return true;
  }

  uint16_t NextPid(AckState& a) {
    // [kNativePidBase, 0xFFFF], skipping ids still in flight
    for (int guard = 0; guard < 0x8000; guard++) {
      uint16_t p = a.next_pid;
      a.next_pid = p == 0xFFFF ? kNativePidBase : p + 1;
      uint32_t i = p - kNativePidBase;
      if (!BitTest(a.inflight, i)) {
        BitSet(a.inflight, i);
        // fresh slot: stale phase bits from a previous tenant would
        // corrupt a later demotion handoff
        BitClr(a.infl_qos2, i);
        BitClr(a.infl_rel, i);
        a.inflight_cnt++;
        return p;
      }
    }
    return kNativePidBase;  // unreachable: inflight capped below 0x8000
  }

  // Batched ack records per poll cycle (the EmitTap/FlushTaps
  // discipline applied to the ack plane): Python's per-message PUBACK
  // bookkeeping becomes one decode per cycle. Chunked at the tap
  // bound: Poll permanently drops any record larger than the caller's
  // whole buffer, and the per-cycle counters are reset here BEFORE
  // emission — an unbounded record would silently lose every conn's
  // ack deltas each cycle once enough conns are window-active.
  void FlushAcks() {
    if (ack_dirty_.empty()) return;
    size_t cap = kTapFlushBytes;
    if (cap > max_size_ / 2) cap = max_size_ / 2 + 1;
    ack_buf_.clear();
    uint32_t n = 0;
    char ent[24];
    auto emit = [&]() {
      if (!n) return;
      std::string payload(reinterpret_cast<char*>(&n), 4);
      payload += ack_buf_;
      // the record id slot carries the shard (round 12): concurrent
      // poll threads feed one Python reconciler, which must attribute
      // each ack batch to the producing shard's host
      events_.push_back(EncodeRecord(7, static_cast<uint64_t>(shard_id_),
                                     payload.data(), payload.size()));
      stats_[kStAckBatches].fetch_add(1, std::memory_order_relaxed);
      ack_buf_.clear();
      n = 0;
    };
    for (uint64_t id : ack_dirty_) {
      auto it = conns_.find(id);
      if (it == conns_.end() || !it->second.ack) continue;
      AckState& a = *it->second.ack;
      a.cyc_dirty = false;
      memcpy(ent, &id, 8);
      uint32_t v = a.cyc_acked;
      memcpy(ent + 8, &v, 4);
      v = a.cyc_rel;
      memcpy(ent + 12, &v, 4);
      v = a.inflight_cnt;
      memcpy(ent + 16, &v, 4);
      v = static_cast<uint32_t>(a.pending.size());
      memcpy(ent + 20, &v, 4);
      a.cyc_acked = a.cyc_rel = 0;
      if (4 + ack_buf_.size() + 24 > cap) emit();
      ack_buf_.append(ent, 24);
      n++;
    }
    ack_dirty_.clear();
    emit();
  }

  // -- durable-session plane (round 10) -----------------------------------
  // A publish whose match set contains kSubDurable entries is appended
  // to the per-flush batch here (pre-parsed layout, payload deduped vs
  // the previous entry — the kind-6 discipline); FlushDurables writes
  // the batch into the store (store.h) and ships the SAME bytes to
  // Python as one kind-10 event for marker reconciliation + live
  // delivery to the connected persistent session.

  // A single entry's record must ALWAYS fit the Python poll buffer
  // (max_size + 65600 — native/__init__.py), or Poll drops it whole
  // and connected persistent sessions silently miss the live delivery
  // while keeping their markers (a ghost replay on next resume). The
  // worst case is 33 header bytes + 17 entry bytes + 8*ntok + the
  // frame's topic+payload (< max_size), so capping tokens per entry at
  // 4096 (32 KB) guarantees the fit; a wider audience splits into
  // several entries sharing the deduped payload.
  static constexpr size_t kDurMaxToksPerEntry = 4096;

  void DurableAppend(uint64_t publisher, uint8_t qos,
                     std::string_view topic, std::string_view payload) {
    stats_[kStDurableIn].fetch_add(1, std::memory_order_relaxed);
    if (cur_trace_) SpanNote(kSpanStoreAppend, dur_tok_scratch_.size());
    // the publisher's clientid persists with the entry (flags bit5):
    // no-local and from_ attribution must survive a restart, and the
    // origin conn id is meaningless in the next life
    const std::string* cid = nullptr;
    auto cit = conn_cids_.find(publisher);
    if (cit != conn_cids_.end() && !cit->second.empty())
      cid = &cit->second;
    for (size_t g = 0; g < dur_tok_scratch_.size();
         g += kDurMaxToksPerEntry)
      DurableAppendEntry(
          publisher, qos, topic, payload, cid, g,
          std::min(dur_tok_scratch_.size(), g + kDurMaxToksPerEntry));
  }

  // @bounded(dur_buf_)
  void DurableAppendEntry(uint64_t publisher, uint8_t qos,
                          std::string_view topic, std::string_view payload,
                          const std::string* cid,
                          size_t tok_begin, size_t tok_end) {
    size_t cap = TeleCap();
    size_t ntok = tok_end - tok_begin;
    size_t entry_max = 19 + 8 * ntok + 2 + topic.size() + 4
                       + payload.size()
                       + (cid ? 1 + cid->size() : 0);
    // 33 = 13-byte event-record header slot + 20-byte batch header
    // ([base_guid][ts][n]); both patched at flush (EmitTap's
    // seed-after-flush lesson: never append headerless post-flush)
    if (dur_buf_.size() > 33 && dur_buf_.size() - 33 + entry_max > cap)
      FlushDurables();
    if (dur_buf_.empty()) dur_buf_.assign(33, '\0');
    bool dup_pl = dur_have_prev_ && payload == dur_prev_payload_;
    char hdr[11];
    memcpy(hdr, &publisher, 8);
    hdr[8] = static_cast<char>((dup_pl ? 0 : 1) | (qos << 1)
                               | (cur_dup_ ? 8 : 0)
                               | (cur_trace_ ? 0x10 : 0)
                               | (cid ? 0x20 : 0));
    uint16_t nt = static_cast<uint16_t>(ntok);
    memcpy(hdr + 9, &nt, 2);
    dur_buf_.append(hdr, 11);
    for (size_t k = tok_begin; k < tok_end; k++) {
      uint64_t tok = dur_tok_scratch_[k];
      dur_buf_.append(reinterpret_cast<const char*>(&tok), 8);
    }
    uint16_t tl = static_cast<uint16_t>(topic.size());
    dur_buf_.append(reinterpret_cast<const char*>(&tl), 2);
    dur_buf_.append(topic.data(), topic.size());
    // flags bit4 (round 13): the sampled trace id persists with the
    // message so a resume replay can re-join its timeline
    if (cur_trace_)
      dur_buf_.append(reinterpret_cast<const char*>(&cur_trace_), 8);
    // flags bit5 (round 18): the publisher's clientid (<= 255 bytes —
    // kEnableFast refuses longer ones at the bind)
    if (cid) {
      dur_buf_.push_back(static_cast<char>(cid->size()));
      dur_buf_.append(*cid);
    }
    if (!dup_pl) {
      uint32_t pl = static_cast<uint32_t>(payload.size());
      dur_buf_.append(reinterpret_cast<const char*>(&pl), 4);
      dur_buf_.append(payload.data(), payload.size());
      dur_prev_payload_.assign(payload.data(), payload.size());
      dur_have_prev_ = true;
    }
    dur_n_++;
    if (dur_buf_.size() - 33 > cap) FlushDurables();
  }

  void FlushDurables() {
    if (dur_buf_.size() <= 33 || !store_) {
      dur_buf_.clear();
      dur_n_ = 0;
      dur_have_prev_ = false;
      return;
    }
    uint64_t base = store_->AllocGuids(dur_n_);
    uint64_t ts = store::WallMs();
    memcpy(&dur_buf_[13], &base, 8);
    memcpy(&dur_buf_[21], &ts, 8);
    memcpy(&dur_buf_[29], &dur_n_, 4);
    uint64_t t0 = telemetry_ ? NowNs() : 0;
    store_->AppendBatch(dur_buf_.data() + 13, dur_buf_.size() - 13);
    if (telemetry_) RecordHist(kHistStoreAppend, NowNs() - t0);
    stats_[kStStoreAppends].fetch_add(dur_n_, std::memory_order_relaxed);
    stats_[kStDurableBatches].fetch_add(1, std::memory_order_relaxed);
    dur_buf_[0] = 10;
    // id slot = shard (round 12): durable consume folds kind-10
    // batches from every shard; guids stay globally unique (the store
    // is shared, AllocGuids is atomic) but attribution is per-shard
    uint64_t id = static_cast<uint64_t>(shard_id_);
    memcpy(&dur_buf_[1], &id, 8);
    uint32_t plen = static_cast<uint32_t>(dur_buf_.size() - 13);
    memcpy(&dur_buf_[9], &plen, 4);
    events_.push_back(std::move(dur_buf_));
    dur_buf_.clear();
    dur_n_ = 0;
    dur_have_prev_ = false;
  }

  // Live plane demotion (kDisableFast): serialize the AckState into
  // kind-11 records the Python session adopts — awaiting-rel ids (the
  // publisher-side qos2 exactly-once set), the inflight window with
  // per-delivery qos/phase, and the window-full pending frames.
  // Chunked at the tap bound; fields are additive across chunks. At
  // least one sub-1 record always goes out so Python sees the flip.
  void EmitHandoff(uint64_t id, Conn& c) {
    stats_[kStHandoffs].fetch_add(1, std::memory_order_relaxed);
    size_t cap = TeleCap();
    std::vector<uint16_t> aw, ifp;
    std::vector<uint8_t> ifs;
    if (c.ack) {
      AckState& a = *c.ack;
      if (a.awaiting_cnt)
        for (uint32_t w = 0; w < 1024; w++) {
          uint64_t bits = a.awaiting_rel[w];
          while (bits) {
            uint32_t b = static_cast<uint32_t>(__builtin_ctzll(bits));
            bits &= bits - 1;
            aw.push_back(static_cast<uint16_t>(w * 64 + b));
          }
        }
      if (a.inflight_cnt)
        for (uint32_t w = 0; w < 512; w++) {
          uint64_t bits = a.inflight[w];
          while (bits) {
            uint32_t b = static_cast<uint32_t>(__builtin_ctzll(bits));
            bits &= bits - 1;
            uint32_t i = w * 64 + b;
            ifp.push_back(static_cast<uint16_t>(kNativePidBase + i));
            ifs.push_back(static_cast<uint8_t>(
                (BitTest(a.infl_qos2, i) ? 1 : 0)
                | (BitTest(a.infl_rel, i) ? 2 : 0)));
          }
        }
    }
    size_t ai = 0, ii = 0;
    bool first = true;
    while (first || ai < aw.size() || ii < ifp.size()) {
      first = false;
      std::string rec;
      rec.push_back(1);
      size_t aw_at = rec.size();
      rec.append(4, '\0');
      uint32_t na = 0;
      while (ai < aw.size() && rec.size() + 2 + 4 < cap) {
        uint16_t pid = aw[ai++];
        rec.append(reinterpret_cast<const char*>(&pid), 2);
        na++;
      }
      memcpy(&rec[aw_at], &na, 4);
      size_t if_at = rec.size();
      rec.append(4, '\0');
      uint32_t ni = 0;
      while (ii < ifp.size() && rec.size() + 3 < cap) {
        uint16_t pid = ifp[ii];
        rec.append(reinterpret_cast<const char*>(&pid), 2);
        rec.push_back(static_cast<char>(ifs[ii]));
        ii++;
        ni++;
      }
      memcpy(&rec[if_at], &ni, 4);
      events_.push_back(EncodeRecord(11, id, rec.data(), rec.size()));
    }
    if (c.ack && !c.ack->pending.empty()) {
      std::string rec;
      uint32_t n = 0;
      auto open = [&]() {
        rec.clear();
        rec.push_back(2);
        rec.append(4, '\0');
        n = 0;
      };
      auto emit = [&]() {
        if (!n) return;
        memcpy(&rec[1], &n, 4);
        events_.push_back(EncodeRecord(11, id, rec.data(), rec.size()));
      };
      open();
      for (auto& [frame, off] : c.ack->pending) {
        (void)off;
        if (n && rec.size() + 4 + frame.size() > cap) {
          emit();
          open();
        }
        uint32_t fl = static_cast<uint32_t>(frame.size());
        rec.append(reinterpret_cast<const char*>(&fl), 4);
        rec += frame;
        n++;
      }
      emit();
    }
  }

  // -- cluster trunk (round 9) --------------------------------------------
  // Cross-node publish forwarding on the C++ plane: per-peer batch
  // buffers flushed as length-prefixed trunk records (trunk.h) straight
  // into the peer host's decoder → local fan-out. All state below is
  // poll-thread-owned; control arrives via ops (kTrunk*).

  void TrunkAccept() {
    for (;;) {
      sockaddr_in peer{};
      socklen_t plen = sizeof(peer);
      int fd = accept4(listen_trunk_fd_, reinterpret_cast<sockaddr*>(&peer),
                       &plen, SOCK_NONBLOCK | SOCK_CLOEXEC);
      if (fd < 0) return;
      // @fault(trunk_accept) — the peer's dial lands on an RST and its
      // redial backoff machinery takes over
      if (FaultHit(fault::kSiteTrunkAccept, 0)) {
        close(fd);
        continue;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      uint64_t tag = kTrunkSockBit | next_trunk_tag_++;
      trunk::Sock s;
      s.fd = fd;
      s.dialer = false;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.u64 = tag;
      epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev);
      trunk_socks_.emplace(tag, std::move(s));
    }
  }

  void TrunkDial(uint64_t peer_id, trunk::Peer& p) {
    if (p.sock_tag) {
      auto sit = trunk_socks_.find(p.sock_tag);
      if (sit != trunk_socks_.end()
          && (sit->second.connecting || p.hello_pending))
        return;  // a dial (or the HELLO grace) is already in flight —
      //           killing it on every retry tick would livelock any
      //           connect slower than the redial cadence (the kernel's
      //           own connect timeout eventually fails it and emits
      //           DOWN; the HELLO grace is deadline-bounded)
      TrunkSockDead(p.sock_tag, "redial");  // replace established link
    }
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) {
      TrunkEmitDown(peer_id, "socket");
      return;
    }
    // @fault(trunk_connect) — the dial fails before it starts; Python
    // sees DOWN and drives the (jittered) redial backoff
    if (FaultHit(fault::kSiteTrunkConnect, peer_id)) {
      close(fd);
      TrunkEmitDown(peer_id, "fault_connect");
      return;
    }
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(p.port);
    if (inet_pton(AF_INET, p.addr.c_str(), &addr.sin_addr) != 1) {
      close(fd);
      TrunkEmitDown(peer_id, "bad_addr");
      return;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    if (rc < 0 && errno != EINPROGRESS) {
      close(fd);
      TrunkEmitDown(peer_id, "connect");
      return;
    }
    uint64_t tag = kTrunkSockBit | next_trunk_tag_++;
    trunk::Sock s;
    s.fd = fd;
    s.dialer = true;
    s.peer_id = peer_id;
    s.connecting = rc < 0;
    epoll_event ev{};
    ev.events = s.connecting ? (EPOLLIN | EPOLLOUT) : EPOLLIN;
    ev.data.u64 = tag;
    epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev);
    p.sock_tag = tag;
    trunk_socks_.emplace(tag, std::move(s));
    if (rc == 0) TrunkUp(peer_id, p);
  }

  // Link established: HELLO first (round 13 — advertise our wire
  // version before any batch), then WAIT for the answer (or the grace
  // deadline, for old peers that ignore unknown record types) before
  // completing the link: the qos1 replay must go out at the link's
  // NEGOTIATED version, or a shadow carrying trace annotations would
  // always downshift to v0 (the round-13 carried edge) — and a v1
  // shadow must never hit a v0 peer's decoder. TrunkCompleteUp then
  // replays BEFORE any new traffic (p.up stays false through the
  // grace, so remote entries punt conservatively — the link-down
  // ladder, bounded by kTrunkHelloGraceMs) and tells Python (kind 9
  // sub 1) so it can flush permits — the ordering guard for the
  // punt→trunk flip, same reasoning as the slow→fast permit grant.
  void TrunkUp(uint64_t peer_id, trunk::Peer& p) {
    auto sit = trunk_socks_.find(p.sock_tag);
    if (sit == trunk_socks_.end()) return;
    if (trunk_wire_max_ >= 1) {
      char hv = static_cast<char>(trunk_wire_max_);
      trunk::AppendRecord(&sit->second.outbuf, trunk::kRecHello, &hv, 1);
      p.hello_pending = true;
      p.hello_deadline_ms = NowMs() + kTrunkHelloGraceMs;
      trunk_hello_pending_++;
      TrunkFlushSock(p.sock_tag, sit->second);
      return;  // TrunkCompleteUp runs on the answer or the deadline
    }
    TrunkCompleteUp(peer_id, p);
  }

  // -- store-backed trunk ring (round 18) ---------------------------------
  // The per-peer unacked qos1 ring journals into the durable store
  // (kRecTrunk / kRecTrunkAck, keyed by peer NODE NAME): kill -9 of a
  // node no longer loses the ring — the reconnect replay draws from
  // recovered segments and the exact-match ack machinery retires store
  // records alongside memory slots.

  const std::string& TrunkStoreName(uint64_t peer_id, trunk::Peer& p) {
    if (p.store_name.empty()) {
      // raw/single-process fallback: tests that never call trunk_ident
      // still get a stable-within-the-dir key
      char buf[24];
      snprintf(buf, sizeof(buf), "peer:%llu",
               static_cast<unsigned long long>(peer_id));
      p.store_name = buf;
    }
    return p.store_name;
  }

  // Merge the persisted ring into the in-memory one (once per peer
  // life): runs before the first dial/journal so a recovered entry can
  // never duplicate a live one.
  void TrunkRingLoad(uint64_t peer_id, trunk::Peer& p) {
    if (!store_ || p.ring_loaded) return;
    p.ring_loaded = true;
    if (!p.unacked.empty()) return;  // live ring exists: nothing to merge
    uint8_t* blob = nullptr;
    size_t blen = 0;
    long n = store_->TrunkFetch(TrunkStoreName(peer_id, p), &blob, &blen);
    size_t pos = 0;
    uint64_t now = NowMs();
    for (long i = 0; i < n && pos + 13 <= blen; i++) {
      uint64_t seq;
      memcpy(&seq, blob + pos, 8);
      uint8_t tf = blob[pos + 8];
      uint32_t rl;
      memcpy(&rl, blob + pos + 9, 4);
      pos += 13;
      if (pos + rl > blen) break;
      trunk::Unacked u;
      u.seq = seq;
      u.flush_ms = now;  // watchdog clock restarts at recovery
      u.has_trace = (tf & 1) != 0;
      u.q1_record.assign(reinterpret_cast<const char*>(blob + pos), rl);
      pos += rl;
      p.unacked.push_back(std::move(u));
      if (seq >= p.next_seq) p.next_seq = seq + 1;
      stats_[kStTrunkRingRecovered].fetch_add(1,
                                              std::memory_order_relaxed);
    }
    free(blob);
  }

  // Negotiation resolved (answer arrived, deadline passed, or this
  // host speaks v0 and never negotiates): replay the unacked qos1 ring
  // at the negotiated version, then emit UP.
  void TrunkCompleteUp(uint64_t peer_id, trunk::Peer& p) {
    if (p.hello_pending) {
      p.hello_pending = false;
      if (trunk_hello_pending_) trunk_hello_pending_--;
    }
    auto sit = trunk_socks_.find(p.sock_tag);
    if (sit == trunk_socks_.end()) return;  // link died in the window
    p.up = true;
    // qos0-only ring entries (empty q1_record: they existed for the
    // OLD link's RTT stage) are dropped here, not replayed: with
    // exact-match acks (round 15) an unreplayable entry at the ring
    // front would read as an ack_gap the moment the peer acked the
    // first replayed batch behind it. Survivors re-stamp their
    // watchdog clock — a ring carried across a down window must not
    // trip ack_timeout the instant the link comes back.
    uint64_t now = NowMs();
    std::deque<trunk::Unacked> keep;
    for (trunk::Unacked& u : p.unacked) {
      if (u.q1_record.empty()) continue;
      u.flush_ms = now;
      // the shadow persists the sampled trace ids (round 14); a
      // reconnect that negotiated below v1 strips them losslessly —
      // never put bytes on a wire the peer cannot parse
      if (u.has_trace && p.wire_ver < 1)
        sit->second.outbuf += trunk::StripTraceRecord(u.q1_record);
      else
        sit->second.outbuf += u.q1_record;
      stats_[kStTrunkReplays].fetch_add(1, std::memory_order_relaxed);
      keep.push_back(std::move(u));
    }
    p.unacked.swap(keep);
    // the watchdog reference moved: re-arm against the fresh front
    if (p.tm_ack) {
      wheel_.Cancel(p.tm_ack);
      p.tm_ack = 0;
    }
    TrunkAckWatch(peer_id, p);
    char sub = 1;
    events_.push_back(EncodeRecord(9, peer_id, &sub, 1));
    TrunkFlushSock(p.sock_tag, sit->second);
  }

  // Once per poll cycle: complete any link whose HELLO answer never
  // came within the grace (an old peer) at wire v0.
  void TrunkHelloScan() {
    if (!trunk_hello_pending_) return;
    uint64_t now = NowMs();
    for (auto& [peer_id, p] : trunk_peers_) {
      if (p.hello_pending && p.sock_tag && now >= p.hello_deadline_ms)
        TrunkCompleteUp(peer_id, p);
    }
  }

  void TrunkEmitDown(uint64_t peer_id, const char* reason) {
    std::string payload;
    payload.push_back(2);
    payload.append(reason);
    events_.push_back(
        EncodeRecord(9, peer_id, payload.data(), payload.size()));
  }

  void TrunkEvent(const epoll_event& ev) {
    uint64_t tag = ev.data.u64;
    auto it = trunk_socks_.find(tag);
    if (it == trunk_socks_.end()) return;
    trunk::Sock& s = it->second;
    if (s.connecting) {
      int err = 0;
      socklen_t el = sizeof(err);
      getsockopt(s.fd, SOL_SOCKET, SO_ERROR, &err, &el);
      if (err != 0 || (ev.events & (EPOLLERR | EPOLLHUP))) {
        TrunkSockDead(tag, "connect_failed");
        return;
      }
      if (!(ev.events & EPOLLOUT)) return;
      s.connecting = false;
      epoll_event e2{};
      e2.events = EPOLLIN;
      e2.data.u64 = tag;
      epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, s.fd, &e2);
      auto pit = trunk_peers_.find(s.peer_id);
      if (pit != trunk_peers_.end() && pit->second.sock_tag == tag)
        TrunkUp(s.peer_id, pit->second);
      return;
    }
    if (ev.events & (EPOLLHUP | EPOLLERR)) {
      TrunkSockDead(tag, "sock_error");
      return;
    }
    if (ev.events & EPOLLOUT) {
      TrunkFlushSock(tag, s);
      if (!trunk_socks_.count(tag)) return;  // flush hit an error
    }
    if (ev.events & EPOLLIN) TrunkRead(tag);
  }

  void TrunkSockDead(uint64_t tag, const char* reason) {
    auto it = trunk_socks_.find(tag);
    if (it == trunk_socks_.end()) return;
    trunk::Sock s = std::move(it->second);
    epoll_ctl(epoll_fd_, EPOLL_CTL_DEL, s.fd, nullptr);
    close(s.fd);
    trunk_socks_.erase(it);
    if (!s.dialer) return;
    auto pit = trunk_peers_.find(s.peer_id);
    if (pit != trunk_peers_.end() && pit->second.sock_tag == tag) {
      pit->second.sock_tag = 0;
      pit->second.up = false;
      // per-LINK negotiation: the next connect re-runs HELLO (the
      // replacement peer may be an older build); a death inside the
      // HELLO grace clears the pending state with the link
      if (pit->second.hello_pending) {
        pit->second.hello_pending = false;
        if (trunk_hello_pending_) trunk_hello_pending_--;
      }
      pit->second.wire_ver = 0;
      // remote entries now behave as punt markers (TryFast reads
      // p.up); the unacked ring is KEPT for the reconnect replay.
      // Python sees DOWN (kind 9 sub 2) and drives the redial.
      TrunkEmitDown(s.peer_id, reason);
    }
  }

  void TrunkRead(uint64_t tag) {
    auto it = trunk_socks_.find(tag);
    if (it == trunk_socks_.end()) return;
    trunk::Sock& s = it->second;
    uint8_t chunk[kReadChunk];
    for (;;) {
      // @fault(trunk_read) — a blackholed trunk read is one half of a
      // partition: the peer's batches/acks/HELLOs vanish in flight
      ssize_t n = FaultRecv(fault::kSiteTrunkRead, s.peer_id, s.fd,
                            chunk, sizeof(chunk));
      if (n > 0) {
        s.inbuf.append(reinterpret_cast<char*>(chunk),
                       static_cast<size_t>(n));
        if (static_cast<size_t>(n) < sizeof(chunk)) break;
      } else if (n == 0) {
        TrunkSockDead(tag, "sock_closed");
        return;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        if (errno == EINTR) continue;
        TrunkSockDead(tag, "sock_error");
        return;
      }
    }
    size_t pos = 0;
    while (s.inbuf.size() - pos >= 5) {
      uint32_t len = 0;
      memcpy(&len, s.inbuf.data() + pos, 4);
      // protocol-fixed bound (trunk.h), NOT this host's max_size_:
      // nodes with different max_packet_size configs must agree on
      // what a well-formed record is, or a legal record from a
      // bigger-configured peer poisons the link forever
      if (len < 1 || len > trunk::kMaxRecordBytes) {
        TrunkSockDead(tag, "bad_record");
        return;
      }
      if (s.inbuf.size() - pos < 4 + static_cast<size_t>(len)) break;
      uint8_t type = static_cast<uint8_t>(s.inbuf[pos + 4]);
      const char* body = s.inbuf.data() + pos + 5;
      size_t blen = len - 1;
      if (type == trunk::kRecBatch) {
        // per-sock seqs must strictly ascend (round 15): a regressed
        // or duplicate seq means the byte stream desynced (an injected
        // partition chopped it) — kill the link; redial replays
        if (blen >= 8) {
          uint64_t bseq = 0;
          memcpy(&bseq, body, 8);
          if (s.last_seq && bseq <= s.last_seq) {
            TrunkSockDead(tag, "seq_regress");
            return;
          }
          s.last_seq = bseq;
        }
        TrunkApplyBatch(s, body, blen);
      } else if (type == trunk::kRecAck && s.dialer && blen >= 8) {
        uint64_t seq = 0;
        memcpy(&seq, body, 8);
        TrunkApplyAck(s.peer_id, seq);
        // an ack_gap verdict kills THIS sock from under the read loop
        // (the TrunkEvent-after-flush guard, applied here too)
        if (!trunk_socks_.count(tag)) return;
      } else if (type == trunk::kRecHello && blen >= 1) {
        uint8_t theirs = static_cast<uint8_t>(body[0]);
        if (s.dialer) {
          // the peer's answer: the link speaks min(ours, theirs) —
          // and negotiation resolving completes the deferred link
          // bring-up (qos1 replay at the negotiated version + UP)
          auto pit = trunk_peers_.find(s.peer_id);
          if (pit != trunk_peers_.end() && pit->second.sock_tag == tag) {
            pit->second.wire_ver =
                theirs < trunk_wire_max_ ? theirs : trunk_wire_max_;
            if (pit->second.hello_pending) {
              uint64_t peer_id = s.peer_id;
              TrunkCompleteUp(peer_id, pit->second);
              // CompleteUp's replay flush may have hit a dead socket:
              // TrunkSockDead then erased `s` out from under this read
              // loop (the TrunkEvent-after-flush guard, applied here)
              if (!trunk_socks_.count(tag)) return;
            }
          }
        } else if (trunk_wire_max_ >= 1) {
          // receiver side: answer with our version (an old dialer
          // never sends HELLO, so this branch never fires against one)
          char hv = static_cast<char>(trunk_wire_max_);
          trunk::AppendRecord(&s.outbuf, trunk::kRecHello, &hv, 1);
        }
      }
      pos += 4 + len;
    }
    s.inbuf.erase(0, pos);
    TrunkPuntFlush();
    FlushDirty();             // deliveries written during ApplyBatch
    TrunkFlushSock(tag, s);   // the per-batch ACKs appended above
  }

  // Apply one received BATCH record: per-entry local fan-out through
  // the SAME match/deliver machinery the fast path uses. Entries whose
  // match set contains punt markers (or shared groups — defensive:
  // replication lag can race a group flip) go up to Python as kind-9
  // punt records instead; rule taps do NOT fire here — rules run on
  // the PUBLISHING node, exactly like the reference's forward lane
  // (emqx_broker:dispatch runs no hooks on the receiving node).
  void TrunkApplyBatch(trunk::Sock& s, const char* body, size_t blen) {
    if (blen < 12) return;
    uint64_t seq = 0;
    uint32_t n = 0;
    memcpy(&seq, body, 8);
    memcpy(&n, body + 8, 4);
    stats_[kStTrunkBatchesIn].fetch_add(1, std::memory_order_relaxed);
    size_t pos = 12;
    std::string_view prev_payload;
    bool have_prev = false;
    for (uint32_t i = 0; i < n && pos + 11 <= blen; i++) {
      uint64_t origin = 0;
      memcpy(&origin, body + pos, 8);
      uint8_t flags = static_cast<uint8_t>(body[pos + 8]);
      uint16_t tlen = 0;
      memcpy(&tlen, body + pos + 9, 2);
      pos += 11;
      if (pos + tlen > blen) break;
      std::string_view topic(body + pos, tlen);
      pos += tlen;
      uint64_t trace = 0;
      if (flags & 0x10) {  // wire-v1 trace extension (negotiated)
        if (pos + 8 > blen) break;
        memcpy(&trace, body + pos, 8);
        pos += 8;
      }
      std::string_view payload;
      if (flags & 1) {
        if (pos + 4 > blen) break;
        uint32_t pl = 0;
        memcpy(&pl, body + pos, 4);
        pos += 4;
        if (pos + pl > blen) break;
        payload = std::string_view(body + pos, pl);
        pos += pl;
        prev_payload = payload;
        have_prev = true;
      } else {
        if (!have_prev) break;  // corrupt batch: dedup with no reference
        payload = prev_payload;
      }
      TrunkFanOut(origin, (flags >> 1) & 3, (flags & 8) != 0, topic,
                  payload, trace);
    }
    cur_trace_ = 0;  // batch context over
    // ack AFTER fan-out: the sender's ring holds the qos1 copy until
    // every local delivery for this batch has been written
    char ab[8];
    memcpy(ab, &seq, 8);
    trunk::AppendRecord(&s.outbuf, trunk::kRecAck, ab, 8);
  }

  void TrunkFanOut(uint64_t origin, uint8_t qos, bool dup,
                   std::string_view topic, std::string_view payload,
                   uint64_t trace = 0) {
    stats_[kStTrunkIn].fetch_add(1, std::memory_order_relaxed);
    match_scratch_.clear();
    groups_scratch_.clear();
    subs_.Match(topic, &match_scratch_, &groups_scratch_);
    bool punt = !groups_scratch_.empty();
    if (!punt)
      for (const SubEntry* e : match_scratch_)
        if (e->flags & kSubPunt) {
          punt = true;
          break;
        }
    if (punt) {
      stats_[kStTrunkPunts].fetch_add(1, std::memory_order_relaxed);
      TrunkPuntAppend(origin, qos, dup, topic, payload, trace);
      return;
    }
    if (telemetry_) cur_hash_ = TopicHash(topic);
    cur_dup_ = dup;
    // re-join the sampled publish's timeline on the RECEIVING node:
    // the deliver_write spans below run under the wire-propagated id
    cur_trace_ = trace;
    if (trace) {
      cur_trace_delivers_ = 0;
      SpanNote(kSpanTrunkRecv, origin);
    }
    // publisher id 0 can never collide with a local conn (ids start at
    // 1), so no ack is written and no-local can never false-match a
    // local subscriber that happens to share the REMOTE publisher's id
    FanOut(0, qos, 0, topic, payload, /*count_fast=*/false);
  }

  // Receiver-side punts ride ONE kind-9 record per read batch (payload
  // [u8 3] + entries, payloads always inline — the sender's dedup may
  // reference an entry that was NOT punted).
  void TrunkPuntAppend(uint64_t origin, uint8_t qos, bool dup,
                       std::string_view topic, std::string_view payload,
                       uint64_t trace = 0) {
    size_t cap = TeleCap();
    size_t entry = 23 + topic.size() + payload.size();
    if (!trunk_punt_buf_.empty() && trunk_punt_buf_.size() + entry > cap)
      TrunkPuntFlush();
    if (trunk_punt_buf_.empty()) trunk_punt_buf_.push_back(3);
    trunk::AppendEntry(&trunk_punt_buf_, origin, qos, dup,
                       /*inline_payload=*/true, topic, payload, trace);
  }

  void TrunkPuntFlush() {
    if (trunk_punt_buf_.empty()) return;
    events_.push_back(EncodeRecord(9, 0, trunk_punt_buf_.data(),
                                   trunk_punt_buf_.size()));
    trunk_punt_buf_.clear();
  }

  // Sender: append one publish to the peer's batch under construction
  // (payload deduped vs the previous entry — the kind-6 discipline);
  // qos1 entries ALSO append a full copy to the qos1-only shadow that
  // becomes this batch's replay record. One FIFO per peer keeps
  // per-topic order trivially (total order per link).
  // @admit-gated — TrunkEligible decides BEFORE the entry lands here
  void TrunkEnqueue(uint64_t peer_id, uint64_t origin, uint8_t qos,
                    bool dup, std::string_view topic,
                    std::string_view payload) {
    auto it = trunk_peers_.find(peer_id);
    if (it == trunk_peers_.end()) return;
    trunk::Peer& p = it->second;
    bool inline_payload = !(p.have_prev && payload == p.prev_payload);
    // wire-versioned trace propagation (round 13): the id rides the
    // entry only on links that negotiated >= v1 — an old peer gets v0
    // entries with the id STRIPPED (losslessly; topic/payload intact)
    uint64_t wire_trace = p.wire_ver >= 1 ? cur_trace_ : 0;
    trunk::AppendEntry(&p.batch, origin, qos, dup, inline_payload, topic,
                       payload, wire_trace);
    if (wire_trace) SpanNote(kSpanTrunkFlush, peer_id, wire_trace);
    if (inline_payload) {
      p.prev_payload.assign(payload.data(), payload.size());
      p.have_prev = true;
    }
    if (qos) {
      // the replay shadow keeps the SAMPLED id even on a v0 link: the
      // replay happens on a FUTURE link whose version is negotiated
      // then — TrunkCompleteUp strips at replay time when that link
      // speaks v0 (round 14; the shadow used to be unconditionally v0
      // and a replayed batch always lost its trace annotation)
      trunk::AppendEntry(&p.q1_batch, origin, qos, dup,
                         /*inline_payload=*/true, topic, payload,
                         cur_trace_);
      if (cur_trace_) p.q1_has_trace = true;
      p.q1_n++;
    } else {
      p.q0_n++;
    }
    if (p.batch_n++ == 0) trunk_dirty_.push_back(peer_id);
    stats_[kStTrunkOut].fetch_add(1, std::memory_order_relaxed);
    size_t cap = TeleCap();
    // BOTH buffers bound the flush: deduped entries add ~15 bytes to
    // `batch` while adding the FULL payload to the qos1 shadow, so a
    // same-payload qos1 burst could otherwise build a replay record
    // past the receiver's record-size bound — which would poison every
    // reconnect with "bad_record" forever
    if (p.batch.size() > cap || p.q1_batch.size() > cap)
      FlushTrunkPeer(peer_id, p);
  }

  // Seal the batch under construction into one wire record + its ring
  // entry. Writes to the socket only while the link is up; a batch
  // sealed while down loses its qos0 entries (in-flight loss, same as
  // a death mid-send) but its qos1 record replays on reconnect.
  void FlushTrunkPeer(uint64_t peer_id, trunk::Peer& p) {
    if (p.batch_n == 0) return;
    // merge the previous life's persisted ring BEFORE minting this
    // batch's seq: recovered entries carry the old (higher) seqs, and
    // a fresh seq minted below them would regress the link's stream
    if (store_ && !p.ring_loaded) TrunkRingLoad(peer_id, p);
    uint64_t seq = p.next_seq++;
    std::string body;
    body.reserve(12 + p.batch.size());
    body.append(reinterpret_cast<const char*>(&seq), 8);
    body.append(reinterpret_cast<const char*>(&p.batch_n), 4);
    body += p.batch;
    trunk::Unacked u;
    u.seq = seq;
    u.t0_ns = telemetry_ ? NowNs() : 0;
    u.flush_ms = NowMs();   // the ack_timeout watchdog's reference
    u.has_trace = p.q1_has_trace;
    if (p.q1_n) {
      std::string q1body;
      q1body.reserve(12 + p.q1_batch.size());
      q1body.append(reinterpret_cast<const char*>(&seq), 8);
      q1body.append(reinterpret_cast<const char*>(&p.q1_n), 4);
      q1body += p.q1_batch;
      trunk::AppendRecord(&u.q1_record, trunk::kRecBatch, q1body.data(),
                          q1body.size());
      if (store_) {
        // journal the replay record BEFORE any socket write of this
        // batch (the PUBACK-after-store discipline applied to the
        // trunk): a kill -9 between the write and the journal could
        // otherwise lose a batch the peer never processed
        store_->TrunkPut(TrunkStoreName(peer_id, p), seq,
                         u.has_trace ? 1 : 0, u.q1_record.data(),
                         u.q1_record.size());
        stats_[kStTrunkRingPersisted].fetch_add(
            1, std::memory_order_relaxed);
      }
    }
    if (p.up) {
      auto sit = trunk_socks_.find(p.sock_tag);
      if (sit != trunk_socks_.end()) {
        trunk::Sock& s = sit->second;
        // the kHighWater mqueue-drop policy applied to the trunk link:
        // a connected-but-stalled peer must not grow the sender's
        // socket backlog without bound. qos0 entries shed (the same
        // fate a backpressured local delivery gets in DeliverTo);
        // qos1 keeps flowing as the qos1-only record because its
        // volume is already bounded by the unacked-ring admission gate
        bool congested = s.outbuf.size() - s.outpos > kHighWater;
        if (!congested) {
          trunk::AppendRecord(&s.outbuf, trunk::kRecBatch,
                              body.data(), body.size());
        } else if (!u.q1_record.empty()) {
          s.outbuf += u.q1_record;
          if (p.q0_n) {
            stats_[kStTrunkShed].fetch_add(p.q0_n,
                                           std::memory_order_relaxed);
            LedgerNote(kLrShed, peer_id);
          }
        } else {
          stats_[kStTrunkShed].fetch_add(p.batch_n,
                                         std::memory_order_relaxed);
          LedgerNote(kLrShed, peer_id);
        }
      }
    }
    // ring admission: qos0-only entries exist only for the RTT stage —
    // never let them grow the ring past its bound (a front entry
    // holding a qos1 record would otherwise block the trim below while
    // qos0 ballast accumulated behind it indefinitely); qos1 overshoot
    // stays soft-bounded by TryFast's admission gate
    if (!u.q1_record.empty() || p.unacked.size() < kTrunkUnackedMax)
      p.unacked.push_back(std::move(u));
    while (p.unacked.size() > kTrunkUnackedMax &&
           p.unacked.front().q1_record.empty())
      p.unacked.pop_front();  // qos0-only entries are droppable ballast
    TrunkAckWatch(peer_id, p);  // first unacked entry arms the watchdog
    if (telemetry_) RecordHist(kHistTrunkBatchN, p.batch_n);
    stats_[kStTrunkBatchesOut].fetch_add(1, std::memory_order_relaxed);
    p.batch.clear();
    p.q1_batch.clear();
    p.batch_n = 0;
    p.q1_n = 0;
    p.q0_n = 0;
    p.q1_has_trace = false;
    p.prev_payload.clear();
    p.have_prev = false;
  }

  // One batch record per poll cycle per dirty peer — the FlushTaps /
  // FlushAcks batching discipline applied to the wire.
  void FlushTrunks() {
    if (trunk_dirty_.empty()) return;
    std::vector<uint64_t> dirty;
    dirty.swap(trunk_dirty_);
    for (uint64_t peer_id : dirty) {
      auto it = trunk_peers_.find(peer_id);
      if (it == trunk_peers_.end()) continue;
      FlushTrunkPeer(peer_id, it->second);
      if (it->second.up) {
        uint64_t tag = it->second.sock_tag;
        auto sit = trunk_socks_.find(tag);
        if (sit != trunk_socks_.end()) TrunkFlushSock(tag, sit->second);
      }
    }
  }

  // Exact-match ack (round 15 — was cumulative): retire precisely the
  // ring entry the ack names. A cumulative trim was the silent-loss
  // enabler under an up-but-black link: batches written into the void
  // were retired by the first post-heal ack for a LATER seq. Acks
  // arrive in seq order on a healthy link, so the front always
  // matches; an ack AHEAD of the front is proof the peer never saw
  // the front batch — kill the link and let the redial replay it
  // (loss becomes at-least-once dups, never silence).
  void TrunkApplyAck(uint64_t peer_id, uint64_t seq) {
    auto it = trunk_peers_.find(peer_id);
    if (it == trunk_peers_.end()) return;
    trunk::Peer& p = it->second;
    if (p.unacked.empty() || seq < p.unacked.front().seq)
      return;  // stale ack (entry already retired): ignore
    if (seq > p.unacked.front().seq) {
      if (p.sock_tag) TrunkSockDead(p.sock_tag, "ack_gap");
      return;
    }
    if (telemetry_ && p.unacked.front().t0_ns)
      RecordHist(kHistTrunkRtt, NowNs() - p.unacked.front().t0_ns);
    // the ack retires the STORE record alongside the memory slot
    // (round 18): qos0-only entries were never journaled
    if (store_ && !p.unacked.front().q1_record.empty())
      store_->TrunkAck(TrunkStoreName(peer_id, p), seq);
    p.unacked.pop_front();
  }

  // Silent-link watchdog (round 15), once per poll cycle next to the
  // The HELLO-grace deadline stays a (tiny, O(peers)) scan; the ack
  // watchdog itself moved onto the wheel (FireTrunkAck): a
  // partitioned-but-ESTABLISHED link never fails a syscall, so only
  // the unacked-front deadline notices its acks stopped. Entries
  // sealed while the link was down are exempt by construction (the
  // fire requires p.up, and TrunkCompleteUp re-stamps every survivor
  // at replay time).

  void TrunkFlushSock(uint64_t tag, trunk::Sock& s) {
    while (s.outpos < s.outbuf.size()) {
      // @fault(trunk_write) — blackhole = the up-but-black link: sends
      // "succeed" while the bytes vanish; the ack_gap/ack_timeout
      // watchdogs are what turn that loss back into a replay
      ssize_t n = FaultSend(fault::kSiteTrunkWrite, s.peer_id, s.fd,
                            s.outbuf.data() + s.outpos,
                            s.outbuf.size() - s.outpos);
      if (n > 0) {
        s.outpos += static_cast<size_t>(n);
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u64 = tag;
        epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, s.fd, &ev);
        return;
      } else if (n < 0 && errno == EINTR) {
        continue;
      } else {
        TrunkSockDead(tag, "sock_error");
        return;
      }
    }
    s.outbuf.clear();
    s.outpos = 0;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = tag;
    epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, s.fd, &ev);
  }

  // -- multi-core shards (round 12) ---------------------------------------
  // One Host instance per shard, each a full single-threaded epoll
  // plane; the match table is replicated (Python broadcasts ops) and
  // only DELIVERY crosses shards, over ring.h's SPSC rings in the
  // trunk BATCH entry layout prefixed with an explicit [u64 target] —
  // the producer shard did the match, so the consumer delivers by conn
  // id instead of re-matching. Degradation ladder mirrors the trunk's:
  // ring-full -> punt -> Python, decided BEFORE any side effect.

  uint64_t ShardPrefix() const {
    return static_cast<uint64_t>(shard_id_) << kShardShift;
  }
  uint64_t MintConnId() { return ShardPrefix() | next_id_++; }
  // Trunk peer links SPREAD across shards (round 15 — they all lived
  // on shard 0, the hotspot an N-node mesh would have measured): peer
  // P's dialer, replay ring, and peer state live on shard P % n.
  // Python routes the link ops there; every shard's trunk LISTENER
  // shares one port via SO_REUSEPORT so inbound links spread too. An
  // unsharded host owns every peer.
  int TrunkShardOf(uint64_t peer) const {
    return group_ ? static_cast<int>(peer % group_->n) : 0;
  }
  bool OwnsTrunkPeer(uint64_t peer) const {
    return TrunkShardOf(peer) == shard_id_;
  }

  // Producer-side admission for one destination: alive consumer and
  // >= 2 free slots (room for the open batch plus one mid-publish
  // seal — a single publish can trigger at most one byte-cap seal, so
  // the cycle-end seal always has a slot).
  // (non-const since round 15: the forced-ring_full fault site counts
  // its fire through the stats/ledger accounting)
  // @admit-check
  bool RingRoom(int dst) {
    // @fault(ring_seal) — forced ring_full: the publish degrades
    // ring-full -> punt -> Python through the REAL ladder accounting
    if (FaultHit(fault::kSiteRingSeal,
                 static_cast<uint64_t>(dst) + 1))
      return false;
    return group_ != nullptr &&
           group_->alive[dst].load(std::memory_order_acquire) &&
           group_->rings[shard_id_][dst].Free() >= 2;
  }

  // Can this publish ride `peer`'s trunk from THIS shard? Non-owner
  // shards consult their Python-broadcast up/down mirror
  // (kTrunkPeerState) and conservatively punt while the mirror lags;
  // the qos1 replay-ring bound is enforced where the ring lives
  // (the peer's owner shard — ring-forwarded entries may overshoot it
  // by the in-flight cycle, the trunk's documented soft bound).
  // @admit-check
  bool TrunkEligible(uint64_t peer, uint8_t qos,
                     size_t entry_bytes) const {
    if (qos == 2 || entry_bytes > trunk::kMaxEntryBytes) return false;
    if (OwnsTrunkPeer(peer)) {
      auto tp = trunk_peers_.find(peer);
      return tp != trunk_peers_.end() && tp->second.up &&
             !(qos == 1 &&
               tp->second.unacked.size() >= kTrunkUnackedMax);
    }
    auto it = trunk_peer_up_.find(peer);
    return it != trunk_peer_up_.end() && it->second;
  }

  // Collect the destination shards this match set needs (plain
  // cross-shard entries + each trunk leg's owner shard when it must
  // ride the ring) and check ring room for each. False = the publish
  // must degrade to a punt — called BEFORE any side effect, the trunk
  // discipline.
  // @admit-check
  bool ShardAdmit() {
    if (!group_) return true;
    xdst_scratch_.clear();
    for (const SubEntry* e : match_scratch_) {
      if (e->flags & (kSubPunt | kSubDurable | kSubRuleTap | kSubRemote))
        continue;
      int ds = ShardOf(e->owner);
      if (ds == shard_id_) continue;
      PushUnique(&xdst_scratch_, ds);
    }
    for (uint64_t peer : trunk_scratch_) {
      int ts = TrunkShardOf(peer);
      if (ts != shard_id_) PushUnique(&xdst_scratch_, ts);
    }
    for (int ds : xdst_scratch_) {
      if (!RingRoom(ds)) {
        stats_[kStShardRingFull].fetch_add(1, std::memory_order_relaxed);
        LedgerNote(kLrRingFull, static_cast<uint64_t>(ds));
        return false;
      }
    }
    return true;
  }

  // Append one cross-shard entry ([u64 target] + the trunk pre-parse
  // entry, payload-deduped per destination batch) and seal at the byte
  // cap. `target` is a conn id (delivery) or kTrunkOwnerBase + peer
  // (trunk forward from a non-trunk shard). Bit 63 of the target word
  // marks the MULTI-TARGET form below; every real target (conn ids
  // top out at bit 59, the trunk owner bit is 62) keeps it clear.
  // @admit-gated — RingRoom/ShardAdmit decide BEFORE a slot is spent
  void XShip(int dst, uint64_t target, uint64_t origin, uint8_t qos,
             bool dup, std::string_view topic, std::string_view payload) {
    std::string& b = XBatch(dst);
    char t8[8];
    memcpy(t8, &target, 8);
    b.append(t8, 8);
    XAppendEntry(dst, b, origin, qos, dup, topic, payload);
    stats_[kStShardRingOut].fetch_add(1, std::memory_order_relaxed);
    if (b.size() > kTapFlushBytes) SealShardBatch(dst);
  }

  // The fan-out form (the perf_opt spine): ONE entry per (publish,
  // destination shard) — [u64 bit63|n][n x u64 (min_qos<<60 | conn)]
  // + the shared trunk pre-parse entry. The consumer decodes the
  // topic/payload ONCE and builds the shared frames ONCE per publish,
  // exactly like FanOut's per-publish shared-frame discipline; the
  // per-target min-qos rides bits 60-61 of each target word (conn ids
  // top out at bit 59). Halves ring bytes and consumer decode for
  // wide audiences vs one single-target entry per subscriber.
  // @admit-gated — RingRoom/ShardAdmit decide BEFORE a slot is spent
  void XShipMulti(int dst, const std::vector<uint64_t>& targets,
                  uint64_t origin, uint8_t qos, std::string_view topic,
                  std::string_view payload) {
    std::string& b = XBatch(dst);
    uint64_t marker = (1ull << 63) | targets.size();
    char t8[8];
    memcpy(t8, &marker, 8);
    b.append(t8, 8);
    b.append(reinterpret_cast<const char*>(targets.data()),
             8 * targets.size());
    XAppendEntry(dst, b, origin, qos, /*dup=*/false, topic, payload);
    stats_[kStShardRingOut].fetch_add(targets.size(),
                                      std::memory_order_relaxed);
    if (b.size() > kTapFlushBytes) SealShardBatch(dst);
  }

  std::string& XBatch(int dst) {
    std::string& b = xbatch_[dst];
    if (b.empty()) {
      b.reserve(kTapFlushBytes + 512);  // one allocation per batch
      b.assign(4, '\0');  // [u32 n] patched at seal
      xdirty_.push_back(dst);
    }
    return b;
  }

  void XAppendEntry(int dst, std::string& b, uint64_t origin,
                    uint8_t qos, bool dup, std::string_view topic,
                    std::string_view payload) {
    bool inline_payload =
        !(xhave_prev_[dst] && payload == xprev_payload_[dst]);
    // the active trace id rides the ring entry (flags bit4): both ends
    // are this binary, so no version negotiation — the consumer shard
    // re-joins the sampled publish's timeline at ring_cross
    trunk::AppendEntry(&b, origin, qos, dup, inline_payload, topic,
                       payload, cur_trace_);
    if (inline_payload) {
      xprev_payload_[dst].assign(payload.data(), payload.size());
      xhave_prev_[dst] = true;
    }
    xbatch_n_[dst]++;
  }

  void SealShardBatch(int dst) {
    std::string& b = xbatch_[dst];
    if (xbatch_n_[dst] == 0) {
      b.clear();
      return;
    }
    memcpy(&b[0], &xbatch_n_[dst], 4);
    // ring the doorbell on the FIRST seal of a cycle, not just at
    // cycle end (FlushShards): a long read-backlog cycle seals many
    // byte-cap batches, and a consumer sleeping until cycle end would
    // turn the pipeline half-duplex (measured ~15% on the 2-core box)
    bool first = xbatch_sealed_[dst] == 0;
    xbatch_sealed_[dst]++;
    if (!group_->rings[shard_id_][dst].Push(std::move(b))) {
      // the consumer wedged past the admission margin (it only holds
      // under a torn-down shard racing the pre-check): drop with the
      // backpressure accounting a stalled local subscriber would get
      stats_[kStShardRingFull].fetch_add(1, std::memory_order_relaxed);
      stats_[kStDropsBackpressure].fetch_add(xbatch_n_[dst],
                                             std::memory_order_relaxed);
      LedgerNote(kLrRingFull, static_cast<uint64_t>(dst));
    }
    b.clear();  // Push moved it on success; failure keeps it — clear both
    xbatch_n_[dst] = 0;
    xprev_payload_[dst].clear();
    xhave_prev_[dst] = false;
    // @fault(ring_doorbell) — a suppressed wakeup: the consumer must
    // still drain on its next natural poll timeout (late, never lost)
    if (first && !FaultHit(fault::kSiteRingDoorbell,
                           static_cast<uint64_t>(dst) + 1))
      group_->RingDoorbell(dst);
  }

  // Once per poll cycle (the FlushTrunks discipline): seal every dirty
  // destination batch and ring its doorbell.
  void FlushShards() {
    if (xdirty_.empty()) return;
    std::vector<int> dirty;
    dirty.swap(xdirty_);
    for (int dst : dirty) {
      SealShardBatch(dst);
      // @fault(ring_doorbell) — cycle-end wakeup suppressed too
      if (!FaultHit(fault::kSiteRingDoorbell,
                    static_cast<uint64_t>(dst) + 1))
        group_->RingDoorbell(dst);
      xbatch_sealed_[dst] = 0;
    }
  }

  // Consume every inbound ring once per poll cycle.
  void DrainShardRings() {
    bool any = false;
    std::string rec;
    for (int src = 0; src < group_->n; src++) {
      if (src == shard_id_) continue;
      ring::SpscRing& r = group_->rings[src][shard_id_];
      while (r.Pop(&rec)) {
        ApplyShardBatch(src, rec);
        any = true;
      }
    }
    if (any) FlushDirty();
  }

  // Apply one ring batch: explicit per-target deliveries (the producer
  // shard did the match and pre-minned each target's qos), plus
  // trunk-forward entries (target carries the trunk owner bit) from
  // shards without trunk links. Fan-out entries carry one target LIST
  // per publish (XShipMulti), so topic/payload decode and the shared
  // frame builds run once per publish — FanOut's discipline, across
  // the ring.
  void ApplyShardBatch(int src, const std::string& rec) {
    if (rec.size() < 4) return;
    uint32_t n = 0;
    memcpy(&n, rec.data(), 4);
    if (telemetry_) RecordHist(kHistShardRingN, n);
    const char* body = rec.data();
    size_t blen = rec.size();
    size_t pos = 4;
    std::string_view prev_payload;
    bool have_prev = false;
    std::string_view last_topic;
    const char* last_pl = nullptr;
    uint64_t applied = 0;
    constexpr uint64_t kConnMask = (1ull << 60) - 1;
    for (uint32_t i = 0; i < n && pos + 8 <= blen; i++) {
      uint64_t t0 = 0;
      memcpy(&t0, body + pos, 8);
      pos += 8;
      uint32_t ntgt = 0;
      size_t tgts_at = 0;
      if (t0 >> 63) {  // multi-target marker: [bit63|n][n x u64]
        ntgt = static_cast<uint32_t>(t0 & 0xFFFFFFFFu);
        if (ntgt == 0 || pos + 8ull * ntgt > blen) break;
        tgts_at = pos;
        pos += 8ull * ntgt;
      }
      if (pos + 11 > blen) break;
      uint64_t origin = 0;
      memcpy(&origin, body + pos, 8);
      uint8_t flags = static_cast<uint8_t>(body[pos + 8]);
      uint16_t tlen = 0;
      memcpy(&tlen, body + pos + 9, 2);
      pos += 11;
      if (pos + tlen > blen) break;
      std::string_view topic(body + pos, tlen);
      pos += tlen;
      uint64_t trace = 0;
      if (flags & 0x10) {  // the producer shard sampled this publish
        if (pos + 8 > blen) break;
        memcpy(&trace, body + pos, 8);
        pos += 8;
      }
      std::string_view payload;
      if (flags & 1) {
        if (pos + 4 > blen) break;
        uint32_t pl = 0;
        memcpy(&pl, body + pos, 4);
        pos += 4;
        if (pos + pl > blen) break;
        payload = std::string_view(body + pos, pl);
        pos += pl;
        prev_payload = payload;
        have_prev = true;
      } else {
        if (!have_prev) break;  // corrupt batch: dedup with no reference
        payload = prev_payload;
      }
      uint8_t qos = (flags >> 1) & 3;
      bool dup = (flags & 8) != 0;
      // re-join the sampled publish's timeline on THIS shard: the
      // consumer-side deliveries below emit deliver_write spans under
      // the propagated id, anchored by one ring_cross point (aux =
      // the producing shard)
      cur_trace_ = trace;
      if (trace) {
        cur_trace_delivers_ = 0;
        SpanNote(kSpanRingCross, static_cast<uint64_t>(src));
      }
      if (ntgt == 0 && (t0 & kTrunkOwnerBase)) {
        applied++;
        TrunkEnqueue(t0 - kTrunkOwnerBase, origin, qos, dup, topic,
                     payload);
        continue;
      }
      // DeliverTo's shared frames are per-publish scratch (the qos0
      // frame and the zero-pid elevated frame are both qos-patched per
      // target): rebuild only when (topic, payload) changed
      if (topic != last_topic || payload.data() != last_pl) {
        frame_v4_.clear();
        frame_v5_.clear();
        frame_q_v4_.clear();
        frame_q_v5_.clear();
        last_topic = topic;
        last_pl = payload.data();
        if (telemetry_) cur_hash_ = TopicHash(topic);
      }
      if (ntgt == 0) {
        applied++;
        SubEntry e{t0, qos, 0};
        DeliverTo(t0, e, origin, qos, topic, payload);
        continue;
      }
      applied += ntgt;
      for (uint32_t k = 0; k < ntgt; k++) {
        uint64_t w = 0;
        memcpy(&w, body + tgts_at + 8ull * k, 8);
        uint8_t oq = static_cast<uint8_t>((w >> 60) & 3);
        uint64_t conn = w & kConnMask;
        SubEntry e{conn, oq, 0};
        DeliverTo(conn, e, origin, oq, topic, payload);
      }
    }
    cur_trace_ = 0;  // batch context over: nothing later may inherit it
    if (applied)
      stats_[kStShardRingIn].fetch_add(applied, std::memory_order_relaxed);
  }

  // -- mqtt-sn gateway (round 11) -----------------------------------------
  // Foreign framing → same MQTT fast path, the ws.h pattern applied to
  // the first UDP gateway: datagrams decode with the shared sn.h codec,
  // translate into MQTT frames, and ride TryFast / the Python channel
  // exactly like TCP bytes would. Egress reverses the translation (one
  // SN datagram per MQTT packet), with a per-conn topic-id registry,
  // sleeping-client buffering, and qos1 retransmit-on-timeout — the
  // asyncio gateway (gateway/mqttsn.py) stays the protocol oracle.

  static uint64_t SnAddrKey(const sockaddr_in& a) {
    return (static_cast<uint64_t>(a.sin_addr.s_addr) << 16) | a.sin_port;
  }

  static void BuildMqttFrame(std::string* out, uint8_t header,
                             const std::string& body) {
    out->push_back(static_cast<char>(header));
    size_t r = body.size();
    do {
      uint8_t b = r & 0x7F;
      r >>= 7;
      out->push_back(static_cast<char>(r ? b | 0x80 : b));
    } while (r);
    *out += body;
  }

  static void MakeMqttAck(std::string* out, uint8_t header, uint16_t pid) {
    out->push_back(static_cast<char>(header));
    out->push_back(0x02);
    out->push_back(static_cast<char>(pid >> 8));
    out->push_back(static_cast<char>(pid & 0xFF));
  }

  // One recvmmsg drains up to kSnRecvBatch datagrams per syscall.
  // Per-datagram UDP syscalls are brutal on sandboxed kernels
  // (~30us/recvfrom measured here vs ~5us amortized via recvmmsg),
  // and peers aggregate messages per datagram (sn.h kPackDatagram),
  // so one syscall can carry thousands of SN messages.
  static constexpr int kSnRecvBatch = 32;
  static constexpr size_t kSnRecvBuf = 65536;  // UDP max: never truncates

  void SnRead() {
    if (sn_rx_buf_.empty()) sn_rx_buf_.resize(kSnRecvBatch * kSnRecvBuf);
    mmsghdr mm[kSnRecvBatch];
    iovec iov[kSnRecvBatch];
    sockaddr_in peers[kSnRecvBatch];
    // bounded per cycle so an SN blast cannot starve the TCP/WS side
    for (int budget = 0; budget < 4096; budget += kSnRecvBatch) {
      for (int i = 0; i < kSnRecvBatch; i++) {
        iov[i].iov_base = sn_rx_buf_.data() + i * kSnRecvBuf;
        iov[i].iov_len = kSnRecvBuf;
        memset(&mm[i].msg_hdr, 0, sizeof(mm[i].msg_hdr));
        mm[i].msg_hdr.msg_name = &peers[i];
        mm[i].msg_hdr.msg_namelen = sizeof(peers[i]);
        mm[i].msg_hdr.msg_iov = &iov[i];
        mm[i].msg_hdr.msg_iovlen = 1;
      }
      int n = recvmmsg(sn_fd_, mm, kSnRecvBatch, 0, nullptr);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;  // EAGAIN: drained
      }
      for (int i = 0; i < n; i++) {
        if (mm[i].msg_len == 0) continue;
        const uint8_t* d = sn_rx_buf_.data() + i * kSnRecvBuf;
        if (telemetry_ && ((++tele_tick_sn_ & tele_mask_) == 0)) {
          uint64_t t0 = NowNs();
          SnIngest(peers[i], d, mm[i].msg_len);
          RecordHist(kHistSnIngest, NowNs() - t0);
        } else {
          SnIngest(peers[i], d, mm[i].msg_len);
        }
      }
      if (n < kSnRecvBatch) break;  // drained
    }
    FlushDirty();
  }

  void SnIngest(const sockaddr_in& peer, const uint8_t* data, size_t len) {
    sn_msgs_scratch_.clear();
    sn::ParseAll(data, len, &sn_msgs_scratch_);
    for (sn::SnMsg& m : sn_msgs_scratch_) SnHandle(peer, m);
  }

  // Mirror of IngestMqtt's per-frame body for a single translated frame.
  void SnForward(uint64_t id, Conn& c, const std::string& f) {
    if (!c.fast || !TryFast(id, c, f)) {
      FrNote(c, c.fast ? kFrPunt : kFrFrame,
             static_cast<uint8_t>(f[0]) >> 4,
             static_cast<uint16_t>(f.size() & 0xFFFF));
      events_.push_back(EncodeRecord(2, id, f.data(), f.size()));
    }
  }

  void SnReply(uint64_t id, Conn& c, const sn::SnMsg& m) {
    // control answers bypass the sleep buffer (the oracle's handle_in
    // replies go straight out too; only DELIVERIES park)
    std::string dg;
    sn::Serialize(m, &dg);
    c.outbuf += dg;
    MarkDirty(id, c);
  }

  // Conn-less direct answer (SEARCHGW, not-connected DISCONNECT).
  void SnSendTo(const sockaddr_in& peer, const sn::SnMsg& m) {
    std::string dg;
    sn::Serialize(m, &dg);
    sendto(sn_fd_, dg.data(), dg.size(), MSG_NOSIGNAL,
           reinterpret_cast<const sockaddr*>(&peer), sizeof(peer));
  }

  std::string SnDefaultCid(uint64_t id) {
    // the oracle mints "sn-<id(self)>"-style fallbacks; ours are the
    // conn id, which is stable for the conn's lifetime
    return "sn-" + std::to_string(id & 0xFFFFFFFFull);
  }

  uint64_t SnNewConn(const sockaddr_in& peer) {
    Conn c;
    c.fd = -1;  // egress rides sendto() on the shared UDP socket
    c.framer = Framer(max_size_);
    c.sn = std::make_unique<SnConnState>();
    c.sn->addr = peer;
    uint64_t id = kSnConnBit | ShardPrefix() | next_sn_id_++;
    c.sn->conn_id = id;
    auto& cref = conns_.emplace(id, std::move(c)).first->second;
    sn_addr_conn_[SnAddrKey(peer)] = id;
    cref.last_rx_ms = NowMs();
    FrNote(cref, kFrOpen, 0, 2);  // arg 2 = SN transport
    char ip[INET_ADDRSTRLEN] = "?";
    inet_ntop(AF_INET, &peer.sin_addr, ip, sizeof(ip));
    std::string info = std::string("sn:") + ip + ":" +
                       std::to_string(ntohs(peer.sin_port));
    events_.push_back(EncodeRecord(1, id, info.data(), info.size()));
    return id;
  }

  // Translate + forward the CONNECT; the Python channel owns the
  // session (auth, CM takeover, hooks) exactly as for TCP clients.
  void SnConnect(uint64_t id, const sn::SnMsg& m) {
    auto it = conns_.find(id);
    if (it == conns_.end()) return;
    Conn& c = it->second;
    SnConnState& s = *c.sn;
    s.clientid = m.clientid.empty() ? SnDefaultCid(id) : m.clientid;
    s.connect_sent = true;
    s.connected = false;
    // duration 0 = "no keepalive" on the wire; the asyncio listener
    // idle-times those peers out at 300s (conn.py UdpGwListener
    // default) — translating 0 to 300 gives the native conn the same
    // effective lifetime instead of leaking it forever
    uint16_t keepalive = m.duration ? m.duration : 300;
    std::string body;
    body.push_back(0);
    body.push_back(4);
    body += "MQTT";
    body.push_back(4);  // translated SN sessions speak MQTT 3.1.1
    body.push_back((m.flags & sn::kFClean) ? 0x02 : 0x00);
    sn::PutBe16(&body, keepalive);
    sn::PutBe16(&body, static_cast<uint16_t>(s.clientid.size()));
    body += s.clientid;
    std::string f;
    BuildMqttFrame(&f, 0x10, body);
    SnForward(id, c, f);
  }

  bool SnResolveTopic(SnConnState& s, uint8_t kind, uint16_t topic_id,
                      std::string* topic) {
    if (kind == sn::kTidPredef) {
      auto it = sn_predefined_.find(topic_id);
      if (it == sn_predefined_.end()) return false;
      *topic = it->second;
      return true;
    }
    if (kind == sn::kTidShort) {
      topic->clear();
      topic->push_back(static_cast<char>(topic_id >> 8));
      topic->push_back(static_cast<char>(topic_id & 0xFF));
      return true;
    }
    auto it = s.topic_of_id.find(topic_id);
    if (it == s.topic_of_id.end()) return false;
    *topic = it->second;
    return true;
  }

  // Per-conn NORMAL id allocation: wrap at the u16 ceiling skipping
  // ids still in use and the reserved 0x0000 (the oracle's fixed
  // _alloc_tid). Returns 0 only when all 65535 ids are taken.
  uint16_t SnAllocTid(SnConnState& s, const std::string& topic) {
    auto it = s.id_of_topic.find(topic);
    if (it != s.id_of_topic.end()) return it->second;
    // wrap in 1..0xFFFE: 0x0000 AND 0xFFFF are reserved (§5.3.11)
    for (int guard = 0; guard < 0xFFFE; guard++) {
      s.next_tid = static_cast<uint16_t>(s.next_tid % 0xFFFE + 1);
      if (!s.topic_of_id.count(s.next_tid)) {
        s.id_of_topic[topic] = s.next_tid;
        s.topic_of_id[s.next_tid] = topic;
        return s.next_tid;
      }
    }
    return 0;
  }

  uint16_t SnNextMid(SnConnState& s) {
    s.next_mid = static_cast<uint16_t>(s.next_mid % 0xFFFF + 1);
    return s.next_mid;
  }

  void SnHandle(const sockaddr_in& peer, sn::SnMsg& m) {
    if (m.type == sn::kSearchGw) {
      sn::SnMsg gi;
      gi.type = sn::kGwInfo;
      gi.rc = sn_gw_id_;
      SnSendTo(peer, gi);
      return;
    }
    if (m.type == sn::kPublish && sn::QosOf(m.flags) < 0) {
      SnQosM1(m);
      return;
    }
    uint64_t key = SnAddrKey(peer);
    auto ait = sn_addr_conn_.find(key);
    if (ait == sn_addr_conn_.end()) {
      if (m.type == sn::kConnect) {
        if (conns_.size() >= max_conns_) return;  // esockd max-conn
        SnConnect(SnNewConn(peer), m);
      } else if (m.type != sn::kDisconnect && m.type != sn::kPingReq) {
        // unknown peer mid-protocol: the oracle's not-connected answer
        sn::SnMsg d;
        d.type = sn::kDisconnect;
        SnSendTo(peer, d);
      }
      return;
    }
    uint64_t id = ait->second;
    auto cit = conns_.find(id);
    if (cit == conns_.end()) {
      sn_addr_conn_.erase(ait);
      return;
    }
    Conn& c = cit->second;
    SnConnState& s = *c.sn;
    c.last_rx_ms = NowMs();
    if (m.type == sn::kConnect) {
      if (s.connected) {
        // any CONNECT on a live conn re-runs the session open — the
        // oracle re-authenticates and re-opens on EVERY CONNECT (a
        // rebooted device with F_CLEAN must get clean-start semantics,
        // and a freshly banned clientid must be re-checked, not waved
        // through as a CONNACK retransmit). Release the old session
        // through the Python channel (close_session parity) and
        // connect fresh; same-clientid reconnects take over their old
        // session in Python exactly like a TCP takeover. The old conn
        // keeps draining; the addr now maps to the new conn.
        sn_addr_conn_.erase(key);
        std::string f;
        f.push_back(static_cast<char>(0xE0));
        f.push_back(0);
        SnForward(id, c, f);
        // conns_ may rehash on the emplace: no Conn& use after this
        SnConnect(SnNewConn(peer), m);
      }
      // else: CONNECT retransmit while the first is awaiting its
      // CONNACK — the in-flight answer covers it
      return;
    }
    if (m.type == sn::kPingReq) {
      stats_[kStSnPings].fetch_add(1, std::memory_order_relaxed);
      if (!s.awake || !s.sleep_buf.empty()) {
        // waking flushes parked deliveries BEFORE the ping answer
        // (MQTT-SN §6.14 buffered delivery on the keepalive ping)
        s.awake = true;
        s.sleep_until_ms = 0;
        while (!s.sleep_buf.empty()) {
          c.outbuf += s.sleep_buf.front();
          s.sleep_buf.pop_front();
        }
        // the flush IS the first transmission of any qos1 delivery
        // parked during sleep — restart the retry clock from here
        uint64_t woke = NowMs();
        for (auto& r : s.rexmit) r.last_tx_ms = woke;
        // re-arm the rexmit wheel deadline the sleep entry cancelled
        if (!s.rexmit.empty() && !s.tm_rexmit)
          s.tm_rexmit = wheel_.Arm(id, kTmSnRexmit, woke + kSnRetryMs);
        MarkDirty(id, c);
      }
      if (s.connected) {
        std::string f;
        f.push_back(static_cast<char>(0xC0));
        f.push_back(0);
        SnForward(id, c, f);  // Python answers PINGRESP -> SN PINGRESP
      }
      return;
    }
    if (m.type == sn::kDisconnect) {
      sn::SnMsg d;
      d.type = sn::kDisconnect;
      if (m.duration) {
        // sleep mode: keep the session, stop delivering, start the
        // announced-silence window the keepalive feed honours
        s.awake = false;
        s.sleep_until_ms = NowMs() + static_cast<uint64_t>(m.duration)
                                     * 1000;
        // park the retry clock with the radio (wake re-arms it)
        if (s.tm_rexmit) {
          wheel_.Cancel(s.tm_rexmit);
          s.tm_rexmit = 0;
        }
        SnReply(id, c, d);
        return;
      }
      SnReply(id, c, d);
      std::string f;
      f.push_back(static_cast<char>(0xE0));
      f.push_back(0);
      SnForward(id, c, f);  // Python tears the session down + closes
      return;
    }
    if (!s.connected) {
      if (s.connect_sent && !s.connack_seen &&
          s.preconn.size() < kSnPreconnMax) {
        // CONNECT is in flight to the Python channel. The oracle
        // connects synchronously, so a client that pipelines
        // REGISTER/SUBSCRIBE/PUBLISH behind its CONNECT (or packs
        // them into one datagram) must have them served, not bounced.
        // Park until the CONNACK egresses, then replay in order.
        s.preconn.push_back(std::move(m));
        return;
      }
      // oracle: everything else requires a session
      sn::SnMsg d;
      d.type = sn::kDisconnect;
      SnReply(id, c, d);
      return;
    }
    SnDispatch(id, c, m);
  }

  // One post-session SN message (the oracle's connected-state
  // handle_in). Split from SnHandle so the preconn replay after a
  // CONNACK egress runs the identical code path.
  static constexpr size_t kSnPreconnMax = 64;

  void SnDispatch(uint64_t id, Conn& c, sn::SnMsg& m) {
    SnConnState& s = *c.sn;
    switch (m.type) {
      case sn::kRegister: {
        uint16_t tid = SnAllocTid(s, m.topic_name);
        stats_[kStSnRegisters].fetch_add(1, std::memory_order_relaxed);
        sn::SnMsg ra;
        ra.type = sn::kRegack;
        ra.topic_id = tid;
        ra.msg_id = m.msg_id;
        // tid 0 is the reserved invalid id: a full registry must answer
        // "rejected: congestion", not hand 0 out as a success
        ra.rc = tid ? sn::kRcAccepted : sn::kRcCongestion;
        SnReply(id, c, ra);
        break;
      }
      case sn::kPublish: {
        int qi = sn::QosOf(m.flags);
        uint8_t qos = qi < 0 ? 0 : static_cast<uint8_t>(qi);
        std::string topic;
        if (!SnResolveTopic(s, m.flags & 0x3, m.topic_id, &topic)) {
          if (qos > 0) {
            sn::SnMsg pa;
            pa.type = sn::kPuback;
            pa.topic_id = m.topic_id;
            pa.msg_id = m.msg_id;
            pa.rc = sn::kRcInvalidTopicId;
            SnReply(id, c, pa);
          }
          break;
        }
        stats_[kStSnIn].fetch_add(1, std::memory_order_relaxed);
        if (qos > 0) {
          // the MQTT ack coming back carries only the msg id; the SN
          // PUBACK needs the topic id too (runaway-bound: a client
          // that never sees its acks can't grow this past the id space)
          if (s.pub_tid.size() > 8192) s.pub_tid.clear();
          s.pub_tid[m.msg_id] = m.topic_id;
        }
        std::string body;
        sn::PutBe16(&body, static_cast<uint16_t>(topic.size()));
        body += topic;
        if (qos) sn::PutBe16(&body, m.msg_id);
        body += m.data;
        uint8_t h = static_cast<uint8_t>(0x30 | (qos << 1));
        if (m.flags & sn::kFDup) h |= 0x08;
        if (m.flags & sn::kFRetain) h |= 0x01;
        std::string f;
        BuildMqttFrame(&f, h, body);
        SnForward(id, c, f);
        break;
      }
      case sn::kPuback: {
        // subscriber acked a delivery: retire the retransmit copy
        // FIRST, then route the ack like any wire PUBACK (native pids
        // consume in TryFastPuback, Python pids forward to the session)
        SnRexmitAck(id, s, m.msg_id);
        std::string f;
        MakeMqttAck(&f, 0x40, m.msg_id);
        SnForward(id, c, f);
        break;
      }
      case sn::kPubrec: {
        std::string f;
        MakeMqttAck(&f, 0x50, m.msg_id);
        SnForward(id, c, f);
        break;
      }
      case sn::kPubrel: {
        std::string f;
        MakeMqttAck(&f, 0x62, m.msg_id);
        SnForward(id, c, f);
        break;
      }
      case sn::kPubcomp: {
        std::string f;
        MakeMqttAck(&f, 0x70, m.msg_id);
        SnForward(id, c, f);
        break;
      }
      case sn::kSubscribe: {
        uint8_t kind = m.flags & 0x3;
        std::string topic;
        uint16_t tid = 0;
        if (kind == sn::kTidPredef) {
          auto pit = sn_predefined_.find(m.topic_id);
          if (pit != sn_predefined_.end()) {
            topic = pit->second;
            tid = m.topic_id;
          }
        } else {
          topic = m.topic_name;
          bool wild = topic.find('+') != std::string::npos ||
                      topic.find('#') != std::string::npos;
          // wildcard filters get no id (delivery auto-registers one)
          tid = (wild || topic.empty()) ? 0 : SnAllocTid(s, topic);
        }
        if (topic.empty()) {
          sn::SnMsg sa;
          sa.type = sn::kSuback;
          sa.flags = m.flags;
          sa.msg_id = m.msg_id;
          sa.rc = sn::kRcInvalidTopicId;
          SnReply(id, c, sa);
          break;
        }
        // grant what delivery honours: SN deliveries cap at qos1
        // (oracle handle_deliver), so the granted qos does too
        int qi = sn::QosOf(m.flags);
        uint8_t qos = qi < 1 ? 0 : 1;
        if (s.sub_tid.size() > 1024) s.sub_tid.clear();
        s.sub_tid[m.msg_id] =
            (static_cast<uint32_t>(m.flags) << 16) | tid;
        std::string body;
        sn::PutBe16(&body, m.msg_id);
        sn::PutBe16(&body, static_cast<uint16_t>(topic.size()));
        body += topic;
        body.push_back(static_cast<char>(qos));
        std::string f;
        BuildMqttFrame(&f, 0x82, body);
        SnForward(id, c, f);  // SUBSCRIBE always runs the Python plane
        break;
      }
      case sn::kUnsubscribe: {
        std::string topic;
        if ((m.flags & 0x3) == sn::kTidPredef) {
          auto pit = sn_predefined_.find(m.topic_id);
          if (pit != sn_predefined_.end()) topic = pit->second;
        } else {
          topic = m.topic_name;
        }
        if (topic.empty()) {
          sn::SnMsg ua;
          ua.type = sn::kUnsuback;
          ua.msg_id = m.msg_id;
          SnReply(id, c, ua);  // the oracle UNSUBACKs regardless
          break;
        }
        std::string body;
        sn::PutBe16(&body, m.msg_id);
        sn::PutBe16(&body, static_cast<uint16_t>(topic.size()));
        body += topic;
        std::string f;
        BuildMqttFrame(&f, 0xA2, body);
        SnForward(id, c, f);
        break;
      }
      default:
        break;  // WILL machinery et al: not served (oracle parity)
    }
  }

  // QoS -1 (§6.8): publish-without-connect on a predefined or short
  // topic. Routed through ONE shared anonymous conn whose synthesized
  // session ("sn-anon") earns publish permits like any client — so a
  // hot QoS -1 topic runs the native fast path after its first pass.
  void SnQosM1(const sn::SnMsg& m) {
    stats_[kStSnQosM1].fetch_add(1, std::memory_order_relaxed);
    uint8_t kind = m.flags & 0x3;
    std::string topic;
    if (kind == sn::kTidPredef) {
      auto it = sn_predefined_.find(m.topic_id);
      if (it == sn_predefined_.end()) return;  // fire-and-forget: drop
      topic = it->second;
    } else if (kind == sn::kTidShort) {
      topic.push_back(static_cast<char>(m.topic_id >> 8));
      topic.push_back(static_cast<char>(m.topic_id & 0xFF));
    } else {
      return;  // NORMAL ids need a connection's registry (oracle)
    }
    uint64_t id = EnsureSnAnon();
    auto it = conns_.find(id);
    if (it == conns_.end()) return;
    std::string body;
    sn::PutBe16(&body, static_cast<uint16_t>(topic.size()));
    body += topic;
    body += m.data;
    uint8_t h = static_cast<uint8_t>(
        0x30 | ((m.flags & sn::kFRetain) ? 1 : 0));
    std::string f;
    BuildMqttFrame(&f, h, body);
    SnForward(id, it->second, f);
  }

  uint64_t EnsureSnAnon() {
    if (sn_anon_id_ && conns_.count(sn_anon_id_)) return sn_anon_id_;
    Conn c;
    c.fd = -1;
    c.framer = Framer(max_size_);
    c.sn = std::make_unique<SnConnState>();
    c.sn->anon = true;
    c.sn->connected = true;
    c.sn->connect_sent = true;
    // per-shard clientid: two shards each minting "sn-anon" would CM-
    // takeover-kick each other's session forever (shard 0 keeps the
    // unsharded name)
    std::string cid = shard_id_ ? "sn-anon-s" + std::to_string(shard_id_)
                                : "sn-anon";
    c.sn->clientid = cid;
    uint64_t id = kSnConnBit | ShardPrefix() | next_sn_id_++;
    c.sn->conn_id = id;
    auto& cref = conns_.emplace(id, std::move(c)).first->second;
    cref.last_rx_ms = NowMs();
    sn_anon_id_ = id;
    events_.push_back(EncodeRecord(1, id, "sn:anon", 7));
    // synthesize the CONNECT so the Python channel opens a real
    // session; keepalive 0 = the anon publisher never idles out
    std::string body;
    body.push_back(0);
    body.push_back(4);
    body += "MQTT";
    body.push_back(4);
    body.push_back(0x02);
    sn::PutBe16(&body, 0);
    sn::PutBe16(&body, static_cast<uint16_t>(cid.size()));
    body += cid;
    std::string f;
    BuildMqttFrame(&f, 0x10, body);
    SnForward(id, cref, f);
    return id;
  }

  // -- SN egress (MQTT -> SN translation) ---------------------------------

  void SnEgress(Conn& c, const char* data, size_t len) {
    sn_frames_scratch_.clear();
    c.sn->egress.Feed(reinterpret_cast<const uint8_t*>(data), len,
                      &sn_frames_scratch_);
    for (const std::string& f : sn_frames_scratch_)
      SnTranslateEgress(c, f);
    // a CONNACK in this span settles the CONNECT round trip: replay
    // pipelined messages AFTER the scratch loop (dispatch may re-enter
    // egress paths) and after the CONNACK bytes joined the outbuf, so
    // the client sees CONNACK before any REGACK/SUBACK/PUBACK
    if (c.sn->connack_seen && !c.sn->preconn.empty())
      SnDrainPreconn(c.sn->conn_id);
  }

  void SnDrainPreconn(uint64_t id) {
    std::deque<sn::SnMsg> q;
    {
      auto it = conns_.find(id);
      if (it == conns_.end() || !it->second.sn) return;
      q.swap(it->second.sn->preconn);
    }
    for (sn::SnMsg& m : q) {
      // re-find each round: a dispatched PUBLISH can rehash conns_
      auto it = conns_.find(id);
      if (it == conns_.end() || !it->second.sn) return;
      Conn& c = it->second;
      if (c.sn->connected) {
        SnDispatch(id, c, m);
      } else {
        // CONNACK was a reject: the oracle answers each post-CONNECT
        // message in the not-connected state with DISCONNECT
        sn::SnMsg d;
        d.type = sn::kDisconnect;
        SnReply(id, c, d);
      }
    }
  }

  void SnTranslateEgress(Conn& c, const std::string& f) {
    SnConnState& s = *c.sn;
    uint8_t type = static_cast<uint8_t>(f[0]) >> 4;
    size_t pos = 1;
    while (pos < f.size() && (static_cast<uint8_t>(f[pos]) & 0x80)) pos++;
    pos++;  // first body byte
    auto pid_at = [&](size_t at) -> uint16_t {
      if (at + 2 > f.size()) return 0;
      return static_cast<uint16_t>(
          (static_cast<uint8_t>(f[at]) << 8) |
          static_cast<uint8_t>(f[at + 1]));
    };
    sn::SnMsg m;
    switch (type) {
      case 2: {  // CONNACK
        if (pos + 2 > f.size()) return;
        uint8_t rc = static_cast<uint8_t>(f[pos + 1]);
        s.connack_seen = true;
        if (rc == 0) s.connected = true;
        m.type = sn::kConnack;
        m.rc = rc ? sn::kRcNotSupported : sn::kRcAccepted;
        break;
      }
      case 3: {  // PUBLISH: a Python-plane delivery for this SN client
        uint8_t h = static_cast<uint8_t>(f[0]);
        uint8_t qos = (h >> 1) & 3;
        if (pos + 2 > f.size()) return;
        uint16_t tlen = pid_at(pos);
        pos += 2;
        if (pos + tlen > f.size()) return;
        std::string_view topic(f.data() + pos, tlen);
        pos += tlen;
        uint16_t pid = 0;
        if (qos) {
          pid = pid_at(pos);
          pos += 2;
          if (pos > f.size()) return;
        }
        std::string_view payload(f.data() + pos, f.size() - pos);
        // the oracle's delivery cap: SN PUBLISHes never exceed qos1
        SnDeliverPublish(c, topic, payload, qos > 1 ? 1 : qos,
                         (h & 1) != 0, (h & 8) != 0, pid);
        return;
      }
      case 4: {  // PUBACK: needs the topic id the MQTT ack dropped
        uint16_t pid = pid_at(pos);
        m.type = sn::kPuback;
        m.msg_id = pid;
        m.rc = sn::kRcAccepted;
        auto it = s.pub_tid.find(pid);
        if (it != s.pub_tid.end()) {
          m.topic_id = it->second;
          s.pub_tid.erase(it);
        }
        break;
      }
      case 5:
        m.type = sn::kPubrec;
        m.msg_id = pid_at(pos);
        break;
      case 6:
        m.type = sn::kPubrel;
        m.msg_id = pid_at(pos);
        break;
      case 7:
        m.type = sn::kPubcomp;
        m.msg_id = pid_at(pos);
        s.pub_tid.erase(m.msg_id);  // the qos2 ingest entry retires here
        break;
      case 9: {  // SUBACK
        uint16_t pid = pid_at(pos);
        uint8_t rc = static_cast<uint8_t>(f.back());
        m.type = sn::kSuback;
        m.msg_id = pid;
        uint32_t ctx2 = 0;
        auto it = s.sub_tid.find(pid);
        if (it != s.sub_tid.end()) {
          ctx2 = it->second;
          s.sub_tid.erase(it);
        }
        if (rc >= 0x80) {
          // denied: echo the REQUEST flags, tid 0 (oracle shape)
          m.flags = static_cast<uint8_t>(ctx2 >> 16);
          m.topic_id = 0;
          m.rc = sn::kRcNotSupported;
        } else {
          m.flags = sn::QosFlags(rc);
          m.topic_id = static_cast<uint16_t>(ctx2 & 0xFFFF);
          m.rc = sn::kRcAccepted;
        }
        break;
      }
      case 11:
        m.type = sn::kUnsuback;
        m.msg_id = pid_at(pos);
        break;
      case 13:
        m.type = sn::kPingResp;
        break;
      case 14:
        m.type = sn::kDisconnect;
        break;
      default:
        return;  // nothing else egresses to an SN client
    }
    std::string dg;
    sn::Serialize(m, &dg);
    c.outbuf += dg;  // control answers bypass the sleep buffer
  }

  // -- SN delivery encode -------------------------------------------------

  void SnOut(Conn& c, const std::string& dgram) {
    SnConnState& s = *c.sn;
    if (!s.awake) {
      // asleep (radio off): park until the next PINGREQ, bounded
      // drop-oldest like the session mqueue (oracle parity). Oldest
      // means oldest PUBLISH — evicting a parked auto-REGISTER while
      // keeping its paired PUBLISH would leave the client holding
      // deliveries on a topic id it never learned, undecodable for
      // the rest of the session (the oracle is immune: it parks
      // deliveries pre-encoding and auto-registers at wake).
      if (s.sleep_buf.size() >= kMaxPending) {
        auto vic = s.sleep_buf.begin();
        for (; vic != s.sleep_buf.end(); ++vic) {
          const std::string& d = *vic;
          size_t toff = static_cast<uint8_t>(d[0]) == 1 ? 3 : 1;
          if (toff < d.size() &&
              static_cast<uint8_t>(d[toff]) != sn::kRegister)
            break;
        }
        s.sleep_buf.erase(vic == s.sleep_buf.end() ? s.sleep_buf.begin()
                                                   : vic);
      }
      s.sleep_buf.push_back(dgram);
      stats_[kStSnSleepParked].fetch_add(1, std::memory_order_relaxed);
      return;
    }
    c.outbuf += dgram;
  }

  // Resolve (auto-registering) the NORMAL topic id a delivery needs —
  // the REGISTER goes out (or parks) ahead of the PUBLISH, so the
  // client can decode the id (oracle handle_deliver).
  uint16_t SnDeliverTid(Conn& c, std::string_view topic) {
    SnConnState& s = *c.sn;
    if (topic.size() > sn::kMaxTopic) return 0;  // REGISTER can't frame it
    std::string key(topic);
    auto it = s.id_of_topic.find(key);
    if (it != s.id_of_topic.end()) return it->second;
    uint16_t tid = SnAllocTid(s, key);
    if (!tid) return 0;  // registry full: nothing deliverable
    sn::SnMsg rg;
    rg.type = sn::kRegister;
    rg.topic_id = tid;
    rg.msg_id = SnNextMid(s);
    rg.topic_name = key;
    std::string dg;
    sn::Serialize(rg, &dg);
    SnOut(c, dg);
    return tid;
  }

  void SnDeliverPublish(Conn& c, std::string_view topic,
                        std::string_view payload, uint8_t qos, bool retain,
                        bool dup, uint16_t pid) {
    if (payload.size() > sn::kMaxPayload) {
      // exceeds the SN u16 wire limit: drop, never truncate the length
      stats_[kStSnDropsOversize].fetch_add(1, std::memory_order_relaxed);
      return;
    }
    uint16_t tid = SnDeliverTid(c, topic);
    if (!tid) return;
    uint8_t flags = sn::QosFlags(qos);
    if (retain) flags |= sn::kFRetain;
    if (dup) flags |= sn::kFDup;
    std::string dg;
    sn::BuildPublish(&dg, flags, tid, qos ? pid : 0, payload, nullptr,
                     nullptr);
    stats_[kStSnOut].fetch_add(1, std::memory_order_relaxed);
    stats_[kStFastBytesOut].fetch_add(dg.size(),
                                      std::memory_order_relaxed);
    SnOut(c, dg);
  }

  void SnRexmitTrack(uint64_t id, Conn& c, uint16_t pid, std::string dgram,
                     size_t flags_off) {
    uint64_t now = NowMs();
    c.sn->rexmit.push_back({pid, std::move(dgram), flags_off, now, 0});
    // the wheel replaced the per-cycle scan: one deadline per conn,
    // parked while the client announced sleep (armed again at wake)
    if (!c.sn->tm_rexmit && c.sn->awake)
      c.sn->tm_rexmit = wheel_.Arm(id, kTmSnRexmit, now + kSnRetryMs);
  }

  void SnRexmitAck(uint64_t id, SnConnState& s, uint16_t pid) {
    auto& rx = s.rexmit;
    for (size_t i = 0; i < rx.size(); i++) {
      if (rx[i].pid != pid) continue;
      rx[i] = std::move(rx.back());
      rx.pop_back();
      break;
    }
    if (rx.empty() && s.tm_rexmit) {
      wheel_.Cancel(s.tm_rexmit);
      s.tm_rexmit = 0;
    }
  }

  // qos1 fast-path delivery to an SN subscriber: SN framing + the SAME
  // AckState window/pending machinery as TCP, plus a retransmit copy
  // (UDP loses datagrams; the inflight bitmap is the authority the
  // timeout scan reads). Returns whether a delivery/admit happened.
  // 0 = dropped, 1 = written to the outbuf, 2 = parked in the window
  // queue (the caller must NOT count kStFastOut — the dequeue does)
  int SnDeliverElevated(uint64_t owner, Conn& t, std::string_view topic,
                        std::string_view payload, bool retain) {
    if (payload.size() > sn::kMaxPayload) {
      // exceeds the SN u16 wire limit: drop, never truncate the length
      stats_[kStSnDropsOversize].fetch_add(1, std::memory_order_relaxed);
      return 0;
    }
    AckState& a = EnsureAck(t);
    uint16_t tid = SnDeliverTid(t, topic);
    if (!tid) return 0;
    uint8_t flags = sn::QosFlags(1);
    if (retain) flags |= sn::kFRetain;
    if (a.inflight_cnt >= t.max_inflight) {
      // receive window full: queue (the mqueue), drop on overflow —
      // the parked copy is a whole SN datagram with a zero msg id the
      // dequeue patches (DrainPending's SN branch)
      if (a.pending.size() >= kMaxPending) {
        stats_[kStDropsInflight].fetch_add(1, std::memory_order_relaxed);
        if (telemetry_) FrNote(t, kFrDrop, 3, 1, cur_hash_);
        return 0;
      }
      std::string dg;
      size_t fo, mo;
      sn::BuildPublish(&dg, flags, tid, 0, payload, &fo, &mo);
      a.pending.emplace_back(std::move(dg), mo);
      AckNote(owner, a);
      return 2;
    }
    uint16_t tp = NextPid(a);
    std::string dg;
    size_t fo, mo;
    sn::BuildPublish(&dg, flags, tid, tp, payload, &fo, &mo);
    if (telemetry_) {
      if (a.rtt.size() < kRttSamples)
        a.rtt.push_back({NowNs(), std::string(topic), tp, 1,
                         cur_trace_});
      FrNote(t, kFrDeliver, 3, tp, cur_hash_);
    }
    stats_[kStSnOut].fetch_add(1, std::memory_order_relaxed);
    stats_[kStFastBytesOut].fetch_add(dg.size(),
                                      std::memory_order_relaxed);
    SnOut(t, dg);
    SnRexmitTrack(owner, t, tp, std::move(dg), fo);
    AckNote(owner, a);
    return 1;
  }

  // Timeout scan (~4/s, gated on any tracked delivery existing):
  // resend with DUP, abandon after kSnMaxRetries freeing the window
  // slot exactly as a PUBACK would.
  // Datagram egress: outbuf holds whole self-delimiting SN messages.
  // Consecutive messages pack into aggregate datagrams up to
  // sn::kPackDatagram (the peer's ParseAll loop decodes them all from
  // one recv), and up to kSnSendBatch aggregates go out per sendmmsg —
  // two layers of syscall amortization, because a per-message sendto
  // costs ~65us on sandboxed kernels. EAGAIN keeps the tail for a
  // later flush; other send errors (ICMP unreachable) drop one
  // aggregate and keep going — UDP semantics.
  static constexpr int kSnSendBatch = 16;

  void SnFlush(uint64_t id, Conn& c) {
    SnConnState& s = *c.sn;
    if (s.anon) {
      // the shared QoS -1 publisher has no peer to answer
      c.outbuf.clear();
      c.outpos = 0;
      if (c.want_close) Drop(id, "closed_by_host", false);
      return;
    }
    while (c.outpos < c.outbuf.size()) {
      // carve the pending range into packed spans at message bounds
      iovec iov[kSnSendBatch];
      mmsghdr mm[kSnSendBatch];
      size_t span_end[kSnSendBatch];
      int nspan = 0;
      size_t pos = c.outpos;
      bool corrupt = false;
      while (pos < c.outbuf.size() && nspan < kSnSendBatch) {
        size_t start = pos;
        while (pos < c.outbuf.size()) {
          uint8_t b0 = static_cast<uint8_t>(c.outbuf[pos]);
          size_t dlen;
          if (b0 == 1) {
            if (pos + 3 > c.outbuf.size()) {
              corrupt = true;  // torn prefix: whole messages only live here
              break;
            }
            dlen = (static_cast<uint8_t>(c.outbuf[pos + 1]) << 8) |
                   static_cast<uint8_t>(c.outbuf[pos + 2]);
          } else {
            dlen = b0;
          }
          if (dlen < 2 || pos + dlen > c.outbuf.size()) {
            corrupt = true;  // never spin on bad framing
            break;
          }
          if (pos > start && pos + dlen - start > sn::kPackDatagram)
            break;  // aggregate full; oversized singles go out alone
          pos += dlen;
        }
        if (pos == start) break;  // corrupt head, nothing to carve
        iov[nspan].iov_base = const_cast<char*>(c.outbuf.data() + start);
        iov[nspan].iov_len = pos - start;
        memset(&mm[nspan].msg_hdr, 0, sizeof(mm[nspan].msg_hdr));
        mm[nspan].msg_hdr.msg_name = &s.addr;
        mm[nspan].msg_hdr.msg_namelen = sizeof(s.addr);
        mm[nspan].msg_hdr.msg_iov = &iov[nspan];
        mm[nspan].msg_hdr.msg_iovlen = 1;
        span_end[nspan] = pos;
        nspan++;
        if (corrupt) break;  // send what precedes the corrupt boundary
      }
      if (nspan == 0) {
        if (corrupt) {  // bad framing at the head: never spin on it
          c.outbuf.clear();
          c.outpos = 0;
        }
        break;
      }
      int sentn = sendmmsg(sn_fd_, mm, nspan, MSG_NOSIGNAL);
      if (sentn < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        c.outpos = span_end[0];  // drop one aggregate, keep going
        continue;
      }
      c.outpos = span_end[sentn - 1];
      // partial send or a corrupt boundary: loop — the next carve either
      // retries the remainder or clears the corrupt head above
    }
    if (c.outpos >= c.outbuf.size()) {
      c.outbuf.clear();
      c.outpos = 0;
    }
    if (c.want_close && c.outbuf.empty())
      Drop(id, "closed_by_host", false);
  }

  // -- native CoAP gateway (round 19) -------------------------------------
  // RFC 7252 terminates in the host: datagrams decode with the shared
  // coap.h codec on the SN plane's listener machinery (recvmmsg
  // ingress, batched sendmmsg egress, per-peer conns in their own
  // id namespace), the /ps pub-sub surface translates into MQTT
  // frames that ride TryFast / the Python channel exactly like SN
  // bytes, and observe notifications resolve host-side on the
  // delivery seam (per-observer 24-bit sequences; CON mode on the
  // native ack plane with wheel-driven RFC 7252 backoff). The asyncio
  // gateway (gateway/coap.py) stays the protocol oracle; any exchange
  // outside the native vocabulary — block-wise transfers,
  // props-carrying retained reads, non-/ps paths (the LwM2M seam) —
  // degrades WHOLE to it as a kind-13 event, never a partial set.

  static constexpr int kCoapRecvBatch = 32;
  static constexpr size_t kCoapRecvBuf = 65536;  // UDP max: no truncation
  static constexpr size_t kCoapSeenMax = 8192;   // MID dedup entries/conn
  static constexpr size_t kCoapNotifyObsMax = 512;  // RST-cancel history
  static constexpr size_t kCoapBlock2Threshold = 1024;  // oracle's
                                                        // block2_size

  void CoapRead() {
    if (coap_rx_buf_.empty())
      coap_rx_buf_.resize(kCoapRecvBatch * kCoapRecvBuf);
    mmsghdr mm[kCoapRecvBatch];
    iovec iov[kCoapRecvBatch];
    sockaddr_in peers[kCoapRecvBatch];
    // bounded per cycle so a CoAP blast cannot starve the TCP/WS side
    for (int budget = 0; budget < 4096; budget += kCoapRecvBatch) {
      for (int i = 0; i < kCoapRecvBatch; i++) {
        iov[i].iov_base = coap_rx_buf_.data() + i * kCoapRecvBuf;
        iov[i].iov_len = kCoapRecvBuf;
        memset(&mm[i].msg_hdr, 0, sizeof(mm[i].msg_hdr));
        mm[i].msg_hdr.msg_name = &peers[i];
        mm[i].msg_hdr.msg_namelen = sizeof(peers[i]);
        mm[i].msg_hdr.msg_iov = &iov[i];
        mm[i].msg_hdr.msg_iovlen = 1;
      }
      int n = recvmmsg(coap_fd_, mm, kCoapRecvBatch, 0, nullptr);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;  // EAGAIN: drained
      }
      for (int i = 0; i < n; i++) {
        if (mm[i].msg_len == 0) continue;
        const uint8_t* d = coap_rx_buf_.data() + i * kCoapRecvBuf;
        // a fired read fault LOSES the datagram (errno and blackhole
        // alike: UDP's loss shape), scoped to the peer's conn
        // @fault(conn_read) — the CoAP datagram-ingress seam
        if (fault_.armed(fault::kSiteConnRead)) {
          auto ait = coap_addr_conn_.find(SnAddrKey(peers[i]));
          uint64_t fkey = ait == coap_addr_conn_.end() ? 0 : ait->second;
          if (fault_.Fire(fault::kSiteConnRead, fkey)) {
            FaultNote(fault::kSiteConnRead);
            continue;
          }
        }
        if (telemetry_ && ((++tele_tick_coap_ & tele_mask_) == 0)) {
          uint64_t t0 = NowNs();
          CoapIngest(peers[i], d, mm[i].msg_len);
          RecordHist(kHistCoapIngest, NowNs() - t0);
        } else {
          CoapIngest(peers[i], d, mm[i].msg_len);
        }
      }
      if (n < kCoapRecvBatch) break;  // drained
    }
    FlushDirty();
  }

  void CoapIngest(const sockaddr_in& peer, const uint8_t* data,
                  size_t len) {
    coap::CoapMsg m;
    if (!coap::Parse(data, len, &m)) return;  // the oracle drops it too
    uint64_t key = SnAddrKey(peer);
    auto ait = coap_addr_conn_.find(key);
    uint64_t id;
    if (ait != coap_addr_conn_.end() && conns_.count(ait->second)) {
      id = ait->second;
    } else {
      // only REQUESTS (and pings) mint endpoint state: a bare ACK/RST
      // from an unknown peer settles nothing, and letting reflected
      // garbage fill the conn table would be an amplification surface
      bool request = (m.type == coap::kCon || m.type == coap::kNon) &&
                     m.code >= coap::kGet && m.code <= 0x1F;
      bool ping = m.type == coap::kCon && m.code == coap::kEmpty;
      if (!request && !ping) return;
      if (conns_.size() >= max_conns_) return;  // esockd max-conn
      id = CoapNewConn(peer);
    }
    auto it = conns_.find(id);
    if (it == conns_.end()) return;
    it->second.last_rx_ms = NowMs();
    CoapHandle(id, it->second, m, data, len);
  }

  uint64_t CoapNewConn(const sockaddr_in& peer) {
    Conn c;
    c.fd = -1;  // egress rides sendmmsg on the shared UDP socket
    c.framer = Framer(max_size_);
    c.coap = std::make_unique<CoapConnState>();
    c.coap->addr = peer;
    uint64_t id = kCoapConnBit | ShardPrefix() | next_coap_id_++;
    c.coap->conn_id = id;
    auto& cref = conns_.emplace(id, std::move(c)).first->second;
    coap_addr_conn_[SnAddrKey(peer)] = id;
    uint64_t now = NowMs();
    cref.last_rx_ms = now;
    // connectionless transport: reap silent endpoints like the asyncio
    // UDP listener's 300s idle default (a later translated CONNECT
    // re-arms the real deadline through set_keepalive)
    cref.keepalive_ms = 300000;
    cref.tm_keepalive = wheel_.Arm(id, kTmKeepalive, now + 300000);
    FrNote(cref, kFrOpen, 0, 3);  // arg 3 = CoAP transport
    char ip[INET_ADDRSTRLEN] = "?";
    inet_ntop(AF_INET, &peer.sin_addr, ip, sizeof(ip));
    std::string info = std::string("coap:") + ip + ":" +
                       std::to_string(ntohs(peer.sin_port));
    events_.push_back(EncodeRecord(1, id, info.data(), info.size()));
    return id;
  }

  // Frame one CoAP message into the conn outbuf. CoAP messages are not
  // self-delimiting (the datagram boundary is the delimiter), so an
  // internal [u16 len] prefix carries each message to CoapFlush, which
  // re-establishes the boundaries with one datagram per message.
  void CoapOut(Conn& c, const std::string& dgram) {
    c.outbuf.push_back(static_cast<char>(dgram.size() >> 8));
    c.outbuf.push_back(static_cast<char>(dgram.size() & 0xFF));
    c.outbuf += dgram;
  }

  static coap::CoapMsg CoapResp(const coap::CoapMsg& req, uint8_t code) {
    coap::CoapMsg r;
    r.type = req.type == coap::kCon ? coap::kAck : coap::kNon;
    r.code = code;
    r.mid = req.mid;
    r.token = req.token;
    return r;
  }

  // Serialize + emit one response, caching the bytes in the MID dedup
  // window so a retransmitted request replays them (oracle remember).
  void CoapReply(uint64_t id, Conn& c, const coap::CoapMsg& resp) {
    std::string dg;
    coap::Serialize(resp, &dg);
    auto it = c.coap->seen.find(resp.mid);
    if (it != c.coap->seen.end()) it->second.response = dg;
    CoapOut(c, dg);
    MarkDirty(id, c);
  }

  uint16_t CoapNextMid(CoapConnState& s) {
    s.next_mid = static_cast<uint16_t>(s.next_mid % 0xFFFF + 1);
    return s.next_mid;
  }

  uint16_t CoapNextMqttMid(CoapConnState& s) {
    s.next_mqtt_mid = static_cast<uint16_t>(s.next_mqtt_mid % 0xFFFF + 1);
    return s.next_mqtt_mid;
  }

  void CoapHandle(uint64_t id, Conn& c, coap::CoapMsg& m,
                  const uint8_t* raw, size_t len) {
    CoapConnState& s = *c.coap;
    if (m.type == coap::kCon && m.code == coap::kEmpty) {
      // CoAP ping (§4.3): pong with RST. The client's mid space is
      // independent of ours — it must NOT settle a pending notify
      // that happens to share the number (oracle parity).
      stats_[kStCoapPings].fetch_add(1, std::memory_order_relaxed);
      coap::CoapMsg r;
      r.type = coap::kRst;
      r.mid = m.mid;
      std::string dg;
      coap::Serialize(r, &dg);
      CoapOut(c, dg);
      MarkDirty(id, c);
      return;
    }
    if (m.type == coap::kAck || m.type == coap::kRst) {
      CoapSettle(id, c, m, raw, len);
      return;
    }
    if (m.code == coap::kEmpty) return;  // NON empty: nothing to do
    if (m.code >= 0x20) return;  // a response class from a client
    // the native-vs-oracle decision comes BEFORE any side effect —
    // one exchange is served whole by exactly one plane
    if (!CoapEligible(m)) {
      CoapPunt(id, c, raw, len);
      return;
    }
    // inbound MID dedup (the oracle's parity-audited window): a
    // byte-identical retransmission replays the cached response; a
    // recycled mid (different token) evicts and runs fresh
    auto sit = s.seen.find(m.mid);
    if (sit != s.seen.end()) {
      if (NowMs() >= sit->second.expire_ms ||
          sit->second.token != m.token) {
        s.seen.erase(sit);
      } else {
        stats_[kStCoapDedupHits].fetch_add(1, std::memory_order_relaxed);
        if (!sit->second.response.empty()) {
          CoapOut(c, sit->second.response);
          MarkDirty(id, c);
        }
        return;  // response still in flight: drop the retransmission
      }
    }
    CoapSeenInsert(s, m);
    CoapServe(id, c, m);
  }

  void CoapSeenInsert(CoapConnState& s, const coap::CoapMsg& m) {
    uint64_t life = m.type == coap::kCon ? coap::kExchangeLifetimeMs
                                         : coap::kNonLifetimeMs;
    uint64_t now = NowMs();
    // over the bound, evict OLDEST-INSERTED first (amortized O(1) via
    // the fifo — a sustained NON blast wraps the 16-bit mid space well
    // inside the RFC lifetimes, and bounded memory beats a perfect
    // replay window there; the natural-expiry case never gets here)
    while (s.seen.size() >= kCoapSeenMax && !s.seen_fifo.empty()) {
      s.seen.erase(s.seen_fifo.front());
      s.seen_fifo.pop_front();
    }
    s.seen[m.mid] = {m.token, "", now + life};
    s.seen_fifo.push_back(m.mid);
    // the fifo tolerates stale mids (recycled entries); cap its drift
    if (s.seen_fifo.size() > 2 * kCoapSeenMax) {
      std::deque<uint16_t> fresh;
      for (uint16_t mid : s.seen_fifo)
        if (s.seen.count(mid) &&
            (fresh.empty() || fresh.back() != mid))
          fresh.push_back(mid);
      s.seen_fifo.swap(fresh);
    }
  }

  // ACK/RST for a message WE originated (a CON notify): settle the
  // retransmit copy — the CoAP ACK is the delivery ack, so a tracked
  // pid routes as a synthesized MQTT PUBACK (native pids consume in
  // TryFastPuback, Python pids forward to the session). RST cancels
  // the observation for ANY notification type (RFC 7641 §3.6). Mids
  // unknown to the native plane route to the Python oracle when it has
  // ever served this endpoint (its own CON commands — e.g. LwM2M
  // downlinks — are tracked there).
  void CoapSettle(uint64_t id, Conn& c, const coap::CoapMsg& m,
                  const uint8_t* raw, size_t len) {
    CoapConnState& s = *c.coap;
    bool known = false;
    auto& rx = s.rexmit;
    for (size_t i = 0; i < rx.size(); i++) {
      if (rx[i].mid != m.mid) continue;
      known = true;
      uint16_t pid = rx[i].pid;
      std::string filter = std::move(rx[i].filter);
      rx[i] = std::move(rx.back());
      rx.pop_back();
      if (rx.empty() && s.tm_notify) {
        wheel_.Cancel(s.tm_notify);
        s.tm_notify = 0;
      }
      if (pid) {
        std::string f;
        MakeMqttAck(&f, 0x40, pid);
        SnForward(id, c, f);
      }
      if (m.type == coap::kRst) CoapCancelObserve(id, c, filter);
      break;
    }
    auto nit = s.notify_obs.find(m.mid);
    if (nit != s.notify_obs.end()) {
      known = true;
      if (m.type == coap::kRst) CoapCancelObserve(id, c, nit->second);
      s.notify_obs.erase(nit);
    }
    if (!known && s.oracle_used) CoapPunt(id, c, raw, len);
  }

  // Drop one observation: remove the observer entry and release the
  // broker subscription through the SAME seam a client unobserve takes
  // (a synthesized MQTT UNSUBSCRIBE — the Python session owns the
  // subscription state; the match-table entry tears down through it).
  void CoapCancelObserve(uint64_t id, Conn& c, const std::string& filter) {
    CoapConnState& s = *c.coap;
    bool found = false;
    for (size_t i = 0; i < s.observers.size(); i++) {
      if (s.observers[i].filter != filter) continue;
      s.observers[i] = std::move(s.observers.back());
      s.observers.pop_back();
      found = true;
      break;
    }
    if (!found || !s.connected) return;
    std::string body;
    sn::PutBe16(&body, CoapNextMqttMid(s));
    sn::PutBe16(&body, static_cast<uint16_t>(filter.size()));
    body += filter;
    std::string f;
    BuildMqttFrame(&f, 0xA2, body);
    SnForward(id, c, f);  // the UNSUBACK egress is swallowed
  }

  // The native-vocabulary test: everything this rejects is served
  // WHOLE by the Python oracle (gateway/coap.py or the configured
  // channel) — block-wise transfers and any other unknown option,
  // plain reads while the retained mirror is incomplete (v5 props),
  // and non-/ps paths including the LwM2M /rd surface. Decided before
  // ANY side effect, so an exchange never splits across planes.
  // @admit-check
  bool CoapEligible(const coap::CoapMsg& m) {
    bool first_seen = false, first_is_ps = false;
    for (const auto& [n, v] : m.options) {
      if (n == coap::kOptUriPath) {
        if (!first_seen) {
          first_seen = true;
          first_is_ps = v == "ps";
        }
      } else if (n != coap::kOptObserve && n != coap::kOptUriQuery &&
                 n != coap::kOptContentFormat) {
        return false;  // Block1/Block2/ETag/...: oracle vocabulary
      }
    }
    if (!first_is_ps) return false;  // /rd et al -> the oracle channel
    if (m.code == coap::kGet && coap::ObserveOf(m) < 0 &&
        !coap_retain_complete_)
      return false;  // plain read with an incomplete retained mirror
    return true;
  }

  // Degrade one exchange WHOLE to the Python oracle (kind 13): the raw
  // datagram ships verbatim; gateway/coap.py (or the configured
  // oracle channel — LwM2M) parses, dedups, executes, and answers
  // through emqx_host_coap_send. The native plane took no side effect
  // for it — never a partial exchange.
  void CoapPunt(uint64_t id, Conn& c, const uint8_t* raw, size_t len) {
    c.coap->oracle_used = true;
    stats_[kStCoapPunts].fetch_add(1, std::memory_order_relaxed);
    FrNote(c, kFrPunt, 0, static_cast<uint16_t>(len & 0xFFFF));
    events_.push_back(EncodeRecord(
        13, id, reinterpret_cast<const char*>(raw), len));
  }

  // Execute one admitted (native-vocabulary) request — the oracle's
  // _handle_request shape. Requests arriving before the translated
  // CONNECT's CONNACK park in preconn and replay through here; the
  // drain (and every other caller) re-runs CoapEligible first.
  // @admit-gated
  void CoapServe(uint64_t id, Conn& c, coap::CoapMsg& m) {
    CoapConnState& s = *c.coap;
    coap_path_scratch_.clear();
    coap::JoinPath(m, &coap_path_scratch_);
    std::string topic;  // "/".join(path[1:]), the oracle's topic
    for (size_t i = 1; i < coap_path_scratch_.size(); i++) {
      if (i > 1) topic += '/';
      topic.append(coap_path_scratch_[i].data(),
                   coap_path_scratch_[i].size());
    }
    if (topic.empty()) {
      CoapReply(id, c, CoapResp(m, coap::kBadRequest));
      return;
    }
    if (!s.connected) {
      if (s.connect_sent && !s.connack_seen) {
        // CONNECT in flight to the Python channel: requests pipelined
        // into the round trip park and replay after the CONNACK (the
        // oracle registers synchronously, so they must be served)
        if (s.preconn.size() < kSnPreconnMax)
          s.preconn.push_back(std::move(m));
        return;
      }
      if (s.connack_seen) {
        // rejected CONNACK: denied auth (oracle UNAUTHORIZED parity);
        // the Python channel is tearing this conn down
        CoapReply(id, c, CoapResp(m, coap::kUnauthorized));
        return;
      }
      CoapConnect(id, c, m);
      auto it = conns_.find(id);
      if (it != conns_.end() && it->second.coap)
        it->second.coap->preconn.push_back(std::move(m));
      return;
    }
    std::string_view want;
    if (coap::Query(m, "clientid", &want) && !want.empty() &&
        want != s.clientid) {
      // the peer RE-REGISTERS under a new identity: the old session's
      // observers must not leak into the new one and the new clientid
      // must be re-authenticated (the parity-audited oracle fix; the
      // SN re-CONNECT discipline — the addr slot moves to a successor
      // conn, the old one keeps draining)
      // the successor conn pays the same admission the first datagram
      // did (review finding: an endpoint flipping identities at the
      // cap must not grow the table past max_conns_ while its old
      // conns drain) — at the cap the request drops like any other
      // over-cap datagram and the client's retransmit retries
      if (conns_.size() >= max_conns_) return;
      CoapSeen carry{};
      auto old_seen = s.seen.find(m.mid);
      bool have_seen = old_seen != s.seen.end();
      if (have_seen) carry = old_seen->second;
      sockaddr_in peer = s.addr;
      coap_addr_conn_.erase(SnAddrKey(peer));
      std::string f;
      f.push_back(static_cast<char>(0xE0));
      f.push_back(0);
      SnForward(id, c, f);  // Python closes the old session
      // conns_ may rehash on the emplace: no Conn& use after this
      uint64_t nid = CoapNewConn(peer);
      auto nit = conns_.find(nid);
      if (nit != conns_.end() && nit->second.coap) {
        // the dedup entry follows the exchange to the successor conn
        // (a retransmission must not re-execute on the new identity)
        if (have_seen) nit->second.coap->seen[m.mid] = carry;
        CoapConnect(nid, nit->second, m);
        nit->second.coap->preconn.push_back(std::move(m));
      }
      return;
    }
    CoapExecute(id, c, m, topic);
  }

  void CoapExecute(uint64_t id, Conn& c, coap::CoapMsg& m,
                   const std::string& topic) {
    CoapConnState& s = *c.coap;
    if (m.code == coap::kPut || m.code == coap::kPost) {
      // publish: qos/retain from the Uri-Query (oracle parity). A
      // qos>=1 publish answers 2.04 only when its MQTT ack lands —
      // the native ack plane gates the CoAP response (CON reliability
      // means "the broker has it", not "the gateway heard it")
      std::string_view qv;
      uint8_t qos = 0;
      if (coap::Query(m, "qos", &qv) && !qv.empty() && qv[0] >= '0' &&
          qv[0] <= '2')
        qos = static_cast<uint8_t>(qv[0] - '0');
      std::string_view rv;
      bool retain =
          coap::Query(m, "retain", &rv) && (rv == "true" || rv == "1");
      stats_[kStCoapIn].fetch_add(1, std::memory_order_relaxed);
      uint16_t mqtt_mid = 0;
      if (qos > 0) {
        mqtt_mid = CoapNextMqttMid(s);
        // runaway bound: a client that never sees its 2.04s cannot
        // grow this past the mid space (the SN pub_tid discipline)
        if (s.pending_pub.size() > 8192) s.pending_pub.clear();
        s.pending_pub[mqtt_mid] = {m.mid, m.token,
                                   m.type == coap::kCon};
      }
      std::string body;
      sn::PutBe16(&body, static_cast<uint16_t>(topic.size()));
      body += topic;
      if (qos) sn::PutBe16(&body, mqtt_mid);
      body += m.payload;
      uint8_t h =
          static_cast<uint8_t>(0x30 | (qos << 1) | (retain ? 1 : 0));
      std::string f;
      BuildMqttFrame(&f, h, body);
      SnForward(id, c, f);
      if (qos == 0)  // nothing acks a qos0 publish: answer now
        CoapReply(id, c, CoapResp(m, coap::kChanged));
      return;
    }
    if (m.code == coap::kGet) {
      long obs = coap::ObserveOf(m);
      if (obs == 0) {
        // observe register -> MQTT SUBSCRIBE (always the Python
        // plane, like SN); the observer entry and the 2.05 reply
        // land when the SUBACK egresses
        std::string_view qv;
        uint8_t qos = 0;
        if (coap::Query(m, "qos", &qv) && !qv.empty() &&
            qv[0] >= '0' && qv[0] <= '2')
          qos = static_cast<uint8_t>(qv[0] - '0');
        uint16_t mqtt_mid = CoapNextMqttMid(s);
        if (s.pending_sub.size() > 1024) s.pending_sub.clear();
        s.pending_sub[mqtt_mid] = {m.mid, m.token, topic, qos,
                                   m.type == coap::kCon};
        std::string body;
        sn::PutBe16(&body, mqtt_mid);
        sn::PutBe16(&body, static_cast<uint16_t>(topic.size()));
        body += topic;
        body.push_back(static_cast<char>(qos));
        std::string f;
        BuildMqttFrame(&f, 0x82, body);
        SnForward(id, c, f);
        return;
      }
      if (obs == 1) {
        // deregister: the oracle replies 2.05 whether or not the
        // observation existed
        CoapCancelObserve(id, c, topic);
        CoapReply(id, c, CoapResp(m, coap::kContent));
        return;
      }
      // plain read: latest retained message. The mirror is complete
      // (CoapEligible gated on it); bodies past the oracle's block2
      // threshold degrade the WHOLE exchange to its slicing — decided
      // before any side effect (a read has none)
      retain_scratch_.clear();
      retained_.Match(topic, store::WallMs(), &retain_scratch_);
      if (retain_scratch_.empty()) {
        CoapReply(id, c, CoapResp(m, coap::kNotFound));
        return;
      }
      const RetainEntry* e = retain_scratch_.back();
      if (e->payload.size() > kCoapBlock2Threshold) {
        s.seen.erase(m.mid);  // the oracle owns this exchange's dedup
        std::string raw;
        coap::Serialize(m, &raw);  // codec roundtrips byte-exactly
        CoapPunt(id, c, reinterpret_cast<const uint8_t*>(raw.data()),
                 raw.size());
        return;
      }
      coap::CoapMsg r = CoapResp(m, coap::kContent);
      r.payload = e->payload;
      CoapReply(id, c, r);
      return;
    }
    if (m.code == coap::kDelete) {
      CoapReply(id, c, CoapResp(m, coap::kDeleted));
      return;
    }
    CoapReply(id, c, CoapResp(m, coap::kNotAllowed));
  }

  // Translate the endpoint's registration into an MQTT CONNECT the
  // Python channel owns (auth/CM takeover/hooks exactly like TCP/SN).
  // Identity comes from the Uri-Query (?clientid/?username/?password,
  // the oracle's _ensure_client), defaulting like SnDefaultCid.
  void CoapConnect(uint64_t id, Conn& c, const coap::CoapMsg& m) {
    CoapConnState& s = *c.coap;
    std::string_view cid, user, pass;
    coap::Query(m, "clientid", &cid);
    bool has_user = coap::Query(m, "username", &user);
    bool has_pass = coap::Query(m, "password", &pass);
    if (has_pass && !has_user) {
      has_user = true;  // 3.1.1 forbids password-without-username
      user = std::string_view();
    }
    s.clientid = cid.empty()
                     ? "coap-" + std::to_string(id & 0xFFFFFFFFull)
                     : std::string(cid);
    s.connect_sent = true;
    s.connected = false;
    std::string body;
    body.push_back(0);
    body.push_back(4);
    body += "MQTT";
    body.push_back(4);  // translated CoAP sessions speak MQTT 3.1.1
    uint8_t flags = 0x02;  // clean session: CoAP endpoints are
                           // connectionless; state lives in observers
    if (has_user) flags |= 0x80;
    if (has_pass) flags |= 0x40;
    body.push_back(static_cast<char>(flags));
    sn::PutBe16(&body, 300);  // the asyncio UDP listener's idle default
    sn::PutBe16(&body, static_cast<uint16_t>(s.clientid.size()));
    body += s.clientid;
    if (has_user) {
      sn::PutBe16(&body, static_cast<uint16_t>(user.size()));
      body.append(user.data(), user.size());
    }
    if (has_pass) {
      sn::PutBe16(&body, static_cast<uint16_t>(pass.size()));
      body.append(pass.data(), pass.size());
    }
    std::string f;
    BuildMqttFrame(&f, 0x10, body);
    SnForward(id, c, f);
  }

  void CoapDrainPreconn(uint64_t id) {
    std::deque<coap::CoapMsg> q;
    {
      auto it = conns_.find(id);
      if (it == conns_.end() || !it->second.coap) return;
      q.swap(it->second.coap->preconn);
    }
    for (coap::CoapMsg& m : q) {
      // re-find each round: a dispatched request can rehash conns_
      auto it = conns_.find(id);
      if (it == conns_.end() || !it->second.coap) return;
      Conn& c = it->second;
      if (!c.coap->connected) {
        // the CONNACK was a reject: the oracle answers UNAUTHORIZED
        CoapReply(id, c, CoapResp(m, coap::kUnauthorized));
        continue;
      }
      // the ladder re-decides per parked message (the vocabulary may
      // have narrowed while parked — e.g. the retained mirror went
      // incomplete); parked messages were already dedup-inserted
      if (!CoapEligible(m)) {
        c.coap->seen.erase(m.mid);
        std::string raw;
        coap::Serialize(m, &raw);
        CoapPunt(id, c, reinterpret_cast<const uint8_t*>(raw.data()),
                 raw.size());
        continue;
      }
      CoapServe(id, c, m);
    }
  }

  // -- CoAP egress (MQTT -> CoAP translation) -----------------------------

  void CoapEgress(Conn& c, const char* data, size_t len) {
    // LOCAL frame list: translation re-enters this function on the
    // same conn (PUBREC -> synthesized PUBREL -> PUBCOMP egress), and
    // a member scratch would be cleared mid-iteration (review
    // finding). The swap recycles the member's capacity in the
    // common non-nested case.
    std::vector<std::string> frames;
    frames.swap(coap_frames_scratch_);
    frames.clear();
    c.coap->egress.Feed(reinterpret_cast<const uint8_t*>(data), len,
                        &frames);
    for (const std::string& f : frames) CoapTranslateEgress(c, f);
    frames.clear();
    coap_frames_scratch_.swap(frames);
    // a CONNACK in this span settles the CONNECT round trip: replay
    // parked requests AFTER the scratch loop (dispatch re-enters
    // egress paths) and after the responses above joined the outbuf
    if (c.coap->connack_seen && !c.coap->preconn.empty())
      CoapDrainPreconn(c.coap->conn_id);
  }

  void CoapTranslateEgress(Conn& c, const std::string& f) {
    CoapConnState& s = *c.coap;
    uint8_t type = static_cast<uint8_t>(f[0]) >> 4;
    size_t pos = 1;
    while (pos < f.size() && (static_cast<uint8_t>(f[pos]) & 0x80)) pos++;
    pos++;  // first body byte
    auto pid_at = [&](size_t at) -> uint16_t {
      if (at + 2 > f.size()) return 0;
      return static_cast<uint16_t>((static_cast<uint8_t>(f[at]) << 8) |
                                   static_cast<uint8_t>(f[at + 1]));
    };
    switch (type) {
      case 2: {  // CONNACK: no CoAP analogue — flips the session gate
        if (pos + 2 > f.size()) return;
        s.connack_seen = true;
        if (static_cast<uint8_t>(f[pos + 1]) == 0) s.connected = true;
        return;
      }
      case 3: {  // PUBLISH: a delivery for this endpoint's observers
        uint8_t h = static_cast<uint8_t>(f[0]);
        uint8_t qos = (h >> 1) & 3;
        if (pos + 2 > f.size()) return;
        uint16_t tlen = pid_at(pos);
        pos += 2;
        if (pos + tlen > f.size()) return;
        std::string_view topic(f.data() + pos, tlen);
        pos += tlen;
        uint16_t pid = 0;
        if (qos) {
          pid = pid_at(pos);
          pos += 2;
          if (pos > f.size()) return;
        }
        std::string_view payload(f.data() + pos, f.size() - pos);
        CoapDeliverNotify(c, topic, payload, pid);
        return;
      }
      case 4:  // PUBACK: the client's qos1 publish is done -> 2.04
        CoapPubDone(c, pid_at(pos));
        return;
      case 5: {  // PUBREC: self-complete the qos2 exchange (the CoAP
                 // client knows nothing of the PUBREL leg)
        std::string rel;
        MakeMqttAck(&rel, 0x62, pid_at(pos));
        SnForward(s.conn_id, c, rel);
        return;
      }
      case 7:  // PUBCOMP: the qos2 publish is done -> 2.04
        CoapPubDone(c, pid_at(pos));
        return;
      case 9: {  // SUBACK: complete the observe registration
        uint16_t pid = pid_at(pos);
        auto it = s.pending_sub.find(pid);
        if (it == s.pending_sub.end()) return;
        CoapConnState::PendingSub ctx = it->second;
        s.pending_sub.erase(it);
        // the oracle registers the observer unconditionally (before
        // ctx.subscribe, denied or not) and replies 2.05 regardless —
        // mirror exactly; a same-filter re-register replaces the
        // token/qos and restarts the observation's sequence
        bool replaced = false;
        for (auto& o : s.observers) {
          if (o.filter != ctx.topic) continue;
          o.token = ctx.token;
          o.qos = ctx.qos;
          o.seq = 1;
          replaced = true;
          break;
        }
        if (!replaced)
          s.observers.push_back({ctx.topic, ctx.token, ctx.qos, 1});
        coap::CoapMsg r;
        r.type = ctx.con ? coap::kAck : coap::kNon;
        r.code = coap::kContent;
        r.mid = ctx.mid;
        r.token = ctx.token;
        r.options.emplace_back(coap::kOptObserve,
                               std::string("\x00\x00\x01", 3));
        CoapReply(s.conn_id, c, r);
        return;
      }
      default:
        return;  // UNSUBACK/PINGRESP/DISCONNECT: nothing to translate
    }
  }

  // Shared PUBACK/PUBCOMP tail: the MQTT ack for a translated publish
  // answers the original exchange 2.04 Changed (piggybacked on the
  // CoAP ACK for CON requests — the response rides the ack plane).
  void CoapPubDone(Conn& c, uint16_t pid) {
    CoapConnState& s = *c.coap;
    auto it = s.pending_pub.find(pid);
    if (it == s.pending_pub.end()) return;
    coap::CoapMsg r;
    r.type = it->second.con ? coap::kAck : coap::kNon;
    r.code = coap::kChanged;
    r.mid = it->second.mid;
    r.token = it->second.token;
    s.pending_pub.erase(it);
    CoapReply(s.conn_id, c, r);
  }

  // Resolve + encode one observe notification on the delivery seam.
  // pid != 0 ties the notify to an MQTT window slot (the peer's ACK,
  // by mid, becomes the synthesized PUBACK that frees it). Per-observer
  // 24-bit sequences; oracle parity throughout.
  void CoapDeliverNotify(Conn& c, std::string_view topic,
                         std::string_view payload, uint16_t pid) {
    CoapConnState& s = *c.coap;
    uint64_t t0 = 0;
    if (telemetry_ && ((++tele_tick_notify_ & tele_mask_) == 0))
      t0 = NowNs();
    CoapObserver* obs = nullptr;
    for (auto& o : s.observers) {
      if (coap::TopicMatch(topic, o.filter)) {
        obs = &o;
        break;
      }
    }
    if (obs == nullptr || payload.size() > coap::kMaxPayload) {
      if (obs != nullptr)
        stats_[kStCoapDropsOversize].fetch_add(
            1, std::memory_order_relaxed);
      // a delivery that cannot reach the peer abandons its window
      // slot exactly as an ack would (the SN exhaustion discipline)
      CoapAbandonPid(s.conn_id, c, pid);
      return;
    }
    obs->seq = (obs->seq + 1) & 0xFFFFFF;
    uint16_t mid = CoapNextMid(s);
    // CON-vs-NON follows the OBSERVER's subscription qos (the oracle's
    // notify_type rule — even a qos0-published message notifies a
    // qos>=1 observation as a tracked CON; pid 0 just means there is
    // no window slot to settle when it resolves)
    uint8_t mtype = obs->qos ? coap::kCon : coap::kNon;
    std::string dg;
    coap::BuildNotify(&dg, mtype, mid, obs->token, obs->seq, payload);
    // the RST-cancel map covers NON notifies too (RFC 7641 §3.6);
    // bounded — but never evict a mid whose CON still awaits its ACK
    // (losing it would orphan the give-up/RST cancel path)
    if (s.notify_obs.size() >= kCoapNotifyObsMax) {
      for (auto it = s.notify_obs.begin(); it != s.notify_obs.end();
           ++it) {
        bool tracked = false;
        for (const auto& r : s.rexmit)
          if (r.mid == it->first) {
            tracked = true;
            break;
          }
        if (!tracked) {
          s.notify_obs.erase(it);
          break;
        }
      }
    }
    s.notify_obs[mid] = obs->filter;
    if (mtype == coap::kCon) {
      uint64_t now = NowMs();
      s.rexmit.push_back({mid, pid, dg, obs->filter,
                          now + coap_ack_timeout_ms_,
                          coap_ack_timeout_ms_, 0});
      if (!s.tm_notify)
        s.tm_notify = wheel_.Arm(s.conn_id, kTmCoapRexmit,
                                 now + coap_ack_timeout_ms_);
    }
    stats_[kStCoapNotifies].fetch_add(1, std::memory_order_relaxed);
    CoapOut(c, dg);
    MarkDirty(s.conn_id, c);
    if (t0) RecordHist(kHistObserveNotify, NowNs() - t0);
  }

  // A delivery that cannot reach the peer (no observer / oversize /
  // retransmit exhaustion) abandons its window slot exactly as a
  // PUBACK would: native pids free inline; Python pids stay with
  // their session's retry machinery.
  void CoapAbandonPid(uint64_t id, Conn& c, uint16_t pid) {
    if (pid < kNativePidBase || !c.ack) return;
    AckState& a = *c.ack;
    uint32_t bi = pid - kNativePidBase;
    if (!BitTest(a.inflight, bi)) return;
    BitClr(a.inflight, bi);
    a.inflight_cnt--;
    a.cyc_acked++;
    AckNote(id, a);
  }

  // Per-conn CON-notify retransmit: the RFC 7252 exponential backoff
  // (base x 2^n) on the timer wheel — the FireSnRexmit shape with
  // per-entry doubling deadlines. Exhaustion drops the unresponsive
  // observer (RFC 7641 §4.5 — stop notifying dead clients), frees the
  // window slot, and lands in the degradation ledger as coap_giveup.
  void FireCoapRexmit(uint64_t id) {
    auto cit = conns_.find(id);
    if (cit == conns_.end() || !cit->second.coap) return;
    Conn& c = cit->second;
    c.coap->tm_notify = 0;
    if (c.coap->rexmit.empty()) return;
    uint64_t now = NowMs();
    uint64_t next_due = 0;
    bool resent = false;
    std::vector<std::string> cancel;
    auto& rx = c.coap->rexmit;
    for (size_t i = 0; i < rx.size();) {
      CoapConRx& r = rx[i];
      if (now < r.next_ms) {
        if (!next_due || r.next_ms < next_due) next_due = r.next_ms;
        i++;
        continue;
      }
      if (r.tries >= coap::kMaxRetransmit) {
        stats_[kStCoapGiveups].fetch_add(1, std::memory_order_relaxed);
        LedgerNote(kLrCoapGiveup, id);
        CoapAbandonPid(id, c, r.pid);
        c.coap->notify_obs.erase(r.mid);
        cancel.push_back(std::move(r.filter));
        rx[i] = std::move(rx.back());
        rx.pop_back();
        continue;
      }
      CoapOut(c, r.dgram);  // resent VERBATIM (CoAP has no DUP bit)
      MarkDirty(id, c);
      resent = true;
      r.tries++;
      r.timeout_ms *= 2;
      r.next_ms = now + r.timeout_ms;
      if (!next_due || r.next_ms < next_due) next_due = r.next_ms;
      stats_[kStCoapRexmits].fetch_add(1, std::memory_order_relaxed);
      i++;
    }
    // cancellations AFTER the scan: CoapCancelObserve forwards MQTT
    // frames whose handling can re-enter the delivery paths
    for (const std::string& filt : cancel) CoapCancelObserve(id, c, filt);
    auto again = conns_.find(id);
    if (again == conns_.end() || !again->second.coap) return;
    Conn& c2 = again->second;
    if (c2.ack) DrainPending(id, c2);  // freed slots pull the queue
    // DrainPending may have tracked a fresh CON (CoapDeliverNotify
    // arms the timer it found zeroed): never double-arm over it
    if (!c2.coap->rexmit.empty() && next_due && !c2.coap->tm_notify)
      c2.coap->tm_notify = wheel_.Arm(id, kTmCoapRexmit, next_due);
    if (resent) FlushDirty();
  }

  // Datagram egress: the outbuf holds [u16 len]-prefixed CoAP
  // messages (one message = one datagram on the wire, RFC 7252 §3);
  // up to kCoapSendBatch go out per sendmmsg — the SN syscall
  // amortization minus packing, which CoAP forbids (so the batch runs
  // deeper than SN's: every message pays its own datagram).
  static constexpr int kCoapSendBatch = 32;

  void CoapFlush(uint64_t id, Conn& c) {
    CoapConnState& s = *c.coap;
    while (c.outpos < c.outbuf.size()) {
      iovec iov[kCoapSendBatch];
      mmsghdr mm[kCoapSendBatch];
      size_t span_end[kCoapSendBatch];
      int nspan = 0;
      size_t pos = c.outpos;
      bool corrupt = false;
      while (pos < c.outbuf.size() && nspan < kCoapSendBatch) {
        if (pos + 2 > c.outbuf.size()) {
          corrupt = true;  // torn prefix: whole messages only live here
          break;
        }
        size_t dlen =
            (static_cast<size_t>(static_cast<uint8_t>(c.outbuf[pos]))
             << 8) |
            static_cast<uint8_t>(c.outbuf[pos + 1]);
        if (pos + 2 + dlen > c.outbuf.size()) {
          corrupt = true;
          break;
        }
        iov[nspan].iov_base =
            const_cast<char*>(c.outbuf.data() + pos + 2);
        iov[nspan].iov_len = dlen;
        memset(&mm[nspan].msg_hdr, 0, sizeof(mm[nspan].msg_hdr));
        mm[nspan].msg_hdr.msg_name = &s.addr;
        mm[nspan].msg_hdr.msg_namelen = sizeof(s.addr);
        mm[nspan].msg_hdr.msg_iov = &iov[nspan];
        mm[nspan].msg_hdr.msg_iovlen = 1;
        span_end[nspan] = pos + 2 + dlen;
        nspan++;
        pos += 2 + dlen;
      }
      if (nspan == 0) {
        if (corrupt) {  // bad framing at the head: never spin on it
          c.outbuf.clear();
          c.outpos = 0;
        }
        break;
      }
      // errno loses the head datagram, short sends only the first of
      // the batch, blackhole claims success while every byte vanishes
      // (the CON-exhaustion rig: notifies into the void retransmit to
      // give-up with no FIN/RST ever surfacing)
      int want = nspan;
      // @fault(conn_write) — the CoAP datagram-egress seam
      if (fault_.armed(fault::kSiteConnWrite)) {
        int fmode = fault_.Fire(fault::kSiteConnWrite, id);
        if (fmode) {
          FaultNote(fault::kSiteConnWrite);
          if (fmode == fault::kModeBlackhole) {
            c.outpos = span_end[nspan - 1];
            continue;
          }
          if (fmode == fault::kModeShort) {
            want = 1;
          } else {  // errno: the datagram is lost (UDP semantics)
            c.outpos = span_end[0];
            continue;
          }
        }
      }
      int sentn = sendmmsg(coap_fd_, mm, want, MSG_NOSIGNAL);
      if (sentn < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        c.outpos = span_end[0];  // drop one datagram, keep going
        continue;
      }
      c.outpos = span_end[sentn - 1];
    }
    if (c.outpos >= c.outbuf.size()) {
      c.outbuf.clear();
      c.outpos = 0;
    }
    if (c.want_close && c.outbuf.empty())
      Drop(id, "closed_by_host", false);
  }

  // -- retained snapshot (round 11) ---------------------------------------
  // SUBSCRIBE-triggered retained delivery below the GIL: the Python
  // retainer (services/retainer.py — the oracle and authoritative
  // store) mirrors every store/delete/expire into retained_ via ops,
  // and the server enqueues one kRetainDeliver op per eligible
  // subscription. Resolution + encode + write all happen here, for
  // TCP, WS, and SN subscribers alike.

  void RetainDeliver(uint64_t id, const std::string& filter,
                     uint8_t maxqos) {
    auto it = FindConnInflate(id);
    if (it == conns_.end()) return;
    cur_trace_ = 0;  // retained bursts are not part of any sampled trace
    Conn& c = it->second;
    stats_[kStRetainDeliver].fetch_add(1, std::memory_order_relaxed);
    uint64_t t0 = telemetry_ ? NowNs() : 0;
    retain_scratch_.clear();
    retained_.Match(filter, store::WallMs(), &retain_scratch_);
    // NO kHighWater break here: the acceptance contract is a retained
    // set bit-identical to the Python oracle, and _native_retained has
    // already told Python the subscription was served — truncating
    // mid-set would silently lose the tail with no fallback. Memory is
    // bounded by the retainer store itself (max_retained), exactly the
    // exposure the asyncio path has; ordinary publish backpressure
    // still applies to everything after this burst.
    for (const RetainEntry* e : retain_scratch_) {
      uint8_t oq = e->qos < maxqos ? e->qos : maxqos;
      if ((c.sn || c.coap) && oq > 1) oq = 1;  // the datagram-gw cap
      if (oq == 0) {
        if (c.sn) {
          SnDeliverPublish(c, e->topic, e->payload, 0, /*retain=*/true,
                           false, 0);
        } else {
          pub_scratch_.clear();
          BuildPublish(&pub_scratch_, e->topic, e->payload, 0, 0,
                       c.proto_ver == 5);
          pub_scratch_[0] = static_cast<char>(0x30 | 0x01);  // retain=1
          AppendMqtt(c, pub_scratch_.data(), pub_scratch_.size());
          stats_[kStFastBytesOut].fetch_add(pub_scratch_.size(),
                                            std::memory_order_relaxed);
        }
      } else if (c.sn) {
        if (!SnDeliverElevated(id, c, e->topic, e->payload,
                               /*retain=*/true))
          continue;
      } else {
        AckState& a = EnsureAck(c);
        pub_scratch_.clear();
        BuildPublish(&pub_scratch_, e->topic, e->payload, 1, 0,
                     c.proto_ver == 5);
        pub_scratch_[0] = static_cast<char>(0x30 | (oq << 1) | 0x01);
        size_t var = 1;
        while (static_cast<uint8_t>(pub_scratch_[var]) & 0x80) var++;
        size_t qoff = var + 1 + 2 + e->topic.size();
        if (a.inflight_cnt >= c.max_inflight) {
          if (a.pending.size() >= kMaxPending) {
            stats_[kStDropsInflight].fetch_add(
                1, std::memory_order_relaxed);
            continue;
          }
          // parked with the retain bit already in the header; the
          // dequeue patch touches only the qos bits and the pid
          a.pending.emplace_back(pub_scratch_, qoff);
          AckNote(id, a);
        } else {
          uint16_t tp = NextPid(a);
          if (oq == 2) BitSet(a.infl_qos2, tp - kNativePidBase);
          if (telemetry_ && a.rtt.size() < kRttSamples)
            a.rtt.push_back({NowNs(), e->topic, tp, oq});
          pub_scratch_[qoff] = static_cast<char>(tp >> 8);
          pub_scratch_[qoff + 1] = static_cast<char>(tp & 0xFF);
          AppendMqtt(c, pub_scratch_.data(), pub_scratch_.size());
          stats_[kStFastBytesOut].fetch_add(pub_scratch_.size(),
                                            std::memory_order_relaxed);
          AckNote(id, a);
        }
      }
      stats_[kStRetainMsgsOut].fetch_add(1, std::memory_order_relaxed);
    }
    MarkDirty(id, c);
    FlushDirty();
    if (telemetry_) RecordHist(kHistRetainDeliver, NowNs() - t0);
  }

  // -- telemetry plane ----------------------------------------------------

  // -- faultline (round 15) ------------------------------------------------
  // Deterministic fault injection at the syscall seams (fault.h). The
  // disarmed cost is ONE relaxed atomic load + branch per seam; every
  // fired fault is observable through the same seams as organic
  // degradation: a faults_injected stat tick + a kLrFault ledger entry
  // (aux = the site) folded once per poll cycle. All fire sites below
  // run on the poll thread (LedgerNote's ownership contract); the
  // store's own sites live in store.h under its mutex.

  void FaultNote(int site) {
    stats_[kStFaultsInjected].fetch_add(1, std::memory_order_relaxed);
    LedgerNote(kLrFault, static_cast<uint64_t>(site));
  }

  // Armed-site decision + accounting for sites with one behavior
  // (accept/connect/ring/doorbell/clock): true = the fault fires.
  bool FaultHit(int site, uint64_t key) {
    if (!fault_.armed(site)) return false;
    if (!fault_.Fire(site, key)) return false;
    FaultNote(site);
    return true;
  }

  // The socket-read seam. errno mode fails with ECONNRESET; blackhole
  // models a partition: whatever the kernel holds is drained and
  // DISCARDED (bytes in flight are lost in the void, and the
  // level-triggered epoll quiesces) while the caller sees "nothing
  // arrived" — no FIN/RST ever surfaces through a blackholed read.
  ssize_t FaultRecv(int site, uint64_t key, int fd, void* buf,
                    size_t cap) {
    if (!fault_.armed(site)) return recv(fd, buf, cap, 0);
    int m = fault_.Fire(site, key);
    if (m == 0) return recv(fd, buf, cap, 0);
    FaultNote(site);
    if (m == fault::kModeBlackhole) {
      [[maybe_unused]] ssize_t junk = recv(fd, buf, cap, 0);
      errno = EAGAIN;
      return -1;
    }
    errno = ECONNRESET;
    return -1;
  }

  // The socket-write seam. short mode genuinely sends only a prefix
  // (the partial-write backlog machinery runs for real); blackhole
  // claims full success while the bytes vanish — the up-but-black
  // link shape the trunk watchdog exists for.
  ssize_t FaultSend(int site, uint64_t key, int fd, const char* buf,
                    size_t len) {
    if (!fault_.armed(site))
      return ::send(fd, buf, len, MSG_NOSIGNAL);
    int m = fault_.Fire(site, key);
    if (m == 0) return ::send(fd, buf, len, MSG_NOSIGNAL);
    FaultNote(site);
    if (m == fault::kModeBlackhole) return static_cast<ssize_t>(len);
    if (m == fault::kModeShort)
      return ::send(fd, buf, len > 1 ? len / 2 : 1, MSG_NOSIGNAL);
    errno = ECONNRESET;
    return -1;
  }

  // Housekeep clock skew: ConnIdleMs sees NowMs() + this many ms while
  // the site is armed (keepalive scans judge conns against a future
  // clock — the idle-teardown machinery under test).
  uint64_t FaultSkewMs() {
    // @fault(housekeep_clock)
    if (!FaultHit(fault::kSiteHousekeepClock, 0)) return 0;
    return static_cast<uint64_t>(
        fault_.Param(fault::kSiteHousekeepClock));
  }

  void RecordHist(int stage, uint64_t ns) {
    Hist& h = hists_[stage];
    h.b[HistBucket(ns)]++;
    h.cnt++;
    h.sum += ns;
    hist_dirty_ |= 1u << stage;
  }

  // Ring-buffer note on a conn's flight recorder (lazy 256B alloc).
  void FrNote(Conn& c, uint8_t event, uint8_t ptype, uint16_t arg,
              uint32_t hash = 0, uint32_t arg2 = 0) {
    if (!telemetry_) return;
    if (!c.fr) c.fr = std::make_unique<FlightRec>();
    FlightRec& r = *c.fr;
    // fr_now_ms_ is the cycle stamp (refreshed at Poll entry): ms
    // resolution is the recorder's contract, and a clock read per
    // note was a measurable share of the telemetry tax
    r.e[r.head] = {static_cast<uint32_t>(fr_now_ms_), event, ptype, arg,
                   hash, arg2};
    r.head = static_cast<uint8_t>((r.head + 1) % kFrCap);
    if (r.n < kFrCap) r.n++;
  }

  size_t TeleCap() const {
    size_t cap = kTapFlushBytes;
    if (cap > max_size_ / 2) cap = max_size_ / 2 + 1;
    return cap;
  }

  // -- native distributed tracing (round 13) ------------------------------

  // Mint the next sampled trace id (seed carries node+shard bits from
  // Python; the low 44 bits count upward, so ids are unique per shard
  // for ~17T sampled publishes).
  uint64_t NextTraceId() {
    return trace_seed_ | (++trace_ctr_ & ((1ull << 44) - 1));
  }

  // The per-publish sampling decision (the kind-8 ticker discipline):
  // tick once per natively-consumed publish, tag 1-in-(mask+1). Called
  // at the commit point — after every punt decision, before any side
  // effect — so the tick count is exactly the native publish count and
  // the sampled subset is deterministic. Rate-bounded per poll cycle
  // (kTraceMaxPerCycle): a blast cycle draining thousands of publishes
  // clips its extra picks instead of flooding the span plane.
  // @admit-gated — the commit point sits AFTER every punt decision
  void TraceSample(uint64_t publisher) {
    cur_trace_ = 0;
    if (!telemetry_ || !tracing_) return;
    if ((++trace_tick_ & trace_mask_) != 0) return;
    if (trace_cyc_used_ >= kTraceMaxPerCycle) return;
    trace_cyc_used_++;
    cur_trace_ = NextTraceId();
    cur_trace_delivers_ = 0;
    stats_[kStTracedPubs].fetch_add(1, std::memory_order_relaxed);
    SpanNote(kSpanIngress, publisher);
  }

  // Emit one span point for the active (or explicitly named) trace.
  void SpanNote(uint8_t stage, uint64_t aux, uint64_t trace = 0) {
    if (!telemetry_) return;
    uint64_t tid = trace ? trace : cur_trace_;
    if (!tid) return;
    char e[26];
    e[0] = 1;
    memcpy(e + 1, &tid, 8);
    e[9] = static_cast<char>(stage);
    uint64_t t = NowNs();
    memcpy(e + 10, &t, 8);
    memcpy(e + 18, &aux, 8);
    SpanAppend(e, 26);
  }

  // Fold one degradation-ladder decision into this cycle's per-reason
  // ledger slot (O(1), no allocation — ladder decisions can be
  // message-rate under overload; FlushSpans emits at most one ledger
  // entry per reason per cycle carrying the folded count).
  void LedgerNote(uint8_t reason, uint64_t aux) {
    if (!telemetry_ || reason == 0 || reason >= kLrCount) return;
    ledger_cyc_[reason]++;
    ledger_aux_[reason] = aux;
    if (cur_trace_) ledger_trace_[reason] = cur_trace_;
  }

  // One deliver_write span per written delivery of the active sampled
  // publish, capped so a wide fan-out cannot flood the span plane.
  // The first delivery past the cap emits ONE truncation marker
  // (aux bit 63) so the clipped timeline declares itself clipped.
  void TraceDeliverNote(uint64_t owner) {
    if (!cur_trace_) return;
    if (cur_trace_delivers_ < kTraceMaxDeliverSpans) {
      cur_trace_delivers_++;
      SpanNote(kSpanDeliverWrite, owner);
    } else if (cur_trace_delivers_ == kTraceMaxDeliverSpans) {
      cur_trace_delivers_++;  // marker fires once per (publish, shard)
      SpanNote(kSpanDeliverWrite, owner | kSpanTruncBit);
    }
  }

  // Whole-sub-record append at the tap bound (the TeleAppend shape —
  // header slot seeded AFTER the flush check).
  // @bounded(span_buf_)
  void SpanAppend(const char* data, size_t len) {
    size_t cap = TeleCap();
    if (span_buf_.size() > 13 && span_buf_.size() - 13 + len > cap)
      FlushSpans();
    if (span_buf_.empty()) span_buf_.assign(13, '\0');
    span_buf_.append(data, len);
    if (span_buf_.size() - 13 > cap) FlushSpans();
  }

  void FlushSpans() {
    for (int r = 1; r < kLrCount; r++) {
      if (!ledger_cyc_[r]) continue;
      char e[34];
      e[0] = 2;
      e[1] = static_cast<char>(r);
      memcpy(e + 2, &ledger_cyc_[r], 8);
      memcpy(e + 10, &ledger_trace_[r], 8);
      memcpy(e + 18, &ledger_aux_[r], 8);
      uint64_t t = NowNs();
      memcpy(e + 26, &t, 8);
      ledger_cyc_[r] = ledger_trace_[r] = ledger_aux_[r] = 0;
      SpanAppend(e, 34);  // zeroed first: a reentrant flush re-scans
    }
    if (span_buf_.size() <= 13) {
      span_buf_.clear();
      return;
    }
    span_buf_[0] = 12;
    // id slot = shard, the kind-7/8/10 convention: N poll threads feed
    // one Python fold, which attributes spans to the producing shard
    uint64_t id = static_cast<uint64_t>(shard_id_);
    memcpy(&span_buf_[1], &id, 8);
    uint32_t plen = static_cast<uint32_t>(span_buf_.size() - 13);
    memcpy(&span_buf_[9], &plen, 4);
    events_.push_back(std::move(span_buf_));
    span_buf_.clear();
    stats_[kStSpanBatches].fetch_add(1, std::memory_order_relaxed);
  }

  // Append ONE whole sub-record; flushes at the tap bound so a chunk
  // boundary never splits a sub-record (Poll drops any record larger
  // than the caller's whole buffer — the kind-6/7 lesson). The header
  // slot is seeded AFTER the flush check (the round-7 EmitTap bug:
  // a headerless post-flush append gets overwritten by the patch).
  // @bounded(tele_buf_)
  void TeleAppend(const char* data, size_t len) {
    size_t cap = TeleCap();
    if (tele_buf_.size() > 13 && tele_buf_.size() - 13 + len > cap)
      FlushTelemetry();
    if (tele_buf_.empty()) tele_buf_.assign(13, '\0');
    tele_buf_.append(data, len);
    if (tele_buf_.size() - 13 > cap) FlushTelemetry();
  }

  void FlushTelemetry() {
    if (tele_buf_.size() <= 13) return;
    tele_buf_[0] = 8;
    // id slot = shard (round 12): the telemetry fold runs under one
    // lock across N poll threads and tags per-shard gauges by this
    uint64_t id = static_cast<uint64_t>(shard_id_);
    memcpy(&tele_buf_[1], &id, 8);
    uint32_t plen = static_cast<uint32_t>(tele_buf_.size() - 13);
    memcpy(&tele_buf_[9], &plen, 4);
    events_.push_back(std::move(tele_buf_));
    tele_buf_.clear();
    stats_[kStTelemetryBatches].fetch_add(1, std::memory_order_relaxed);
  }

  // Per-cycle histogram deltas (sub-record 1): only dirty stages, only
  // buckets that moved. The flushed shadow updates as each record is
  // BUILT, so the deltas sum to the totals exactly — even when
  // TeleAppend chunks the cycle across several kind-8 events.
  void FlushHistDeltas() {
    if (!telemetry_ || !hist_dirty_) return;
    for (int s = 0; s < kHistCount; s++) {
      if (!(hist_dirty_ & (1u << s))) continue;
      Hist& cur = hists_[s];
      Hist& old = hists_flushed_[s];
      tele_scratch_.clear();
      char hdr[20];
      hdr[0] = 1;
      hdr[1] = static_cast<char>(s);
      uint64_t cd = cur.cnt - old.cnt;
      uint64_t sd = cur.sum - old.sum;
      memcpy(hdr + 2, &cd, 8);
      memcpy(hdr + 10, &sd, 8);
      tele_scratch_.append(hdr, 20);  // bytes 18-19 patched below
      uint16_t nb = 0;
      for (int i = 0; i < 64; i++) {
        uint64_t d = cur.b[i] - old.b[i];
        if (!d) continue;
        char ent[5];
        ent[0] = static_cast<char>(i);
        uint32_t d32 = d > 0xFFFFFFFFull ? 0xFFFFFFFFu
                                         : static_cast<uint32_t>(d);
        memcpy(ent + 1, &d32, 4);
        tele_scratch_.append(ent, 5);
        nb++;
      }
      memcpy(&tele_scratch_[18], &nb, 2);
      old = cur;
      TeleAppend(tele_scratch_.data(), tele_scratch_.size());
    }
    hist_dirty_ = 0;
  }

  // Dump a conn's flight-recorder tail (sub-record 2), oldest first.
  void EmitFlightRec(uint64_t id, Conn& c, uint8_t reason) {
    if (!telemetry_ || !c.fr || c.fr->n == 0) return;
    FlightRec& r = *c.fr;
    tele_scratch_.clear();
    char hdr[11];
    hdr[0] = 2;
    memcpy(hdr + 1, &id, 8);
    hdr[9] = static_cast<char>(reason);
    hdr[10] = static_cast<char>(r.n);
    tele_scratch_.append(hdr, 11);
    uint8_t start = static_cast<uint8_t>((r.head + kFrCap - r.n) % kFrCap);
    for (uint8_t i = 0; i < r.n; i++) {
      const FrEntry& e = r.e[(start + i) % kFrCap];
      tele_scratch_.append(reinterpret_cast<const char*>(&e), sizeof(e));
    }
    stats_[kStFrDumps].fetch_add(1, std::memory_order_relaxed);
    TeleAppend(tele_scratch_.data(), tele_scratch_.size());
  }

  // Sampled native ack RTT past the slow-ack threshold (sub-record 3):
  // services/slow_subs.py ranks these next to Python-plane deliveries.
  void EmitSlowAck(uint64_t id, uint8_t qos, uint64_t rtt_ns,
                   const std::string& topic) {
    if (rtt_ns < slow_ack_ns_) return;
    tele_scratch_.clear();
    char hdr[16];
    hdr[0] = 3;
    memcpy(hdr + 1, &id, 8);
    uint64_t us = rtt_ns / 1000;
    uint32_t us32 = us > 0xFFFFFFFFull ? 0xFFFFFFFFu
                                       : static_cast<uint32_t>(us);
    memcpy(hdr + 9, &us32, 4);
    hdr[13] = static_cast<char>(qos);
    uint16_t tl = topic.size() > 0xFFFF
                      ? 0xFFFF
                      : static_cast<uint16_t>(topic.size());
    memcpy(hdr + 14, &tl, 2);
    tele_scratch_.append(hdr, 16);
    tele_scratch_.append(topic.data(), tl);
    TeleAppend(tele_scratch_.data(), tele_scratch_.size());
  }

  // Close out a matching ack-RTT sample (PUBACK ends a qos1 stamp,
  // PUBCOMP a qos2 one — the full exchange RTT by construction, since
  // the inflight bit holds across PUBREC/PUBREL).
  void TeleAckRtt(uint64_t id, AckState& a, uint16_t pid) {
    for (size_t i = 0; i < a.rtt.size(); i++) {
      if (a.rtt[i].pid != pid) continue;
      uint64_t rtt = NowNs() - a.rtt[i].t0_ns;
      RecordHist(a.rtt[i].qos == 2 ? kHistQos2Rtt : kHistQos1Rtt, rtt);
      if (telemetry_) {
        EmitSlowAck(id, a.rtt[i].qos, rtt, a.rtt[i].topic);
        // a traced delivery's ack closes its timeline (round 13): the
        // sample carried the publish's trace id across the exchange.
        // aux = subscriber conn with the delivery qos in bits 60-61
        // (conn ids top out at bit 59 + the shard prefix), so the
        // Python fold can attribute the exemplar to the right RTT
        // histogram (qos1_rtt vs qos2_rtt)
        if (a.rtt[i].trace)
          SpanNote(kSpanAck,
                   id | (static_cast<uint64_t>(a.rtt[i].qos) << 60),
                   a.rtt[i].trace);
      }
      a.rtt[i] = std::move(a.rtt.back());
      a.rtt.pop_back();
      return;
    }
  }

  static void BuildPublish(std::string* out, std::string_view topic,
                           std::string_view payload, uint8_t qos,
                           uint16_t pid, bool v5) {
    size_t remaining = 2 + topic.size() + (qos ? 2 : 0) + (v5 ? 1 : 0) +
                       payload.size();
    out->push_back(static_cast<char>(0x30 | (qos << 1)));
    size_t r = remaining;
    do {
      uint8_t b = r & 0x7F;
      r >>= 7;
      out->push_back(static_cast<char>(r ? b | 0x80 : b));
    } while (r);
    out->push_back(static_cast<char>(topic.size() >> 8));
    out->push_back(static_cast<char>(topic.size() & 0xFF));
    out->append(topic.data(), topic.size());
    if (qos) {
      out->push_back(static_cast<char>(pid >> 8));
      out->push_back(static_cast<char>(pid & 0xFF));
    }
    if (v5) out->push_back('\0');  // empty property section
    out->append(payload.data(), payload.size());
  }

  void MarkDirty(uint64_t id, Conn& c) {
    if (!c.dirty) {
      c.dirty = true;
      dirty_.push_back(id);
    }
  }

  // Append one MQTT byte span to a conn's transport buffer; WS conns
  // get it wrapped in a binary frame (one frame per serialized span,
  // matching the asyncio server's one-frame-per-packet-batch shape);
  // SN conns run the MQTT->SN egress translation (sn gateway, below).
  void AppendMqtt(Conn& c, const char* data, size_t len) {
    if (c.sn) {
      SnEgress(c, data, len);
      return;
    }
    if (c.coap) {
      CoapEgress(c, data, len);
      return;
    }
    if (c.ws) ws::AppendFrameHeader(&c.outbuf, ws::kOpBinary, len);
    c.outbuf.append(data, len);
  }

  void Flush(uint64_t id, Conn& c) {
    if (c.sn) {
      SnFlush(id, c);
      return;
    }
    if (c.coap) {
      CoapFlush(id, c);
      return;
    }
    if (c.fd < 0) {
      // synthetic conns (bench/test herd) have no socket: egress is
      // discarded, want_close honours the normal teardown path
      c.outbuf.clear();
      c.outpos = 0;
      if (c.want_close) Drop(id, "closed_by_host", false);
      return;
    }
    while (c.outpos < c.outbuf.size()) {
      // @fault(conn_write) — errno/short/blackhole on the conn send
      ssize_t n = FaultSend(fault::kSiteConnWrite, id, c.fd,
                            c.outbuf.data() + c.outpos,
                            c.outbuf.size() - c.outpos);
      if (n > 0) {
        c.outpos += static_cast<size_t>(n);
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u64 = id;
        epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, c.fd, &ev);
        return;
      } else if (n < 0 && errno == EINTR) {
        continue;
      } else {
        Drop(id, "sock_error", true);
        return;
      }
    }
    c.outbuf.clear();
    c.outpos = 0;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = id;
    epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, c.fd, &ev);
    if (c.want_close) Drop(id, "closed_by_host", false);
  }

  void Drop(uint64_t id, const char* reason, bool notify) {
    auto it = conns_.find(id);
    if (it == conns_.end()) {
      // hibernating conns tear down from the parked record directly —
      // no inflation on the way to the grave
      DropParked(id, reason, notify);
      return;
    }
    // wheel timers die with the conn (generation-checked: a handle
    // already consumed by a same-tick fire no-ops here)
    if (it->second.tm_keepalive) wheel_.Cancel(it->second.tm_keepalive);
    if (it->second.tm_park) wheel_.Cancel(it->second.tm_park);
    if (it->second.sn && it->second.sn->tm_rexmit)
      wheel_.Cancel(it->second.sn->tm_rexmit);
    if (it->second.coap && it->second.coap->tm_notify)
      wheel_.Cancel(it->second.coap->tm_notify);
    if (telemetry_ && it->second.fr) {
      // flight-recorder dump on abnormal close / protocol error, and
      // always for traced conns (the tail rides the trace log).
      // want_close means PYTHON asked for this teardown (channel error,
      // keepalive, server shutdown): those close as closed_by_host even
      // when the drain hits a dead socket mid-flush, so only genuine
      // C++-level protocol errors dump the recorder (the Python-side
      // teardown noise used to dump on every raced sock_error).
      Conn& c = it->second;
      bool benign = c.want_close ||
                    strcmp(reason, "sock_closed") == 0 ||
                    strcmp(reason, "closed_by_host") == 0 ||
                    strcmp(reason, "ws_close") == 0;
      if (c.traced || !benign) {
        uint8_t why = c.traced ? kFrReasonTrace
                      : (strcmp(reason, "frame_error") == 0 ||
                         strncmp(reason, "ws_", 3) == 0)
                          ? kFrReasonError
                          : kFrReasonClose;
        EmitFlightRec(id, c, why);
      }
    }
    // tear down this conn's real subscription entries; punt markers are
    // owned by Python tokens and removed through the broker observer
    for (const std::string& filt : it->second.own_subs)
      subs_.Remove(id, filt);
    for (const auto& [token, filt] : it->second.own_shared)
      subs_.SharedRemove(token, id, filt);
    if (it->second.sn) {
      // datagram conns share the listener fd: release only the
      // bookkeeping (the addr slot may already point at a successor
      // after a new-identity re-CONNECT — never steal it)
      SnConnState& s = *it->second.sn;
      if (!s.anon) {
        auto ait = sn_addr_conn_.find(SnAddrKey(s.addr));
        if (ait != sn_addr_conn_.end() && ait->second == id)
          sn_addr_conn_.erase(ait);
      }
      if (id == sn_anon_id_) sn_anon_id_ = 0;
    } else if (it->second.coap) {
      // CoAP conns share the listener fd too: release only the addr
      // slot, and only if it still points at US (a new-identity
      // re-register may have handed it to a successor conn)
      auto ait = coap_addr_conn_.find(SnAddrKey(it->second.coap->addr));
      if (ait != coap_addr_conn_.end() && ait->second == id)
        coap_addr_conn_.erase(ait);
    } else if (it->second.fd >= 0) {  // synthetic conns have no socket
      epoll_ctl(epoll_fd_, EPOLL_CTL_DEL, it->second.fd, nullptr);
      close(it->second.fd);
    }
    conns_.erase(it);
    conn_cids_.erase(id);
    if (notify)
      events_.push_back(EncodeRecord(3, id, reason, strlen(reason)));
  }

  uint32_t max_size_;
  uint32_t max_conns_;
  int epoll_fd_ = -1;
  int listen_fd_ = -1;
  int wake_fd_ = -1;
  int port_ = 0;
  uint64_t next_id_ = 1;
  std::unordered_map<uint64_t, Conn> conns_;
  // conn -> clientid (round 18, poll-thread-owned like conns_): set by
  // kEnableFast, read by DurableAppend to stamp the origin clientid
  // into persisted entries; a SIDE map (not Conn state) so it survives
  // park/inflate cycles — erased only at real teardown
  std::unordered_map<uint64_t, std::string> conn_cids_;
  std::deque<std::string> events_;  // encoded records awaiting pickup
  std::mutex mu_;
  std::vector<std::pair<uint64_t, std::string>> pending_;         // @guards(mu_)
  std::vector<uint64_t> pending_closes_;                          // @guards(mu_)
  std::vector<Op> pending_ops_;                                   // @guards(mu_)
  // fast path (poll-thread-owned)
  SubTable subs_;
  std::vector<const SubEntry*> match_scratch_;
  std::vector<SharedGroup*> groups_scratch_;
  std::string pub_scratch_;
  std::string key_scratch_;
  std::string frame_v4_, frame_v5_;  // per-publish shared qos0 frames
  // per-publish shared elevated-qos frames (zero pid, qos1 header;
  // patched per target) + their pid byte offsets
  std::string frame_q_v4_, frame_q_v5_;
  size_t qpid_off_v4_ = 0, qpid_off_v5_ = 0;
  // conns with window activity this poll cycle → one kind-7 record
  std::vector<uint64_t> ack_dirty_;
  std::string ack_buf_;
  std::vector<uint64_t> dirty_;
  // @atomic(relaxed: monotone counters; poll thread bumps, gauge reads tear-free but unordered)
  std::atomic<uint64_t> stats_[kStatCount] = {};
  // enforces ConnIdleMs contract
  // @atomic(acq_rel: poll-thread start release-publishes loop state; misuse checks acquire-load)
  std::atomic<pthread_t> poll_thread_{};
  // @atomic(relaxed: warn-once latch, exact count never matters)
  mutable std::atomic<bool> idle_misuse_warned_{false};
  // -- telemetry plane (poll-thread-owned) --------------------------------
  bool telemetry_ = true;        // EMQX_NATIVE_TELEMETRY=0 escape hatch
  uint64_t slow_ack_ns_ = 500ull * 1000 * 1000;  // slow-ack report floor
  Hist hists_[kHistCount];
  Hist hists_flushed_[kHistCount];  // shadow at last kind-8 emission
  uint32_t hist_dirty_ = 0;         // bit per stage
  uint64_t poll_exit_ns_ = 0;       // GIL-stint reference stamp
  uint64_t flush_t0_ = 0;           // sampled route->flush stamp
  uint32_t tele_tick_ = 0;          // sampled publish-stage counter
  uint32_t tele_tick_ws_ = 0;       // sampled WS-ingest counter
  uint32_t tele_tick_sn_ = 0;       // sampled SN-ingest counter
  // per-message stages sample 1-in-(mask+1); default 7 = the 1-in-8
  // documented cadence, overridable via EMQX_NATIVE_TELEMETRY_SHIFT
  uint32_t tele_mask_ = 7;
  uint64_t fr_now_ms_ = 0;          // per-cycle flight-recorder stamp
  uint64_t last_hist_flush_ms_ = 0;  // hist-delta emission cadence
  uint32_t cur_hash_ = 0;           // current publish's topic hash
  // @bounded — kind-8 batch (bytes [0,13) = header slot)
  std::string tele_buf_;
  std::string tele_scratch_;  // one sub-record under construction
  // -- native distributed tracing (round 13, poll-thread-owned) ------------
  bool tracing_ = true;       // EMQX_NATIVE_TRACING=0 escape hatch
  uint32_t trace_mask_ = 63;  // sample 1-in-(mask+1); default 1-in-64
  uint32_t trace_tick_ = 0;   // global publish ticker (deterministic)
  uint64_t trace_seed_ = 1ull << 63;  // node+shard prefix (Python sets)
  uint64_t trace_ctr_ = 0;
  uint32_t trace_cyc_used_ = 0;  // sampled publishes this poll cycle
  uint64_t cur_trace_ = 0;    // active publish's trace id (0 = unsampled)
  uint8_t cur_trace_delivers_ = 0;  // deliver_write spans emitted so far
  uint32_t fan_xshipped_ = 0;  // shards shipped by the LAST FanOut
  // @bounded — kind-12 batch (bytes [0,13) = header slot)
  std::string span_buf_;
  // per-cycle degradation-ledger accumulators (one kind-12 sub-2 entry
  // per nonzero reason per cycle)
  uint64_t ledger_cyc_[kLrCount] = {};
  uint64_t ledger_trace_[kLrCount] = {};
  uint64_t ledger_aux_[kLrCount] = {};
  // highest trunk wire version this host speaks/advertises (tests cap
  // it at 0 to simulate an old peer)
  uint8_t trunk_wire_max_ = trunk::kWireVersion;
  // -- faultline (round 15) ------------------------------------------------
  // deterministic fault injection (fault.h): armed from any thread,
  // fired on the poll thread; disarmed sites cost one relaxed load
  fault::Injector fault_;
  // silent-link watchdog deadline: a front ring entry unacked this
  // long on an UP link kills it (TrunkAckScan) — the only way an
  // up-but-black partition ever resolves into a replay
  uint64_t trunk_ack_timeout_ms_ = 10000;
  // -- device match lane (poll-thread-owned) ------------------------------
  // Permitted PUBLISHes whose wildcard match runs on the DEVICE router
  // instead of the C++ trie walk: the frame parks here keyed by a lane
  // sequence number while its topic rides a batched kernel launch
  // (broker/native_server.py pump → models/router_model.py); the
  // response names the matched filter strings and delivery resolves
  // them through SubTable::MatchFilter. The per-message walk stays as
  // the always-correct fallback (soft cap, stale drain, lane off).
  bool lane_enabled_ = false;
  uint8_t max_qos_allowed_ = 2;  // mqtt.max_qos_allowed zone cap mirror
  uint64_t lane_seq_ = 1;
  std::unordered_map<uint64_t, LaneEntry> lane_pending_;
  std::deque<uint64_t> lane_order_;          // seqs in arrival order
  // per-topic pending counts: a topic with lane entries in flight must
  // keep going through the lane (a walk fallback would overtake them)
  std::unordered_map<std::string, uint32_t> lane_topic_pending_;
  // topics whose remaining parked frames must punt (ordering guard
  // after a nondeterministic punt); cleared as their counts drain
  std::unordered_set<std::string> lane_poisoned_;
  // @atomic(relaxed: backlog gauge; poll thread stores, mgmt reads tear-free but unordered)
  std::atomic<uint64_t> lane_backlog_{0};
  // -- durable-session plane (poll-thread-owned) ---------------------------
  // The host-side message store (store.h): attached by Python BEFORE
  // the poll thread starts (like the listeners). Null = durable plane
  // off; matched kSubDurable entries then degrade to punts.
  store::DurableStore* store_ = nullptr;
  // @bounded — bytes [0,33) = event+batch header slot
  std::string dur_buf_;
  uint32_t dur_n_ = 0;             // entries in dur_buf_
  std::string dur_prev_payload_;   // payload-dedup reference
  bool dur_have_prev_ = false;
  std::vector<uint64_t> dur_tok_scratch_;  // tokens matched by ONE publish
  bool cur_dup_ = false;           // current publish's DUP bit (FanOut)
  // punt markers mirrored into their own table: the device model only
  // covers broker-table subscriptions, so lane delivery re-checks this
  // (usually tiny) trie per message — remote "n:" routes and any punt
  // shape the device cannot see still force the Python fan-out
  SubTable punt_subs_;
  std::vector<const SubEntry*> punt_scratch_;
  // batched rule-tap entries awaiting one event; bytes [0,13) are the
  // record header slot FlushTaps patches before moving the buffer out
  // @bounded
  std::string tap_buf_;
  std::string tap_prev_payload_;  // payload-dedup reference
  bool tap_have_prev_ = false;
  // -- websocket listener --------------------------------------------------
  int listen_ws_fd_ = -1;
  int ws_port_ = 0;
  std::string ws_path_ = "/mqtt";  // required upgrade request-target
  // -- cluster trunk (poll-thread-owned) -----------------------------------
  int listen_trunk_fd_ = -1;
  int trunk_port_ = 0;
  uint64_t next_trunk_tag_ = 1;
  uint32_t trunk_hello_pending_ = 0;  // links inside the HELLO grace
  std::unordered_map<uint64_t, trunk::Sock> trunk_socks_;  // tag → sock
  std::unordered_map<uint64_t, trunk::Peer> trunk_peers_;  // peer → state
  std::vector<uint64_t> trunk_dirty_;    // peers batched this cycle
  std::vector<uint64_t> trunk_scratch_;  // peers matched by ONE publish
  std::string trunk_punt_buf_;           // kind-9 sub-3 under construction
  // -- mqtt-sn gateway (round 11, poll-thread-owned) -----------------------
  int sn_fd_ = -1;
  int sn_port_ = 0;
  uint8_t sn_gw_id_ = 1;
  uint64_t next_sn_id_ = 1;             // ids minted under kSnConnBit
  uint64_t sn_anon_id_ = 0;             // the shared QoS -1 publisher
  std::unordered_map<uint64_t, uint64_t> sn_addr_conn_;  // addr → conn
  std::unordered_map<uint16_t, std::string> sn_predefined_;
  // -- conn-scale plane (round 16, poll-thread-owned) ----------------------
  // The per-shard timer wheel (keepalive, park-after, SN rexmit, trunk
  // ack watchdog) + the hibernation plane. parked_bytes_/counters are
  // atomics only because Python-side gauges read them cross-thread.
  wheel::Wheel wheel_{NowMs()};
  park::Slab<park::Parked> park_slab_;
  std::unordered_map<uint64_t, uint32_t> parked_;  // conn id -> slab slot
  // @atomic(relaxed: parked-memory gauge; poll thread adds/subs, conn_counts reads tear-free but unordered)
  std::atomic<uint64_t> parked_bytes_{0};
  park::AcceptGovernor gov_;
  bool park_enabled_ = true;
  uint64_t park_after_ms_ = 0;  // explicit override; 0 = 2x-grace auto
  std::vector<sn::SnMsg> sn_msgs_scratch_;
  std::vector<std::string> sn_frames_scratch_;
  std::vector<uint8_t> sn_rx_buf_;  // recvmmsg slots, sized on first read
  // -- coap gateway (round 19, poll-thread-owned) --------------------------
  int coap_fd_ = -1;
  int coap_port_ = 0;
  uint64_t next_coap_id_ = 1;           // ids minted under kCoapConnBit
  std::unordered_map<uint64_t, uint64_t> coap_addr_conn_;  // addr → conn
  std::vector<uint8_t> coap_rx_buf_;    // recvmmsg slots, lazy-sized
  std::vector<std::string> coap_frames_scratch_;  // egress MQTT frames
  std::vector<std::string_view> coap_path_scratch_;
  std::string coap_pub_scratch_;        // per-target qos1 frame patch
  // Python's retained mirror carries no props-bearing topics; while
  // ANY exist the mirror is incomplete and plain GETs degrade whole
  // to the oracle (kCoapRetainState keeps this in sync)
  bool coap_retain_complete_ = true;
  uint64_t coap_ack_timeout_ms_ = coap::kAckTimeoutMs;
  uint32_t tele_tick_coap_ = 0;         // sampled CoAP-ingest counter
  uint32_t tele_tick_notify_ = 0;       // sampled observe-notify counter
  // -- retained snapshot (round 11, poll-thread-owned) ---------------------
  RetainTable retained_;
  std::vector<const RetainEntry*> retain_scratch_;
  // -- multi-core shards (round 12, poll-thread-owned) ---------------------
  // The group is Python-owned and outlives every member host; shard 0
  // with group_ == nullptr IS the unsharded host (every shard check
  // short-circuits). Outbound batches accumulate per destination and
  // seal once per poll cycle (FlushShards) or at the byte cap.
  ring::ShardGroup* group_ = nullptr;
  int shard_id_ = 0;
  std::string xbatch_[ring::kMaxShards];       // open batch per dest
  uint32_t xbatch_n_[ring::kMaxShards] = {};   // entries in each batch
  uint32_t xbatch_sealed_[ring::kMaxShards] = {};  // seals this cycle
  std::string xprev_payload_[ring::kMaxShards];  // payload-dedup ref
  bool xhave_prev_[ring::kMaxShards] = {};
  std::vector<int> xdirty_;       // destinations batched this cycle
  std::vector<int> xdst_scratch_;  // dest shards of ONE publish (admission)
  // ONE publish's cross-shard audience per destination (FanOut collects,
  // XShipMulti ships one multi-target entry per non-empty slot)
  std::vector<uint64_t> xtgt_scratch_[ring::kMaxShards];
  // each peer's OWNER-shard link state mirrored here by Python
  // (kTrunkPeerState broadcast off the kind-9 UP/DOWN events, round
  // 15 spread): non-owner shards decide trunk-vs-punt from this,
  // conservatively down while the mirror lags
  std::unordered_map<uint64_t, bool> trunk_peer_up_;
};

}  // namespace
}  // namespace emqx_native

// ---------------------------------------------------------------------------
// C ABI for ctypes

extern "C" {

// reuseport != 0 binds the TCP listener with SO_REUSEPORT so N shard
// hosts can share one port (kernel accept sharding — round 12).
void* emqx_host_create(const char* bind_addr, uint16_t port,
                       uint32_t max_size, uint32_t max_conns,
                       int reuseport) {
  auto* h = new emqx_native::Host(max_size, max_conns);
  if (!h->Init(bind_addr, port, reuseport != 0)) {
    delete h;
    return nullptr;
  }
  return h;
}

int emqx_host_port(void* h) {
  return static_cast<emqx_native::Host*>(h)->port();
}

// Open the RFC6455 listener on an already-created host. Call BEFORE
// the poll thread starts (the epoll set is mutated from this thread).
// Returns the bound port, or -1.
int emqx_host_listen_ws(void* h, const char* bind_addr, uint16_t port,
                        const char* path, int reuseport) {
  return static_cast<emqx_native::Host*>(h)->ListenWs(bind_addr, port,
                                                      path,
                                                      reuseport != 0);
}

long emqx_host_poll(void* h, uint8_t* buf, size_t cap, int timeout_ms) {
  return static_cast<emqx_native::Host*>(h)->Poll(buf, cap, timeout_ms);
}

int emqx_host_send(void* h, uint64_t conn, const uint8_t* data, size_t len) {
  return static_cast<emqx_native::Host*>(h)->Send(conn, data, len);
}

int emqx_host_close_conn(void* h, uint64_t conn) {
  return static_cast<emqx_native::Host*>(h)->CloseConn(conn);
}

// --- fast-path control plane (thread-safe, applied on the poll thread) ----

// ``clientid`` (nullable) binds the conn's clientid for origin
// attribution: durable appends persist it (store entry flags bit5) so
// no-local / from_ survive a restart (round 18).
int emqx_host_enable_fast(void* h, uint64_t conn, int proto_ver,
                          uint32_t max_inflight, const char* clientid) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kEnableFast;
  op.owner = conn;
  op.proto_ver = static_cast<uint8_t>(proto_ver);
  op.max_inflight = max_inflight;
  if (clientid) op.str = clientid;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_disable_fast(void* h, uint64_t conn) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kDisableFast;
  op.owner = conn;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// flags: bit0 = punt marker, bit1 = no-local
int emqx_host_sub_add(void* h, uint64_t owner, const char* filter,
                      uint8_t qos, uint8_t flags) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSubAdd;
  op.owner = owner;
  op.str = filter;
  op.qos = qos;
  op.flags = flags;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_sub_del(void* h, uint64_t owner, const char* filter) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSubDel;
  op.owner = owner;
  op.str = filter;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_shared_add(void* h, uint64_t token, uint64_t conn,
                         const char* filter, uint8_t qos, uint8_t flags) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSharedAdd;
  op.token = token;
  op.owner = conn;
  op.str = filter;
  op.qos = qos;
  op.flags = flags;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_shared_del(void* h, uint64_t token, uint64_t conn,
                         const char* filter) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSharedDel;
  op.token = token;
  op.owner = conn;
  op.str = filter;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_permit(void* h, uint64_t conn, const char* topic) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kPermit;
  op.owner = conn;
  op.str = topic;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_permits_flush(void* h) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kPermitsFlush;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_set_lane(void* h, int enabled) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetLane;
  op.flags = enabled ? 1 : 0;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_lane_deliver(void* h, const uint8_t* blob, size_t len) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kLaneDeliver;
  op.str.assign(reinterpret_cast<const char*>(blob), len);
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

long emqx_host_lane_backlog(void* h) {
  return static_cast<long>(
      static_cast<emqx_native::Host*>(h)->LaneBacklog());
}

// Dynamic native-plane share of a conn's receive-maximum budget: the
// Python server re-divides the budget per batched ack cycle (the caps
// of the two planes always sum to <= the budget, so occupancy cannot
// exceed the client's Receive Maximum).
int emqx_host_set_inflight_cap(void* h, uint64_t conn, uint32_t cap) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetInflightCap;
  op.owner = conn;
  op.max_inflight = cap;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Trace punt (observability): a traced conn's PUBLISHes take the
// Python plane (full hook visibility) and its flight-recorder tail is
// dumped — immediately on attach and again at teardown (kind 8).
int emqx_host_set_trace(void* h, uint64_t conn, int on) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetTrace;
  op.owner = conn;
  op.flags = on ? 1 : 0;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Telemetry master switch + slow-ack report floor (ns). Histograms,
// flight recorders, and kind-8 emission all gate on `enabled` — the
// EMQX_NATIVE_TELEMETRY=0 escape hatch for overhead-sensitive runs.
int emqx_host_set_telemetry(void* h, int enabled, uint64_t slow_ack_ns) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetTelemetry;
  op.flags = enabled ? 1 : 0;
  op.token = slow_ack_ns;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Native distributed tracing (round 13): the deterministic 1-in-2^shift
// publish sampler. `seed` carries the node+shard prefix trace ids mint
// under (nonzero; 0 keeps the current seed). Tracing also gates on the
// telemetry master switch.
int emqx_host_set_tracing(void* h, int enabled, int shift, uint64_t seed) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetTracing;
  op.flags = enabled ? 1 : 0;
  op.max_inflight = shift >= 0 && shift <= 16
                        ? static_cast<uint32_t>(shift)
                        : 6u;
  op.token = seed;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Cap the trunk wire version this host advertises/accepts (tests set 0
// to exercise the old-peer trace-id downshift).
int emqx_host_set_trunk_wire(void* h, int version) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetTrunkWire;
  op.qos = static_cast<uint8_t>(version < 0 ? 0 : version);
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// --- cluster trunk plane (round 9) ----------------------------------------

// Open the trunk listener (BEFORE the poll thread starts). Peer hosts
// dial this port; received batch records fan out locally below the GIL.
// Returns the bound port, or -1.
int emqx_host_trunk_listen(void* h, const char* bind_addr, uint16_t port,
                           int reuseport) {
  return static_cast<emqx_native::Host*>(h)->ListenTrunk(bind_addr, port,
                                                         reuseport != 0);
}

// Silent-link watchdog deadline in ms (round 15): a front replay-ring
// entry unacked this long on an UP link kills the link so the redial
// can replay it — the only resolution for an up-but-black partition.
// 0 disables the watchdog (default 10s).
int emqx_host_set_trunk_ack_timeout(void* h, uint64_t ms) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetTrunkAckTimeout;
  op.token = ms;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// --- faultline (round 15) ---------------------------------------------------

// Arm (mode 0 disarms) one named fault site — see fault.h for the
// site/mode catalog and the n_or_prob/seed/key determinism contract.
// Store sites forward to the attached store's injector. Thread-safe.
int emqx_host_fault_arm(void* h, int site, int mode, double n_or_prob,
                        uint64_t seed, uint64_t key) {
  return static_cast<emqx_native::Host*>(h)->FaultArm(site, mode,
                                                      n_or_prob, seed,
                                                      key);
}

// Faults fired at one site so far (-1 on a bad site index).
long emqx_host_fault_fired(void* h, int site) {
  return static_cast<emqx_native::Host*>(h)->FaultFired(site);
}

// Dial (or re-dial) a peer's trunk listener. Thread-safe; the poll
// thread performs the nonblocking connect and reports the outcome as a
// kind-9 UP/DOWN event. A successful (re)connect replays the peer's
// unacked qos1 batches before any new traffic.
int emqx_host_trunk_connect(void* h, uint64_t peer, const char* addr,
                            uint16_t port) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kTrunkConnect;
  op.owner = peer;
  op.str = addr;
  op.token = port;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Bind a peer id to its stable NODE NAME (round 18): the durable store
// keys the persisted trunk replay ring on it, since peer ids renumber
// per process. Call before trunk_connect so the previous life's ring
// merges ahead of fresh traffic.
int emqx_host_trunk_ident(void* h, uint64_t peer, const char* name) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kTrunkIdent;
  op.owner = peer;
  op.str = name ? name : "";
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Drop a peer link. forget=0 keeps the peer state (the qos1 replay
// ring survives for the next connect); forget=1 erases it entirely
// (the node left the cluster and its routes are gone — including the
// store-backed ring records).
int emqx_host_trunk_disconnect(void* h, uint64_t peer, int forget) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kTrunkDisconnect;
  op.owner = peer;
  op.flags = forget ? 1 : 0;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Install/remove a remote entry: a cross-node route served by `peer`'s
// trunk instead of a punt marker. While the trunk is down the entry
// BEHAVES as a punt marker (degradation ladder trunk → punt → Python).
int emqx_host_trunk_route_add(void* h, uint64_t peer, const char* filter) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kTrunkRouteAdd;
  op.owner = peer;
  op.str = filter;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_trunk_route_del(void* h, uint64_t peer, const char* filter) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kTrunkRouteDel;
  op.owner = peer;
  op.str = filter;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// --- multi-core shard plane (round 12) --------------------------------------

// Create the cross-shard ring group for `n` shard hosts. Python owns
// the group: create it BEFORE any host joins, destroy it AFTER every
// member host is destroyed (the group owns the doorbell eventfds a
// racing producer may still write to during a member's teardown).
void* emqx_shard_group_create(int n) {
  if (n < 1 || n > emqx_native::ring::kMaxShards) return nullptr;
  return new emqx_native::ring::ShardGroup(n);
}

void emqx_shard_group_destroy(void* g) {
  delete static_cast<emqx_native::ring::ShardGroup*>(g);
}

// Make `h` shard `shard_id` of group `g` (call BEFORE the poll thread
// starts): conn ids gain the shard prefix (bits 56-58), cross-shard
// deliveries ride the group's SPSC rings, and the group's doorbell for
// this shard joins the epoll set. Returns 0, or -1 on a bad id.
int emqx_host_join_group(void* h, void* g, int shard_id) {
  return static_cast<emqx_native::Host*>(h)->JoinGroup(
      static_cast<emqx_native::ring::ShardGroup*>(g), shard_id);
}

// Mirror a peer's OWNER-shard link state onto the other shards
// (Python broadcasts the kind-9 UP/DOWN events here): each shard's
// trunk-vs-punt oracle for legs it would ring-forward to the owner
// (peer % n since round 15).
int emqx_host_trunk_peer_state(void* h, uint64_t peer, int up) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kTrunkPeerState;
  op.owner = peer;
  op.flags = up ? 1 : 0;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// --- mqtt-sn gateway + retained snapshot (round 11) -------------------------

// Open the MQTT-SN/UDP gateway socket (BEFORE the poll thread starts,
// like the other listeners). Returns the bound port, or -1.
int emqx_host_listen_sn(void* h, const char* bind_addr, uint16_t port,
                        int gw_id, int reuseport) {
  return static_cast<emqx_native::Host*>(h)->ListenSn(bind_addr, port,
                                                      gw_id,
                                                      reuseport != 0);
}

// Install/remove a gateway-wide predefined topic id (empty topic
// forgets the id). Thread-safe; applied on the poll thread.
int emqx_host_sn_predefined(void* h, uint16_t topic_id,
                            const char* topic) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSnPredef;
  op.owner = topic_id;
  op.str = topic ? topic : "";
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Mirror one retained message into the host-side snapshot (the Python
// retainer stays the oracle and the authoritative store). deadline_ms
// is the EFFECTIVE absolute wall-clock expiry (0 = never): Python
// folds per-message expiry and the store default into one number.
int emqx_host_set_retained(void* h, const char* topic,
                           const uint8_t* payload, uint32_t plen,
                           uint8_t qos, uint64_t deadline_ms) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kRetainSet;
  op.str = topic;
  op.str2.assign(reinterpret_cast<const char*>(payload), plen);
  op.qos = qos;
  op.token = deadline_ms;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_retain_del(void* h, const char* topic) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kRetainDel;
  op.str = topic;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// SUBSCRIBE-triggered retained delivery below the GIL: match the
// snapshot against `filter` and write every live entry to `conn`
// (retain=1, qos = min(msg, max_qos); elevated qos rides the native
// ack plane, SN conns get SN framing + the qos1 cap).
int emqx_host_retain_deliver(void* h, uint64_t conn, const char* filter,
                             uint8_t max_qos) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kRetainDeliver;
  op.owner = conn;
  op.str = filter;
  op.qos = max_qos;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Per-message telemetry sampling override: stages sample 1-in-2^shift
// (default 3). Out-of-range shifts reset to the default.
int emqx_host_set_telemetry_shift(void* h, int shift) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetTeleShift;
  op.token = static_cast<uint64_t>(shift);
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Codec test surface: parse every SN message in `in` with the shared
// sn.h codec and re-serialize — tests/test_native_sn.py drives the
// Python oracle codec through the same vectors and compares bytes.
long emqx_sn_roundtrip(const uint8_t* in, size_t len, uint8_t** out,
                       size_t* out_len) {
  std::vector<emqx_native::sn::SnMsg> msgs;
  emqx_native::sn::ParseAll(in, len, &msgs);
  std::string buf;
  for (const auto& m : msgs) emqx_native::sn::Serialize(m, &buf);
  uint8_t* p = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
  memcpy(p, buf.data(), buf.size());
  *out = p;
  *out_len = buf.size();
  return static_cast<long>(msgs.size());
}

// --- coap gateway (round 19) ------------------------------------------------

// Open the CoAP/UDP gateway socket (BEFORE the poll thread starts,
// like the other listeners). Returns the bound port, or -1.
int emqx_host_listen_coap(void* h, const char* bind_addr, uint16_t port,
                          int reuseport) {
  return static_cast<emqx_native::Host*>(h)->ListenCoap(bind_addr, port,
                                                        reuseport != 0);
}

// Answer path for oracle-served (kind-13 punted) exchanges: raw CoAP
// response bytes for `conn`'s peer. Thread-safe; applied on the poll
// thread, framed into the conn's datagram outbuf verbatim.
int emqx_host_coap_send(void* h, uint64_t conn, const uint8_t* data,
                        uint32_t len) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kCoapSend;
  op.owner = conn;
  op.str.assign(reinterpret_cast<const char*>(data), len);
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Mirror whether the retained snapshot is COMPLETE (no props-carrying
// topics excluded): plain CoAP GETs serve natively only while it is;
// otherwise they degrade whole to the Python oracle's lookup.
int emqx_host_coap_retain_state(void* h, int complete) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kCoapRetainState;
  op.flags = complete ? 1 : 0;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// CON-notify retransmit base in ms (0 restores the RFC 7252 default
// ACK_TIMEOUT x 1.5 = 3000); tests compress the backoff clock with it.
int emqx_host_set_coap_ack_timeout(void* h, uint64_t ms) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetCoapAckTimeout;
  op.token = ms;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Codec test surface: parse one CoAP datagram with the shared coap.h
// codec and re-serialize — tests/test_native_coap.py drives the Python
// oracle codec through the same vectors and compares bytes.
long emqx_coap_roundtrip(const uint8_t* in, size_t len, uint8_t** out,
                         size_t* out_len) {
  emqx_native::coap::CoapMsg m;
  std::string buf;
  long n = 0;
  if (emqx_native::coap::Parse(in, len, &m)) {
    emqx_native::coap::Serialize(m, &buf);
    n = 1;
  }
  uint8_t* p = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
  memcpy(p, buf.data(), buf.size());
  *out = p;
  *out_len = buf.size();
  return n;
}

// --- durable-session plane (round 10) --------------------------------------

// Open (or recover) a durable store. dir "" = anonymous (in-memory)
// segments; fsync_policy: 0 never, 1 per batch, 2 ~100ms interval.
// Returns null when the directory cannot be used at all.
void* emqx_store_open(const char* dir, uint64_t segment_bytes,
                      int fsync_policy) {
  auto* s = new emqx_native::store::DurableStore(
      dir ? dir : "", static_cast<size_t>(segment_bytes), fsync_policy);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

void emqx_store_close(void* s) {
  delete static_cast<emqx_native::store::DurableStore*>(s);
}

// sid -> stable (restart-surviving) token; markers key on it.
uint64_t emqx_store_register(void* s, const char* sid) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Register(sid);
}

// sid -> token without creating one; 0 = never registered.
uint64_t emqx_store_lookup(void* s, const char* sid) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Lookup(sid);
}

// Single-message append (Python-plane persistence + test surface); the
// data plane appends whole batches through the attached host instead.
// `trace` != 0 persists a sampled trace id with the entry (flags bit4);
// `cid`/`cl` persist the publisher's clientid (flags bit5) so no-local
// and from_ attribution survive a restart. Returns the assigned guid
// (0 on a malformed call).
uint64_t emqx_store_append(void* s, uint64_t origin, uint8_t flags,
                           const uint64_t* toks, uint16_t ntok,
                           const char* topic, uint16_t tlen,
                           const char* payload, uint32_t plen,
                           uint64_t trace, const char* cid, uint8_t cl) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Append(
      origin, flags, toks, ntok, topic, tlen, payload, plen, trace,
      cid, cl);
}

// --- one-recovery-path surfaces (round 18) ---------------------------------

// Retire a REGISTER token (session-expiry GC): sid→token mapping,
// SESSION record, and leftover markers die with it.
int emqx_store_unregister(void* s, uint64_t token) {
  static_cast<emqx_native::store::DurableStore*>(s)->Unregister(token);
  return 0;
}

// Write (blen > 0) or delete (blen == 0) a session-catalog record.
int emqx_store_put_session(void* s, uint64_t token, const char* body,
                           uint32_t blen) {
  static_cast<emqx_native::store::DurableStore*>(s)->PutSession(
      token, body ? body : "", blen);
  return 0;
}

// All live session-catalog records as a malloc'd blob of
// [u64 token][u16 sidlen][sid][u32 blen][body] entries (free with
// emqx_buf_free). Returns the count — the boot walk.
long emqx_store_sessions(void* s, uint8_t** out, size_t* out_len) {
  return static_cast<emqx_native::store::DurableStore*>(s)->FetchSessions(
      out, out_len);
}

// Trunk replay-ring records, keyed by peer NODE NAME (the host's data
// plane journals through these via its attached store; this is the
// raw test/inspection surface).
int emqx_store_trunk_put(void* s, const char* name, uint64_t seq,
                         uint8_t tflags, const char* data, size_t len) {
  static_cast<emqx_native::store::DurableStore*>(s)->TrunkPut(
      name ? name : "", seq, tflags, data, len);
  return 0;
}

int emqx_store_trunk_ack(void* s, const char* name, uint64_t seq) {
  static_cast<emqx_native::store::DurableStore*>(s)->TrunkAck(
      name ? name : "", seq);
  return 0;
}

// The named ring in seq order as a malloc'd blob of
// [u64 seq][u8 tflags][u32 len][record bytes] entries. Returns count.
long emqx_store_trunk_fetch(void* s, const char* name, uint8_t** out,
                            size_t* out_len) {
  return static_cast<emqx_native::store::DurableStore*>(s)->TrunkFetch(
      name ? name : "", out, out_len);
}

long emqx_store_trunk_pending(void* s, const char* name) {
  return static_cast<emqx_native::store::DurableStore*>(s)->TrunkPending(
      name ? name : "");
}

// Consume (token, guid) markers; returns how many were live.
long emqx_store_consume(void* s, uint64_t token, const uint64_t* guids,
                        uint32_t n) {
  return static_cast<long>(
      static_cast<emqx_native::store::DurableStore*>(s)->Consume(
          token, guids, n));
}

// Pending messages for a token (guid order) as a malloc'd blob of
// [u64 guid][u64 origin][u64 ts_ms][u8 flags][u16 tlen][topic]
// [u32 plen][payload] entries (free with emqx_buf_free). Returns count.
long emqx_store_fetch(void* s, uint64_t token, uint8_t** out,
                      size_t* out_len) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Fetch(
      token, out, out_len);
}

long emqx_store_pending(void* s, uint64_t token) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Pending(token);
}

// Unlink all-consumed sealed segments + compact thin live tails;
// returns segments freed.
long emqx_store_gc(void* s) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Gc();
}

int emqx_store_sync(void* s) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Sync();
}

long emqx_store_stat(void* s, int slot) {
  return static_cast<emqx_native::store::DurableStore*>(s)->Stat(slot);
}

// Age-based compaction trigger (round 15): a sealed segment whose live
// tail has sat past `ms` gets re-homed regardless of the thin-tail
// byte bound, so one huge live message can no longer pin an otherwise
// dead segment forever. 0 disables the age trigger.
int emqx_store_set_compact_age(void* s, uint64_t ms) {
  static_cast<emqx_native::store::DurableStore*>(s)->SetCompactAge(ms);
  return 0;
}

// Direct store-injector surface (raw store tests; the product path
// arms through emqx_host_fault_arm, which forwards store sites here).
int emqx_store_fault_arm(void* s, int site, int mode, double n_or_prob,
                         uint64_t seed, uint64_t key) {
  if (site < 0 || site >= emqx_native::fault::kSiteCount) return -1;
  static_cast<emqx_native::store::DurableStore*>(s)->injector()->Arm(
      site, mode, n_or_prob, seed, key);
  return 0;
}

long emqx_store_fault_fired(void* s, int site) {
  return static_cast<long>(
      static_cast<emqx_native::store::DurableStore*>(s)
          ->injector()
          ->FiredCount(site));
}

// Attach a store to a host (BEFORE the poll thread starts). The host
// borrows the pointer: destroy the host first, then close the store.
int emqx_host_attach_store(void* h, void* s) {
  static_cast<emqx_native::Host*>(h)->AttachStore(
      static_cast<emqx_native::store::DurableStore*>(s));
  return 0;
}

// Install/remove a durable entry (the FOURTH match-table entry kind):
// publishes matching `filter` are persisted below the GIL for the
// session registered under `token` while the fast path proceeds.
int emqx_host_durable_add(void* h, uint64_t token, const char* filter,
                          uint8_t qos) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kDurableAdd;
  op.owner = token;
  op.str = filter;
  op.qos = qos;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

int emqx_host_durable_del(void* h, uint64_t token, const char* filter) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kDurableDel;
  op.owner = token;
  op.str = filter;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Poll-thread-only telemetry note (the replay_drain stage): -2 off
// thread, -1 bad stage.
int emqx_host_note_stage(void* h, int stage, uint64_t ns) {
  return static_cast<emqx_native::Host*>(h)->NoteStage(stage, ns);
}

int emqx_host_set_max_qos(void* h, int max_qos) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetMaxQos;
  op.qos = static_cast<uint8_t>(max_qos);
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

long emqx_host_stat(void* h, int slot) {
  return static_cast<emqx_native::Host*>(h)->Stat(slot);
}

long emqx_host_conn_idle_ms(void* h, uint64_t conn) {
  return static_cast<emqx_native::Host*>(h)->ConnIdleMs(conn);
}

void emqx_host_destroy(void* h) {
  delete static_cast<emqx_native::Host*>(h);
}

// -- conn-scale plane (round 16) -------------------------------------------

// Arm/replace a conn's native keepalive deadline on the shard's timer
// wheel. `deadline_ms` is the EFFECTIVE expiry (callers pass 1.5x the
// negotiated keepalive, the [MQTT-3.1.2-24] grace); 0 disarms. The
// Python housekeep loop stops scanning conns whose keepalive lives
// here — the O(N)-per-tick sweep becomes O(expired).
int emqx_host_set_keepalive(void* h, uint64_t conn, uint64_t deadline_ms) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetKeepalive;
  op.owner = conn;
  op.token = deadline_ms;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Conn-scale knobs: `enabled` gates hibernation, `park_after_ms` is
// the no-keepalive park horizon fallback (0 keeps the default; conns
// with a keepalive park after 2x their grace deadline),
// `accept_burst` caps accepts per poll cycle (0 = unlimited; the
// remainder defers to the kernel backlog), `mem_budget_bytes` sheds
// accepts once the conn-memory estimate crosses it (0 = unlimited,
// sheds are ledger-visible as accept_shed).
int emqx_host_set_park(void* h, int enabled, uint32_t park_after_ms,
                       uint32_t accept_burst, uint64_t mem_budget_bytes) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSetPark;
  op.flags = enabled ? 1 : 0;
  op.max_inflight = park_after_ms;
  op.owner = accept_burst;
  op.token = mem_budget_bytes;
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// Bench/test surface (raw hosts only): conjure `n` resident fast
// conns with no socket so the conn-scale structures run at 10^6 scale
// inside an fd-capped container; every `sub_every`-th conn installs a
// unique subscription under `topic_prefix`. Not a product path.
int emqx_host_synth_conns(void* h, uint32_t n, uint32_t keepalive_ms,
                          uint32_t sub_every, const char* topic_prefix) {
  emqx_native::Op op;
  op.kind = emqx_native::Op::kSynthConns;
  op.owner = n;
  op.token = keepalive_ms;
  op.max_inflight = sub_every;
  op.str = topic_prefix ? topic_prefix : "synth";
  return static_cast<emqx_native::Host*>(h)->Enqueue(std::move(op));
}

// out[4] = {resident conns, parked conns, parked bytes, armed timers}.
// POLL-THREAD ONLY (returns -2 off thread, the ConnIdleMs contract).
int emqx_host_conn_counts(void* h, uint64_t* out) {
  return static_cast<emqx_native::Host*>(h)->ConnCounts(out);
}

// Timer-wheel parity surface: run a seeded op script on a standalone
// wheel (caller's thread, no host) and return the op/fire journal the
// Python brute-force oracle replays (free with emqx_buf_free).
long emqx_wheel_selftest(uint64_t seed, uint32_t n_ops, uint8_t** out,
                         size_t* out_len) {
  std::vector<uint8_t> buf;
  emqx_native::wheel::SelfTestScript(seed, n_ops, &buf);
  uint8_t* mem = static_cast<uint8_t*>(malloc(buf.empty() ? 1 : buf.size()));
  if (!buf.empty()) memcpy(mem, buf.data(), buf.size());
  *out = mem;
  *out_len = buf.size();
  return static_cast<long>(buf.size());
}

// --- standalone sub table (differential testing vs router/trie.py) --------

void* emqx_subtable_create() { return new emqx_native::SubTable(); }

void emqx_subtable_destroy(void* t) {
  delete static_cast<emqx_native::SubTable*>(t);
}

void emqx_subtable_add(void* t, uint64_t owner, const char* filter,
                       uint8_t qos, uint8_t flags) {
  static_cast<emqx_native::SubTable*>(t)->Add(owner, filter, qos, flags);
}

int emqx_subtable_del(void* t, uint64_t owner, const char* filter) {
  return static_cast<emqx_native::SubTable*>(t)->Remove(owner, filter) ? 1 : 0;
}

// Fills out[] with the owners of every matching entry; returns the
// total match count (callers re-invoke with a larger buffer if needed).
long emqx_subtable_match(void* t, const char* topic, uint64_t* out,
                         long cap) {
  std::vector<const emqx_native::SubEntry*> hits;
  static_cast<emqx_native::SubTable*>(t)->Match(topic, &hits);
  long n = 0;
  for (const auto* e : hits) {
    if (n < cap) out[n] = e->owner;
    n++;
  }
  return n;
}

// Per-filter terminal lookup (the device lane's delivery primitive),
// exposed for differential testing against Match: the union of
// MatchFilter over a topic's oracle-matched filters must equal the
// walk's match set.
long emqx_subtable_match_filter(void* t, const char* filter, uint64_t* out,
                                long cap) {
  std::vector<const emqx_native::SubEntry*> hits;
  static_cast<emqx_native::SubTable*>(t)->MatchFilter(filter, &hits);
  long n = 0;
  for (const auto* e : hits) {
    if (n < cap) out[n] = e->owner;
    n++;
  }
  return n;
}

// Bulk match benchmark surface (the emqx_broker_bench.erl:run1/4 shape:
// many topics against a wildcard-dense table): matches every
// newline-separated topic in one call so per-call ctypes overhead stays
// off the measurement. Returns topics processed; *out_matches totals the
// entries matched across all topics.
long emqx_subtable_match_many(void* t, const char* topics, size_t len,
                              long* out_matches) {
  auto* table = static_cast<emqx_native::SubTable*>(t);
  std::vector<const emqx_native::SubEntry*> hits;
  long n_topics = 0, matches = 0;
  size_t start = 0;
  for (size_t i = 0; i <= len; i++) {
    if (i == len || topics[i] == '\n') {
      if (i > start) {
        hits.clear();
        table->Match(std::string_view(topics + start, i - start), &hits);
        matches += static_cast<long>(hits.size());
        n_topics++;
      }
      start = i + 1;
    }
  }
  *out_matches = matches;
  return n_topics;
}

void emqx_subtable_shared_add(void* t, uint64_t token, uint64_t owner,
                              const char* filter, uint8_t qos,
                              uint8_t flags) {
  static_cast<emqx_native::SubTable*>(t)->SharedAdd(token, owner, filter,
                                                    qos, flags);
}

int emqx_subtable_shared_del(void* t, uint64_t token, uint64_t owner,
                             const char* filter) {
  return static_cast<emqx_native::SubTable*>(t)->SharedRemove(
             token, owner, filter)
             ? 1
             : 0;
}

// One rotating pick per matched shared group; out pairs are
// (group token, picked owner). All-or-nothing: when every pickable
// group fits the buffer, all pairs are written, cursors advance, and
// the pair count is returned; on overflow NOTHING is written and NO
// cursor moves (a retry after a cursor-advancing partial call would
// double-rotate the already-written groups and starve fixed members),
// *out_total reports the size to re-invoke with. Empty groups are
// skipped — no pick exists for them.
long emqx_subtable_shared_pick(void* t, const char* topic, uint64_t* out,
                               long cap, long* out_total) {
  std::vector<const emqx_native::SubEntry*> hits;
  std::vector<emqx_native::SharedGroup*> groups;
  static_cast<emqx_native::SubTable*>(t)->Match(topic, &hits, &groups);
  long total = 0;
  for (auto* g : groups)
    if (!g->members.empty()) total++;
  if (out_total) *out_total = total;
  if (2 * total > cap) return 0;
  long n = 0;
  for (auto* g : groups) {
    if (g->members.empty()) continue;
    const auto& e = g->members[g->cursor % g->members.size()];
    g->cursor++;
    out[2 * n] = g->token;
    out[2 * n + 1] = e.owner;
    n++;
  }
  return n;
}

// Bulk dispatch benchmark surface: run rotating picks for every
// newline-separated topic in one call (per-call ctypes overhead would
// otherwise dominate the measurement). Returns topics processed;
// *out_picks counts the group picks made.
long emqx_subtable_shared_pick_many(void* t, const char* topics, size_t len,
                                    long* out_picks) {
  auto* table = static_cast<emqx_native::SubTable*>(t);
  std::vector<const emqx_native::SubEntry*> hits;
  std::vector<emqx_native::SharedGroup*> groups;
  long n_topics = 0, picks = 0;
  size_t start = 0;
  for (size_t i = 0; i <= len; i++) {
    if (i == len || topics[i] == '\n') {
      if (i > start) {
        hits.clear();
        groups.clear();
        table->Match(std::string_view(topics + start, i - start), &hits,
                     &groups);
        for (auto* g : groups) {
          if (!g->members.empty()) {
            g->cursor++;
            picks++;
          }
        }
        n_topics++;
      }
      start = i + 1;
    }
  }
  *out_picks = picks;
  return n_topics;
}

// --- standalone framer (for parity tests + non-socket embedding) ----------

void* emqx_framer_create(uint32_t max_size) {
  return new emqx_native::Framer(max_size);
}

// Feeds a chunk; returns a malloc'd buffer of concatenated
// [u32 len][frame bytes] records in *out/*out_len (caller frees with
// emqx_buf_free). Returns the FrameStatus as int.
int emqx_framer_feed(void* f, const uint8_t* data, size_t len, uint8_t** out,
                     size_t* out_len) {
  std::vector<std::string> frames;
  auto st = static_cast<emqx_native::Framer*>(f)->Feed(data, len, &frames);
  size_t total = 0;
  for (auto& fr : frames) total += 4 + fr.size();
  uint8_t* buf = static_cast<uint8_t*>(malloc(total ? total : 1));
  size_t pos = 0;
  for (auto& fr : frames) {
    uint32_t n = static_cast<uint32_t>(fr.size());
    memcpy(buf + pos, &n, 4);
    pos += 4;
    memcpy(buf + pos, fr.data(), fr.size());
    pos += fr.size();
  }
  *out = buf;
  *out_len = total;
  return static_cast<int>(st);
}

void emqx_framer_destroy(void* f) {
  delete static_cast<emqx_native::Framer*>(f);
}

void emqx_buf_free(void* p) { free(p); }

}  // extern "C"
