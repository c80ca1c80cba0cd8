// Native cluster trunk (round 9): the inter-node message plane.
//
// Two native hosts talk to each other over plain TCP "trunk" links so a
// cross-node publish never touches either node's Python plane for QoS0
// (and QoS1 rides with a bounded replay ring).  This is the gen_rpc
// forwarding lane of the reference (emqx_broker.erl:302-324 casting
// `dispatch` on a per-topic-ordered client pool, emqx_rpc.erl:74-84)
// moved below the GIL, the way rounds 6-8 moved acks, WS and telemetry
// there.
//
// Wire format (symmetric; in practice each direction of forwarding uses
// its own dialed link — A dials B to forward A->B):
//
//   [u32 len][u8 type][body]          little-endian, len covers type+body
//
//   type 2 = BATCH  body = [u64 seq][u32 n] + n entries, one entry per
//                   forwarded publish in the kind-6 pre-parse layout:
//                   [u64 origin][u8 flags][u16 tlen][topic]
//                   + (flags bit0 ? [u32 plen][payload] : payload
//                   identical to the PREVIOUS entry in this batch).
//                   flags bits 1-2 = qos, bit 3 = publisher DUP.
//                   One batch per poll cycle per peer (the EmitTap /
//                   FlushAcks batching discipline applied to the wire);
//                   TCP framing + the receiver's sequential decode give
//                   per-topic order for free.
//   type 3 = ACK    body = [u64 seq] — the receiver acks each batch
//                   AFTER local fan-out. Acks retire EXACTLY the ring
//                   entry they name (round 15): a cumulative trim let
//                   an up-but-black link (a TCP partition, not a
//                   close) lose acked qos1 silently — batches written
//                   into the void were retired by the first
//                   post-heal ack for a LATER seq. Now an ack for a
//                   seq ahead of the ring front is evidence the link
//                   skipped data and kills it ("ack_gap"), and a link
//                   whose front entry goes unacked past the ack
//                   timeout dies too ("ack_timeout") — both deaths
//                   redial + replay the ring, so loss becomes dups.
//                   The sender also uses the ack for the
//                   enqueue->peer-ack RTT stage.
//
// Reliability ladder (host.cc wires the seams):
//   - QoS0: fire-and-forget; batches are not retained once written.
//   - QoS1: every flushed batch containing elevated-qos entries keeps a
//     qos1-only copy in a bounded per-peer unacked ring; on reconnect
//     the ring replays before new traffic (at-least-once across a link
//     death — duplicates allowed, loss not).  A full ring degrades NEW
//     qos1 publishes to the Python forward lane.
//   - QoS2: never trunks — exactly-once spans two nodes' session state
//     and stays on the Python lane (the remote entry punts).
#pragma once

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>

namespace emqx_native {
namespace trunk {

constexpr uint8_t kRecBatch = 2;
constexpr uint8_t kRecAck = 3;
// HELLO (round 13, wire version negotiation): body = [u8 version].
// The dialer sends its version on connect BEFORE any batch; the
// receiver answers with its own. Either side missing the exchange
// (an old peer ignores unknown record types and sends none) leaves
// the negotiated version at 0, and the dialer then emits v0 entries —
// trace ids are STRIPPED (losslessly: topic/payload untouched), never
// put on a wire the peer cannot parse.
constexpr uint8_t kRecHello = 4;
// Version 1 adds the per-entry trace-id extension: entry flags bit 4
// set means a [u64 trace_id] follows the topic bytes (before the
// payload section). Both sides must have negotiated >= 1 to use it.
constexpr uint8_t kWireVersion = 1;

// PROTOCOL-level size bounds, deliberately independent of either
// node's max_packet_size: a record sized by the sender's config but
// validated against the receiver's would poison mismatched clusters
// (the oversized replay record re-killing the link on every redial).
// Publishes whose entry exceeds kMaxEntryBytes never trunk — they
// degrade to the Python forward lane like any other punt.
constexpr size_t kMaxEntryBytes = 128 * 1024;
constexpr size_t kMaxRecordBytes = 512 * 1024;

// Frame one trunk record onto a socket buffer.
inline void AppendRecord(std::string* out, uint8_t type, const char* body,
                         size_t blen) {
  uint32_t len = static_cast<uint32_t>(1 + blen);
  char hdr[5];
  memcpy(hdr, &len, 4);
  hdr[4] = static_cast<char>(type);
  out->append(hdr, 5);
  out->append(body, blen);
}

// Append one pre-parse entry ([origin][flags][topic][trace?][payload?])
// to a batch body under construction.  ``inline_payload=false`` emits
// the dedup form (payload identical to the previous entry in this
// batch). ``trace != 0`` sets flags bit 4 and appends the [u64
// trace_id] after the topic bytes (the wire-v1 tracing extension —
// callers pass 0 on links whose negotiated version is below 1).
inline void AppendEntry(std::string* out, uint64_t origin, uint8_t qos,
                        bool dup, bool inline_payload,
                        std::string_view topic, std::string_view payload,
                        uint64_t trace = 0) {
  char hdr[11];
  memcpy(hdr, &origin, 8);
  hdr[8] = static_cast<char>((inline_payload ? 1 : 0) | (qos << 1) |
                             (dup ? 8 : 0) | (trace ? 0x10 : 0));
  uint16_t tl = static_cast<uint16_t>(topic.size());
  memcpy(hdr + 9, &tl, 2);
  out->append(hdr, 11);
  out->append(topic.data(), topic.size());
  if (trace) out->append(reinterpret_cast<const char*>(&trace), 8);
  if (inline_payload) {
    uint32_t pl = static_cast<uint32_t>(payload.size());
    out->append(reinterpret_cast<const char*>(&pl), 4);
    out->append(payload.data(), payload.size());
  }
}

// Re-encode one framed qos1 replay record at wire v0: clear each
// entry's trace flag (bit 4) and drop its [u64 trace_id] — the
// lossless strip (topic/payload untouched) TrunkEnqueue applies to
// LIVE entries on v0 links, applied at REPLAY time to a shadow built
// on a v1 link whose reconnect negotiated lower. Replay-shadow
// entries are always payload-inline. Any parse inconsistency returns
// the input unchanged (the caller built this record; a malformed one
// is an upstream bug, and v0 peers reject oversized/garbled records
// at the link layer anyway).
inline std::string StripTraceRecord(const std::string& rec) {
  if (rec.size() < 5 + 12 || static_cast<uint8_t>(rec[4]) != kRecBatch)
    return rec;
  const char* body = rec.data() + 5;
  size_t blen = rec.size() - 5;
  uint32_t n = 0;
  memcpy(&n, body + 8, 4);
  std::string out_body;
  out_body.reserve(blen);
  out_body.append(body, 12);  // [u64 seq][u32 n] unchanged
  size_t pos = 12;
  for (uint32_t i = 0; i < n; i++) {
    if (pos + 11 > blen) return rec;
    char hdr[11];
    memcpy(hdr, body + pos, 11);
    uint8_t flags = static_cast<uint8_t>(hdr[8]);
    uint16_t tlen = 0;
    memcpy(&tlen, hdr + 9, 2);
    hdr[8] = static_cast<char>(flags & ~0x10);
    pos += 11;
    if (pos + tlen > blen) return rec;
    out_body.append(hdr, 11);
    out_body.append(body + pos, tlen);
    pos += tlen;
    if (flags & 0x10) {
      if (pos + 8 > blen) return rec;
      pos += 8;  // the dropped trace id
    }
    if (flags & 1) {
      if (pos + 4 > blen) return rec;
      uint32_t pl = 0;
      memcpy(&pl, body + pos, 4);
      if (pos + 4 + pl > blen) return rec;
      out_body.append(body + pos, 4 + pl);
      pos += 4 + pl;
    }
  }
  std::string out;
  AppendRecord(&out, kRecBatch, out_body.data(), out_body.size());
  return out;
}

// One trunk TCP socket (dialer or accepted), poll-thread-owned.
struct Sock {
  int fd = -1;
  bool dialer = false;      // we dialed it (it carries OUR batches out)
  bool connecting = false;  // nonblocking connect still in flight
  uint64_t peer_id = 0;     // dialer only: which peer this link serves
  std::string inbuf;        // partial trunk records
  std::string outbuf;       // unsent bytes (partial-write backlog)
  size_t outpos = 0;
  // highest BATCH seq applied on this sock (receiver side): seqs must
  // strictly ascend per link — a regressed/duplicate seq is a poisoned
  // stream and kills the sock ("seq_regress", round 15). Gaps are
  // legal (replay skips acked/empty batches; down-window seals burn
  // seqs), so only monotonicity is enforced here; loss detection is
  // the SENDER's ack_gap/ack_timeout job.
  uint64_t last_seq = 0;
};

// A flushed-but-unacked batch (the QoS1 replay ring entry).
struct Unacked {
  uint64_t seq = 0;
  uint64_t t0_ns = 0;       // flush stamp (0 = telemetry off)
  // coarse flush/replay stamp for the silent-link watchdog (round 15):
  // refreshed at replay so a ring carried across a down window does
  // not trip the timeout the instant the link comes back up
  uint64_t flush_ms = 0;
  // pre-framed qos1-only wire record for this batch ("" = batch held
  // no elevated-qos entries; nothing to replay, ring entry exists only
  // for the RTT stage). Built at the HIGHEST wire version the entries
  // carry (sampled trace ids persist in the shadow, round 14): replay
  // emits it verbatim on a >= v1 link and re-encodes it at v0 —
  // StripTraceRecord — when the reconnected peer negotiated lower.
  std::string q1_record;
  bool has_trace = false;   // any entry carries the bit-4 extension
};

// Per-peer trunk state: link identity + the batch under construction.
struct Peer {
  uint64_t sock_tag = 0;    // live dialer sock tag (0 = no link)
  bool up = false;          // connected; remote entries forward here
  // negotiated wire version for the CURRENT link (reset to 0 on every
  // link death; re-negotiated by the HELLO exchange per connection)
  uint8_t wire_ver = 0;
  std::string addr;         // redial target (Python drives redial)
  uint16_t port = 0;
  // stable store key for the persisted replay ring (round 18): the
  // peer's NODE NAME, set by trunk_ident — peer ids renumber across
  // restarts, so the ring must key on something that survives them.
  // Empty = no ident yet; the host falls back to "peer:<id>" (raw
  // single-process tests).
  std::string store_name;
  // the persisted ring was merged into `unacked` (or this peer started
  // journaling fresh) — guards against a later load duplicating entries
  bool ring_loaded = false;
  // HELLO sent on the live link, answer (or the bounded grace
  // deadline, for old peers that never answer) still pending: the
  // qos1 replay + the UP event wait for the negotiated version, so a
  // replayed batch can keep its trace annotation on v1 links
  bool hello_pending = false;
  uint64_t hello_deadline_ms = 0;
  std::string batch;        // BATCH entries accumulated this cycle
  uint32_t batch_n = 0;
  uint32_t q0_n = 0;        // qos0 entries in `batch` (shed accounting)
  std::string q1_batch;     // qos1-only copies (full payloads, no dedup)
  uint32_t q1_n = 0;
  bool q1_has_trace = false;  // q1_batch holds >= 1 bit-4 trace entry
  std::string prev_payload; // payload-dedup reference (batch-scoped)
  bool have_prev = false;
  uint64_t next_seq = 1;
  std::deque<Unacked> unacked;
  // ack-watchdog wheel handle (round 16): the per-poll TrunkAckScan
  // sweep moved onto the host's timer wheel — armed when the ring
  // front gains its watchdog reference (first unacked entry, replay
  // re-stamp), re-armed from the fire against the live front
  // @gen-handle
  uint64_t tm_ack = 0;
};

}  // namespace trunk
}  // namespace emqx_native
