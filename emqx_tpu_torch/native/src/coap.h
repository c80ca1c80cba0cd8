// CoAP 1.0 (RFC 7252) for the native plane — the C++ twin of
// gateway/coap.py's Frame codec (which stays the asyncio oracle and
// the conformance reference; tests/test_native_coap.py drives BOTH
// planes through one shared vector set so the codecs cannot drift
// apart). Shared by host.cc (gateway side: datagram decode, CoAP<->
// MQTT translation, observe-notify encode) and loadgen.cc (client
// side: the CoAP publisher/observer fleet for the coap bench), so the
// two ends are framed by the same functions and a bug cannot hide
// behind a matching bug — the sn.h discipline applied to RFC 7252.
//
// Wire shape (RFC 7252 §3): ONE datagram carries ONE message —
//   [ver:2 type:2 tkl:4][code u8][mid u16 BE][token 0-8B]
//   [options: (delta:4 len:4)[ext-delta][ext-len][value]...]
//   [0xFF payload]
// Parse/serialize behaviors mirror the oracle EXACTLY, including its
// edge handling: options whose declared length overruns the datagram
// yield a clamped (short) value; a 13/14 length/delta extension byte
// past the end voids the message (the oracle raises mid-parse and the
// UDP listener drops the datagram); serialization emits options in
// stable number order with minimal 13/269 extensions.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace emqx_native {
namespace coap {

// message types (§3)
constexpr uint8_t kCon = 0;
constexpr uint8_t kNon = 1;
constexpr uint8_t kAck = 2;
constexpr uint8_t kRst = 3;

// method / response codes (class.detail -> byte), the oracle's set
constexpr uint8_t kEmpty = 0x00;
constexpr uint8_t kGet = 0x01;
constexpr uint8_t kPost = 0x02;
constexpr uint8_t kPut = 0x03;
constexpr uint8_t kDelete = 0x04;
constexpr uint8_t kCreated = 0x41;   // 2.01
constexpr uint8_t kDeleted = 0x42;   // 2.02
constexpr uint8_t kValid = 0x43;     // 2.03
constexpr uint8_t kChanged = 0x44;   // 2.04
constexpr uint8_t kContent = 0x45;   // 2.05
constexpr uint8_t kBadRequest = 0x80;    // 4.00
constexpr uint8_t kUnauthorized = 0x81;  // 4.01
constexpr uint8_t kNotFound = 0x84;      // 4.04
constexpr uint8_t kNotAllowed = 0x85;    // 4.05

// option numbers (§5.10 + RFC 7959/7641)
constexpr uint16_t kOptEtag = 4;
constexpr uint16_t kOptObserve = 6;
constexpr uint16_t kOptLocationPath = 8;
constexpr uint16_t kOptUriPath = 11;
constexpr uint16_t kOptContentFormat = 12;
constexpr uint16_t kOptUriQuery = 15;
constexpr uint16_t kOptBlock2 = 23;
constexpr uint16_t kOptBlock1 = 27;
constexpr uint16_t kOptSize2 = 28;
constexpr uint16_t kOptSize1 = 60;

// transport-machine constants (§4.8, the oracle's TransportManager):
// CON retransmit starts at ACK_TIMEOUT x ACK_RANDOM_FACTOR = 3s and
// doubles per try; MAX_RETRANSMIT tries then give-up. The dedup window
// is EXCHANGE_LIFETIME for CON requests, NON_LIFETIME for NONs.
constexpr uint64_t kAckTimeoutMs = 3000;  // 2.0s x 1.5 (oracle values)
constexpr uint8_t kMaxRetransmit = 4;
constexpr uint64_t kExchangeLifetimeMs = 247000;
constexpr uint64_t kNonLifetimeMs = 145000;

// The host frames outbound CoAP messages in its per-conn outbuf with a
// u16 length prefix (CoAP messages are not self-delimiting; the
// datagram boundary is the delimiter, re-established at flush), so no
// message may exceed 65535 wire bytes — also comfortably under the
// 65507-byte UDP payload ceiling. Deliveries that cannot fit are
// DROPPED at the translation seam (the sn.h oversize discipline):
// notify overhead = 4 (header) + 8 (token) + 4 (observe option) + 1
// (payload marker).
constexpr size_t kMaxMessage = 0xFFFF;
constexpr size_t kMaxPayload = kMaxMessage - 17;

struct CoapMsg {
  uint8_t type = kCon;
  uint8_t code = kEmpty;
  uint16_t mid = 0;
  std::string token;                                   // 0-8 bytes
  std::vector<std::pair<uint32_t, std::string>> options;
  std::string payload;

  const std::string* Opt(uint32_t number) const {
    for (const auto& [n, v] : options)
      if (n == number) return &v;
    return nullptr;
  }
};

// Decode one datagram. Mirrors the oracle's Frame.parse exactly:
// false = the datagram yields no message (short header, version != 1,
// tkl > 8, or a truncated 13/14 extension byte — where the oracle
// raises and its UDP listener drops the datagram).
inline bool Parse(const uint8_t* d, size_t len, CoapMsg* m) {
  if (len < 4) return false;
  uint8_t b0 = d[0];
  if ((b0 >> 6) != 1) return false;
  uint8_t tkl = b0 & 0xF;
  if (tkl > 8) return false;
  m->type = (b0 >> 4) & 0x3;
  m->code = d[1];
  m->mid = static_cast<uint16_t>((d[2] << 8) | d[3]);
  size_t off = 4;
  // a short token clamps like the oracle's slice (off stays in range)
  size_t tk = std::min<size_t>(tkl, len - off);
  m->token.assign(reinterpret_cast<const char*>(d + off), tk);
  off += tkl;
  m->options.clear();
  m->payload.clear();
  if (off > len) return true;  // token overran: no options, no payload
  uint32_t number = 0;
  while (off < len && d[off] != 0xFF) {
    uint32_t delta = d[off] >> 4;
    uint32_t ln = d[off] & 0xF;
    off += 1;
    // 13/14 extensions; a missing extension byte voids the message
    // (struct.unpack_from raises in the oracle)
    if (delta == 13) {
      if (off >= len) return false;
      delta = d[off] + 13;
      off += 1;
    } else if (delta == 14) {
      if (off + 2 > len) return false;
      delta = static_cast<uint32_t>((d[off] << 8) | d[off + 1]) + 269;
      off += 2;
    }
    if (ln == 13) {
      if (off >= len) return false;
      ln = d[off] + 13;
      off += 1;
    } else if (ln == 14) {
      if (off + 2 > len) return false;
      ln = static_cast<uint32_t>((d[off] << 8) | d[off + 1]) + 269;
      off += 2;
    }
    number += delta;
    // a value overrunning the datagram yields a clamped short value
    // and ends the scan (Python slice semantics: off jumps past len)
    size_t avail = off < len ? std::min<size_t>(ln, len - off) : 0;
    m->options.emplace_back(
        number,
        std::string(reinterpret_cast<const char*>(d + off), avail));
    off += ln;
  }
  if (off < len) {  // stopped at the 0xFF payload marker
    m->payload.assign(reinterpret_cast<const char*>(d + off + 1),
                      len - off - 1);
  }
  return true;
}

inline uint8_t ExtNibble(uint32_t value) {
  if (value < 13) return static_cast<uint8_t>(value);
  return value < 269 ? 13 : 14;
}

inline void PutExtBytes(std::string* out, uint32_t value) {
  if (value < 13) return;
  if (value < 269) {
    out->push_back(static_cast<char>(value - 13));
  } else {
    uint32_t v = value - 269;
    out->push_back(static_cast<char>(v >> 8));
    out->push_back(static_cast<char>(v & 0xFF));
  }
}

// Serialize one message; byte-identical to the oracle's
// Frame.serialize (stable sort by option number, minimal extensions,
// payload marker only when the payload is non-empty).
inline void Serialize(const CoapMsg& m, std::string* out) {
  out->push_back(static_cast<char>(
      (1 << 6) | (m.type << 4) | (m.token.size() & 0xF)));
  out->push_back(static_cast<char>(m.code));
  out->push_back(static_cast<char>(m.mid >> 8));
  out->push_back(static_cast<char>(m.mid & 0xFF));
  *out += m.token;
  // the oracle sorts with Python's STABLE sort; repeated numbers
  // (Uri-Path segments) must keep their relative order
  std::vector<const std::pair<uint32_t, std::string>*> opts;
  opts.reserve(m.options.size());
  for (const auto& o : m.options) opts.push_back(&o);
  std::stable_sort(opts.begin(), opts.end(),
                   [](const auto* a, const auto* b) {
                     return a->first < b->first;
                   });
  uint32_t prev = 0;
  for (const auto* o : opts) {
    uint8_t dn = ExtNibble(o->first - prev);
    uint8_t ln = ExtNibble(static_cast<uint32_t>(o->second.size()));
    out->push_back(static_cast<char>((dn << 4) | ln));
    PutExtBytes(out, o->first - prev);
    PutExtBytes(out, static_cast<uint32_t>(o->second.size()));
    *out += o->second;
    prev = o->first;
  }
  if (!m.payload.empty()) {
    out->push_back(static_cast<char>(0xFF));
    *out += m.payload;
  }
}

// Every Uri-Path segment joined with '/', the oracle's
// "/".join(path[1:]) shape — the caller strips the leading segment.
inline void JoinPath(const CoapMsg& m, std::vector<std::string_view>* segs) {
  segs->clear();
  for (const auto& [n, v] : m.options)
    if (n == kOptUriPath) segs->push_back(v);
}

// Uri-Query "k=v" lookup. LAST duplicate wins — the oracle's
// queries() builds a dict in option order, so later values overwrite
// earlier ones; a first-match here would resolve a DIFFERENT identity
// than the same datagram punted to the oracle (review finding).
inline bool Query(const CoapMsg& m, std::string_view key,
                  std::string_view* val) {
  bool found = false;
  for (const auto& [n, v] : m.options) {
    if (n != kOptUriQuery) continue;
    size_t eq = v.find('=');
    std::string_view k = eq == std::string::npos
                             ? std::string_view(v)
                             : std::string_view(v).substr(0, eq);
    if (k != key) continue;
    *val = eq == std::string::npos
               ? std::string_view()
               : std::string_view(v).substr(eq + 1);
    found = true;
  }
  return found;
}

// The Observe option decoded as the oracle's observe(): -1 = absent,
// 0 = present-but-empty (register), else the big-endian uint value.
inline long ObserveOf(const CoapMsg& m) {
  const std::string* v = m.Opt(kOptObserve);
  if (v == nullptr) return -1;
  long out = 0;
  for (unsigned char c : *v) out = (out << 8) | c;
  return out;
}

// Build one observe notification (CON for qos>=1 subscriptions, NON
// otherwise): 2.05 Content carrying the subscribe token, the
// observation's rolling 24-bit sequence (ALWAYS 3 bytes — oracle
// to_bytes(3) parity), and the payload.
inline void BuildNotify(std::string* out, uint8_t type, uint16_t mid,
                        const std::string& token, uint32_t seq,
                        std::string_view payload) {
  CoapMsg n;
  n.type = type;
  n.code = kContent;
  n.mid = mid;
  n.token = token;
  std::string sv;
  sv.push_back(static_cast<char>((seq >> 16) & 0xFF));
  sv.push_back(static_cast<char>((seq >> 8) & 0xFF));
  sv.push_back(static_cast<char>(seq & 0xFF));
  n.options.emplace_back(kOptObserve, std::move(sv));
  n.payload.assign(payload.data(), payload.size());
  Serialize(n, out);
}

// Plain-topic-vs-MQTT-filter match ('+'/'#' semantics, emqx_topic.erl
// rules) for resolving which observer a delivery notifies — the
// oracle's core.topic.match over the per-endpoint observer map.
inline bool TopicMatch(std::string_view topic, std::string_view filter) {
  size_t ti = 0, fi = 0;
  for (;;) {
    size_t te = topic.find('/', ti);
    size_t fe = filter.find('/', fi);
    std::string_view tw = topic.substr(
        ti, te == std::string_view::npos ? topic.size() - ti : te - ti);
    std::string_view fw = filter.substr(
        fi, fe == std::string_view::npos ? filter.size() - fi : fe - fi);
    if (fw == "#") return true;
    if (fw != "+" && fw != tw) return false;
    bool tlast = te == std::string_view::npos;
    bool flast = fe == std::string_view::npos;
    if (tlast && flast) return true;
    // "a/#" also matches "a": one trailing '#' level may remain
    if (tlast)
      return !flast && filter.substr(fe + 1) == "#";
    if (flast) return false;
    ti = te + 1;
    fi = fe + 1;
  }
}

}  // namespace coap
}  // namespace emqx_native
