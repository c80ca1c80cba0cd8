// MQTT-SN 1.2 for the native plane — the C++ twin of
// gateway/mqttsn.py (which stays the asyncio oracle and the
// conformance reference; tests/test_native_sn.py drives BOTH planes
// through one shared vector set so the codecs cannot drift apart).
// Shared by host.cc (gateway side: datagram decode, SN<->MQTT
// translation, delivery encode) and loadgen.cc (client side: the SN
// publisher/subscriber fleet for the mixed-protocol bench), so the two
// ends are framed by the same functions and a bug cannot hide behind a
// matching bug — the ws.h discipline applied to the UDP gateway.
//
// Wire shape (MQTT-SN 1.2 §5.2): one datagram carries one or more
// messages, each [len u8][type u8][body] — or, for len >= 256,
// [0x01][len u16 BE][type u8][body] where len covers the 3-byte
// prefix. All multi-byte integers are big-endian.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

namespace emqx_native {
namespace sn {

// message types (§5.2.1)
constexpr uint8_t kAdvertise = 0x00;
constexpr uint8_t kSearchGw = 0x01;
constexpr uint8_t kGwInfo = 0x02;
constexpr uint8_t kConnect = 0x04;
constexpr uint8_t kConnack = 0x05;
constexpr uint8_t kWillTopicReq = 0x06;
constexpr uint8_t kWillMsgReq = 0x08;
constexpr uint8_t kRegister = 0x0A;
constexpr uint8_t kRegack = 0x0B;
constexpr uint8_t kPublish = 0x0C;
constexpr uint8_t kPuback = 0x0D;
constexpr uint8_t kPubcomp = 0x0E;
constexpr uint8_t kPubrec = 0x0F;
constexpr uint8_t kPubrel = 0x10;
constexpr uint8_t kSubscribe = 0x12;
constexpr uint8_t kSuback = 0x13;
constexpr uint8_t kUnsubscribe = 0x14;
constexpr uint8_t kUnsuback = 0x15;
constexpr uint8_t kPingReq = 0x16;
constexpr uint8_t kPingResp = 0x17;
constexpr uint8_t kDisconnect = 0x18;

// return codes (§5.3.10)
constexpr uint8_t kRcAccepted = 0;
constexpr uint8_t kRcCongestion = 1;
constexpr uint8_t kRcInvalidTopicId = 2;
constexpr uint8_t kRcNotSupported = 3;

// flag bits (§5.3.4)
constexpr uint8_t kFDup = 0x80;
constexpr uint8_t kFRetain = 0x10;
constexpr uint8_t kFWill = 0x08;
constexpr uint8_t kFClean = 0x04;

// topic-id kinds (flags bits 0-1)
constexpr uint8_t kTidNormal = 0;
constexpr uint8_t kTidPredef = 1;
constexpr uint8_t kTidShort = 2;

// Packed-datagram cap: both ends aggregate consecutive small messages
// to the same peer into one datagram up to this size (§5.2 allows any
// number of messages per datagram; one MTU keeps aggregates fragment-
// free on real networks). A single message larger than the cap still
// goes out alone — the cap bounds aggregation, not message size.
constexpr size_t kPackDatagram = 1400;

// The long-form length prefix is a u16, so no SN message may exceed
// 65535 wire bytes (§5.2.1). Deliveries that cannot fit are DROPPED at
// the translation seam — silently truncating the length field would
// corrupt the egress stream (the peer's carve would misparse payload
// bytes as message boundaries). PUBLISH wire overhead = 2 (long-form
// length) + 7 (len byte + type + flags + tid + mid); REGISTER = 2 + 6
// plus the topic name.
constexpr size_t kMaxPayload = 0xFFFF - 9;
constexpr size_t kMaxTopic = 0xFFFF - 8;

// flags qos field: 0b11 encodes the spec's QoS -1 (§6.8)
inline int QosOf(uint8_t flags) {
  int q = (flags >> 5) & 3;
  return q == 3 ? -1 : q;
}

inline uint8_t QosFlags(int qos) {
  return qos < 0 ? 0x60 : static_cast<uint8_t>((qos & 3) << 5);
}

struct SnMsg {
  uint8_t type = 0;
  uint8_t flags = 0;
  uint16_t topic_id = 0;
  uint16_t msg_id = 0;
  uint16_t duration = 0;
  uint8_t rc = 0;
  std::string topic_name;
  std::string clientid;
  std::string data;
};

inline uint16_t Be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

// Decode one message body (type byte + fields). Field offsets mirror
// gateway/mqttsn.py _parse_body exactly; where the Python oracle would
// raise on a truncated body (struct.unpack_from) and the listener drops
// the datagram, this returns false and the caller skips the message —
// the same observable outcome.
inline bool ParseBody(const uint8_t* b, size_t n, SnMsg* m) {
  if (n == 0) return false;
  m->type = b[0];
  uint8_t t = m->type;
  if (t == kConnect) {
    if (n < 5) return false;
    m->flags = b[1];
    m->duration = Be16(b + 3);
    m->clientid.assign(reinterpret_cast<const char*>(b + 5), n - 5);
  } else if (t == kConnack || t == kWillTopicReq || t == kWillMsgReq ||
             t == kPingResp) {
    if (n > 1) m->rc = b[1];
  } else if (t == kRegister) {
    if (n < 5) return false;
    m->topic_id = Be16(b + 1);
    m->msg_id = Be16(b + 3);
    m->topic_name.assign(reinterpret_cast<const char*>(b + 5), n - 5);
  } else if (t == kRegack) {
    if (n < 6) return false;
    m->topic_id = Be16(b + 1);
    m->msg_id = Be16(b + 3);
    m->rc = b[5];
  } else if (t == kPublish) {
    if (n < 6) return false;
    m->flags = b[1];
    m->topic_id = Be16(b + 2);
    m->msg_id = Be16(b + 4);
    m->data.assign(reinterpret_cast<const char*>(b + 6), n - 6);
  } else if (t == kPuback) {
    if (n < 6) return false;
    m->topic_id = Be16(b + 1);
    m->msg_id = Be16(b + 3);
    m->rc = b[5];
  } else if (t == kPubrec || t == kPubrel || t == kPubcomp ||
             t == kUnsuback) {
    if (n < 3) return false;
    m->msg_id = Be16(b + 1);
  } else if (t == kSubscribe || t == kUnsubscribe) {
    if (n < 4) return false;
    m->flags = b[1];
    m->msg_id = Be16(b + 2);
    if ((m->flags & 0x3) == kTidPredef) {
      if (n < 6) return false;
      m->topic_id = Be16(b + 4);
    } else {
      m->topic_name.assign(reinterpret_cast<const char*>(b + 4), n - 4);
    }
  } else if (t == kSuback) {
    if (n < 7) return false;
    m->flags = b[1];
    m->topic_id = Be16(b + 2);
    m->msg_id = Be16(b + 4);
    m->rc = b[6];
  } else if (t == kPingReq) {
    m->clientid.assign(reinterpret_cast<const char*>(b + 1), n - 1);
  } else if (t == kDisconnect) {
    if (n >= 3) m->duration = Be16(b + 1);
  } else if (t == kSearchGw) {
    if (n > 1) m->rc = b[1];  // radius
  }
  return true;
}

// Decode every message in one datagram (the oracle's Frame.parse loop:
// malformed length prefixes terminate the scan instead of spinning).
// A body too short for its type voids the WHOLE datagram — the oracle
// raises mid-parse there and the UDP listener drops the datagram, so
// none of its messages (even earlier valid ones) are ever applied.
inline void ParseAll(const uint8_t* d, size_t len, std::vector<SnMsg>* out) {
  size_t base = out->size();
  size_t pos = 0;
  while (pos < len) {
    size_t body_at, msg_len;
    if (d[pos] == 0x01) {
      if (len - pos < 3) break;
      msg_len = Be16(d + pos + 1);
      if (msg_len < 4) break;  // length covers the 3-byte prefix + type
      body_at = pos + 3;
    } else {
      msg_len = d[pos];
      if (msg_len < 2) break;  // 0/1 would not consume any bytes
      body_at = pos + 1;
    }
    if (pos + msg_len > len) break;  // truncated: refuse, don't spin
    SnMsg m;
    if (!ParseBody(d + body_at, pos + msg_len - body_at, &m)) {
      out->resize(base);  // datagram voided, oracle parity
      return;
    }
    out->push_back(std::move(m));
    pos += msg_len;
  }
}

inline void PutBe16(std::string* s, uint16_t v) {
  s->push_back(static_cast<char>(v >> 8));
  s->push_back(static_cast<char>(v & 0xFF));
}

// Prepend the length framing to a finished body (type byte included).
inline void Frame(std::string* out, const std::string& body) {
  size_t ln = body.size() + 1;
  if (ln < 256) {
    out->push_back(static_cast<char>(ln));
  } else {
    out->push_back(0x01);
    PutBe16(out, static_cast<uint16_t>(ln + 2));
  }
  *out += body;
}

// Serialize one message; field layouts mirror the oracle's
// Frame.serialize (including the parity-audit fixes: PINGREQ carries
// the clientid, DISCONNECT carries a nonzero sleep duration).
inline void Serialize(const SnMsg& m, std::string* out) {
  std::string body;
  uint8_t t = m.type;
  body.push_back(static_cast<char>(t));
  if (t == kConnack) {
    body.push_back(static_cast<char>(m.rc));
  } else if (t == kConnect) {
    body.push_back(static_cast<char>(m.flags));
    body.push_back(0x01);  // protocol id
    PutBe16(&body, m.duration);
    body += m.clientid;
  } else if (t == kRegister) {
    PutBe16(&body, m.topic_id);
    PutBe16(&body, m.msg_id);
    body += m.topic_name;
  } else if (t == kRegack) {
    PutBe16(&body, m.topic_id);
    PutBe16(&body, m.msg_id);
    body.push_back(static_cast<char>(m.rc));
  } else if (t == kPublish) {
    body.push_back(static_cast<char>(m.flags));
    PutBe16(&body, m.topic_id);
    PutBe16(&body, m.msg_id);
    body += m.data;
  } else if (t == kPuback) {
    PutBe16(&body, m.topic_id);
    PutBe16(&body, m.msg_id);
    body.push_back(static_cast<char>(m.rc));
  } else if (t == kPubrec || t == kPubrel || t == kPubcomp ||
             t == kUnsuback) {
    PutBe16(&body, m.msg_id);
  } else if (t == kSubscribe || t == kUnsubscribe) {
    body.push_back(static_cast<char>(m.flags));
    PutBe16(&body, m.msg_id);
    if ((m.flags & 0x3) == kTidPredef)
      PutBe16(&body, m.topic_id);
    else
      body += m.topic_name;
  } else if (t == kSuback) {
    body.push_back(static_cast<char>(m.flags));
    PutBe16(&body, m.topic_id);
    PutBe16(&body, m.msg_id);
    body.push_back(static_cast<char>(m.rc));
  } else if (t == kPingReq) {
    body += m.clientid;
  } else if (t == kPingResp) {
    // bare
  } else if (t == kDisconnect) {
    if (m.duration) PutBe16(&body, m.duration);
  } else if (t == kGwInfo) {
    body.push_back(static_cast<char>(m.rc));
  } else if (t == kAdvertise) {
    body.push_back(static_cast<char>(m.rc));
    PutBe16(&body, m.duration);
  }
  Frame(out, body);
}

// Append one SN PUBLISH datagram; reports the absolute offsets of the
// flags byte and the msg-id field inside *out so the delivery path can
// patch a freshly allocated packet id into a parked copy (the host's
// pending-queue discipline) and set DUP on a retransmit.
inline void BuildPublish(std::string* out, uint8_t flags, uint16_t topic_id,
                         uint16_t msg_id, std::string_view payload,
                         size_t* flags_off, size_t* mid_off) {
  size_t ln = 1 + 1 + 1 + 2 + 2 + payload.size();
  size_t base = out->size();
  if (ln < 256) {
    out->push_back(static_cast<char>(ln));
    base += 1;
  } else {
    out->push_back(0x01);
    PutBe16(out, static_cast<uint16_t>(ln + 2));
    base += 3;
  }
  out->push_back(static_cast<char>(kPublish));
  out->push_back(static_cast<char>(flags));
  PutBe16(out, topic_id);
  PutBe16(out, msg_id);
  out->append(payload.data(), payload.size());
  if (flags_off) *flags_off = base + 1;
  if (mid_off) *mid_off = base + 4;
}

}  // namespace sn
}  // namespace emqx_native
