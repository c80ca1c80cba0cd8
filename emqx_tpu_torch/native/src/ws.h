// RFC6455 for the native plane — the C++ twin of broker/ws.py (which
// stays the slow-plane oracle and conformance reference). Shared by
// host.cc (server side: upgrade handshake + masked-client decode +
// binary egress) and loadgen.cc (client side: request + masked egress +
// unmasked decode), so the two ends are framed by the same state
// machine and a bug cannot hide behind a matching bug.
//
// Design notes:
//   - the decoder STREAMS data-frame payload bytes to the caller as
//     they arrive (unmasked incrementally — the mask key is positional,
//     so no whole-frame buffering): MQTT-over-WS packets need not align
//     with WS frame boundaries (MQTT 5 §6.0), and the byte stream feeds
//     the MQTT Framer exactly like TCP bytes do. Fragmented data
//     messages therefore "reassemble" for free — the fragments' payload
//     bytes flow to the sink in order — while opcode sequencing
//     (continuation-without-start, interleaved messages, fragmented
//     control frames, RSV bits) is still validated per RFC;
//   - control frames (<=125 bytes) ARE buffered whole: ping payloads
//     echo into pongs and close frames carry a status code;
//   - SHA1 lives here only for the Sec-WebSocket-Accept digest (RFC6455
//     §4.2.2); it is not a general-purpose hash surface.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>

namespace emqx_native {
namespace ws {

constexpr uint8_t kOpCont = 0x0;
constexpr uint8_t kOpText = 0x1;
constexpr uint8_t kOpBinary = 0x2;
constexpr uint8_t kOpClose = 0x8;
constexpr uint8_t kOpPing = 0x9;
constexpr uint8_t kOpPong = 0xA;

constexpr const char* kGuid = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11";

// -- SHA1 (for the accept key only) -----------------------------------------

inline void Sha1(const uint8_t* data, size_t len, uint8_t out[20]) {
  uint32_t h[5] = {0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476,
                   0xC3D2E1F0};
  uint64_t total = static_cast<uint64_t>(len) * 8;
  // message + 0x80 + zero pad + 8-byte big-endian bit length
  size_t padded = ((len + 8) / 64 + 1) * 64;
  std::string buf(reinterpret_cast<const char*>(data), len);
  buf.push_back(static_cast<char>(0x80));
  buf.resize(padded, '\0');
  for (int i = 0; i < 8; i++)
    buf[padded - 1 - i] = static_cast<char>((total >> (8 * i)) & 0xFF);
  auto rol = [](uint32_t v, int n) { return (v << n) | (v >> (32 - n)); };
  for (size_t off = 0; off < padded; off += 64) {
    uint32_t w[80];
    for (int i = 0; i < 16; i++)
      w[i] = (static_cast<uint8_t>(buf[off + 4 * i]) << 24) |
             (static_cast<uint8_t>(buf[off + 4 * i + 1]) << 16) |
             (static_cast<uint8_t>(buf[off + 4 * i + 2]) << 8) |
             static_cast<uint8_t>(buf[off + 4 * i + 3]);
    for (int i = 16; i < 80; i++)
      w[i] = rol(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
    for (int i = 0; i < 80; i++) {
      uint32_t f, k;
      if (i < 20) {
        f = (b & c) | (~b & d);
        k = 0x5A827999;
      } else if (i < 40) {
        f = b ^ c ^ d;
        k = 0x6ED9EBA1;
      } else if (i < 60) {
        f = (b & c) | (b & d) | (c & d);
        k = 0x8F1BBCDC;
      } else {
        f = b ^ c ^ d;
        k = 0xCA62C1D6;
      }
      uint32_t t = rol(a, 5) + f + e + k + w[i];
      e = d;
      d = c;
      c = rol(b, 30);
      b = a;
      a = t;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
  }
  for (int i = 0; i < 5; i++) {
    out[4 * i] = (h[i] >> 24) & 0xFF;
    out[4 * i + 1] = (h[i] >> 16) & 0xFF;
    out[4 * i + 2] = (h[i] >> 8) & 0xFF;
    out[4 * i + 3] = h[i] & 0xFF;
  }
}

inline std::string Base64(const uint8_t* data, size_t len) {
  static const char tbl[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  std::string out;
  out.reserve((len + 2) / 3 * 4);
  for (size_t i = 0; i < len; i += 3) {
    uint32_t v = data[i] << 16;
    if (i + 1 < len) v |= data[i + 1] << 8;
    if (i + 2 < len) v |= data[i + 2];
    out.push_back(tbl[(v >> 18) & 63]);
    out.push_back(tbl[(v >> 12) & 63]);
    out.push_back(i + 1 < len ? tbl[(v >> 6) & 63] : '=');
    out.push_back(i + 2 < len ? tbl[v & 63] : '=');
  }
  return out;
}

inline std::string AcceptKey(std::string_view client_key) {
  std::string joined(client_key);
  joined += kGuid;
  uint8_t digest[20];
  Sha1(reinterpret_cast<const uint8_t*>(joined.data()), joined.size(),
       digest);
  return Base64(digest, 20);
}

// -- handshake ---------------------------------------------------------------

// Parse one HTTP/1.1 upgrade request (bytes through the blank line).
// Returns true when it is a well-formed GET websocket upgrade; fills
// the client key, the request path (query string stripped) and whether
// the `mqtt` subprotocol was offered. Header names are
// case-insensitive; values case-insensitively substring-matched the
// same way broker/ws.py's oracle does.
inline bool ParseUpgradeRequest(std::string_view req, std::string* key,
                                std::string* path, bool* mqtt_proto) {
  *mqtt_proto = false;
  size_t line_end = req.find("\r\n");
  if (line_end == std::string_view::npos) return false;
  std::string_view start = req.substr(0, line_end);
  size_t sp1 = start.find(' ');
  size_t sp2 = start.rfind(' ');
  if (sp1 == std::string_view::npos || sp2 <= sp1) return false;
  if (start.substr(0, sp1) != "GET") return false;
  std::string_view target = start.substr(sp1 + 1, sp2 - sp1 - 1);
  size_t q = target.find('?');
  path->assign(target.substr(0, q));
  auto lower = [](std::string s) {
    for (char& c : s)
      if (c >= 'A' && c <= 'Z') c += 32;
    return s;
  };
  bool upgrade_ws = false, conn_upgrade = false, have_key = false;
  size_t pos = line_end + 2;
  while (pos < req.size()) {
    size_t eol = req.find("\r\n", pos);
    if (eol == std::string_view::npos) eol = req.size();
    std::string_view line = req.substr(pos, eol - pos);
    pos = eol + 2;
    size_t colon = line.find(':');
    if (colon == std::string_view::npos) continue;
    std::string name = lower(std::string(line.substr(0, colon)));
    std::string_view val = line.substr(colon + 1);
    while (!val.empty() && (val.front() == ' ' || val.front() == '\t'))
      val.remove_prefix(1);
    while (!val.empty() && (val.back() == ' ' || val.back() == '\r'))
      val.remove_suffix(1);
    if (name == "upgrade") {
      upgrade_ws = lower(std::string(val)).find("websocket") !=
                   std::string::npos;
    } else if (name == "connection") {
      conn_upgrade = lower(std::string(val)).find("upgrade") !=
                     std::string::npos;
    } else if (name == "sec-websocket-key") {
      key->assign(val);
      have_key = !key->empty();
    } else if (name == "sec-websocket-protocol") {
      if (lower(std::string(val)).find("mqtt") != std::string::npos)
        *mqtt_proto = true;
    }
  }
  return upgrade_ws && conn_upgrade && have_key;
}

inline std::string BuildUpgradeResponse(const std::string& accept,
                                        bool mqtt_proto) {
  std::string r =
      "HTTP/1.1 101 Switching Protocols\r\n"
      "Upgrade: websocket\r\n"
      "Connection: Upgrade\r\n"
      "Sec-WebSocket-Accept: " + accept + "\r\n";
  if (mqtt_proto) r += "Sec-WebSocket-Protocol: mqtt\r\n";
  r += "\r\n";
  return r;
}

inline std::string Build400() {
  return "HTTP/1.1 400 Bad Request\r\nContent-Length: 0\r\n\r\n";
}

inline std::string BuildUpgradeRequest(const std::string& host,
                                       const std::string& path,
                                       const std::string& key) {
  return "GET " + path + " HTTP/1.1\r\n"
         "Host: " + host + "\r\n"
         "Upgrade: websocket\r\n"
         "Connection: Upgrade\r\n"
         "Sec-WebSocket-Key: " + key + "\r\n"
         "Sec-WebSocket-Version: 13\r\n"
         "Sec-WebSocket-Protocol: mqtt\r\n\r\n";
}

// -- frame encode ------------------------------------------------------------

// Append one frame header (FIN=1). mask_key != nullptr sets the mask
// bit and appends the key; the CALLER XORs the payload it then appends
// (clients mask, servers never do — RFC6455 §5.3).
inline void AppendFrameHeader(std::string* out, uint8_t opcode, size_t len,
                              const uint8_t* mask_key = nullptr) {
  out->push_back(static_cast<char>(0x80 | opcode));
  uint8_t mbit = mask_key ? 0x80 : 0;
  if (len < 126) {
    out->push_back(static_cast<char>(mbit | len));
  } else if (len < 65536) {
    out->push_back(static_cast<char>(mbit | 126));
    out->push_back(static_cast<char>(len >> 8));
    out->push_back(static_cast<char>(len & 0xFF));
  } else {
    out->push_back(static_cast<char>(mbit | 127));
    for (int i = 7; i >= 0; i--)
      out->push_back(static_cast<char>(
          (static_cast<uint64_t>(len) >> (8 * i)) & 0xFF));
  }
  if (mask_key)
    out->append(reinterpret_cast<const char*>(mask_key), 4);
}

// -- incremental decoder -----------------------------------------------------

enum class WsStatus : int {
  kOk = 0,
  kProtoError = 1,   // RSV bits / opcode sequence / mask rule violated
  kCtrlTooBig = 2,   // control frame payload over 125 bytes
  kAborted = 3,      // the data sink asked to stop (downstream error)
};

// Resumable frame state machine. Data-frame payloads stream to
// `on_data(chunk, len) -> bool` (false aborts); complete control frames
// land in `on_ctrl(opcode, payload, len) -> bool`. `data` is mutable:
// masked payload bytes unmask IN PLACE (word-at-a-time), so the hot
// path pays one XOR pass and zero copies between the socket buffer and
// the MQTT framer.
class WsDecoder {
 public:
  explicit WsDecoder(bool require_mask) : require_mask_(require_mask) {}

  template <typename DataFn, typename CtrlFn>
  WsStatus Feed(uint8_t* data, size_t len, DataFn&& on_data,
                CtrlFn&& on_ctrl) {
    size_t pos = 0;
    while (pos < len) {
      switch (phase_) {
        case Phase::kB0: {
          uint8_t b0 = data[pos++];
          if (b0 & 0x70) return WsStatus::kProtoError;  // RSV set
          fin_ = b0 & 0x80;
          opcode_ = b0 & 0x0F;
          is_ctrl_ = opcode_ >= 0x8;
          if (is_ctrl_) {
            if (!fin_) return WsStatus::kProtoError;  // fragmented ctrl
            if (opcode_ != kOpClose && opcode_ != kOpPing &&
                opcode_ != kOpPong)
              return WsStatus::kProtoError;
          } else if (opcode_ == kOpCont) {
            if (!in_msg_) return WsStatus::kProtoError;
          } else if (opcode_ == kOpText || opcode_ == kOpBinary) {
            if (in_msg_) return WsStatus::kProtoError;  // interleaved
            in_msg_ = !fin_;
          } else {
            return WsStatus::kProtoError;
          }
          if (!is_ctrl_ && opcode_ == kOpCont) in_msg_ = !fin_;
          phase_ = Phase::kB1;
          break;
        }
        case Phase::kB1: {
          uint8_t b1 = data[pos++];
          masked_ = b1 & 0x80;
          if (require_mask_ && !masked_) return WsStatus::kProtoError;
          uint8_t n = b1 & 0x7F;
          if (is_ctrl_ && n > 125) return WsStatus::kCtrlTooBig;
          if (n < 126) {
            need_ = n;
            ext_need_ = 0;
            phase_ = masked_ ? Phase::kMask : Phase::kPayload;
          } else {
            ext_need_ = n == 126 ? 2 : 8;
            need_ = 0;
            phase_ = Phase::kExtLen;
          }
          mask_got_ = 0;
          mask_off_ = 0;
          if (phase_ == Phase::kPayload && need_ == 0) {
            WsStatus st = FinishEmpty(on_data, on_ctrl);
            if (st != WsStatus::kOk) return st;
          }
          break;
        }
        case Phase::kExtLen: {
          need_ = (need_ << 8) | data[pos++];
          if (--ext_need_ == 0) {
            phase_ = masked_ ? Phase::kMask : Phase::kPayload;
            if (phase_ == Phase::kPayload && need_ == 0) {
              WsStatus st = FinishEmpty(on_data, on_ctrl);
              if (st != WsStatus::kOk) return st;
            }
          }
          break;
        }
        case Phase::kMask: {
          mask_[mask_got_++] = data[pos++];
          if (mask_got_ == 4) {
            phase_ = Phase::kPayload;
            if (need_ == 0) {
              WsStatus st = FinishEmpty(on_data, on_ctrl);
              if (st != WsStatus::kOk) return st;
            }
          }
          break;
        }
        case Phase::kPayload: {
          size_t take = len - pos;
          if (take > need_) take = static_cast<size_t>(need_);
          uint8_t* chunk = data + pos;
          if (masked_) {
            // in-place unmask, 8 bytes per XOR once key-phase-aligned
            size_t i = 0;
            uint32_t ph = mask_off_;
            while (i < take && (ph & 3)) {
              chunk[i++] ^= mask_[ph & 3];
              ph++;
            }
            if (take >= i + 8) {
              uint64_t key8;
              uint8_t kb[8];
              for (int b = 0; b < 8; b++) kb[b] = mask_[b & 3];
              memcpy(&key8, kb, 8);
              for (; i + 8 <= take; i += 8) {
                uint64_t v;
                memcpy(&v, chunk + i, 8);
                v ^= key8;
                memcpy(chunk + i, &v, 8);
              }
            }
            // word loop consumed multiples of 4: phase is 0 here
            for (uint32_t t = 0; i < take; i++, t++)
              chunk[i] ^= mask_[t & 3];
            mask_off_ = (mask_off_ + take) & 3;
          }
          if (is_ctrl_) {
            ctrl_buf_.append(reinterpret_cast<const char*>(chunk), take);
          } else {
            if (!on_data(reinterpret_cast<const char*>(chunk), take))
              return WsStatus::kAborted;
          }
          pos += take;
          need_ -= take;
          if (need_ == 0) {
            if (is_ctrl_) {
              bool keep = on_ctrl(opcode_, ctrl_buf_.data(),
                                  ctrl_buf_.size());
              ctrl_buf_.clear();
              if (!keep) return WsStatus::kAborted;
            }
            phase_ = Phase::kB0;
          }
          break;
        }
      }
    }
    return WsStatus::kOk;
  }

 private:
  template <typename DataFn, typename CtrlFn>
  WsStatus FinishEmpty(DataFn&& on_data, CtrlFn&& on_ctrl) {
    // zero-length payload completes the frame without a kPayload pass
    if (is_ctrl_) {
      if (!on_ctrl(opcode_, ctrl_buf_.data(), size_t{0}))
        return WsStatus::kAborted;
    } else {
      if (!on_data("", size_t{0})) return WsStatus::kAborted;
    }
    phase_ = Phase::kB0;
    return WsStatus::kOk;
  }

  // Decoder sits at a frame AND message boundary — the park plane's
  // hibernation precondition for WS conns (the decoder is dropped and
  // rebuilt at inflation, so mid-frame state must not exist).
 public:
  bool idle() const { return phase_ == Phase::kB0 && !in_msg_; }

 private:
  enum class Phase { kB0, kB1, kExtLen, kMask, kPayload };
  bool require_mask_;
  Phase phase_ = Phase::kB0;
  bool fin_ = false, masked_ = false, is_ctrl_ = false, in_msg_ = false;
  uint8_t opcode_ = 0;
  uint64_t need_ = 0;
  int ext_need_ = 0;
  uint8_t mask_[4] = {};
  int mask_got_ = 0;
  uint32_t mask_off_ = 0;
  std::string ctrl_buf_;   // control-frame payload accumulation
};

}  // namespace ws
}  // namespace emqx_native
