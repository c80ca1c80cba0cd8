// Native MQTT load generator — the emqtt-bench analogue (the reference
// measures its 1M msg/s with an Erlang client fleet; a Python client
// fleet tops out around 15k msg/s total and would measure itself, not
// the broker). Single thread, nonblocking sockets, one epoll loop for
// the whole fleet: subscribers count deliveries and sample end-to-end
// latency from an 8-byte monotonic-ns timestamp at the head of every
// payload; publishers blast with TCP backpressure as the only pacing.
//
// Driven from bench.py over ctypes (emqx_loadgen_run blocks; ctypes
// releases the GIL so the broker's poll thread keeps running).

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <string>
#include <vector>

#include "coap.h"
#include "frame.h"
#include "sn.h"
#include "ws.h"

namespace {

using emqx_native::Framer;
using emqx_native::FrameStatus;
namespace lws = emqx_native::ws;

inline uint64_t NowNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

void PutU16(std::string* s, uint16_t v) {
  s->push_back(static_cast<char>(v >> 8));
  s->push_back(static_cast<char>(v & 0xFF));
}

void PutVarint(std::string* s, size_t v) {
  do {
    uint8_t b = v & 0x7F;
    v >>= 7;
    s->push_back(static_cast<char>(v ? b | 0x80 : b));
  } while (v);
}

std::string Connect(const std::string& clientid, int proto_ver) {
  std::string body;
  PutU16(&body, 4);
  body += "MQTT";
  body.push_back(static_cast<char>(proto_ver));
  body.push_back(0x02);  // clean start
  PutU16(&body, 60);     // keepalive
  if (proto_ver == 5) body.push_back('\0');  // empty properties
  PutU16(&body, static_cast<uint16_t>(clientid.size()));
  body += clientid;
  std::string f;
  f.push_back(0x10);
  PutVarint(&f, body.size());
  return f + body;
}

std::string Subscribe(uint16_t pid, const std::string& filt, uint8_t qos,
                      int proto_ver) {
  std::string body;
  PutU16(&body, pid);
  if (proto_ver == 5) body.push_back('\0');
  PutU16(&body, static_cast<uint16_t>(filt.size()));
  body += filt;
  body.push_back(static_cast<char>(qos));
  std::string f;
  f.push_back(static_cast<char>(0x82));
  PutVarint(&f, body.size());
  return f + body;
}

std::string Publish(const std::string& topic, const std::string& payload,
                    uint8_t qos, uint16_t pid, int proto_ver) {
  std::string body;
  PutU16(&body, static_cast<uint16_t>(topic.size()));
  body += topic;
  if (qos) PutU16(&body, pid);
  if (proto_ver == 5) body.push_back('\0');
  body += payload;
  std::string f;
  f.push_back(static_cast<char>(0x30 | (qos << 1)));
  PutVarint(&f, body.size());
  return f + body;
}

std::string Ack(uint8_t header, uint16_t pid) {
  std::string f;
  f.push_back(static_cast<char>(header));
  f.push_back(0x02);
  PutU16(&f, pid);
  return f;
}

// [h][varint][pid] — pid of PUBACK/PUBREC/PUBREL/PUBCOMP
uint16_t AckPid(const std::string& f) {
  size_t pos = 1;
  while (pos < f.size() && (static_cast<uint8_t>(f[pos]) & 0x80)) pos++;
  pos++;
  if (pos + 2 > f.size()) return 0;
  return (static_cast<uint8_t>(f[pos]) << 8) |
         static_cast<uint8_t>(f[pos + 1]);
}

struct LgConn {
  int fd = -1;
  Framer framer{1 << 20};
  std::string outbuf;
  size_t outpos = 0;
  bool connacked = false;
  bool subacked = false;
  bool is_sub = false;
  uint32_t idx = 0;
  // -- ws mode (the emqtt-bench `ws://` analogue) --------------------------
  bool ws = false;
  bool ws_open = false;      // 101 received; frames flow
  std::string ws_hs;         // upgrade response accumulation
  // server frames arrive unmasked (require_mask=false); the decoder
  // still handles a masked frame generically should one appear
  lws::WsDecoder ws_dec{/*require_mask=*/false};
  uint8_t ws_key[4] = {};    // nonzero client mask key (per conn)
  std::string cid;           // CONNECT is deferred until the 101 lands
};

struct Loadgen {
  std::vector<LgConn> conns;
  int ep = -1;
  uint64_t received = 0, sent = 0, acks = 0, errors = 0;
  std::vector<uint64_t> lat;
  int proto_ver = 4;
  uint8_t qos = 0;

  ~Loadgen() {
    for (auto& c : conns)
      if (c.fd >= 0) close(c.fd);
    if (ep >= 0) close(ep);
  }

  // Append MQTT bytes to a conn's socket buffer; ws conns wrap them in
  // one masked binary frame (clients MUST mask, RFC6455 §5.3 — the key
  // is nonzero so the broker pays the real unmask cost).
  void AppendOut(LgConn& c, const std::string& bytes) {
    if (!c.ws) {
      c.outbuf += bytes;
      return;
    }
    lws::AppendFrameHeader(&c.outbuf, lws::kOpBinary, bytes.size(),
                           c.ws_key);
    size_t at = c.outbuf.size();
    c.outbuf += bytes;
    for (size_t i = 0; i < bytes.size(); i++)
      c.outbuf[at + i] ^= static_cast<char>(c.ws_key[i & 3]);
  }

  bool FlushOut(LgConn& c) {
    while (c.outpos < c.outbuf.size()) {
      ssize_t n = send(c.fd, c.outbuf.data() + c.outpos,
                       c.outbuf.size() - c.outpos, MSG_NOSIGNAL);
      if (n > 0) {
        c.outpos += static_cast<size_t>(n);
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u32 = c.idx;
        epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
        return true;
      } else if (n < 0 && errno == EINTR) {
        continue;
      } else {
        return false;
      }
    }
    c.outbuf.clear();
    c.outpos = 0;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = c.idx;
    epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
    return true;
  }

  void OnFrame(LgConn& c, const std::string& f) {
    uint8_t type = static_cast<uint8_t>(f[0]) >> 4;
    if (type == 2) {  // CONNACK
      c.connacked = true;
    } else if (type == 9) {  // SUBACK
      c.subacked = true;
    } else if (type == 3) {  // PUBLISH delivery
      uint8_t dqos = (static_cast<uint8_t>(f[0]) >> 1) & 3;
      size_t pos = 1;
      while (pos < f.size() && (static_cast<uint8_t>(f[pos]) & 0x80)) pos++;
      pos++;
      if (pos + 2 > f.size()) return;
      uint16_t tlen = (static_cast<uint8_t>(f[pos]) << 8) |
                      static_cast<uint8_t>(f[pos + 1]);
      pos += 2 + tlen;
      if (dqos) {
        if (pos + 2 > f.size()) return;
        uint16_t pid = (static_cast<uint8_t>(f[pos]) << 8) |
                       static_cast<uint8_t>(f[pos + 1]);
        pos += 2;
        // qos1 delivery → PUBACK; qos2 → PUBREC (broker answers
        // PUBREL, completed below)
        AppendOut(c, Ack(dqos == 1 ? 0x40 : 0x50, pid));
      }
      if (proto_ver == 5 && pos < f.size()) {
        uint8_t plen = static_cast<uint8_t>(f[pos]);
        pos += 1 + plen;  // bench properties always fit one varint byte
      }
      if (pos + 8 <= f.size()) {
        uint64_t stamp;
        memcpy(&stamp, f.data() + pos, 8);
        uint64_t now = NowNs();
        if (now > stamp && now - stamp < 60ull * 1000000000ull)
          lat.push_back(now - stamp);
      }
      received++;
    } else if (type == 4) {  // PUBACK for our qos1 publishes
      acks++;
    } else if (type == 5) {  // PUBREC for our qos2 publish → PUBREL
      AppendOut(c, Ack(0x62, AckPid(f)));
    } else if (type == 6) {  // PUBREL from the broker → PUBCOMP
      AppendOut(c, Ack(0x70, AckPid(f)));
    } else if (type == 7) {  // PUBCOMP completes our qos2 publish
      acks++;
    }
  }

  // One conn's inbound bytes → MQTT frames (through the ws codec when
  // applicable; `data` is mutable for in-place unmasking). Returns
  // false on a framing/protocol error.
  bool Ingest(LgConn& c, uint8_t* data, size_t len) {
    if (!c.ws) return FeedMqtt(c, data, len);
    if (!c.ws_open) {
      c.ws_hs.append(reinterpret_cast<const char*>(data), len);
      size_t end = c.ws_hs.find("\r\n\r\n");
      if (end == std::string::npos) return c.ws_hs.size() <= 16384;
      if (c.ws_hs.compare(0, 12, "HTTP/1.1 101") != 0) return false;
      c.ws_open = true;
      AppendOut(c, Connect(c.cid, proto_ver));  // deferred CONNECT
      std::string left = c.ws_hs.substr(end + 4);
      c.ws_hs.clear();
      if (left.empty()) return true;
      return WsFeed(c, reinterpret_cast<uint8_t*>(&left[0]), left.size());
    }
    return WsFeed(c, data, len);
  }

  bool WsFeed(LgConn& c, uint8_t* data, size_t len) {
    bool ok = true;
    lws::WsStatus st = c.ws_dec.Feed(
        data, len,
        [&](const char* p, size_t n) {
          if (n && !FeedMqtt(c, reinterpret_cast<const uint8_t*>(p), n)) {
            ok = false;
            return false;
          }
          return true;
        },
        [&](uint8_t op, const char* p, size_t n) {
          if (op == lws::kOpPing) {  // masked pong echo
            lws::AppendFrameHeader(&c.outbuf, lws::kOpPong, n, c.ws_key);
            size_t at = c.outbuf.size();
            c.outbuf.append(p, n);
            for (size_t i = 0; i < n; i++)
              c.outbuf[at + i] ^= static_cast<char>(c.ws_key[i & 3]);
            return true;
          }
          return op != lws::kOpClose;  // close ends the conn
        });
    return ok && st == lws::WsStatus::kOk;
  }

  bool FeedMqtt(LgConn& c, const uint8_t* data, size_t len) {
    std::vector<std::string> frames;
    if (c.framer.Feed(data, len, &frames) != FrameStatus::kOk)
      return false;
    for (auto& f : frames) OnFrame(c, f);
    return true;
  }

  // Pump readable/writable conns once; returns false on fatal error.
  bool Pump(int timeout_ms) {
    epoll_event evs[128];
    int n = epoll_wait(ep, evs, 128, timeout_ms);
    if (n < 0) return errno == EINTR;
    uint8_t chunk[64 * 1024];
    for (int i = 0; i < n; i++) {
      LgConn& c = conns[evs[i].data.u32];
      if (c.fd < 0) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        errors++;
        close(c.fd);
        c.fd = -1;
        continue;
      }
      if (evs[i].events & EPOLLOUT) {
        if (!FlushOut(c)) {
          errors++;
          close(c.fd);
          c.fd = -1;
          continue;
        }
      }
      if (!(evs[i].events & EPOLLIN)) continue;
      for (;;) {
        ssize_t r = recv(c.fd, chunk, sizeof(chunk), 0);
        if (r > 0) {
          if (!Ingest(c, chunk, static_cast<size_t>(r))) {
            errors++;
            close(c.fd);
            c.fd = -1;
            break;
          }
          if (!c.outbuf.empty()) FlushOut(c);  // pubacks
          if (static_cast<size_t>(r) < sizeof(chunk)) break;
        } else if (r == 0) {
          close(c.fd);
          c.fd = -1;
          break;
        } else {
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          if (errno == EINTR) continue;
          errors++;
          close(c.fd);
          c.fd = -1;
          break;
        }
      }
    }
    return true;
  }
};

}  // namespace

extern "C" {

// out[8]: sent, received, wall_ns, p50_ns, p99_ns, max_ns, acks, errors
//
// qos selects the full exchange depth: 0 = fire-and-forget, 1 =
// PUBLISH/PUBACK both directions, 2 = the four-packet exactly-once
// exchange on both the publisher (PUBREC→PUBREL, PUBCOMP counts into
// acks) and the subscriber (PUBREC, PUBREL→PUBCOMP) sides.
//
// window = 0: blast mode — publishers keep ~64KB buffered and TCP
//   backpressure paces them; measures peak throughput, but delivery
//   latency then measures queue depth, not the broker.
// window > 0: windowed mode — total unreceived messages are capped at
//   `window`, so latency percentiles measure the broker's delivery
//   path at a sustainable rate (no coordinated omission).
// warmup != 0: each publisher first sends one message per topic and
//   waits, letting the broker's permit machinery move those
//   (conn, topic) pairs onto the native fast path before the clock
//   starts (permits are per-connection, so warming must happen in-run).
// ws != 0: the whole fleet speaks MQTT-over-WebSocket (RFC6455
//   upgrade on /mqtt, masked binary frames with nonzero keys so the
//   broker pays the real unmask cost) — point `port` at the broker's
//   WS listener.
int emqx_loadgen_run(const char* host, uint16_t port, uint32_t n_subs,
                     uint32_t n_pubs, uint32_t msgs_per_pub, uint8_t qos,
                     uint32_t payload_len, int proto_ver, int idle_timeout_ms,
                     uint32_t window, int warmup, int ws, uint32_t salt,
                     uint64_t* out) {
  Loadgen lg;
  lg.proto_ver = proto_ver;
  lg.qos = qos;
  uint32_t total = n_subs + n_pubs;
  lg.conns.resize(total);
  lg.ep = epoll_create1(EPOLL_CLOEXEC);
  if (lg.ep < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return -2;

  for (uint32_t i = 0; i < total; i++) {
    LgConn& c = lg.conns[i];
    c.idx = i;
    c.is_sub = i < n_subs;
    c.fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (c.fd < 0) return -3;
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    if (connect(c.fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 &&
        errno != EINPROGRESS)
      return -4;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = i;
    epoll_ctl(lg.ep, EPOLL_CTL_ADD, c.fd, &ev);
    std::string cid = (c.is_sub ? "lgs" : "lgp") + std::to_string(salt + i);
    if (ws) {
      c.ws = true;
      c.cid = cid;
      uint64_t seed = NowNs() ^ (0x9E3779B97F4A7C15ull * (i + 1));
      for (int b = 0; b < 4; b++)
        c.ws_key[b] = static_cast<uint8_t>((seed >> (8 * b)) & 0xFF);
      if (!(c.ws_key[0] | c.ws_key[1] | c.ws_key[2] | c.ws_key[3]))
        c.ws_key[0] = 1;
      // handshake request is HTTP, not a frame: raw bytes; the CONNECT
      // follows from Ingest once the 101 arrives
      c.outbuf += lws::BuildUpgradeRequest(
          host, "/mqtt", "bG9hZGdlbi1ub25jZS0wMDE=");
    } else {
      c.outbuf += Connect(cid, proto_ver);
    }
    lg.FlushOut(c);
  }

  // wait for all CONNACKs, then all SUBACKs (handshake deadline 15s)
  uint64_t deadline = NowNs() + 15ull * 1000000000ull;
  auto all = [&](bool LgConn::* flag, bool subs_only) {
    for (auto& c : lg.conns) {
      if (subs_only && !c.is_sub) continue;
      if (c.fd >= 0 && !(c.*flag)) return false;
    }
    return true;
  };
  while (!all(&LgConn::connacked, false)) {
    if (NowNs() > deadline || !lg.Pump(100)) return -5;
  }
  for (uint32_t i = 0; i < n_subs; i++) {
    LgConn& c = lg.conns[i];
    if (c.fd < 0) continue;
    lg.AppendOut(c, Subscribe(1, "lg/" + std::to_string(salt + i) + "/+", qos,
                              proto_ver));
    lg.FlushOut(c);
  }
  while (!all(&LgConn::subacked, true)) {
    if (NowNs() > deadline || !lg.Pump(100)) return -6;
  }

  uint64_t expected = static_cast<uint64_t>(n_pubs) * msgs_per_pub;
  lg.lat.reserve(std::min<uint64_t>(expected, 4u << 20));
  std::string pad(payload_len > 8 ? payload_len - 8 : 0, 'x');
  std::vector<uint32_t> next_msg(n_pubs, 0);

  if (warmup) {
    // one slow-path message per (publisher, topic) pair earns the
    // publish permits; then idle so the broker's grant step runs
    uint64_t warm_expected = static_cast<uint64_t>(n_pubs) * n_subs;
    for (uint32_t j = 0; j < n_pubs; j++) {
      LgConn& c = lg.conns[n_subs + j];
      if (c.fd < 0) continue;
      for (uint32_t k = 0; k < n_subs; k++) {
        uint64_t stamp = NowNs();
        std::string payload(reinterpret_cast<char*>(&stamp), 8);
        payload += pad;
        lg.AppendOut(c, Publish("lg/" + std::to_string(salt + k) + "/m",
                                payload, 0, 0, proto_ver));
      }
      lg.FlushOut(c);
    }
    uint64_t warm_deadline = NowNs() + 20ull * 1000000000ull;
    while (lg.received < warm_expected && NowNs() < warm_deadline) {
      if (!lg.Pump(100)) break;
    }
    // grant latency: the broker queues permits and applies them on an
    // idle poll step; 600ms of pumping is comfortably past that
    uint64_t settle_until = NowNs() + 600ull * 1000000ull;
    while (NowNs() < settle_until) lg.Pump(50);
    lg.received = lg.sent = lg.acks = 0;
    lg.lat.clear();
  }

  // blast/windowed: publisher j round-robins the subscriber topics;
  // payload head is the publish timestamp (ns), refreshed per message
  uint64_t t0 = NowNs();
  uint64_t last_progress = t0;
  uint64_t last_received = 0;
  uint16_t pid = 1;
  while (true) {
    // fill publisher buffers (~64KB each; EAGAIN pacing does the rest;
    // in windowed mode the in-flight cap paces instead)
    bool done_sending = true;
    for (uint32_t j = 0; j < n_pubs; j++) {
      LgConn& c = lg.conns[n_subs + j];
      if (c.fd < 0) continue;
      while (next_msg[j] < msgs_per_pub &&
             c.outbuf.size() - c.outpos < 64 * 1024 &&
             (window == 0 || lg.sent - lg.received < window)) {
        uint64_t stamp = NowNs();
        std::string payload(reinterpret_cast<char*>(&stamp), 8);
        payload += pad;
        std::string topic =
            "lg/" + std::to_string(salt + (j + next_msg[j]) % n_subs) + "/m";
        if (qos) pid = pid == 0x7FFF ? 1 : pid + 1;
        lg.AppendOut(c, Publish(topic, payload, qos, pid, proto_ver));
        next_msg[j]++;
        lg.sent++;
      }
      if (next_msg[j] < msgs_per_pub) done_sending = false;
      if (!c.outbuf.empty() && !lg.FlushOut(c)) {
        lg.errors++;
        close(c.fd);
        c.fd = -1;
      }
    }
    if (lg.received >= expected) break;
    if (!lg.Pump(done_sending ? 50 : 1)) break;
    uint64_t now = NowNs();
    if (lg.received != last_received) {
      last_received = lg.received;
      last_progress = now;
    } else if (now - last_progress >
               static_cast<uint64_t>(idle_timeout_ms) * 1000000ull) {
      break;  // stalled: report what we have
    }
  }
  uint64_t wall = NowNs() - t0;

  uint64_t p50 = 0, p99 = 0, mx = 0;
  if (!lg.lat.empty()) {
    size_t i50 = lg.lat.size() / 2;
    size_t i99 = lg.lat.size() * 99 / 100;
    if (i99 >= lg.lat.size()) i99 = lg.lat.size() - 1;
    std::nth_element(lg.lat.begin(), lg.lat.begin() + i50, lg.lat.end());
    p50 = lg.lat[i50];
    std::nth_element(lg.lat.begin(), lg.lat.begin() + i99, lg.lat.end());
    p99 = lg.lat[i99];
    mx = *std::max_element(lg.lat.begin(), lg.lat.end());
  }
  out[0] = lg.sent;
  out[1] = lg.received;
  out[2] = wall;
  out[3] = p50;
  out[4] = p99;
  out[5] = mx;
  out[6] = lg.acks;
  out[7] = lg.errors;
  return 0;
}

// --- MQTT-SN/UDP fleet (round 11) -------------------------------------------
// The emqtt-bench analogue for the SN gateway: a connected-UDP fleet
// speaking the shared sn.h codec (the same functions the host decodes
// with). Subscribers SUBSCRIBE "lgsn/<i>" and count deliveries (8-byte
// ns stamp at the payload head, like the TCP fleet); publisher j
// REGISTERs and blasts "lgsn/<j % n_subs>". UDP has no transport
// backpressure, so pacing is ALWAYS windowed (sent-minus-progress cap;
// window=0 defaults to 1024) — an unpaced blast would measure kernel
// datagram drops, not the broker.

namespace {

struct SnLgConn {
  int fd = -1;
  uint32_t idx = 0;
  bool is_sub = false;
  bool connacked = false;
  bool subacked = false;
  bool regacked = false;
  uint16_t pub_tid = 0;  // publisher's registered topic id
  std::string obuf;      // messages packed per datagram (sn.h cap)
};

}  // namespace

// out[8]: sent, received, wall_ns, p50_ns, p99_ns, max_ns, acks, errors
int emqx_loadgen_run_sn(const char* host, uint16_t port, uint32_t n_subs,
                        uint32_t n_pubs, uint32_t msgs_per_pub,
                        uint8_t qos, uint32_t payload_len,
                        int idle_timeout_ms, uint32_t window, int warmup,
                        uint64_t* out) {
  namespace lsn = emqx_native::sn;
  if (window == 0) window = 1024;
  uint32_t total = n_subs + n_pubs;
  std::vector<SnLgConn> conns(total);
  int ep = epoll_create1(EPOLL_CLOEXEC);
  if (ep < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(ep);
    return -2;
  }
  uint64_t sent = 0, received = 0, acks = 0, errors = 0;
  std::vector<uint64_t> lat;
  lat.reserve(1 << 20);

  auto cleanup = [&]() {
    for (auto& c : conns)
      if (c.fd >= 0) close(c.fd);
    close(ep);
  };
  // Messages pack into aggregate datagrams (one send() per ~46 small
  // messages instead of one each — per-datagram UDP syscalls dominate
  // on sandboxed kernels). flush_conn ships the pending aggregate;
  // every sender loop flushes before blocking so nothing is stranded.
  auto flush_conn = [&](SnLgConn& c) {
    if (c.obuf.empty()) return;
    if (send(c.fd, c.obuf.data(), c.obuf.size(), MSG_NOSIGNAL) < 0 &&
        errno != EAGAIN && errno != EWOULDBLOCK)
      errors++;
    c.obuf.clear();
  };
  auto send_msg = [&](SnLgConn& c, const lsn::SnMsg& m) {
    std::string dg;
    lsn::Serialize(m, &dg);
    if (!c.obuf.empty() && c.obuf.size() + dg.size() > lsn::kPackDatagram)
      flush_conn(c);
    c.obuf += dg;
    if (c.obuf.size() >= lsn::kPackDatagram) flush_conn(c);
  };

  for (uint32_t i = 0; i < total; i++) {
    SnLgConn& c = conns[i];
    c.idx = i;
    c.is_sub = i < n_subs;
    c.fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (c.fd < 0 ||
        connect(c.fd, reinterpret_cast<sockaddr*>(&addr),
                sizeof(addr)) < 0) {
      cleanup();
      return -3;
    }
    int buf = 4 << 20;  // datagram bursts queue in the kernel, not drop
    setsockopt(c.fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = i;
    epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
    lsn::SnMsg m;
    m.type = lsn::kConnect;
    m.flags = lsn::kFClean;
    m.duration = 60;
    m.clientid = (c.is_sub ? "lgsns" : "lgsnp") + std::to_string(i);
    send_msg(c, m);
  }

  auto pump = [&](int timeout_ms) {
    for (auto& c : conns) flush_conn(c);  // nothing stranded across waits
    epoll_event evs[128];
    int n = epoll_wait(ep, evs, 128, timeout_ms);
    if (n < 0) return errno == EINTR;
    uint8_t chunk[65536];
    std::vector<lsn::SnMsg> msgs;
    for (int i = 0; i < n; i++) {
      SnLgConn& c = conns[evs[i].data.u32];
      if (c.fd < 0) continue;
      for (;;) {
        ssize_t r = recv(c.fd, chunk, sizeof(chunk), 0);
        if (r < 0) {
          if (errno == EINTR) continue;
          break;  // EAGAIN (or ICMP error: next send surfaces it)
        }
        if (r == 0) continue;
        msgs.clear();
        lsn::ParseAll(chunk, static_cast<size_t>(r), &msgs);
        for (lsn::SnMsg& m : msgs) {
          if (m.type == lsn::kConnack) {
            c.connacked = true;
          } else if (m.type == lsn::kSuback) {
            c.subacked = true;
          } else if (m.type == lsn::kRegack) {
            c.regacked = true;
            c.pub_tid = m.topic_id;
          } else if (m.type == lsn::kRegister) {
            // gateway auto-REGISTER ahead of a delivery: acknowledge
            lsn::SnMsg ra;
            ra.type = lsn::kRegack;
            ra.topic_id = m.topic_id;
            ra.msg_id = m.msg_id;
            send_msg(c, ra);
          } else if (m.type == lsn::kPublish) {
            int dq = lsn::QosOf(m.flags);
            if (dq > 0) {
              lsn::SnMsg pa;
              pa.type = lsn::kPuback;
              pa.topic_id = m.topic_id;
              pa.msg_id = m.msg_id;
              send_msg(c, pa);
            }
            if (m.data.size() >= 8) {
              uint64_t stamp;
              memcpy(&stamp, m.data.data(), 8);
              uint64_t now = NowNs();
              if (now > stamp && now - stamp < 60ull * 1000000000ull)
                lat.push_back(now - stamp);
            }
            received++;
          } else if (m.type == lsn::kPuback) {
            acks++;
          }
        }
      }
      flush_conn(c);  // replies (PUBACK/REGACK) go out with the drain
    }
    return true;
  };

  // handshake: CONNACKs, then SUBACKs + publisher REGACKs (deadline
  // 15s with one datagram-loss retry at half time)
  uint64_t deadline = NowNs() + 15ull * 1000000000ull;
  bool retried = false;
  auto phase_done = [&](int phase) {
    for (auto& c : conns) {
      if (phase == 0 && !c.connacked) return false;
      if (phase == 1 && c.is_sub && !c.subacked) return false;
      if (phase == 1 && !c.is_sub && !c.regacked) return false;
    }
    return true;
  };
  while (!phase_done(0)) {
    if (NowNs() > deadline || !pump(100)) {
      cleanup();
      return -5;
    }
    if (!retried && NowNs() > deadline - 7ull * 1000000000ull) {
      retried = true;  // a lost CONNECT datagram: one resend sweep
      for (auto& c : conns)
        if (!c.connacked) {
          lsn::SnMsg m;
          m.type = lsn::kConnect;
          m.flags = lsn::kFClean;
          m.duration = 60;
          m.clientid =
              (c.is_sub ? "lgsns" : "lgsnp") + std::to_string(c.idx);
          send_msg(c, m);
        }
    }
  }
  for (uint32_t i = 0; i < total; i++) {
    SnLgConn& c = conns[i];
    if (c.is_sub) {
      lsn::SnMsg m;
      m.type = lsn::kSubscribe;
      m.flags = lsn::QosFlags(qos);
      m.msg_id = 1;
      m.topic_name = "lgsn/" + std::to_string(i);
      send_msg(c, m);
    } else {
      lsn::SnMsg m;
      m.type = lsn::kRegister;
      m.msg_id = 1;
      m.topic_name =
          "lgsn/" + std::to_string(n_subs ? (i - n_subs) % n_subs : 0);
      send_msg(c, m);
    }
  }
  while (!phase_done(1)) {
    if (NowNs() > deadline || !pump(100)) {
      cleanup();
      return -6;
    }
  }

  uint64_t expected = static_cast<uint64_t>(n_pubs) * msgs_per_pub;
  std::string pad(payload_len > 8 ? payload_len - 8 : 0, 'x');

  auto publish_one = [&](SnLgConn& c, uint8_t q, uint16_t mid) {
    uint64_t stamp = NowNs();
    lsn::SnMsg m;
    m.type = lsn::kPublish;
    m.flags = lsn::QosFlags(q);
    m.topic_id = c.pub_tid;
    m.msg_id = mid;
    m.data.assign(reinterpret_cast<char*>(&stamp), 8);
    m.data += pad;
    send_msg(c, m);
  };

  if (warmup) {
    // one slow-path message per publisher earns the publish permit;
    // then idle past the broker's grant step (the TCP fleet's shape)
    for (uint32_t j = 0; j < n_pubs; j++)
      publish_one(conns[n_subs + j], 0, 0);
    uint64_t settle = NowNs() + 800ull * 1000000ull;
    while (NowNs() < settle) pump(50);
    received = acks = 0;
    lat.clear();
  }

  // windowed blast: total outstanding (unacked for qos1, undelivered
  // for qos0-with-subs) capped at `window`
  std::vector<uint32_t> next_msg(n_pubs, 0);
  uint64_t t0 = NowNs();
  uint64_t last_progress = t0;
  uint64_t last_seen = 0;
  uint16_t mid = 1;
  while (true) {
    bool done_sending = true;
    uint64_t progress = qos ? acks : (n_subs ? received : sent);
    for (uint32_t j = 0; j < n_pubs; j++) {
      SnLgConn& c = conns[n_subs + j];
      uint32_t burst = 0;
      while (next_msg[j] < msgs_per_pub && sent - progress < window &&
             burst++ < 64) {
        mid = mid == 0xFFFF ? 1 : mid + 1;
        publish_one(c, qos, mid);
        next_msg[j]++;
        sent++;
      }
      if (next_msg[j] < msgs_per_pub) done_sending = false;
    }
    bool complete = done_sending &&
                    (qos ? acks >= expected : true) &&
                    (n_subs ? received >= expected : true);
    if (complete) break;
    if (!pump(done_sending ? 50 : 1)) break;
    uint64_t seen = received + acks;
    uint64_t now = NowNs();
    if (seen != last_seen) {
      last_seen = seen;
      last_progress = now;
    } else if (now - last_progress >
               static_cast<uint64_t>(idle_timeout_ms) * 1000000ull) {
      break;  // stalled (datagram loss): report what we have
    }
  }
  uint64_t wall = NowNs() - t0;

  uint64_t p50 = 0, p99 = 0, mx = 0;
  if (!lat.empty()) {
    size_t i50 = lat.size() / 2;
    size_t i99 = lat.size() * 99 / 100;
    if (i99 >= lat.size()) i99 = lat.size() - 1;
    std::nth_element(lat.begin(), lat.begin() + i50, lat.end());
    p50 = lat[i50];
    std::nth_element(lat.begin(), lat.begin() + i99, lat.end());
    p99 = lat[i99];
    mx = *std::max_element(lat.begin(), lat.end());
  }
  out[0] = sent;
  out[1] = received;
  out[2] = wall;
  out[3] = p50;
  out[4] = p99;
  out[5] = mx;
  out[6] = acks;
  out[7] = errors;
  cleanup();
  return 0;
}

// -- conn-scale herd (round 16) --------------------------------------------
//
// The C10M axis the fleet above cannot exercise: N mostly-idle conns
// that connect in a storm, then just sit there honoring staggered
// keepalives while a (separate, small) loadgen fleet measures fan-out
// throughput against the same broker. Per-conn state is deliberately
// tiny (the herd itself must not be the memory story it measures) and
// PINGREQ->PINGRESP round trips are the keepalive-latency probe: the
// bench's "keepalive p99 honored" gate is this herd's ping RTT p99
// plus zero broker-initiated closes during the hold.
//
// ctypes releases the GIL for the whole call; `live` is a 4-slot
// progress surface the caller polls from Python (connacked, errors,
// pings, broker_closes) and `stop` ends the hold early.

int emqx_loadgen_conn_scale(const char* host, uint16_t port,
                            uint32_t n_conns, uint32_t burst,
                            uint16_t keepalive_s, uint32_t sub_every,
                            uint32_t hold_ms, int proto_ver,
                            volatile int32_t* stop,
                            volatile uint64_t* live, uint64_t* out) {
  struct HerdConn {
    int fd = -1;
    // 0 = TCP connecting (awaiting writability), 1 = CONNECT sent
    // (awaiting CONNACK), 2 = up, 3 = dead
    uint8_t state = 0;
    uint64_t ping_t0 = 0;       // outstanding PINGREQ stamp (0 = none)
    uint64_t next_ping_ms = 0;  // staggered schedule
    std::string inbuf;          // partial-frame carry (tiny)
  };
  if (burst == 0) burst = 512;
  int ep = epoll_create1(EPOLL_CLOEXEC);
  if (ep < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(ep);
    return -2;
  }
  std::vector<HerdConn> conns(n_conns);
  std::vector<uint64_t> rtts;
  uint64_t t_start = NowNs();
  uint64_t connacked = 0, errors = 0, pings = 0, closes = 0;
  uint32_t started = 0;
  uint64_t ka_ms = static_cast<uint64_t>(keepalive_s) * 1000;
  auto now_ms = []() { return NowNs() / 1000000ull; };
  auto fail = [&](HerdConn& c) {
    if (c.fd >= 0) close(c.fd);
    c.fd = -1;
    if (c.state == 2) closes++;
    c.state = 3;
    errors++;
    if (live) {
      live[1] = errors;
      live[3] = closes;
    }
  };
  // minimal inbound machine: split frames (1-byte varints cover every
  // packet the herd can see except a delivered PUBLISH, which it skips
  // with the full varint), count CONNACK/PINGRESP
  auto ingest = [&](uint32_t idx, const uint8_t* data, size_t len) {
    HerdConn& c = conns[idx];
    c.inbuf.append(reinterpret_cast<const char*>(data), len);
    size_t pos = 0;
    while (true) {
      if (c.inbuf.size() - pos < 2) break;
      size_t hp = pos + 1;
      uint32_t rem = 0, mult = 1;
      bool done = false, bad = false;
      while (hp < c.inbuf.size()) {
        uint8_t b = static_cast<uint8_t>(c.inbuf[hp++]);
        rem += (b & 0x7F) * mult;
        if (!(b & 0x80)) {
          done = true;
          break;
        }
        if (mult > 128u * 128u * 128u) {
          bad = true;
          break;
        }
        mult *= 128;
      }
      if (bad) {
        fail(c);
        return;
      }
      if (!done || c.inbuf.size() - hp < rem) break;
      uint8_t type = static_cast<uint8_t>(c.inbuf[pos]) >> 4;
      if (type == 2 && c.state == 1) {
        c.state = 2;
        connacked++;
        if (live) live[0] = connacked;
        uint64_t base = now_ms();
        // stagger first pings uniformly across one keepalive interval
        c.next_ping_ms =
            base + 1 + (ka_ms ? (static_cast<uint64_t>(idx) * ka_ms) /
                                    (n_conns ? n_conns : 1)
                              : 0);
        if (sub_every && idx % sub_every == 0) {
          std::string sub = Subscribe(
              1, "herd/" + std::to_string(idx), 0, proto_ver);
          if (send(c.fd, sub.data(), sub.size(), MSG_NOSIGNAL) < 0 &&
              errno != EAGAIN && errno != EWOULDBLOCK)
            fail(c);
        }
      } else if (type == 13 && c.ping_t0) {  // PINGRESP
        uint64_t rtt = NowNs() - c.ping_t0;
        c.ping_t0 = 0;
        rtts.push_back(rtt);
        pings++;
        if (live) live[2] = pings;
      }
      pos = hp + rem;
    }
    if (pos) c.inbuf.erase(0, pos);
  };
  // CONNECT goes out only once the TCP handshake completed (a send
  // right after a nonblocking connect() EAGAINs and would silently
  // strand the conn pre-CONNECT — measured as a ~40%% stall at 6k)
  auto send_connect = [&](uint32_t idx, HerdConn& c) {
    std::string body;
    PutU16(&body, 4);
    body += "MQTT";
    body.push_back(static_cast<char>(proto_ver));
    body.push_back(0x02);
    PutU16(&body, keepalive_s);
    if (proto_ver == 5) body.push_back('\0');
    std::string cid = "herd" + std::to_string(idx);
    PutU16(&body, static_cast<uint16_t>(cid.size()));
    body += cid;
    std::string f;
    f.push_back(0x10);
    PutVarint(&f, body.size());
    f += body;
    if (send(c.fd, f.data(), f.size(), MSG_NOSIGNAL) !=
        static_cast<ssize_t>(f.size())) {
      fail(c);
      return;
    }
    c.state = 1;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = idx;
    epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
  };
  auto pump = [&](int timeout_ms) {
    epoll_event evs[256];
    int n = epoll_wait(ep, evs, 256, timeout_ms);
    uint8_t chunk[16 * 1024];
    for (int i = 0; i < n; i++) {
      uint32_t idx = evs[i].data.u32;
      HerdConn& c = conns[idx];
      if (c.fd < 0) continue;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        fail(c);
        continue;
      }
      if ((evs[i].events & EPOLLOUT) && c.state == 0) {
        int err = 0;
        socklen_t el = sizeof(err);
        getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &el);
        if (err) {
          fail(c);
          continue;
        }
        send_connect(idx, c);
        if (c.fd < 0) continue;
      }
      if (!(evs[i].events & EPOLLIN)) continue;
      for (;;) {
        ssize_t r = recv(c.fd, chunk, sizeof(chunk), 0);
        if (r > 0) {
          ingest(idx, chunk, static_cast<size_t>(r));
          if (c.fd < 0 || static_cast<size_t>(r) < sizeof(chunk)) break;
        } else if (r == 0) {
          fail(c);
          break;
        } else {
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          if (errno == EINTR) continue;
          fail(c);
          break;
        }
      }
    }
  };
  // the keepalive service: runs during the STORM too — a large herd's
  // connect phase can outlast a keepalive interval, and the broker's
  // wheel shows no mercy to a client that negotiated one and went mute
  uint64_t next_ping_scan = 0;
  auto service_pings = [&]() {
    if (!ka_ms) return;
    uint64_t t = now_ms();
    // the herd must not become its own O(N)-per-pump sweep: ping
    // deadlines have second granularity, so a 250ms scan cadence
    // keeps the fleet honest without stealing the (possibly single)
    // core from the broker under measurement
    if (t < next_ping_scan) return;
    next_ping_scan = t + 250;
    for (uint32_t i = 0; i < started; i++) {
      HerdConn& c = conns[i];
      if (c.state != 2 || c.fd < 0 || t < c.next_ping_ms) continue;
      uint8_t pingreq[2] = {0xC0, 0x00};
      ssize_t w = send(c.fd, pingreq, 2, MSG_NOSIGNAL);
      if (w == 2) {
        if (!c.ping_t0) c.ping_t0 = NowNs();
        c.next_ping_ms = t + ka_ms;
      } else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK) {
        fail(c);
      } else {
        c.next_ping_ms = t + 50;  // backpressured: retry shortly
      }
    }
  };
  // connect storm, paced at `burst` initiations per pump cycle
  uint64_t connect_deadline =
      now_ms() + 60000 + static_cast<uint64_t>(n_conns) / 10;
  while (started < n_conns || connacked + errors < started) {
    uint32_t launched = 0;
    while (started < n_conns && launched < burst) {
      uint32_t i = started++;
      launched++;
      HerdConn& c = conns[i];
      c.fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
      if (c.fd < 0) {
        c.state = 3;
        errors++;
        continue;
      }
      int rc = connect(c.fd, reinterpret_cast<sockaddr*>(&addr),
                       sizeof(addr));
      if (rc < 0 && errno != EINPROGRESS) {
        fail(c);
        continue;
      }
      epoll_event ev{};
      // writability = handshake done; send_connect flips to EPOLLIN
      ev.events = EPOLLIN | EPOLLOUT;
      ev.data.u32 = i;
      epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
      if (rc == 0) send_connect(i, c);  // loopback same-call completion
    }
    pump(5);
    service_pings();
    if (stop && *stop) break;
    if (now_ms() > connect_deadline) break;
  }
  uint64_t peak = connacked;
  // hold: idle herd honoring staggered keepalives
  uint64_t hold_end = now_ms() + hold_ms;
  while ((stop == nullptr || !*stop) && now_ms() < hold_end) {
    pump(20);
    service_pings();
  }
  for (auto& c : conns)
    if (c.fd >= 0) close(c.fd);
  close(ep);
  std::sort(rtts.begin(), rtts.end());
  auto pct = [&](double q) -> uint64_t {
    if (rtts.empty()) return 0;
    size_t k = static_cast<size_t>(q * (rtts.size() - 1));
    return rtts[k];
  };
  out[0] = peak;
  out[1] = errors;
  out[2] = pings;
  out[3] = pct(0.50);
  out[4] = pct(0.99);
  out[5] = rtts.empty() ? 0 : rtts.back();
  out[6] = NowNs() - t_start;
  out[7] = closes;
  return 0;
}

// -- CoAP observer/publisher fleet (round 19) --------------------------------
//
// The coap-bench client: observers GET+Observe /ps/lgc/<i> topics,
// publishers POST to them — NON for qos0 (deliveries counted at the
// observers), CON with ?qos=1 for qos1 (the 2.04 acks gate the
// window). Speaks the SHARED coap.h codec, so the same fleet drives
// the native listener and the asyncio gateway/coap.py with identical
// wire traffic and identical pacing (the SN bench discipline). CoAP
// forbids packing messages into one datagram, so the syscall
// amortization is sendmmsg/recvmmsg batches of WHOLE datagrams.
// `fanout` puts every observer on ONE topic (the fan-out arm).
//
// out[8]: sent, received, wall_ns, p50_ns, p99_ns, max_ns, acks, errors
int emqx_loadgen_run_coap(const char* host, uint16_t port, uint32_t n_subs,
                          uint32_t n_pubs, uint32_t msgs_per_pub,
                          uint8_t qos, uint32_t payload_len,
                          int idle_timeout_ms, uint32_t window, int warmup,
                          int fanout, uint64_t* out) {
  namespace lco = emqx_native::coap;
  if (window == 0) window = 256;
  uint32_t total = n_subs + n_pubs;
  struct CoapLg {
    int fd = -1;
    uint32_t idx = 0;
    bool is_sub = false;
    bool ready = false;       // observer: 2.05 seen; publisher: warm ack
    uint16_t mid = 0;
    std::vector<std::string> obuf;  // whole datagrams, sendmmsg-batched
  };
  std::vector<CoapLg> conns(total);
  int ep = epoll_create1(EPOLL_CLOEXEC);
  if (ep < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(ep);
    return -2;
  }
  uint64_t sent = 0, received = 0, acks = 0, errors = 0;
  std::vector<uint64_t> lat;
  lat.reserve(1 << 20);
  auto cleanup = [&]() {
    for (auto& c : conns)
      if (c.fd >= 0) close(c.fd);
    close(ep);
  };
  constexpr int kBatch = 32;
  auto flush_conn = [&](CoapLg& c) {
    size_t i = 0;
    while (i < c.obuf.size()) {
      mmsghdr mm[kBatch];
      iovec iov[kBatch];
      int n = 0;
      for (; n < kBatch && i + n < c.obuf.size(); n++) {
        iov[n].iov_base = const_cast<char*>(c.obuf[i + n].data());
        iov[n].iov_len = c.obuf[i + n].size();
        memset(&mm[n].msg_hdr, 0, sizeof(mm[n].msg_hdr));
        mm[n].msg_hdr.msg_iov = &iov[n];
        mm[n].msg_hdr.msg_iovlen = 1;
      }
      int sn2 = sendmmsg(c.fd, mm, n, MSG_NOSIGNAL);
      if (sn2 < 0) {
        if (errno == EINTR) continue;
        if (errno != EAGAIN && errno != EWOULDBLOCK) errors++;
        break;  // keep the tail for the next flush
      }
      i += static_cast<size_t>(sn2);
    }
    c.obuf.erase(c.obuf.begin(), c.obuf.begin() + i);
  };
  auto send_msg = [&](CoapLg& c, const lco::CoapMsg& m) {
    std::string dg;
    lco::Serialize(m, &dg);
    c.obuf.push_back(std::move(dg));
    if (c.obuf.size() >= kBatch) flush_conn(c);
  };
  auto topic_of = [&](uint32_t i) {
    return std::to_string(fanout ? 0 : (n_subs ? i % n_subs : 0));
  };
  auto make_req = [&](CoapLg& c, uint8_t type, uint8_t code,
                      const std::string& tseg) {
    lco::CoapMsg m;
    m.type = type;
    m.code = code;
    c.mid = c.mid == 0xFFFF ? 1 : c.mid + 1;
    m.mid = c.mid;
    if (c.is_sub) {
      m.token.push_back(static_cast<char>(c.idx >> 8));
      m.token.push_back(static_cast<char>(c.idx & 0xFF));
    }
    m.options.emplace_back(lco::kOptUriPath, "ps");
    m.options.emplace_back(lco::kOptUriPath, "lgc");
    m.options.emplace_back(lco::kOptUriPath, tseg);
    m.options.emplace_back(
        lco::kOptUriQuery,
        std::string("clientid=") + (c.is_sub ? "lgcs" : "lgcp") +
            std::to_string(c.idx));
    if (qos)
      m.options.emplace_back(lco::kOptUriQuery,
                             std::string("qos=") + char('0' + qos));
    return m;
  };

  for (uint32_t i = 0; i < total; i++) {
    CoapLg& c = conns[i];
    c.idx = i;
    c.is_sub = i < n_subs;
    c.fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (c.fd < 0 ||
        connect(c.fd, reinterpret_cast<sockaddr*>(&addr),
                sizeof(addr)) < 0) {
      cleanup();
      return -3;
    }
    int buf = 4 << 20;
    setsockopt(c.fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u32 = i;
    epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev);
  }

  // handshake: observers register (CON GET Observe:0 -> 2.05);
  // publishers send ONE CON warmup POST (earns the permit; the 2.04
  // proves the gateway session is up) — both planes, same shape
  auto kickoff = [&](CoapLg& c) {
    if (c.is_sub) {
      lco::CoapMsg m = make_req(c, lco::kCon, lco::kGet,
                                topic_of(c.idx));
      m.options.emplace_back(lco::kOptObserve, std::string());
      send_msg(c, m);
    } else {
      lco::CoapMsg m =
          make_req(c, lco::kCon, lco::kPost, topic_of(c.idx));
      m.payload.assign(8, '\0');  // zero stamp: never a latency sample
      send_msg(c, m);
    }
  };
  for (auto& c : conns) kickoff(c);

  uint8_t rxbuf[kBatch * 2048];
  auto pump = [&](int timeout_ms) {
    for (auto& c : conns) flush_conn(c);
    epoll_event evs[128];
    int n = epoll_wait(ep, evs, 128, timeout_ms);
    if (n < 0) return errno == EINTR;
    for (int i = 0; i < n; i++) {
      CoapLg& c = conns[evs[i].data.u32];
      if (c.fd < 0) continue;
      for (;;) {
        mmsghdr mm[kBatch];
        iovec iov[kBatch];
        for (int k = 0; k < kBatch; k++) {
          iov[k].iov_base = rxbuf + k * 2048;
          iov[k].iov_len = 2048;
          memset(&mm[k].msg_hdr, 0, sizeof(mm[k].msg_hdr));
          mm[k].msg_hdr.msg_iov = &iov[k];
          mm[k].msg_hdr.msg_iovlen = 1;
        }
        int r = recvmmsg(c.fd, mm, kBatch, 0, nullptr);
        if (r < 0) {
          if (errno == EINTR) continue;
          break;  // EAGAIN (or ICMP error: the next send surfaces it)
        }
        for (int k = 0; k < r; k++) {
          lco::CoapMsg m;
          if (!lco::Parse(rxbuf + k * 2048, mm[k].msg_len, &m)) continue;
          if (m.code == lco::kContent &&
              (m.type == lco::kCon || m.type == lco::kNon) &&
              m.Opt(lco::kOptObserve) != nullptr) {
            // an observe notification (the registration reply is an
            // ACK and lands in the branch below)
            if (m.type == lco::kCon) {
              lco::CoapMsg a;
              a.type = lco::kAck;
              a.mid = m.mid;
              send_msg(c, a);
            }
            if (m.payload.size() >= 8) {
              uint64_t stamp;
              memcpy(&stamp, m.payload.data(), 8);
              uint64_t now = NowNs();
              if (stamp && now > stamp &&
                  now - stamp < 60ull * 1000000000ull)
                lat.push_back(now - stamp);
            }
            received++;
          } else if (m.type == lco::kAck) {
            if (m.code == lco::kContent) {
              c.ready = true;  // observe registration accepted
            } else if (m.code == lco::kChanged) {
              if (!c.ready)
                c.ready = true;  // the warmup POST's ack
              else
                acks++;
            } else if (m.code >= 0x80) {
              errors++;
            }
          }
        }
        if (r < kBatch) break;
      }
      flush_conn(c);
    }
    return true;
  };

  uint64_t deadline = NowNs() + 15ull * 1000000000ull;
  bool retried = false;
  auto all_ready = [&]() {
    for (auto& c : conns)
      if (!c.ready) return false;
    return true;
  };
  while (!all_ready()) {
    if (NowNs() > deadline || !pump(100)) {
      cleanup();
      return -5;
    }
    if (!retried && NowNs() > deadline - 7ull * 1000000000ull) {
      retried = true;  // one datagram-loss resend sweep
      for (auto& c : conns)
        if (!c.ready) kickoff(c);
    }
  }
  if (warmup) {
    // idle past the broker's permit-grant step (the SN fleet's shape)
    uint64_t settle = NowNs() + 800ull * 1000000ull;
    while (NowNs() < settle) pump(50);
    received = acks = 0;
    lat.clear();
  }

  uint64_t expected = static_cast<uint64_t>(n_pubs) * msgs_per_pub;
  uint64_t expect_rx = fanout ? expected * n_subs : expected;
  std::string pad(payload_len > 8 ? payload_len - 8 : 0, 'x');
  std::vector<uint32_t> next_msg(n_pubs, 0);
  uint64_t t0 = NowNs();
  uint64_t last_progress = t0;
  uint64_t last_seen = 0;
  bool stalled = false;
  while (true) {
    bool done_sending = true;
    uint64_t progress = qos ? acks : (n_subs ? received : sent);
    uint64_t scale = (!qos && n_subs && fanout) ? n_subs : 1;
    for (uint32_t j = 0; j < n_pubs; j++) {
      CoapLg& c = conns[n_subs + j];
      uint32_t burst = 0;
      while (next_msg[j] < msgs_per_pub &&
             sent - progress / scale < window && burst++ < 64) {
        lco::CoapMsg m = make_req(c, qos ? lco::kCon : lco::kNon,
                                  lco::kPost, topic_of(c.idx));
        uint64_t stamp = NowNs();
        m.payload.assign(reinterpret_cast<char*>(&stamp), 8);
        m.payload += pad;
        send_msg(c, m);
        next_msg[j]++;
        sent++;
      }
      if (next_msg[j] < msgs_per_pub) done_sending = false;
    }
    bool complete = done_sending && (qos ? acks >= expected : true) &&
                    (n_subs ? received >= expect_rx : true);
    if (complete) break;
    if (!pump(done_sending ? 50 : 1)) break;
    uint64_t seen = received + acks;
    uint64_t now = NowNs();
    if (seen != last_seen) {
      last_seen = seen;
      last_progress = now;
    } else if (now - last_progress >
               static_cast<uint64_t>(idle_timeout_ms) * 1000000ull) {
      // stalled (datagram loss): report what we have — measured to
      // the LAST progress stamp, so the dead idle-timeout tail never
      // deflates the rate (which would flatter whichever arm runs
      // against the lossier plane)
      stalled = true;
      break;
    }
  }
  uint64_t wall = (stalled ? last_progress : NowNs()) - t0;
  if (wall == 0) wall = 1;
  uint64_t p50 = 0, p99 = 0, mx = 0;
  if (!lat.empty()) {
    size_t i50 = lat.size() / 2;
    size_t i99 = lat.size() * 99 / 100;
    if (i99 >= lat.size()) i99 = lat.size() - 1;
    std::nth_element(lat.begin(), lat.begin() + i50, lat.end());
    p50 = lat[i50];
    std::nth_element(lat.begin(), lat.begin() + i99, lat.end());
    p99 = lat[i99];
    mx = *std::max_element(lat.begin(), lat.end());
  }
  out[0] = sent;
  out[1] = received;
  out[2] = wall;
  out[3] = p50;
  out[4] = p99;
  out[5] = mx;
  out[6] = acks;
  out[7] = errors;
  cleanup();
  return 0;
}

}  // extern "C"
