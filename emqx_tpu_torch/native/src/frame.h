// Incremental MQTT frame splitter — the C++ twin of the Python
// Parser state machine in emqx_tpu/mqtt/frame.py (itself the analogue of
// the reference's varint remaining-length machine, emqx_frame.erl:163-217).
//
// This layer only *frames*: it finds packet boundaries and hands complete
// frames (fixed header byte + remaining-length + body) upward. Semantic
// packet parsing stays in Python / on device.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace emqx_native {

enum class FrameStatus : int {
  kOk = 0,
  kBadType = 1,       // fixed-header type nibble 0
  kVarintTooLong = 2, // >4 continuation bytes
  kTooLarge = 3,      // remaining length above max_size
};

// One connection's resumable framing state.
class Framer {
 public:
  explicit Framer(uint32_t max_size = 0x0FFFFFFF) : max_size_(max_size) {}

  // Feed a chunk; append each complete frame (header..body, verbatim
  // wire bytes) to `out`. Returns kOk or the first framing error, at
  // which point the connection must be dropped (state is poisoned).
  FrameStatus Feed(const uint8_t* data, size_t len,
                   std::vector<std::string>* out) {
    size_t pos = 0;
    while (pos < len) {
      switch (phase_) {
        case Phase::kHeader: {
          uint8_t h = data[pos++];
          if ((h >> 4) == 0) return FrameStatus::kBadType;
          frame_.clear();
          frame_.push_back(static_cast<char>(h));
          len_value_ = 0;
          len_mult_ = 1;
          phase_ = Phase::kLength;
          break;
        }
        case Phase::kLength: {
          uint8_t b = data[pos++];
          frame_.push_back(static_cast<char>(b));
          len_value_ += static_cast<uint32_t>(b & 0x7F) * len_mult_;
          if (b & 0x80) {
            if (len_mult_ > 128u * 128u * 128u)
              return FrameStatus::kVarintTooLong;
            len_mult_ *= 128;
          } else {
            if (len_value_ > max_size_) return FrameStatus::kTooLarge;
            need_ = len_value_;
            if (need_ == 0) {
              out->push_back(frame_);
              phase_ = Phase::kHeader;
            } else {
              phase_ = Phase::kBody;
            }
          }
          break;
        }
        case Phase::kBody: {
          size_t take = std::min(static_cast<size_t>(need_), len - pos);
          frame_.append(reinterpret_cast<const char*>(data + pos), take);
          pos += take;
          need_ -= static_cast<uint32_t>(take);
          if (need_ == 0) {
            out->push_back(frame_);
            frame_.clear();
            phase_ = Phase::kHeader;
          }
          break;
        }
      }
    }
    return FrameStatus::kOk;
  }

  // No partial frame buffered — the conn-scale park plane only
  // hibernates a conn whose framer sits at a packet boundary (a
  // parked conn's framer is dropped and rebuilt at inflation).
  bool idle() const { return phase_ == Phase::kHeader; }

 private:
  enum class Phase { kHeader, kLength, kBody };
  uint32_t max_size_;
  Phase phase_ = Phase::kHeader;
  std::string frame_;
  uint32_t len_value_ = 0;
  uint32_t len_mult_ = 1;
  uint32_t need_ = 0;
};

}  // namespace emqx_native
