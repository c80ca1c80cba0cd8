// Snappy block-format codec (compress + decompress), C ABI for ctypes.
//
// The reference pulls compression in through the `snappyer` NIF (a C
// binding of google/snappy) for Kafka record batches (SURVEY.md §2.4);
// this is a from-scratch implementation of the same wire format
// (format_description.txt): varint uncompressed length, then a tag
// stream of literals and copies with 1/2/4-byte offsets.
//
// Greedy matcher over a 4-byte hash table — the same structure as the
// format's reference implementation, sized for broker payloads (KB,
// not GB): offsets fit 32 bits, one block per call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash32(uint32_t v, int shift) {
  return (v * 0x1e35a7bdu) >> shift;
}

inline uint8_t* emit_varint(uint8_t* dst, uint32_t n) {
  while (n >= 0x80) {
    *dst++ = static_cast<uint8_t>(n) | 0x80;
    n >>= 7;
  }
  *dst++ = static_cast<uint8_t>(n);
  return dst;
}

inline uint8_t* emit_literal(uint8_t* dst, const uint8_t* src, long len) {
  long n = len - 1;
  if (n < 60) {
    *dst++ = static_cast<uint8_t>(n << 2);
  } else {
    int bytes = (n < (1 << 8)) ? 1 : (n < (1 << 16)) ? 2
               : (n < (1 << 24)) ? 3 : 4;
    *dst++ = static_cast<uint8_t>((59 + bytes) << 2);
    for (int i = 0; i < bytes; i++) *dst++ = (n >> (8 * i)) & 0xff;
  }
  std::memcpy(dst, src, len);
  return dst + len;
}

// one copy element, 4 <= len <= 64
inline uint8_t* emit_copy_chunk(uint8_t* dst, uint32_t offset, long len) {
  if (len <= 11 && offset < 2048) {
    *dst++ = 0x01 | ((len - 4) << 2) | ((offset >> 8) << 5);
    *dst++ = offset & 0xff;
  } else if (offset < (1u << 16)) {
    *dst++ = 0x02 | ((len - 1) << 2);
    *dst++ = offset & 0xff;
    *dst++ = (offset >> 8) & 0xff;
  } else {
    *dst++ = 0x03 | ((len - 1) << 2);
    for (int i = 0; i < 4; i++) *dst++ = (offset >> (8 * i)) & 0xff;
  }
  return dst;
}

inline uint8_t* emit_copy(uint8_t* dst, uint32_t offset, long len) {
  // >64 splits; keep every chunk >= 4 by emitting 60s first
  while (len > 64) {
    dst = emit_copy_chunk(dst, offset, 60);
    len -= 60;
  }
  return emit_copy_chunk(dst, offset, len);
}

}  // namespace

extern "C" {

long emqx_snappy_max_compressed(long n) { return 32 + n + n / 6; }

// -> bytes written, or -1 if `cap` would be exceeded (the caller falls
// back; emits never write past dst+cap)
long emqx_snappy_compress(const uint8_t* src, long n, uint8_t* dst,
                          long cap) {
  if (cap < 8) return -1;
  uint8_t* out = emit_varint(dst, static_cast<uint32_t>(n));
  if (n == 0) return out - dst;
  const uint8_t* dend = dst + cap;

  int shift = 18;  // 16k-entry table
  std::vector<int32_t> table(1 << (32 - shift), -1);

  long i = 0, lit = 0;
  while (i + 4 <= n) {
    uint32_t v = load32(src + i);
    uint32_t h = hash32(v, shift);
    int32_t cand = table[h];
    table[h] = static_cast<int32_t>(i);
    if (cand >= 0 && load32(src + cand) == v) {
      long len = 4;
      while (i + len < n && src[cand + len] == src[i + len]) len++;
      // only cost-effective copies: a 5-byte copy4 tag for a 4-byte
      // match would EXPAND the stream (and break the size bound)
      if (static_cast<uint32_t>(i - cand) >= (1u << 16) && len < 8) {
        i++;
        continue;
      }
      // worst emit: literal (5-byte header) + split copies
      if (out + (i - lit) + 5 + (len / 60 + 1) * 5 > dend) return -1;
      if (lit < i) out = emit_literal(out, src + lit, i - lit);
      out = emit_copy(out, static_cast<uint32_t>(i - cand), len);
      i += len;
      lit = i;
    } else {
      i++;
    }
  }
  if (lit < n) {
    if (out + (n - lit) + 5 > dend) return -1;
    out = emit_literal(out, src + lit, n - lit);
  }
  return out - dst;
}

long emqx_snappy_uncompressed_length(const uint8_t* src, long n) {
  uint32_t len = 0;
  int shift = 0;
  long pos = 0;
  while (pos < n && shift < 35) {
    uint8_t b = src[pos++];
    len |= static_cast<uint32_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) return static_cast<long>(len);
    shift += 7;
  }
  return -1;
}

// -> bytes written, or -1 on malformed input / capacity overflow
long emqx_snappy_decompress(const uint8_t* src, long n, uint8_t* dst,
                            long cap) {
  long pos = 0;
  {  // skip the length varint (validated by caller via _uncompressed_length)
    while (pos < n && (src[pos] & 0x80)) pos++;
    if (pos >= n) return -1;
    pos++;
  }
  long w = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    if ((tag & 0x03) == 0x00) {  // literal
      long len = (tag >> 2) + 1;
      if (len > 60) {
        int bytes = static_cast<int>(len - 60);
        if (pos + bytes > n) return -1;
        len = 0;
        for (int k = 0; k < bytes; k++)
          len |= static_cast<long>(src[pos + k]) << (8 * k);
        len += 1;
        pos += bytes;
      }
      if (pos + len > n || w + len > cap) return -1;
      std::memcpy(dst + w, src + pos, len);
      pos += len;
      w += len;
    } else {
      long len;
      uint32_t offset;
      if ((tag & 0x03) == 0x01) {
        if (pos + 1 > n) return -1;
        len = ((tag >> 2) & 0x07) + 4;
        offset = (static_cast<uint32_t>(tag >> 5) << 8) | src[pos];
        pos += 1;
      } else if ((tag & 0x03) == 0x02) {
        if (pos + 2 > n) return -1;
        len = (tag >> 2) + 1;
        offset = src[pos] | (static_cast<uint32_t>(src[pos + 1]) << 8);
        pos += 2;
      } else {
        if (pos + 4 > n) return -1;
        len = (tag >> 2) + 1;
        offset = src[pos] | (static_cast<uint32_t>(src[pos + 1]) << 8) |
                 (static_cast<uint32_t>(src[pos + 2]) << 16) |
                 (static_cast<uint32_t>(src[pos + 3]) << 24);
        pos += 4;
      }
      if (offset == 0 || offset > static_cast<uint32_t>(w) ||
          w + len > cap)
        return -1;
      // byte-by-byte: overlapping copies (offset < len) replicate
      for (long k = 0; k < len; k++) dst[w + k] = dst[w + k - offset];
      w += len;
    }
  }
  return w;
}

}  // extern "C"
