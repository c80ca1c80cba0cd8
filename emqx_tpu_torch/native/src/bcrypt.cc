// bcrypt (OpenBSD Blowfish password hashing) — the reference lists
// bcrypt as a native dep (mix.exs:635, used by
// emqx_authn_password_hashing.erl); the image ships no bcrypt wheel, so
// this is the from-scratch C++ primitive behind access/hashing.py.
//
// Two deliberate design points:
//
// 1. The Blowfish P-array and S-boxes are the first 18+1024 words of
//    the hexadecimal expansion of pi. Instead of embedding a 4 KiB
//    constant blob, InitTables() COMPUTES them at first use with a
//    fixed-point Machin formula (pi = 16*atan(1/5) - 4*atan(1/239))
//    over a little-endian u32 bignum — ~50 ms once, then cached. The
//    first word is asserted against the universally known 0x243F6A88.
//
// 2. The EksBlowfish schedule follows the OpenBSD structure
//    (Blowfish_expandstate / expand0state; bcrypt_hashpass): state
//    seeded from pi, salted expansion, then 2^cost alternating
//    key/salt expansions, then "OrpheanBeholderScryDoubt" enciphered
//    64 times; 23 of 24 output bytes are emitted in bcrypt's own
//    base64 alphabet. Verified against the published John-the-Ripper /
//    OpenBSD test vectors (tests/test_bcrypt.py).

#include <string.h>

#include <cstdint>
#include <cstdio>
#include <mutex>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// pi hex digits via fixed-point Machin

constexpr int kPiWords = 18 + 1024;  // P + 4 S-boxes
constexpr int kGuard = 2;            // truncation-guard limbs

// value is sum(limb[i] * 2^(32 i)); fixed size, little-endian
using Big = std::vector<uint32_t>;

void DivSmall(Big* a, uint32_t d) {
  uint64_t rem = 0;
  for (int i = static_cast<int>(a->size()) - 1; i >= 0; i--) {
    uint64_t cur = (rem << 32) | (*a)[i];
    (*a)[i] = static_cast<uint32_t>(cur / d);
    rem = cur % d;
  }
}

void AddInto(Big* a, const Big& b) {
  uint64_t carry = 0;
  for (size_t i = 0; i < a->size(); i++) {
    uint64_t cur = static_cast<uint64_t>((*a)[i]) + b[i] + carry;
    (*a)[i] = static_cast<uint32_t>(cur);
    carry = cur >> 32;
  }
}

void SubFrom(Big* a, const Big& b) {
  int64_t borrow = 0;
  for (size_t i = 0; i < a->size(); i++) {
    int64_t cur = static_cast<int64_t>((*a)[i]) - b[i] - borrow;
    borrow = cur < 0;
    (*a)[i] = static_cast<uint32_t>(cur + (borrow ? (1ll << 32) : 0));
  }
}

void MulSmall(Big* a, uint32_t m) {
  uint64_t carry = 0;
  for (size_t i = 0; i < a->size(); i++) {
    uint64_t cur = static_cast<uint64_t>((*a)[i]) * m + carry;
    (*a)[i] = static_cast<uint32_t>(cur);
    carry = cur >> 32;
  }
}

bool IsZero(const Big& a) {
  for (uint32_t w : a)
    if (w) return false;
  return true;
}

// atan(1/x) * 2^(32*(n-1)) for an n-limb working size (the top limb
// holds the integer part, which is 0 for x >= 2)
Big AtanInv(uint32_t x, size_t n) {
  Big term(n, 0);
  term[n - 1] = 1;                       // 1.0 in fixed point
  DivSmall(&term, x);                    // 1/x
  Big sum = term;
  uint32_t x2 = x * x;
  bool add = false;                      // next op after the first term
  for (uint32_t k = 3;; k += 2) {
    DivSmall(&term, x2);
    if (IsZero(term)) break;
    Big t = term;
    DivSmall(&t, k);
    if (add)
      AddInto(&sum, t);
    else
      SubFrom(&sum, t);
    add = !add;
  }
  return sum;
}

const uint32_t* PiWords() {
  static uint32_t words[kPiWords];
  static std::once_flag once;
  std::call_once(once, [] {
    size_t n = kPiWords + kGuard + 1;    // +1 limb for the integer part
    Big pi = AtanInv(5, n);
    MulSmall(&pi, 16);
    Big a239 = AtanInv(239, n);
    MulSmall(&a239, 4);
    SubFrom(&pi, a239);
    // integer part (3) lives in the top limb; the fraction's hex
    // digits follow MSB-first in the limbs below it
    for (int i = 0; i < kPiWords; i++)
      words[i] = pi[n - 2 - i];
    // the one constant everybody knows: P[0] = first 8 hex digits
    if (words[0] != 0x243F6A88u)
      words[0] = 0;  // poison => every vector test fails loudly
  });
  return words;
}

// ---------------------------------------------------------------------------
// Blowfish / EksBlowfish (OpenBSD structure)

struct BlfState {
  uint32_t P[18];
  uint32_t S[4][256];
};

inline uint32_t F(const BlfState& s, uint32_t x) {
  return ((s.S[0][x >> 24] + s.S[1][(x >> 16) & 0xFF]) ^
          s.S[2][(x >> 8) & 0xFF]) +
         s.S[3][x & 0xFF];
}

void Encipher(const BlfState& s, uint32_t* xl, uint32_t* xr) {
  uint32_t Xl = *xl ^ s.P[0];
  uint32_t Xr = *xr;
  for (int i = 1; i <= 16; i += 2) {
    Xr ^= F(s, Xl) ^ s.P[i];
    Xl ^= F(s, Xr) ^ s.P[i + 1];
  }
  *xl = Xr ^ s.P[17];
  *xr = Xl;
}

void InitState(BlfState* s) {
  const uint32_t* w = PiWords();
  memcpy(s->P, w, sizeof(s->P));
  memcpy(s->S, w + 18, sizeof(s->S));
}

// big-endian cyclic word stream over a byte buffer
inline uint32_t Stream2Word(const uint8_t* data, size_t len, size_t* j) {
  uint32_t w = 0;
  for (int i = 0; i < 4; i++) {
    w = (w << 8) | data[*j];
    *j = (*j + 1) % len;
  }
  return w;
}

void ExpandState(BlfState* s, const uint8_t* salt, size_t salt_len,
                 const uint8_t* key, size_t key_len) {
  size_t j = 0;
  for (int i = 0; i < 18; i++) s->P[i] ^= Stream2Word(key, key_len, &j);
  j = 0;
  uint32_t L = 0, R = 0;
  for (int i = 0; i < 18; i += 2) {
    L ^= Stream2Word(salt, salt_len, &j);
    R ^= Stream2Word(salt, salt_len, &j);
    Encipher(*s, &L, &R);
    s->P[i] = L;
    s->P[i + 1] = R;
  }
  for (int b = 0; b < 4; b++) {
    for (int i = 0; i < 256; i += 2) {
      L ^= Stream2Word(salt, salt_len, &j);
      R ^= Stream2Word(salt, salt_len, &j);
      Encipher(*s, &L, &R);
      s->S[b][i] = L;
      s->S[b][i + 1] = R;
    }
  }
}

void Expand0State(BlfState* s, const uint8_t* key, size_t key_len) {
  size_t j = 0;
  for (int i = 0; i < 18; i++) s->P[i] ^= Stream2Word(key, key_len, &j);
  uint32_t L = 0, R = 0;
  for (int i = 0; i < 18; i += 2) {
    Encipher(*s, &L, &R);
    s->P[i] = L;
    s->P[i + 1] = R;
  }
  for (int b = 0; b < 4; b++) {
    for (int i = 0; i < 256; i += 2) {
      Encipher(*s, &L, &R);
      s->S[b][i] = L;
      s->S[b][i + 1] = R;
    }
  }
}

// ---------------------------------------------------------------------------
// bcrypt proper

const char kB64[] =
    "./ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789";

int B64Index(char c) {
  for (int i = 0; i < 64; i++)
    if (kB64[i] == c) return i;
  return -1;
}

// bcrypt base64: 22 chars -> 16 bytes (salt)
bool DecodeSalt(const char* s22, uint8_t out[16]) {
  int bits = 0, acc = 0, n = 0;
  for (int i = 0; i < 22; i++) {
    int v = B64Index(s22[i]);
    if (v < 0) return false;
    acc = (acc << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      if (n < 16) out[n++] = static_cast<uint8_t>((acc >> bits) & 0xFF);
    }
  }
  return n == 16;
}

void EncodeB64(const uint8_t* data, int len, char* out) {
  int bits = 0, acc = 0, n = 0;
  for (int i = 0; i < len; i++) {
    acc = (acc << 8) | data[i];
    bits += 8;
    while (bits >= 6) {
      bits -= 6;
      out[n++] = kB64[(acc >> bits) & 0x3F];
    }
  }
  if (bits) out[n++] = kB64[(acc << (6 - bits)) & 0x3F];
  out[n] = '\0';
}

}  // namespace

extern "C" {

// setting: "$2a$NN$<22-char salt>" (or $2b/$2y — identical for keys
// <= 72 bytes, which the caller enforces); out must hold >= 61 bytes.
// Returns 0 on success.
int emqx_bcrypt_hash(const uint8_t* password, size_t pw_len,
                     const char* setting, char* out) {
  if (strlen(setting) < 29 || setting[0] != '$' || setting[3] != '$' ||
      setting[6] != '$')
    return -1;
  char minor = setting[2];
  if (setting[1] != '2' ||
      (minor != 'a' && minor != 'b' && minor != 'y'))
    return -1;
  int cost = (setting[4] - '0') * 10 + (setting[5] - '0');
  if (cost < 4 || cost > 31) return -2;
  uint8_t salt[16];
  if (!DecodeSalt(setting + 7, salt)) return -3;
  if (pw_len > 72) pw_len = 72;

  // key = password + trailing NUL (the $2a/$2b convention)
  std::vector<uint8_t> key(pw_len + 1);
  memcpy(key.data(), password, pw_len);
  key[pw_len] = 0;

  BlfState s;
  InitState(&s);
  ExpandState(&s, salt, 16, key.data(), key.size());
  for (uint64_t k = 0; k < (1ull << cost); k++) {
    Expand0State(&s, key.data(), key.size());
    Expand0State(&s, salt, 16);
  }

  static const char kMagic[] = "OrpheanBeholderScryDoubt";  // 24 bytes
  uint32_t cdata[6];
  size_t j = 0;
  for (int i = 0; i < 6; i++)
    cdata[i] = Stream2Word(reinterpret_cast<const uint8_t*>(kMagic), 24, &j);
  for (int k = 0; k < 64; k++)
    for (int i = 0; i < 6; i += 2) Encipher(s, &cdata[i], &cdata[i + 1]);

  uint8_t digest[24];
  for (int i = 0; i < 6; i++) {
    digest[4 * i] = static_cast<uint8_t>(cdata[i] >> 24);
    digest[4 * i + 1] = static_cast<uint8_t>(cdata[i] >> 16);
    digest[4 * i + 2] = static_cast<uint8_t>(cdata[i] >> 8);
    digest[4 * i + 3] = static_cast<uint8_t>(cdata[i]);
  }
  memcpy(out, setting, 29);
  out[29] = '\0';
  EncodeB64(digest, 23, out + 29);      // bcrypt drops the 24th byte
  return 0;
}

// 16 random bytes -> "$2b$NN$<22 chars>" (caller supplies entropy so
// this stays a pure function; out >= 30 bytes)
int emqx_bcrypt_gensalt(int cost, const uint8_t rnd[16], char* out) {
  if (cost < 4 || cost > 31) return -1;
  snprintf(out, 8, "$2b$%02d$", cost);
  EncodeB64(rnd, 16, out + 7);
  return 0;
}

}  // extern "C"
