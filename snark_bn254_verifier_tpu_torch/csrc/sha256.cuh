// SHA-256 (FIPS 180-4) for one message per thread: the compression, a
// streaming context that takes bytes and words, the padding, and a start
// from a midstate, so a prefix that every lane shares is hashed once on
// the host. Kernel K7 (plonk.cuh) runs the PlonK transcript on it; the
// host build (host_check.cc) checks it against hashlib without a card.
//
// The context's block is 16 big-endian words, filled a byte at a time at
// a position that is the same on every lane of a batch (the messages have
// one layout), so the only branch, "the block is full", is taken by all
// lanes of a warp together: the compression is a __noinline__ function
// (one copy of its 64 unrolled rounds), and the rule of tower.cuh holds.
#pragma once

#include "fp.cuh"

BN_CONST uint32_t SHA256_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u,
    0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu,
    0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu,
    0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u,
    0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u, 0x90befffau, 0xa4506cebu, 0xbef9a3f7u,
    0xc67178f2u};

BN_CONST uint32_t SHA256_IV[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                                  0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};

BN_INLINE uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// h = the compression of h with one block of 16 big-endian words.
BN_NOINLINE void sha256_compress(uint32_t* h, const uint32_t* block) {
  uint32_t w[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) w[t] = block[t];
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint32_t t1 = hh + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                        ((e & f) ^ (~e & g)) + SHA256_K[t] + w[t & 15];
    const uint32_t t2 =
        (rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

struct sha256_ctx {
  uint32_t h[8];
  uint32_t w[16];  // the block being filled, big-endian words
  uint32_t n;      // its bytes so far
  uint32_t total;  // bytes hashed so far, the prefix of a midstate included
};

// Start from the state ``mid`` reached after ``prefix`` bytes, a whole
// number of blocks (SHA256_IV after none).
BN_INLINE void sha256_start(sha256_ctx& c, const uint32_t* mid, uint32_t prefix) {
#pragma unroll
  for (int j = 0; j < 8; ++j) c.h[j] = mid[j];
#pragma unroll
  for (int j = 0; j < 16; ++j) c.w[j] = 0;
  c.n = 0;
  c.total = prefix;
}

BN_INLINE void sha256_init(sha256_ctx& c) { sha256_start(c, SHA256_IV, 0); }

BN_INLINE void sha256_byte(sha256_ctx& c, uint32_t byte) {
  c.w[c.n >> 2] |= (byte & 0xFFu) << (24 - 8 * (c.n & 3));
  ++c.total;
  if (++c.n == 64) {
    sha256_compress(c.h, c.w);
    for (int j = 0; j < 16; ++j) c.w[j] = 0;
    c.n = 0;
  }
}

BN_INLINE void sha256_bytes(sha256_ctx& c, const uint8_t* p, int len) {
  for (int i = 0; i < len; ++i) sha256_byte(c, p[i]);
}

// A 32-bit word, big-endian (four bytes).
BN_INLINE void sha256_word(sha256_ctx& c, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) sha256_byte(c, v >> s);
}

// A 256-bit value of 8 little-endian words as its 32 big-endian bytes.
BN_INLINE void sha256_fp(sha256_ctx& c, const fp& v) {
  for (int k = NW - 1; k >= 0; --k) sha256_word(c, v.w[k]);
}

// The ASCII bytes of a NUL-terminated string.
BN_INLINE void sha256_str(sha256_ctx& c, const char* s) {
  for (; *s; ++s) sha256_byte(c, (uint8_t)*s);
}

// The padding (0x80, zeros, the bit length), then the digest as 8
// big-endian words (h order: out[0] holds the digest's first 4 bytes).
BN_INLINE void sha256_final(sha256_ctx& c, uint32_t* out) {
  const uint32_t bits_hi = c.total >> 29, bits_lo = c.total << 3;
  sha256_byte(c, 0x80u);
  while (c.n != 56) sha256_byte(c, 0);
  c.w[14] = bits_hi;
  c.w[15] = bits_lo;
  sha256_compress(c.h, c.w);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = c.h[j];
}

// A digest's 32 bytes as a 256-bit big-endian integer, little-endian words.
BN_INLINE void digest_to_fp(fp& r, const uint32_t* d) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = d[NW - 1 - k];
}
