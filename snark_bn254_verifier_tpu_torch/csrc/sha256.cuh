// SHA-256 (FIPS 180-4) for one message per thread: the compression, a
// streaming context that takes words and bytes, the padding, and a start
// from a midstate, so a prefix that every lane shares is hashed once on
// the host. Kernel K7 (plonk.cuh) runs the PlonK transcript on it; the
// host build (host_check.cc) checks it against hashlib without a card.
//
// The context fills its block a 32-bit word at a time: the messages of a
// batch have one layout (the VK fixes it), so the byte position is the
// same on every lane, and a big-endian word appended at any position is
// split by two shifts into the word being filled (its top bytes, kept in
// a register) and the next. The block itself is 16 words that the caller
// places: on the card in shared memory, laid out [word][lane] (stride 32,
// no bank conflicts), so no per-thread array is indexed by a value known
// only at run time (the compiler would place it in local memory). Every branch ("the word is full", "the block is full")
// is taken by all lanes of a warp together, and the compression is a
// __noinline__ function taking and returning its state by value (one copy
// of its 64 unrolled rounds), so the rule of tower.cuh holds.
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

// A little-endian 32-bit word of four message bytes as the big-endian word
// SHA-256 reads.
BN_INLINE uint32_t bswap32(uint32_t x) {
#if defined(__CUDACC__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

struct sha256_state {
  uint32_t h[8];
};

// The state after one block of 16 big-endian words, word t at w[t * ws].
BN_NOINLINE sha256_state sha256_compress(sha256_state s, const uint32_t* w, int ws) {
  uint32_t x[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) x[t] = w[t * ws];
  uint32_t a = s.h[0], b = s.h[1], c = s.h[2], d = s.h[3], e = s.h[4], f = s.h[5], g = s.h[6],
           hh = s.h[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = x[(t - 15) & 15], w2 = x[(t - 2) & 15];
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (w2 >> 10);
      x[t & 15] += s0 + x[(t - 7) & 15] + s1;
    }
    const uint32_t t1 = hh + (rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)) +
                        ((e & f) ^ (~e & g)) + SHA256_K[t] + x[t & 15];
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
  s.h[0] += a;
  s.h[1] += b;
  s.h[2] += c;
  s.h[3] += d;
  s.h[4] += e;
  s.h[5] += f;
  s.h[6] += g;
  s.h[7] += hh;
  return s;
}

struct sha256_ctx {
  sha256_state s;
  uint32_t* w;     // the block: word j at w[j * ws]
  int ws;
  uint32_t acc;    // the word being filled: its bytes so far, from the top
  uint32_t n;      // bytes in the block so far, acc's included
  uint32_t total;  // bytes hashed so far, the prefix of a midstate included
};

// Start from the state ``mid`` reached after ``prefix`` bytes, a whole
// number of blocks (SHA256_IV after none), with the block at blk, word j
// at blk[j * ws].
BN_INLINE void sha256_start(sha256_ctx& c, const uint32_t* mid, uint32_t prefix, uint32_t* blk,
                            int ws) {
#pragma unroll
  for (int j = 0; j < 8; ++j) c.s.h[j] = mid[j];
  c.w = blk;
  c.ws = ws;
  c.acc = 0;
  c.n = 0;
  c.total = prefix;
}

BN_INLINE void sha256_init(sha256_ctx& c, uint32_t* blk, int ws) {
  sha256_start(c, SHA256_IV, 0, blk, ws);
}

// A big-endian word (four bytes) at any byte position: the word being
// filled takes its top bytes, the rest start the next word (at a word
// edge, s = 0, the whole word is written and nothing is left over).
BN_INLINE void sha256_word(sha256_ctx& c, uint32_t x) {
  const uint32_t s = 8 * (c.n & 3);
  c.w[(c.n >> 2) * c.ws] = c.acc | (x >> s);
  c.acc = (uint32_t)((uint64_t)x << (32 - s));
  c.n += 4;
  c.total += 4;
  if (c.n >= 64) {
    c.s = sha256_compress(c.s, c.w, c.ws);
    c.n -= 64;
  }
}

BN_INLINE void sha256_byte(sha256_ctx& c, uint32_t byte) {
  c.acc |= (byte & 0xFFu) << (24 - 8 * (c.n & 3));
  ++c.n;
  ++c.total;
  if ((c.n & 3) == 0) {
    c.w[((c.n >> 2) - 1) * c.ws] = c.acc;
    c.acc = 0;
    if (c.n == 64) {
      c.s = sha256_compress(c.s, c.w, c.ws);
      c.n = 0;
    }
  }
}

// ``nbytes`` message bytes held as little-endian memory words at p[0],
// p[ps], ...: whole words, then the bytes of a last part word.
BN_INLINE void sha256_mem(sha256_ctx& c, const uint32_t* p, int ps, int nbytes) {
  int i = 0;
  for (; i + 4 <= nbytes; i += 4) sha256_word(c, bswap32(p[(i >> 2) * ps]));
  for (; i < nbytes; ++i) sha256_byte(c, p[(i >> 2) * ps] >> (8 * (i & 3)));
}

// A 256-bit value of 8 little-endian words as its 32 big-endian bytes.
BN_INLINE void sha256_fp(sha256_ctx& c, const fp& v) {
#pragma unroll
  for (int k = NW - 1; k >= 0; --k) sha256_word(c, v.w[k]);
}

BN_INLINE void sha256_digest(sha256_ctx& c, const sha256_state& d) {
#pragma unroll
  for (int j = 0; j < 8; ++j) sha256_word(c, d.h[j]);
}

// The ASCII bytes of a string literal (its NUL left out).
template <int N>
BN_INLINE void sha256_str(sha256_ctx& c, const char (&s)[N]) {
#pragma unroll
  for (int i = 0; i + 1 < N; ++i) sha256_byte(c, (uint8_t)s[i]);
}

// The padding (0x80, zeros to the word edge, then zero words to byte 56 of
// a block, the bit length), then the digest, h[0] holding its first 4
// bytes big-endian.
BN_INLINE sha256_state sha256_final(sha256_ctx& c) {
  const uint32_t bits_hi = c.total >> 29, bits_lo = c.total << 3;
  sha256_byte(c, 0x80u);
  while ((c.n & 3) != 0) sha256_byte(c, 0);
  while (c.n != 56) sha256_word(c, 0);
  c.w[14 * c.ws] = bits_hi;
  c.w[15 * c.ws] = bits_lo;
  return sha256_compress(c.s, c.w, c.ws);
}

// A digest's 32 bytes as a 256-bit big-endian integer, little-endian words.
BN_INLINE void digest_to_fp(fp& r, const sha256_state& d) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = d.h[NW - 1 - k];
}
