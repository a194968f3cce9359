// Kernel K7, the PlonK batch's per-lane scalar pass:
//
//   K7a plonk_lanes_a  before phase A: the proof's bytes decoded and
//                      checked (load_plonk_proof_from_bytes), the gamma,
//                      beta, alpha, zeta transcript, BSB22's hash to
//                      field, and the Fr algebra of the linearisation
//                      (its early check included); writes the lane's
//                      valid bit, zeta, the proof's points as K2's
//                      Montgomery rows and the linearisation scalars
//   K7b plonk_lanes_b  between phase A and phase B: the KZG fold
//                      challenge over phase A's digest, its powers, the
//                      folded evaluation and the randomiser terms; writes
//                      the combo and quotient MSMs' scalars
//
// There is no Pallas original: the JAX package does this pass in Python on
// the host (snark_bn254_verifier_tpu/parallel/batch.py:575-600 for the
// fold, :642-733 for the lane passes), which needs phase A's digests on
// the host between the phases. On the card the batch needs no host round
// trip.
//
// What bounds it: a lane is one long chain of dependent integer work
// (K7a: 17 SHA-256 compressions and, in the plain twin's count, 504 Fr/Fq
// products, 381 of them a Fermat inversion) on a kilobyte of input, and a
// batch of 1024 lanes is 32 warps, so latency sets the time, not throughput
// or bytes. The design:
//   - a block is K7_LPB = 32 lanes and several warps with roles over the
//     same lanes, in stages split by __syncthreads, handing values over
//     through shared memory laid out [word][lane]: K7a runs the transcript
//     chain, BSB22's hashes and the on-curve decodes side by side, then
//     the domain powers, the Lagrange fraction with its inverse and the
//     claimed values' products side by side, then the check; K7b the fold
//     transcript beside the claimed values' products, then the challenge's
//     powers' two uses;
//   - the block's proof rows are copied into shared memory first by all
//     its threads, 4 bytes a thread per copy, consecutive threads on
//     consecutive words (cp.async, all in flight at once), at an odd
//     stride of words a row so that a word read by all lanes hits 32
//     banks; every decode and hashed proof word is then read from there;
//   - SHA-256 takes whole words (sha256.cuh), its block in shared memory;
//   - the one inverse a lane is Bernstein-Yang's divsteps (fr_inv below),
//     constant time, about 600 steps of a few integer operations instead
//     of 381 dependent Montgomery products;
//   - every product is a __noinline__ function that takes and returns its
//     operands by value.
// The lanes of a batch share one byte layout (the VK fixes it), so every
// loop and every __noinline__ call is the same on every lane of a warp; a
// lane that fails a check runs every round, and its outputs are selected
// after them (the rule of tower.cuh; a warp's role is uniform on it).
// Nothing is compiled in of the VK: nb_public, nb (BSB22 commitments) and
// the domain size come from the VK's words.
//
// The Fr algebra keeps the values of the JAX package's _lane_challenges
// and _lane_finish, in Montgomery form; a value is the same field element
// whatever the order of its products, so the outputs are the plain twin's
// bit for bit. The public-input and BSB22 Lagrange terms are summed as one
// fraction zs num / den (zs = Z_H(zeta) / n), so a lane inverts
// (zeta - 1) den once and keeps no array of denominators; a zero
// denominator (zeta on the domain) masks the lane.
#pragma once

#include "sha256.cuh"

// The VK's words (ops/plonk_lanes.py::LanesVk.blob), shared by K7a and K7b.
enum {
  PV_NB_PUB = 0,      // public inputs
  PV_NB = 1,          // BSB22 commitments
  PV_MID_BYTES = 2,   // bytes under PV_MID: "gamma" and the VK's points, whole blocks
  PV_TAIL_LEN = 3,    // the bytes of that prefix left over, below 64
  PV_SIZE_LO = 4,     // the domain size, 64 bits
  PV_SIZE_HI = 5,
  PV_MID = 6,         // 8 words: the gamma transcript's SHA-256 state after PV_MID_BYTES
  PV_TAIL = 14,       // 16 words: the left-over bytes, in order
  PV_HTF_MID = 30,    // 8 words: the state after expand_msg_xmd's 64 zero bytes
  PV_FR = 38,         // Fr in Montgomery form, 8 words each (PVF_* below)
};
// Fr constants, in order from PV_FR: size_inv, the domain generator, the
// coset shift u, w^j for the nb_public inputs, w^(nb_public + cci) for the
// nb commitments. Then the fold's VK digests s0, s1, qcp (64 bytes each).
enum { PVF_SIZE_INV = 0, PVF_GEN = 1, PVF_U = 2, PVF_WPOW = 3 };

BN_INLINE int pv_digests(int nb_pub, int nb) { return PV_FR + 8 * (PVF_WPOW + nb_pub + nb); }

// gnark's proof layout (plonk/converter.rs:121-178): 8 G1 points (l, r, o,
// z, h0, h1, h2, the batched opening's h), the 4-byte count of claimed
// values at 512 and 6 + nb values, the shifted opening's h and value, the
// 4-byte count of commitments and nb commitments (ops/plonk_lanes.py::
// proof_bytes, which the host checks). Every offset is a multiple of 4.
BN_INLINE int plonk_off_zs(int nb) { return 516 + 32 * (6 + nb); }  // shifted opening's h
BN_INLINE int plonk_off_cmt(int nb) { return plonk_off_zs(nb) + 100; }  // commitments
// K2's point rows of a lane: cmt_0..cmt_{nb-1}, l, r, o, z, h0, h1, h2, hb, hs
BN_INLINE int plonk_row_offset(int j, int nb) {
  return j < nb ? plonk_off_cmt(nb) + 64 * j : (j - nb < 8 ? 64 * (j - nb) : plonk_off_zs(nb));
}

#define K7_LPB 32      // lanes a block, a warp's width
#define K7A_WARPS 4    // K7a's roles (plonk_a_stage*)
#define K7B_WARPS 2    // K7b's roles (plonk_b_stage*)

// Products by value: one copy each, no operand in local memory.
BN_NOINLINE fp frmul(fp a, fp b) {
  fp r;
  fp_mul<FR>(r, a, b);
  return r;
}

BN_NOINLINE fp fqmul(fp a, fp b) {
  fp r;
  fp_mul<FQ>(r, a, b);
  return r;
}

BN_INLINE fp fp_words(const uint32_t* w) {
  fp r;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = w[j];
  return r;
}

BN_INLINE fp fp_small(uint32_t v) {
  fp r;
  fp_zero(r);
  r.w[0] = v;
  return r;
}

BN_INLINE fp fr_one() {
  fp r;
  fp_one<FR>(r);
  return r;
}

BN_INLINE fp fr_add(const fp& a, const fp& b) {
  fp r;
  fp_add<FR>(r, a, b);
  return r;
}

BN_INLINE fp fr_sub(const fp& a, const fp& b) {
  fp r;
  fp_sub<FR>(r, a, b);
  return r;
}

BN_INLINE fp fr_neg(const fp& a) {
  fp r;
  fp_neg<FR>(r, a);
  return r;
}

// A value below 2^256 (any 32 bytes) into Montgomery form mod F: v R mod
// F is the product of v and R^2 (their product is below F R, so one
// conditional subtraction reduces it).
template <int F>
BN_INLINE fp to_mont(const fp& v) {
  return F == FQ ? fqmul(v, fp_words(FQ_R2)) : frmul(v, fp_words(FR_R2));
}

// Montgomery form out to the canonical value (a product by plain 1).
template <int F>
BN_INLINE fp from_mont(const fp& m) {
  return F == FQ ? fqmul(m, fp_small(1)) : frmul(m, fp_small(1));
}

template <int F>
BN_INLINE bool canonical(const fp& v) {
  fp m;
#pragma unroll
  for (int j = 0; j < NW; ++j) m.w[j] = F == FQ ? FQ_MOD[j] : FR_MOD[j];
  return words_lt(v, m);
}

// a^e for a 64-bit e the same on every lane, as ops/field.py::pow_const.
BN_INLINE fp fr_pow_u64(const fp& a, uint64_t e) {
  int nbits = 0;
  while (nbits < 64 && (e >> nbits) != 0) ++nbits;
  fp acc = fr_one();
  for (int i = nbits - 1; i >= 0; --i) {
    acc = frmul(acc, acc);
    if ((e >> i) & 1u) acc = frmul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------- inverse
//
// Bernstein and Yang's constant-time modular inverse ("Fast constant-time
// gcd computation and modular inversion", 2019) in the form of the
// half-delta divsteps on signed 30-bit limbs: 20 batches of 30 divsteps
// (600; 590 suffice for moduli below 2^256), each batch a 2x2 matrix of
// 30-bit entries built from the low words alone and then applied to the
// full f, g (exact division by 2^30) and to d, e (mod r, by adding the
// multiple of r that clears the low 30 bits). Every step is the same
// sequence of masks, adds and shifts on every lane: no branch on a value.
// It gives the unique inverse mod r, so the same limbs as Fermat's
// a^(r-2) of the plain twin (ops/field.py::inv); zero maps to zero (g
// starts at zero and d stays zero).

struct s30 {
  int32_t v[9];
};
#define S30_MASK 0x3FFFFFFF

// 30 divsteps on the low words f0 (odd), g0 of f, g; the matrix (u v; q
// r), scaled by 2^30, into t; returns the new zeta = -(delta + 1/2).
BN_INLINE int32_t divsteps_30(int32_t zeta, uint32_t f0, uint32_t g0, int32_t* t) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    uint32_t c1 = (uint32_t)(zeta >> 31);   // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);      // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;  // both: swap (f, g) and negate, as the divstep does
    zeta = (int32_t)(((uint32_t)zeta ^ c1) - 1u);
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return zeta;
}

// [d, e] = t [d, e] / 2^30 mod r, d and e kept in (-2r, r).
BN_INLINE void update_de_30(s30& d, s30& e, const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((BN_FR_INV30 * (uint32_t)cd + (uint32_t)md) & S30_MASK);
  me -= (int32_t)((BN_FR_INV30 * (uint32_t)ce + (uint32_t)me) & S30_MASK);
  cd += (int64_t)FR_MOD_S30[0] * md;
  ce += (int64_t)FR_MOD_S30[0] * me;
  cd >>= 30;  // the low 30 bits are zero
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += (int64_t)u * d.v[i] + (int64_t)v * e.v[i] + (int64_t)FR_MOD_S30[i] * md;
    ce += (int64_t)q * d.v[i] + (int64_t)r * e.v[i] + (int64_t)FR_MOD_S30[i] * me;
    d.v[i - 1] = (int32_t)cd & S30_MASK;
    e.v[i - 1] = (int32_t)ce & S30_MASK;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// [f, g] = t [f, g] / 2^30, exactly.
BN_INLINE void update_fg_30(s30& f, s30& g, const int32_t* t) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)u * f.v[i] + (int64_t)v * g.v[i];
    cg += (int64_t)q * f.v[i] + (int64_t)r * g.v[i];
    f.v[i - 1] = (int32_t)cf & S30_MASK;
    g.v[i - 1] = (int32_t)cg & S30_MASK;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// Limbs carried into [0, 2^30) but the top one.
BN_INLINE void s30_carry(s30& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a.v[i + 1] += a.v[i] >> 30;
    a.v[i] &= S30_MASK;
  }
}

// d in (-2r, r), negated where f's sign says, into [0, r).
BN_INLINE void s30_normalize(s30& d, int32_t sign) {
  int32_t add = d.v[8] >> 31, neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] = ((d.v[i] + (FR_MOD_S30[i] & add)) ^ neg) - neg;
  s30_carry(d);
  add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] += FR_MOD_S30[i] & add;
  s30_carry(d);
}

// The plain inverse of a value below r: a^-1 mod r (0 for 0).
BN_INLINE fp fr_inv_plain(const fp& a) {
  s30 f, g, d, e;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int bit = 30 * i, w = bit >> 5, sh = bit & 31;
    const uint64_t two = a.w[w] | (w + 1 < NW ? (uint64_t)a.w[w + 1] << 32 : 0);
    g.v[i] = (int32_t)((two >> sh) & S30_MASK);
    f.v[i] = FR_MOD_S30[i];
    d.v[i] = 0;
    e.v[i] = i == 0;
  }
  int32_t zeta = -1, t[4];
#pragma unroll 1
  for (int k = 0; k < 20; ++k) {
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
  }
  s30_normalize(d, f.v[8]);  // f = +-1: d = +-a^-1
  fp r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int bit = 32 * k, i = bit / 30, sh = bit % 30;
    r.w[k] = (uint32_t)(((uint64_t)d.v[i] >> sh) | ((uint64_t)d.v[i + 1] << (30 - sh)));
  }
  return r;
}

// The Montgomery inverse: a = z R gives z^-1 R = (z R)^-1 R^3 R^-1.
BN_NOINLINE fp fr_inv(fp a) { return frmul(fr_inv_plain(a), fp_words(FR_R3)); }

// ----------------------------------------------------- a block's layout
//
// Shared memory, 32-bit words: the block's proof rows (row r at r * rw,
// rw = L / 4 made odd), then per-lane slots laid out [word][lane]: SHA-256
// blocks (16 words a lane), Fr values (8 words a lane), flags (1 word).

BN_HOST_DEVICE int k7_row_words(long long L) { return (int)(L / 4) | 1; }

struct k7_smem {
  uint32_t* rows;
  int rw;
  uint32_t* x;  // the slots
};

BN_INLINE k7_smem k7_layout(uint32_t* smem, long long L) {
  k7_smem s;
  s.rows = smem;
  s.rw = k7_row_words(L);
  s.x = smem + K7_LPB * s.rw;
  return s;
}

// Slot k of a lane l: its word j at x[(k + j) * K7_LPB + l] (k counts words).
BN_INLINE void xput(uint32_t* x, int k, int l, const fp& v) {
#pragma unroll
  for (int j = 0; j < NW; ++j) x[(k + j) * K7_LPB + l] = v.w[j];
}

BN_INLINE fp xget(const uint32_t* x, int k, int l) {
  fp v;
#pragma unroll
  for (int j = 0; j < NW; ++j) v.w[j] = x[(k + j) * K7_LPB + l];
  return v;
}

// Stage 0 of both kernels: the block's proof rows from raw (n, L) into
// shared memory, every thread of the block on consecutive words (cp.async
// on the card: all copies in flight, then one wait before the barrier).
BN_INLINE void k7_stage_rows(const uint8_t* raw, long long L, long long n, long long block,
                             const k7_smem& s, int tid, int nthreads) {
  const long long first = block * K7_LPB;
  const int nl = (int)(n - first < K7_LPB ? n - first : K7_LPB), lw = (int)(L / 4);
  const uint32_t* src = (const uint32_t*)(raw + first * L);
  for (int r = 0; r < nl; ++r)
    for (int j = tid; j < lw; j += nthreads) {
      uint32_t* dst = s.rows + r * s.rw + j;
#if defined(__CUDACC__)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst)),
                   "l"(src + (long long)r * lw + j));
#else
      *dst = src[(long long)r * lw + j];
#endif
    }
#if defined(__CUDACC__)
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// 32 big-endian bytes at byte off (a multiple of 4) of a staged row, as a
// 256-bit value of little-endian words.
BN_INLINE fp be_row(const uint32_t* row, int off) {
  fp r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = bswap32(row[(off >> 2) + NW - 1 - k]);
  return r;
}

// The bytes [off, off + len) of a staged row (multiples of 4) into c.
BN_INLINE void sha256_row(sha256_ctx& c, const uint32_t* row, int off, int len) {
  sha256_mem(c, row + (off >> 2), 1, len);
}

// A challenge of the transcript: the digest reduced mod r (Montgomery).
BN_INLINE fp challenge(const sha256_state& d) {
  fp v;
  digest_to_fp(v, d);
  return to_mont<FR>(v);
}

// The lane's Fr value at byte off of its row (32 big-endian bytes): ok &=
// canonical; v the canonical value; returns its Montgomery form.
BN_INLINE fp fr_decode(fp& v, bool& ok, const uint32_t* row, int off) {
  v = be_row(row, off);
  ok = ok && canonical<FR>(v);
  return to_mont<FR>(v);
}

// A proof's G1 point at byte off of its row: x, y canonical (below p) and
// on y^2 = x^3 + 3, so (0, 0) fails (serialization.py:54-61, :113-126);
// (xm, ym) its Montgomery coordinates. Five Fq products.
BN_INLINE bool g1_decode(fp& xm, fp& ym, const uint32_t* row, int off) {
  const fp x = be_row(row, off), y = be_row(row, off + 32);
  const bool canon = canonical<FQ>(x) && canonical<FQ>(y);
  xm = to_mont<FQ>(x);
  ym = to_mont<FQ>(y);
  fp t = fqmul(fqmul(xm, xm), xm);
  fp_add<FQ>(t, t, fp_words(G1_B_MONT));
  return canon && fp_eq(t, fqmul(ym, ym));
}

// hash_to_field (RFC 9380 expand_message_xmd, SHA-256, 48 bytes) of the
// 64-byte commitment at byte off of the row with the DST "BSB22-Plonk"
// (plonk/verify.rs:140), reduced mod r, in Montgomery form: the 384-bit
// value hi 2^256 + lo is lo R^2 + hi R^3 under one product each.
BN_INLINE fp bsb22_hash(const uint32_t* row, int off, const uint32_t* vkc, uint32_t* blk) {
  sha256_ctx c;
  sha256_start(c, vkc + PV_HTF_MID, 64, blk, K7_LPB);  // Z_pad, 64 zero bytes
  sha256_row(c, row, off, 64);
  sha256_byte(c, 0);  // l_i_b_str = I2OSP(48, 2)
  sha256_byte(c, 48);
  sha256_byte(c, 0);  // I2OSP(0, 1)
  sha256_str(c, "BSB22-Plonk");  // DST_prime = DST || I2OSP(len(DST), 1)
  sha256_byte(c, 11);
  const sha256_state b0 = sha256_final(c);
  sha256_init(c, blk, K7_LPB);
  sha256_digest(c, b0);
  sha256_byte(c, 1);
  sha256_str(c, "BSB22-Plonk");
  sha256_byte(c, 11);
  const sha256_state b1 = sha256_final(c);
  sha256_init(c, blk, K7_LPB);
#pragma unroll
  for (int j = 0; j < 8; ++j) sha256_word(c, b0.h[j] ^ b1.h[j]);
  sha256_byte(c, 2);
  sha256_str(c, "BSB22-Plonk");
  sha256_byte(c, 11);
  const sha256_state b2 = sha256_final(c);
  // the 48 bytes b1 || b2[0:16] as 12 big-endian words; lo is the low 8
  fp lo, hi;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo.w[k] = b2.h[3 - k];
    lo.w[4 + k] = b1.h[7 - k];
    hi.w[k] = b1.h[3 - k];
    hi.w[4 + k] = 0;
  }
  return fr_add(to_mont<FR>(lo), frmul(hi, fp_words(FR_R3)));
}

BN_INLINE void store_or_zero(int32_t* p, int64_t stride, const fp& v, bool ok) {
  fp z;
  fp_zero(z);
  store_fp(p, stride, ok ? v : z);
}

// ------------------------------------------------------------------ K7a
//
// One block of K7a over B = n lanes. raw: (n, L) proof bytes, L the VK's
// proof length; pub: (nb_public, 16, n) canonical Fr limbs; valid_in (n,)
// the host's byte checks. Writes valid_out (n,), zeta (16, n) canonical,
// px, py (m, 16, n) Montgomery and pinf (m, n) for K2's m = nb + 9 point
// rows, lin (nb + 10, 16, n) canonical: every output zero (a point at
// infinity) on a lane that fails. Four warps a block over its 32 lanes,
// four stages between barriers:
//   0  all: the proof rows into shared memory
//   1  w0: the gamma, beta, alpha, zeta transcript; w1: BSB22's hashes;
//      w1-w3: the m on-curve decodes, K2's point rows written
//   2  w0: zeta^n, Z_H, zs and the zeta^(n+2) columns; w1: the Lagrange
//      fraction and its one inverse; w2: the claimed values (canonical)
//      and the check's and s1's products; w3: the s2 product, l r
//   3  w0: L_1, the public part, the early check, the verdict, the
//      remaining outputs, and zeros on a failed lane.

struct k7a_args {
  const uint8_t* raw;
  long long L;
  const int32_t* pub;
  const uint8_t* valid_in;
  const uint32_t* vkc;
  uint8_t* valid_out;
  int32_t* zeta;
  int32_t* px;
  int32_t* py;
  uint8_t* pinf;
  int32_t* lin;
  long long n;
};

// K7a's slots, in words from k7_smem.x (each Fr value 8 words a lane)
enum {
  XA_SHA0 = 0,                 // w0's SHA-256 block
  XA_SHA1 = 16,                // w1's
  XA_GAMMA = 32, XA_BETA = 40, XA_ALPHA = 48, XA_ZETA = 56,
  XA_ZS = 64,                  // Z_H(zeta) / n
  XA_INVD0 = 72,               // 1 / (zeta - 1)
  XA_FRAC = 80,                // num / den of the Lagrange terms, zs left out
  XA_CL0 = 88,                 // p12 f3 alpha zu
  XA_S2V = 96,                 // -(g1 g2 g3 alpha)
  XA_CV0 = 104,                // the first claimed value, Montgomery
  XA_OK = 112,                 // 4 flag words: w1-w3's decodes, w2's canonical values
  XA_ZERO = 116,               // w1's: a zero denominator
  XA_HASH = 117,               // nb BSB22 hashes
};

BN_HOST_DEVICE int k7a_smem_words(long long L, int nb) {
  return K7_LPB * (k7_row_words(L) + XA_HASH + 8 * nb);
}

BN_INLINE int k7_warp_lane(int tid, long long block, long long n, int& l, long long& lane) {
  l = tid & (K7_LPB - 1);
  const long long i = block * K7_LPB + l;
  lane = i < n ? i : n - 1;  // a ragged block's idle lanes repeat the last
  return tid / K7_LPB;
}

BN_INLINE void plonk_a_stage1(const k7a_args& a, const k7_smem& s, int tid, long long block) {
  int l;
  long long lane;
  const int warp = k7_warp_lane(tid, block, a.n, l, lane);
  const uint32_t* vkc = a.vkc;
  const int nb_pub = (int)vkc[PV_NB_PUB], nb = (int)vkc[PV_NB], m = nb + 9;
  const long long n = a.n;
  const uint32_t* row = s.rows + (lane - block * K7_LPB) * s.rw;
  if (warp == 0) {
    // gamma: the VK's part from its midstate, the inputs, l, r, o
    sha256_ctx c;
    uint32_t* blk = s.x + XA_SHA0 * K7_LPB + l;
    sha256_start(c, vkc + PV_MID, vkc[PV_MID_BYTES], blk, K7_LPB);
    sha256_mem(c, vkc + PV_TAIL, 1, (int)vkc[PV_TAIL_LEN]);
    for (int j = 0; j < nb_pub; ++j) {
      fp w;
      load_fp(w, a.pub + (long long)j * 16 * n + lane, n);
      sha256_fp(c, w);
    }
    sha256_row(c, row, 0, 192);
    const sha256_state dg = sha256_final(c);
    // beta binds the previous challenge's raw digest, not its value mod r
    sha256_init(c, blk, K7_LPB);
    sha256_str(c, "beta");
    sha256_digest(c, dg);
    const sha256_state db = sha256_final(c);
    sha256_init(c, blk, K7_LPB);
    sha256_str(c, "alpha");
    sha256_digest(c, db);
    sha256_row(c, row, plonk_off_cmt(nb), 64 * nb);
    sha256_row(c, row, 192, 64);  // z
    const sha256_state da = sha256_final(c);
    sha256_init(c, blk, K7_LPB);
    sha256_str(c, "zeta");
    sha256_digest(c, da);
    sha256_row(c, row, 256, 192);  // h0, h1, h2
    const sha256_state dz = sha256_final(c);
    xput(s.x, XA_GAMMA, l, challenge(dg));
    xput(s.x, XA_BETA, l, challenge(db));
    xput(s.x, XA_ALPHA, l, challenge(da));
    xput(s.x, XA_ZETA, l, challenge(dz));
    return;
  }
  if (warp == 1)
    for (int j = 0; j < nb; ++j)
      xput(s.x, (XA_HASH + 8 * j), l,
           bsb22_hash(row, plonk_off_cmt(nb) + 64 * j, vkc, s.x + XA_SHA1 * K7_LPB + l));
  // the proof's points, dealt to w2, w3, w1 in turn: checked, then K2's rows
  bool ok = true;
  for (int j = (warp + 1) % 3; j < m; j += 3) {
    fp xm, ym;
    ok = g1_decode(xm, ym, row, plonk_row_offset(j, nb)) && ok;
    store_fp(a.px + (long long)j * 16 * n + lane, n, xm);
    store_fp(a.py + (long long)j * 16 * n + lane, n, ym);
  }
  s.x[(XA_OK + warp - 1) * K7_LPB + l] = ok;
}

BN_INLINE void plonk_a_stage2(const k7a_args& a, const k7_smem& s, int tid, long long block) {
  int l;
  long long lane;
  const int warp = k7_warp_lane(tid, block, a.n, l, lane);
  const uint32_t* vkc = a.vkc;
  const uint32_t* frc = vkc + PV_FR;
  const int nb_pub = (int)vkc[PV_NB_PUB], nb = (int)vkc[PV_NB], ncv = 6 + nb;
  const long long n = a.n;
  const uint32_t* row = s.rows + (lane - block * K7_LPB) * s.rw;
  const fp zeta = xget(s.x, XA_ZETA, l), one = fr_one();
  int32_t* lin = a.lin + lane;
  const long long col = 16 * n;  // between lin's rows
  if (warp == 0) {
    // zeta^n, Z_H(zeta), zs, and the columns of zeta^(n+2)
    const fp zn = fr_pow_u64(zeta, (uint64_t)vkc[PV_SIZE_LO] | ((uint64_t)vkc[PV_SIZE_HI] << 32));
    const fp zh = fr_sub(zn, one);
    xput(s.x, XA_ZS, l, frmul(zh, fp_words(frc + 8 * PVF_SIZE_INV)));
    const fp zn2 = frmul(frmul(zn, zeta), zeta);
    store_fp(lin + (nb + 7) * col, n, from_mont<FR>(fr_neg(zh)));
    store_fp(lin + (nb + 8) * col, n, from_mont<FR>(fr_neg(frmul(zn2, zh))));
    store_fp(lin + (nb + 9) * col, n, from_mont<FR>(fr_neg(frmul(frmul(zn2, zn2), zh))));
  } else if (warp == 1) {
    // sum_j w^j x_j prod_{i != j} d_i over den = prod_j d_j, d_j = zeta - w^j
    fp num, den = one;
    fp_zero(num);
    bool zero = false;
    for (int j = 0; j < nb_pub + nb; ++j) {
      const fp w = fp_words(frc + 8 * (PVF_WPOW + j)), d = fr_sub(zeta, w);
      zero = zero || fp_is_zero(d);
      fp x;
      if (j < nb_pub) {  // L_j(zeta) times the input
        load_fp(x, a.pub + (long long)j * 16 * n + lane, n);
        x = to_mont<FR>(x);
      } else {  // the commitment's Lagrange term times its hash
        x = xget(s.x, (XA_HASH + 8 * (j - nb_pub)), l);
      }
      num = fr_add(frmul(num, d), frmul(frmul(w, x), den));
      den = frmul(den, d);
    }
    const fp d0 = fr_sub(zeta, one);
    zero = zero || fp_is_zero(d0);
    const fp inv = fr_inv(frmul(d0, den));
    xput(s.x, XA_INVD0, l, frmul(den, inv));
    xput(s.x, XA_FRAC, l, frmul(frmul(num, d0), inv));
    s.x[XA_ZERO * K7_LPB + l] = zero;
  } else if (warp == 2) {
    // the claimed values (every one canonical), the early check's and s1's products
    const fp gamma = xget(s.x, XA_GAMMA, l), beta = xget(s.x, XA_BETA, l);
    const fp alpha = xget(s.x, XA_ALPHA, l);
    bool ok = true;
    fp v, l_, r_, o_;
    xput(s.x, XA_CV0, l, fr_decode(v, ok, row, 516));
    const fp lm = fr_decode(l_, ok, row, 516 + 32), rm = fr_decode(r_, ok, row, 516 + 64);
    const fp om = fr_decode(o_, ok, row, 516 + 96), s1m = fr_decode(v, ok, row, 516 + 128);
    const fp s2m = fr_decode(v, ok, row, 516 + 160);
    for (int i = 6; i < ncv; ++i) {
      v = be_row(row, 516 + 32 * i);
      ok = ok && canonical<FR>(v);
      store_fp(lin + (i - 6) * col, n, v);  // qc_i; zeroed in stage 3 if the lane fails
    }
    const fp zum = fr_decode(v, ok, row, plonk_off_zs(nb) + 64);
    s.x[(XA_OK + 3) * K7_LPB + l] = ok;
    const fp f1 = fr_add(fr_add(frmul(beta, s1m), gamma), lm);
    const fp f2 = fr_add(fr_add(frmul(beta, s2m), gamma), rm);
    const fp p12 = frmul(f1, f2);
    xput(s.x, XA_CL0, l, frmul(frmul(frmul(p12, fr_add(om, gamma)), alpha), zum));
    store_fp(lin + (nb + 5) * col, n, from_mont<FR>(frmul(frmul(frmul(p12, beta), alpha), zum)));
  } else {
    // -(g1 g2 g3 alpha), and the columns of l, r, o, l r and one
    const fp gamma = xget(s.x, XA_GAMMA, l), beta = xget(s.x, XA_BETA, l);
    const fp alpha = xget(s.x, XA_ALPHA, l);
    bool ok = true;  // w2 keeps the verdict
    fp l_, r_, o_;
    const fp lm = fr_decode(l_, ok, row, 516 + 32), rm = fr_decode(r_, ok, row, 516 + 64);
    const fp om = fr_decode(o_, ok, row, 516 + 96);
    const fp u = fp_words(frc + 8 * PVF_U);
    const fp g1 = fr_add(fr_add(frmul(beta, zeta), gamma), lm);
    fp bu = frmul(beta, u);
    const fp g2 = fr_add(fr_add(frmul(bu, zeta), gamma), rm);
    bu = frmul(bu, u);
    const fp g3 = fr_add(fr_add(frmul(bu, zeta), gamma), om);
    xput(s.x, XA_S2V, l, fr_neg(frmul(frmul(frmul(g1, g2), g3), alpha)));
    store_fp(lin + nb * col, n, l_);
    store_fp(lin + (nb + 1) * col, n, r_);
    store_fp(lin + (nb + 2) * col, n, from_mont<FR>(frmul(lm, rm)));
    store_fp(lin + (nb + 3) * col, n, o_);
    store_fp(lin + (nb + 4) * col, n, fp_small(1));
  }
}

BN_INLINE void plonk_a_stage3(const k7a_args& a, const k7_smem& s, int tid, long long block) {
  int l;
  long long lane;
  if (k7_warp_lane(tid, block, a.n, l, lane) != 0) return;
  const int nb = (int)a.vkc[PV_NB], m = nb + 9;
  const long long n = a.n, col = 16 * n;
  bool ok = a.valid_in[lane] != 0 && !s.x[XA_ZERO * K7_LPB + l];
  for (int k = 0; k < 4; ++k) ok = ok && s.x[(XA_OK + k) * K7_LPB + l] != 0;
  const fp zs = xget(s.x, XA_ZS, l), alpha = xget(s.x, XA_ALPHA, l);
  const fp l1 = frmul(zs, xget(s.x, XA_INVD0, l));  // L_1(zeta) = Z_H / (n (zeta - 1))
  const fp asl1 = frmul(frmul(l1, alpha), alpha);  // alpha^2 L_1(zeta)
  const fp pi = frmul(zs, xget(s.x, XA_FRAC, l));  // the public part
  const fp cl = fr_neg(fr_add(fr_sub(xget(s.x, XA_CL0, l), asl1), pi));
  ok = ok && fp_eq(cl, xget(s.x, XA_CV0, l));  // OpeningPolyMismatchError otherwise
  const fp coeff_z = from_mont<FR>(fr_add(asl1, xget(s.x, XA_S2V, l)));
  const fp z_c = from_mont<FR>(xget(s.x, XA_ZETA, l));

  // outputs, selected by the lane's verdict
  int32_t* lin = a.lin + lane;
  store_or_zero(lin + (nb + 6) * col, n, coeff_z, ok);
  store_or_zero(a.zeta + lane, n, z_c, ok);
  a.valid_out[lane] = ok ? 1 : 0;
  for (int j = 0; j < m; ++j) a.pinf[(long long)j * n + lane] = ok ? 0 : 1;
  if (!ok) {  // stores only: no __noinline__ call under this branch
    fp z;
    fp_zero(z);
    for (int j = 0; j < m; ++j) {
      store_fp(a.px + (long long)j * col + lane, n, z);
      store_fp(a.py + (long long)j * col + lane, n, z);
    }
    for (int i = 0; i < nb + 10; ++i)
      if (i != nb + 6) store_fp(lin + i * col, n, z);
  }
}

// ------------------------------------------------------------------ K7b
//
// One block of K7b. raw and vkc as K7a's; valid (n,), zeta (16, n)
// canonical from K7a; rand (16, n) the lane's canonical randomiser; the
// phase-A digest (dx, dy (16, n) Montgomery, dinf (n,)). Writes sc
// (6 + nb + 6, 16, n) canonical: the combo MSM's gamma powers for the
// digests (lin, l, r, o, s0, s1, qcp), r, -(folded evaluation + r zu),
// zeta, r zeta w; then the quotient MSM's 1, r (kzg.rs:87-186 folded
// into two MSMs); all zero on an invalid lane. Two warps a block over its
// 32 lanes, three stages between barriers:
//   0  both: the proof rows into shared memory
//   1  w0: the fold's transcript (derive_gamma) and the challenge's
//      powers; w1: the claimed values, zu, the randomiser and zeta in
//      Montgomery form, the randomiser columns
//   2  w0: the folded evaluation; w1: the powers' columns.

struct k7b_args {
  const uint8_t* raw;
  long long L;
  const uint8_t* valid;
  const int32_t* zeta;
  const int32_t* rand;
  const int32_t* dx;
  const int32_t* dy;
  const uint8_t* dinf;
  const uint32_t* vkc;
  int32_t* sc;
  long long n;
};

// K7b's slots, in words from k7_smem.x: w0's SHA-256 block, r zu, then the
// claimed values (Montgomery) and the challenge's powers, 6 + nb each
enum { XB_SHA = 0, XB_FE0 = 16, XB_CV = 24 };

BN_HOST_DEVICE int k7b_smem_words(long long L, int nb) {
  return K7_LPB * (k7_row_words(L) + XB_CV + 16 * (6 + nb));
}

// The most dynamic shared memory a block may ask for on sm_90, and so the
// most BSB22 commitments a VK may have for K7: both layouts grow with nb
// (the rows 96 bytes a lane, the slots 8 or 16 words), K7b's faster, so
// K7b sets the ceiling (nb = 37). ops/plonk_cuda.py::K7_MAX_NB is this.
#define K7_SMEM_MAX 232448

BN_HOST_DEVICE long long k7_smem_bytes(long long L, int nb, bool lanes_a) {
  return 4ll * (lanes_a ? k7a_smem_words(L, nb) : k7b_smem_words(L, nb));
}

BN_HOST_DEVICE int k7_max_nb() {
  int nb = 0;
  for (;; ++nb) {
    const long long L = 808 + 96ll * (nb + 1);  // ops/plonk_lanes.py::proof_bytes
    if (k7_smem_bytes(L, nb + 1, true) > K7_SMEM_MAX ||
        k7_smem_bytes(L, nb + 1, false) > K7_SMEM_MAX)
      return nb;
  }
}

BN_INLINE void plonk_b_stage1(const k7b_args& a, const k7_smem& s, int tid, long long block) {
  int l;
  long long lane;
  const int warp = k7_warp_lane(tid, block, a.n, l, lane);
  const uint32_t* vkc = a.vkc;
  const int nb_pub = (int)vkc[PV_NB_PUB], nb = (int)vkc[PV_NB], ncv = 6 + nb;
  const long long n = a.n;
  const uint32_t* row = s.rows + (lane - block * K7_LPB) * s.rw;
  const int xg = XB_CV + 8 * ncv;  // the powers' slots
  fp zc;
  load_fp(zc, a.zeta + lane, n);
  if (warp == 0) {
    // the digest as g1_to_bytes gives it: canonical x || y, zeros at infinity
    fp x, y, zero;
    fp_zero(zero);
    load_fp(x, a.dx + lane, n);
    load_fp(y, a.dy + lane, n);
    x = from_mont<FQ>(x);
    y = from_mont<FQ>(y);
    const bool inf = a.dinf[lane] != 0;
    fp_select(x, inf, zero, x);
    fp_select(y, inf, zero, y);
    // derive_gamma (models/kzg.py): zeta, the digests, the claimed values, zu
    sha256_ctx c;
    sha256_init(c, s.x + XB_SHA * K7_LPB + l, K7_LPB);
    sha256_str(c, "gamma");
    sha256_fp(c, zc);
    sha256_fp(c, x);
    sha256_fp(c, y);
    sha256_row(c, row, 0, 192);  // l, r, o
    sha256_mem(c, vkc + pv_digests(nb_pub, nb), 1, 64 * (2 + nb));
    sha256_row(c, row, 516, 32 * ncv);
    sha256_row(c, row, plonk_off_zs(nb) + 64, 32);
    const fp gam = challenge(sha256_final(c));
    fp g = fr_one();
    for (int i = 1; i < ncv; ++i) {
      g = frmul(g, gam);
      xput(s.x, (xg + 8 * i), l, g);
    }
    return;
  }
  const bool ok = a.valid[lane] != 0;
  for (int i = 0; i < ncv; ++i)
    xput(s.x, (XB_CV + 8 * i), l, to_mont<FR>(be_row(row, 516 + 32 * i)));
  fp rc;
  load_fp(rc, a.rand + lane, n);
  const fp rm = to_mont<FR>(rc);
  xput(s.x, XB_FE0, l, frmul(rm, to_mont<FR>(be_row(row, plonk_off_zs(nb) + 64))));
  // r zeta w, at the shifted point
  const fp rs = from_mont<FR>(frmul(frmul(to_mont<FR>(zc), fp_words(vkc + PV_FR + 8 * PVF_GEN)), rm));
  int32_t* sc = a.sc + lane;
  const long long col = 16 * n;
  store_or_zero(sc, n, fp_small(1), ok);
  store_or_zero(sc + ncv * col, n, rc, ok);
  store_or_zero(sc + (ncv + 2) * col, n, zc, ok);
  store_or_zero(sc + (ncv + 3) * col, n, rs, ok);
  store_or_zero(sc + (ncv + 4) * col, n, fp_small(1), ok);
  store_or_zero(sc + (ncv + 5) * col, n, rc, ok);
}

BN_INLINE void plonk_b_stage2(const k7b_args& a, const k7_smem& s, int tid, long long block) {
  int l;
  long long lane;
  const int warp = k7_warp_lane(tid, block, a.n, l, lane);
  const int nb = (int)a.vkc[PV_NB], ncv = 6 + nb;
  const long long n = a.n, col = 16 * n;
  const int xg = XB_CV + 8 * ncv;
  const bool ok = a.valid[lane] != 0;
  int32_t* sc = a.sc + lane;
  if (warp == 0) {  // -(sum_i gamma^i cv_i + r zu)
    fp folded = xget(s.x, XB_CV, l);
    for (int i = 1; i < ncv; ++i)
      folded = fr_add(folded, frmul(xget(s.x, (XB_CV + 8 * i), l),
                                    xget(s.x, (xg + 8 * i), l)));
    const fp fe = fr_neg(fr_add(folded, xget(s.x, XB_FE0, l)));
    store_or_zero(sc + (ncv + 1) * col, n, from_mont<FR>(fe), ok);
  } else {
    for (int i = 1; i < ncv; ++i)
      store_or_zero(sc + i * col, n, from_mont<FR>(xget(s.x, (xg + 8 * i), l)), ok);
  }
}
