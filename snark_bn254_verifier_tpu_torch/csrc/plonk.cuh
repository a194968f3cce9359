// Kernel K7, the PlonK batch's per-lane scalar pass, one thread per lane:
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
// What bounds it: about 30 SHA-256 compressions and 500 Fr products a
// lane (most of them the one Fermat inversion), all dependent integer
// work on a few kilobytes of input, so integer issue and latency; at
// batch 1024 one thread a lane fills few SMs, the first design's limit
// (PERF.md). The lanes of a batch share one byte layout (the VK fixes
// it), so every loop and every __noinline__ call (the compression, the
// products) is the same on every lane of a warp; a lane that fails a
// check runs every round, and its outputs are selected after them (the
// rule of tower.cuh). Nothing is compiled in of the VK: nb_public, nb
// (BSB22 commitments) and the domain size come from the VK's words.
//
// The Fr algebra keeps the values of the JAX package's _lane_challenges
// and _lane_finish, in Montgomery form. The public-input and BSB22
// Lagrange terms are summed as one fraction num / den, so a lane inverts
// (zeta - 1) * den once (Fermat) and keeps no array of denominators; a
// zero denominator (zeta on the domain) masks the lane.
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
// proof_bytes, which the host checks).
BN_INLINE int plonk_off_zs(int nb) { return 516 + 32 * (6 + nb); }  // shifted opening's h
BN_INLINE int plonk_off_cmt(int nb) { return plonk_off_zs(nb) + 100; }  // commitments
// K2's point rows of a lane: cmt_0..cmt_{nb-1}, l, r, o, z, h0, h1, h2, hb, hs
BN_INLINE int plonk_row_offset(int j, int nb) {
  return j < nb ? plonk_off_cmt(nb) + 64 * j : (j - nb < 8 ? 64 * (j - nb) : plonk_off_zs(nb));
}

BN_NOINLINE void fr_mul(fp& r, const fp& a, const fp& b) { fp_mul<FR>(r, a, b); }
BN_NOINLINE void fq_mul_nl(fp& r, const fp& a, const fp& b) { fp_mul<FQ>(r, a, b); }

BN_INLINE void fp_words(fp& r, const uint32_t* w) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = w[j];
}

BN_INLINE void fp_small(fp& r, uint32_t v) {
  fp_zero(r);
  r.w[0] = v;
}

// 32 big-endian bytes as a 256-bit value of little-endian words.
BN_INLINE void be_load(fp& r, const uint8_t* p) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint8_t* q = p + 4 * (NW - 1 - k);
    r.w[k] = ((uint32_t)q[0] << 24) | ((uint32_t)q[1] << 16) | ((uint32_t)q[2] << 8) | q[3];
  }
}

// a^(r-2), square-and-multiply from the exponent's top bit (the plain
// twin's ops/field.py::inv); zero maps to zero.
BN_INLINE void fr_inv(fp& r, const fp& a) {
  fp acc;
  fp_one<FR>(acc);
  for (int i = BN_FR_PM2_NBITS - 1; i >= 0; --i) {
    fr_mul(acc, acc, acc);
    if ((FR_PM2[i >> 5] >> (i & 31)) & 1u) fr_mul(acc, acc, a);
  }
  r = acc;
}

// a^e for a 64-bit e the same on every lane, as ops/field.py::pow_const.
BN_INLINE void fr_pow_u64(fp& r, const fp& a, uint64_t e) {
  int nbits = 0;
  while (nbits < 64 && (e >> nbits) != 0) ++nbits;
  fp acc;
  fp_one<FR>(acc);
  for (int i = nbits - 1; i >= 0; --i) {
    fr_mul(acc, acc, acc);
    if ((e >> i) & 1u) fr_mul(acc, acc, a);
  }
  r = acc;
}

// A value below 2^256 (any 32 bytes) into Montgomery form mod F: v R mod
// F is the product of v and R^2 (their product is below F R, so one
// conditional subtraction reduces it).
template <int F>
BN_INLINE void to_mont(fp& r, const fp& v) {
  fp r2;
  fp_words(r2, F == FQ ? FQ_R2 : FR_R2);
  if (F == FQ)
    fq_mul_nl(r, v, r2);
  else
    fr_mul(r, v, r2);
}

// Montgomery form out to the canonical value (a product by plain 1).
template <int F>
BN_INLINE void from_mont(fp& r, const fp& m) {
  fp one;
  fp_small(one, 1);
  if (F == FQ)
    fq_mul_nl(r, m, one);
  else
    fr_mul(r, m, one);
}

template <int F>
BN_INLINE bool canonical(const fp& v) {
  fp m;
  fp_words(m, F == FQ ? FQ_MOD : FR_MOD);
  return words_lt(v, m);
}

// A proof's G1 point at p: x, y canonical (below p) and on y^2 = x^3 + 3,
// so (0, 0) fails (serialization.py:54-61, :113-126); (xm, ym) its
// Montgomery coordinates. Five Fq products.
BN_INLINE bool g1_decode(fp& xm, fp& ym, const uint8_t* p) {
  fp x, y, t, u, b;
  be_load(x, p);
  be_load(y, p + 32);
  const bool canon = canonical<FQ>(x) && canonical<FQ>(y);
  to_mont<FQ>(xm, x);
  to_mont<FQ>(ym, y);
  fq_mul_nl(t, xm, xm);
  fq_mul_nl(t, t, xm);
  fp_words(b, G1_B_MONT);
  fp_add<FQ>(t, t, b);
  fq_mul_nl(u, ym, ym);
  return canon && fp_eq(t, u);
}

// The lane's Fr value at p (32 big-endian bytes): ok &= canonical; v the
// canonical value, m its Montgomery form.
BN_INLINE void fr_decode(fp& v, fp& m, bool& ok, const uint8_t* p) {
  be_load(v, p);
  ok = ok && canonical<FR>(v);
  to_mont<FR>(m, v);
}

// hash_to_field (RFC 9380 expand_message_xmd, SHA-256, 48 bytes) of a
// 64-byte commitment with the DST "BSB22-Plonk" (plonk/verify.rs:140),
// reduced mod r, in Montgomery form: the 384-bit value hi 2^256 + lo is
// lo R^2 + hi R^3 under one Montgomery product each.
BN_INLINE void bsb22_hash(fp& out, const uint8_t* cmt, const uint32_t* vkc) {
  const char* dst = "BSB22-Plonk";
  uint32_t b0[8], b1[8], b2[8];
  sha256_ctx c;
  sha256_start(c, vkc + PV_HTF_MID, 64);  // Z_pad, 64 zero bytes
  sha256_bytes(c, cmt, 64);
  sha256_byte(c, 0);   // l_i_b_str = I2OSP(48, 2)
  sha256_byte(c, 48);
  sha256_byte(c, 0);   // I2OSP(0, 1)
  sha256_str(c, dst);  // DST_prime = DST || I2OSP(len(DST), 1)
  sha256_byte(c, 11);
  sha256_final(c, b0);
  sha256_init(c);
  for (int j = 0; j < 8; ++j) sha256_word(c, b0[j]);
  sha256_byte(c, 1);
  sha256_str(c, dst);
  sha256_byte(c, 11);
  sha256_final(c, b1);
  sha256_init(c);
  for (int j = 0; j < 8; ++j) sha256_word(c, b0[j] ^ b1[j]);
  sha256_byte(c, 2);
  sha256_str(c, dst);
  sha256_byte(c, 11);
  sha256_final(c, b2);
  // the 48 bytes b1 || b2[0:16] as 12 big-endian words; lo is the low 8
  fp lo, hi, r3, a, b;
  for (int k = 0; k < 4; ++k) {
    lo.w[k] = b2[3 - k];
    lo.w[4 + k] = b1[7 - k];
    hi.w[k] = b1[3 - k];
    hi.w[4 + k] = 0;
  }
  to_mont<FR>(a, lo);
  fp_words(r3, FR_R3);
  fr_mul(b, hi, r3);
  fp_add<FR>(out, a, b);
}

// A challenge of the transcript: the digest reduced mod r (Montgomery).
BN_INLINE void challenge(fp& r, const uint32_t* digest) {
  fp v;
  digest_to_fp(v, digest);
  to_mont<FR>(r, v);
}

BN_INLINE void store_or_zero(int32_t* p, int64_t stride, const fp& v, bool ok) {
  fp z;
  fp_zero(z);
  store_fp(p, stride, ok ? v : z);
}

// One lane of K7a over B = n lanes. raw: (n, L) proof bytes, L the VK's
// proof length; pub: (nb_public, 16, n) canonical Fr limbs; valid_in (n,)
// the host's byte checks. Writes valid_out (n,), zeta (16, n) canonical,
// px, py (m, 16, n) Montgomery and pinf (m, n) for K2's m = nb + 9 point
// rows, lin (nb + 10, 16, n) canonical: every output zero (a point at
// infinity) on a lane that fails.
BN_INLINE void plonk_lanes_a_lane(const uint8_t* raw, long long L, const int32_t* pub,
                                  const uint8_t* valid_in, const uint32_t* vkc,
                                  uint8_t* valid_out, int32_t* zeta_out, int32_t* px,
                                  int32_t* py, uint8_t* pinf, int32_t* lin, long long n,
                                  long long lane) {
  const int nb_pub = (int)vkc[PV_NB_PUB], nb = (int)vkc[PV_NB];
  const int ncv = 6 + nb, m = nb + 9;
  const uint8_t* p = raw + lane * L;
  const uint32_t* frc = vkc + PV_FR;
  bool ok = valid_in[lane] != 0;

  // the proof's points: checked, then K2's Montgomery rows
  for (int j = 0; j < m; ++j) {
    fp xm, ym;
    ok = g1_decode(xm, ym, p + plonk_row_offset(j, nb)) && ok;
    store_fp(px + (long long)j * 16 * n + lane, n, xm);
    store_fp(py + (long long)j * 16 * n + lane, n, ym);
  }

  // gamma: the VK's part from its midstate, the inputs, l, r, o
  uint32_t dg[8], db[8], da[8], dz[8];
  sha256_ctx c;
  sha256_start(c, vkc + PV_MID, vkc[PV_MID_BYTES]);
  sha256_bytes(c, (const uint8_t*)(vkc + PV_TAIL), (int)vkc[PV_TAIL_LEN]);
  for (int j = 0; j < nb_pub; ++j) {
    fp w;
    load_fp(w, pub + (long long)j * 16 * n + lane, n);
    sha256_fp(c, w);
  }
  sha256_bytes(c, p, 192);
  sha256_final(c, dg);
  // beta binds the previous challenge's raw digest, not its value mod r
  sha256_init(c);
  sha256_str(c, "beta");
  for (int j = 0; j < 8; ++j) sha256_word(c, dg[j]);
  sha256_final(c, db);
  sha256_init(c);
  sha256_str(c, "alpha");
  for (int j = 0; j < 8; ++j) sha256_word(c, db[j]);
  sha256_bytes(c, p + plonk_off_cmt(nb), 64 * nb);
  sha256_bytes(c, p + 192, 64);  // z
  sha256_final(c, da);
  sha256_init(c);
  sha256_str(c, "zeta");
  for (int j = 0; j < 8; ++j) sha256_word(c, da[j]);
  sha256_bytes(c, p + 256, 192);  // h0, h1, h2
  sha256_final(c, dz);
  fp gamma, beta, alpha, zeta;
  challenge(gamma, dg);
  challenge(beta, db);
  challenge(alpha, da);
  challenge(zeta, dz);

  // zeta^n, Z_H(zeta), and the Lagrange terms as one fraction num / den
  fp one, zn, zh, zs, num, den, t, size_inv;
  fp_one<FR>(one);
  fr_pow_u64(zn, zeta, (uint64_t)vkc[PV_SIZE_LO] | ((uint64_t)vkc[PV_SIZE_HI] << 32));
  fp_sub<FR>(zh, zn, one);
  fp_words(size_inv, frc + 8 * PVF_SIZE_INV);
  fr_mul(zs, zh, size_inv);
  fp_zero(num);
  den = one;
  bool zero = false;
  for (int j = 0; j < nb_pub + nb; ++j) {
    fp w, d, a, x;
    fp_words(w, frc + 8 * (PVF_WPOW + j));
    fp_sub<FR>(d, zeta, w);
    zero = zero || fp_is_zero(d);
    if (j < nb_pub) {  // L_j(zeta) times the input
      load_fp(x, pub + (long long)j * 16 * n + lane, n);
      to_mont<FR>(x, x);
    } else {  // the commitment's Lagrange term times its hash
      bsb22_hash(x, p + plonk_off_cmt(nb) + 64 * (j - nb_pub), vkc);
    }
    fr_mul(a, zs, w);
    fr_mul(a, a, x);
    fr_mul(num, num, d);
    fr_mul(t, a, den);
    fp_add<FR>(num, num, t);
    fr_mul(den, den, d);
  }
  fp d0, inv, l1, pi;
  fp_sub<FR>(d0, zeta, one);
  zero = zero || fp_is_zero(d0);
  fr_mul(t, d0, den);
  fr_inv(inv, t);
  fr_mul(l1, zs, den);
  fr_mul(l1, l1, inv);  // L_1(zeta) = Z_H(zeta) / (n (zeta - 1))
  fr_mul(pi, num, d0);
  fr_mul(pi, pi, inv);  // the public part, num / den
  ok = ok && !zero;

  // the claimed values (every one canonical) and the early check
  fp cv0, cv0m, l, lm, r, rm, o, om, s1, s1m, s2, s2m, zu, zum;
  const uint8_t* cv = p + 516;
  fr_decode(cv0, cv0m, ok, cv);
  fr_decode(l, lm, ok, cv + 32);
  fr_decode(r, rm, ok, cv + 64);
  fr_decode(o, om, ok, cv + 96);
  fr_decode(s1, s1m, ok, cv + 128);
  fr_decode(s2, s2m, ok, cv + 160);
  for (int i = 6; i < ncv; ++i) {
    fp v;
    be_load(v, cv + 32 * i);
    ok = ok && canonical<FR>(v);
    store_fp(lin + (long long)(i - 6) * 16 * n + lane, n, v);  // qc_i; zeroed below if !ok
  }
  fr_decode(zu, zum, ok, p + plonk_off_zs(nb) + 64);

  fp asl1, f1, f2, f3, p12, cl;
  fr_mul(asl1, l1, alpha);
  fr_mul(asl1, asl1, alpha);  // alpha^2 L_1(zeta)
  fr_mul(f1, beta, s1m);
  fp_add<FR>(f1, f1, gamma);
  fp_add<FR>(f1, f1, lm);
  fr_mul(f2, beta, s2m);
  fp_add<FR>(f2, f2, gamma);
  fp_add<FR>(f2, f2, rm);
  fp_add<FR>(f3, om, gamma);
  fr_mul(p12, f1, f2);
  fr_mul(cl, p12, f3);
  fr_mul(cl, cl, alpha);
  fr_mul(cl, cl, zum);
  fp_sub<FR>(cl, cl, asl1);
  fp_add<FR>(cl, cl, pi);
  fp_neg<FR>(cl, cl);
  ok = ok && fp_eq(cl, cv0m);  // OpeningPolyMismatchError otherwise

  // the linearisation scalars
  fp s1v, u, bz, bu, g1, g2, g3, s2v, coeff_z, rl, zn2, zn2_zh, zn2sq_zh, zh_neg;
  fr_mul(s1v, p12, beta);
  fr_mul(s1v, s1v, alpha);
  fr_mul(s1v, s1v, zum);
  fp_words(u, frc + 8 * PVF_U);
  fr_mul(bz, beta, zeta);
  fp_add<FR>(g1, bz, gamma);
  fp_add<FR>(g1, g1, lm);
  fr_mul(bu, beta, u);
  fr_mul(t, bu, zeta);
  fp_add<FR>(g2, t, gamma);
  fp_add<FR>(g2, g2, rm);
  fr_mul(bu, bu, u);
  fr_mul(t, bu, zeta);
  fp_add<FR>(g3, t, gamma);
  fp_add<FR>(g3, g3, om);
  fr_mul(s2v, g1, g2);
  fr_mul(s2v, s2v, g3);
  fr_mul(s2v, s2v, alpha);
  fp_neg<FR>(s2v, s2v);
  fp_add<FR>(coeff_z, asl1, s2v);
  fr_mul(rl, lm, rm);
  fr_mul(zn2, zn, zeta);
  fr_mul(zn2, zn2, zeta);  // zeta^(n+2)
  fr_mul(zn2_zh, zn2, zh);
  fp_neg<FR>(zn2_zh, zn2_zh);
  fr_mul(zn2sq_zh, zn2, zn2);
  fr_mul(zn2sq_zh, zn2sq_zh, zh);
  fp_neg<FR>(zn2sq_zh, zn2sq_zh);
  fp_neg<FR>(zh_neg, zh);

  // outputs, selected by the lane's verdict
  fp z_c, plain_one;
  from_mont<FR>(z_c, zeta);
  fp_small(plain_one, 1);
  fp col[10];
  col[0] = l;
  col[1] = r;
  from_mont<FR>(col[2], rl);
  col[3] = o;
  col[4] = plain_one;
  from_mont<FR>(col[5], s1v);
  from_mont<FR>(col[6], coeff_z);
  from_mont<FR>(col[7], zh_neg);
  from_mont<FR>(col[8], zn2_zh);
  from_mont<FR>(col[9], zn2sq_zh);
  for (int k = 0; k < 10; ++k)
    store_or_zero(lin + (long long)(nb + k) * 16 * n + lane, n, col[k], ok);
  store_or_zero(zeta_out + lane, n, z_c, ok);
  valid_out[lane] = ok ? 1 : 0;
  for (int j = 0; j < m; ++j) pinf[(long long)j * n + lane] = ok ? 0 : 1;
  if (!ok) {  // stores only: no __noinline__ call under this branch
    fp z;
    fp_zero(z);
    for (int j = 0; j < m; ++j) {
      store_fp(px + (long long)j * 16 * n + lane, n, z);
      store_fp(py + (long long)j * 16 * n + lane, n, z);
    }
    for (int i = 0; i < nb; ++i) store_fp(lin + (long long)i * 16 * n + lane, n, z);
  }
}

// One lane of K7b. raw and vkc as K7a's; valid (n,), zeta (16, n)
// canonical from K7a; rand (16, n) the lane's canonical randomiser; the
// phase-A digest (dx, dy (16, n) Montgomery, dinf (n,)). Writes sc
// (6 + nb + 6, 16, n) canonical: the combo MSM's gamma powers for the
// digests (lin, l, r, o, s0, s1, qcp), r, -(folded evaluation + r zu),
// zeta, r zeta w; then the quotient MSM's 1, r (kzg.rs:87-186 folded
// into two MSMs); all zero on an invalid lane.
BN_INLINE void plonk_lanes_b_lane(const uint8_t* raw, long long L, const uint8_t* valid,
                                  const int32_t* zeta_in, const int32_t* rand,
                                  const int32_t* dx, const int32_t* dy, const uint8_t* dinf,
                                  const uint32_t* vkc, int32_t* sc, long long n,
                                  long long lane) {
  const int nb_pub = (int)vkc[PV_NB_PUB], nb = (int)vkc[PV_NB];
  const int ncv = 6 + nb;
  const uint8_t* p = raw + lane * L;
  const bool ok = valid[lane] != 0;

  // the digest as g1_to_bytes gives it: canonical x || y, zeros at infinity
  fp x, y, zc, zero;
  fp_zero(zero);
  load_fp(x, dx + lane, n);
  load_fp(y, dy + lane, n);
  from_mont<FQ>(x, x);
  from_mont<FQ>(y, y);
  const bool inf = dinf[lane] != 0;
  fp_select(x, inf, zero, x);
  fp_select(y, inf, zero, y);
  load_fp(zc, zeta_in + lane, n);

  // derive_gamma (models/kzg.py): zeta, the digests, the claimed values, zu
  sha256_ctx c;
  uint32_t dg[8];
  sha256_init(c);
  sha256_str(c, "gamma");
  sha256_fp(c, zc);
  sha256_fp(c, x);
  sha256_fp(c, y);
  sha256_bytes(c, p, 192);  // l, r, o
  sha256_bytes(c, (const uint8_t*)(vkc + pv_digests(nb_pub, nb)), 64 * (2 + nb));
  sha256_bytes(c, p + 516, 32 * ncv);
  sha256_bytes(c, p + plonk_off_zs(nb) + 64, 32);
  sha256_final(c, dg);
  fp gam, g, folded, v, vm, t;
  challenge(gam, dg);

  fp_one<FR>(g);
  be_load(v, p + 516);
  to_mont<FR>(folded, v);  // gamma^0 cv_0
  fp plain_one;
  fp_small(plain_one, 1);
  store_or_zero(sc + lane, n, plain_one, ok);
  for (int i = 1; i < ncv; ++i) {
    fr_mul(g, g, gam);
    from_mont<FR>(t, g);
    store_or_zero(sc + (long long)i * 16 * n + lane, n, t, ok);
    be_load(v, p + 516 + 32 * i);
    to_mont<FR>(vm, v);
    fr_mul(vm, vm, g);
    fp_add<FR>(folded, folded, vm);
  }
  fp rc, rm, zum, zm, gen, fe, rs;
  load_fp(rc, rand + lane, n);
  to_mont<FR>(rm, rc);
  be_load(v, p + plonk_off_zs(nb) + 64);
  to_mont<FR>(zum, v);
  fr_mul(fe, rm, zum);
  fp_add<FR>(fe, folded, fe);  // folded evaluation + r zu
  fp_neg<FR>(fe, fe);
  from_mont<FR>(fe, fe);
  to_mont<FR>(zm, zc);
  fp_words(gen, vkc + PV_FR + 8 * PVF_GEN);
  fr_mul(rs, zm, gen);  // zeta w, the shifted point
  fr_mul(rs, rs, rm);
  from_mont<FR>(rs, rs);
  const fp tail[6] = {rc, fe, zc, rs, plain_one, rc};
  for (int k = 0; k < 6; ++k)
    store_or_zero(sc + (long long)(ncv + k) * 16 * n + lane, n, tail[k], ok);
}
