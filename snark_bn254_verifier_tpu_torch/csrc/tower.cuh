// BN254 extension tower on one thread: Fq2 = Fq[u]/(u^2+1),
// Fq6 = Fq2[v]/(v^3 - XI), Fq12 = Fq6[w]/(w^2 - v), XI = 9 + u.
//
// Formulas are those of ops/tower.py (and of the JAX package's tower), so
// each product matches its plain twin limb for limb. The team kernels
// (team.cuh) inline their Fq2 products (fq2_mul_in) and split each Fq12
// product over the team; the __noinline__ Fq2/Fq6 products and the
// inversions here serve K4's once-per-lane Fq12 inverse. Every function
// tolerates its output aliasing an input.
//
// Rule for the kernels: every lane of a warp makes the same __noinline__
// calls. No such call sits under a branch on lane data; a lane that has
// nothing to do computes a neutral product or one whose result is not
// kept. On an H100 under CUDA 12.8's ptxas (-O1 and -O3), K2 built with
// __noinline__ G1 functions faulted (illegal address) exactly when the
// lanes of a warp took different paths through those calls; the same
// code was exact with one lane per warp or with equal data in all lanes.
#pragma once

#include "fp.cuh"

struct fq2 {
  fp c0, c1;
};
struct fq6 {
  fq2 c0, c1, c2;
};
struct fq12 {
  fq6 c0, c1;
};

// ---------------------------------------------------------------- Fq2

BN_INLINE void fq2_add(fq2& r, const fq2& a, const fq2& b) {
  fp_add<FQ>(r.c0, a.c0, b.c0);
  fp_add<FQ>(r.c1, a.c1, b.c1);
}

BN_INLINE void fq2_sub(fq2& r, const fq2& a, const fq2& b) {
  fp_sub<FQ>(r.c0, a.c0, b.c0);
  fp_sub<FQ>(r.c1, a.c1, b.c1);
}

BN_INLINE void fq2_neg(fq2& r, const fq2& a) {
  fp_neg<FQ>(r.c0, a.c0);
  fp_neg<FQ>(r.c1, a.c1);
}

BN_INLINE void fq2_dbl(fq2& r, const fq2& a) { fq2_add(r, a, a); }

BN_INLINE void fq2_conj(fq2& r, const fq2& a) {
  r.c0 = a.c0;
  fp_neg<FQ>(r.c1, a.c1);
}

BN_INLINE void fq2_zero(fq2& r) {
  fp_zero(r.c0);
  fp_zero(r.c1);
}

BN_INLINE void fq2_one(fq2& r) {
  fp_one<FQ>(r.c0);
  fp_zero(r.c1);
}

BN_INLINE bool fq2_is_zero(const fq2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

BN_INLINE void fq2_select(fq2& r, bool c, const fq2& a, const fq2& b) {
  fp_select(r.c0, c, a.c0, b.c0);
  fp_select(r.c1, c, a.c1, b.c1);
}

// Both components times an Fq element.
BN_INLINE void fq2_mul_fq(fq2& r, const fq2& a, const fp& s) {
  fp_mul<FQ>(r.c0, a.c0, s);
  fp_mul<FQ>(r.c1, a.c1, s);
}

// Times XI = 9 + u: (9a0 - a1) + (a0 + 9a1) u.
BN_INLINE void fq2_mul_xi(fq2& r, const fq2& a) {
  fq2 a2, a4, a8, a9;
  fq2_add(a2, a, a);
  fq2_add(a4, a2, a2);
  fq2_add(a8, a4, a4);
  fq2_add(a9, a8, a);
  fp re, im;
  fp_sub<FQ>(re, a9.c0, a.c1);
  fp_add<FQ>(im, a.c0, a9.c1);
  r.c0 = re;
  r.c1 = im;
}

// Karatsuba: c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1.
// Inlined form, for the team kernels (team.cuh), whose products stay in
// registers.
BN_INLINE void fq2_mul_in(fq2& r, const fq2& a, const fq2& b) {
  fp t0, t1, sa, sb, t2;
  fp_mul<FQ>(t0, a.c0, b.c0);
  fp_mul<FQ>(t1, a.c1, b.c1);
  fp_add<FQ>(sa, a.c0, a.c1);
  fp_add<FQ>(sb, b.c0, b.c1);
  fp_mul<FQ>(t2, sa, sb);
  fp_sub<FQ>(r.c0, t0, t1);
  fp_add<FQ>(t0, t0, t1);
  fp_sub<FQ>(r.c1, t2, t0);
}

BN_NOINLINE void fq2_mul(fq2& r, const fq2& a, const fq2& b) { fq2_mul_in(r, a, b); }

// Square, inlined: (a0 + a1)(a0 - a1) + 2 a0 a1 u, two products.
BN_INLINE void fq2_sq_in(fq2& r, const fq2& a) {
  fp s, d, t;
  fp_add<FQ>(s, a.c0, a.c1);
  fp_sub<FQ>(d, a.c0, a.c1);
  fp_mul<FQ>(t, a.c0, a.c1);
  fp_mul<FQ>(r.c0, s, d);
  fp_add<FQ>(r.c1, t, t);
}

BN_INLINE void fq2_sq(fq2& r, const fq2& a) { fq2_mul(r, a, a); }

BN_NOINLINE void fq2_inv(fq2& r, const fq2& a) {
  fp n, t, ninv;
  fp_mul<FQ>(n, a.c0, a.c0);
  fp_mul<FQ>(t, a.c1, a.c1);
  fp_add<FQ>(n, n, t);
  fq_inv(ninv, n);
  fp_mul<FQ>(r.c0, a.c0, ninv);
  fp_mul<FQ>(t, a.c1, ninv);
  fp_neg<FQ>(r.c1, t);
}

// ---------------------------------------------------------------- Fq6

BN_INLINE void fq6_sub(fq6& r, const fq6& a, const fq6& b) {
  fq2_sub(r.c0, a.c0, b.c0);
  fq2_sub(r.c1, a.c1, b.c1);
  fq2_sub(r.c2, a.c2, b.c2);
}

BN_INLINE void fq6_neg(fq6& r, const fq6& a) {
  fq2_neg(r.c0, a.c0);
  fq2_neg(r.c1, a.c1);
  fq2_neg(r.c2, a.c2);
}

// (a0 + a1 v + a2 v^2) v = XI a2 + a0 v + a1 v^2.
BN_INLINE void fq6_mul_by_v(fq6& r, const fq6& a) {
  fq2 t;
  fq2_mul_xi(t, a.c2);
  r.c2 = a.c1;
  r.c1 = a.c0;
  r.c0 = t;
}

// Toom-style: 6 Fq2 products.
BN_NOINLINE void fq6_mul(fq6& r, const fq6& a, const fq6& b) {
  fq2 t0, t1, t2, x, y, m12, m01, m02, u;
  fq2_mul(t0, a.c0, b.c0);
  fq2_mul(t1, a.c1, b.c1);
  fq2_mul(t2, a.c2, b.c2);
  fq2_add(x, a.c1, a.c2);
  fq2_add(y, b.c1, b.c2);
  fq2_mul(m12, x, y);
  fq2_add(x, a.c0, a.c1);
  fq2_add(y, b.c0, b.c1);
  fq2_mul(m01, x, y);
  fq2_add(x, a.c0, a.c2);
  fq2_add(y, b.c0, b.c2);
  fq2_mul(m02, x, y);
  // c0 = t0 + XI (m12 - t1 - t2)
  fq2_add(u, t1, t2);
  fq2_sub(u, m12, u);
  fq2_mul_xi(u, u);
  fq2_add(r.c0, t0, u);
  // c1 = m01 - t0 - t1 + XI t2
  fq2_add(u, t0, t1);
  fq2_sub(u, m01, u);
  fq2_mul_xi(x, t2);
  fq2_add(r.c1, u, x);
  // c2 = m02 - t0 - t2 + t1
  fq2_add(u, t0, t2);
  fq2_sub(u, m02, u);
  fq2_add(r.c2, u, t1);
}

BN_NOINLINE void fq6_inv(fq6& r, const fq6& a) {
  fq2 s0, s1, s2, m12, m01, m02, c0, c1, c2, t, u;
  fq2_sq(s0, a.c0);
  fq2_sq(s1, a.c1);
  fq2_sq(s2, a.c2);
  fq2_mul(m12, a.c1, a.c2);
  fq2_mul(m01, a.c0, a.c1);
  fq2_mul(m02, a.c0, a.c2);
  fq2_mul_xi(u, m12);
  fq2_sub(c0, s0, u);
  fq2_mul_xi(u, s2);
  fq2_sub(c1, u, m01);
  fq2_sub(c2, s1, m02);
  fq2_mul(t, a.c2, c1);
  fq2_mul(u, a.c1, c2);
  fq2_add(t, t, u);
  fq2_mul_xi(t, t);
  fq2_mul(u, a.c0, c0);
  fq2_add(t, t, u);
  fq2_inv(t, t);
  fq2_mul(r.c0, c0, t);
  fq2_mul(r.c1, c1, t);
  fq2_mul(r.c2, c2, t);
}

// --------------------------------------------------------------- Fq12

BN_NOINLINE void fq12_inv(fq12& r, const fq12& a) {
  fq6 s0, s1, t;
  fq6_mul(s0, a.c0, a.c0);
  fq6_mul(s1, a.c1, a.c1);
  fq6_mul_by_v(s1, s1);
  fq6_sub(t, s0, s1);
  fq6_inv(t, t);
  fq6_mul(s0, a.c0, t);
  fq6_mul(s1, a.c1, t);
  r.c0 = s0;
  fq6_neg(r.c1, s1);
}

BN_INLINE void load_fq2_const(fq2& r, const uint32_t* words) {
  for (int j = 0; j < NW; ++j) {
    r.c0.w[j] = words[j];
    r.c1.w[j] = words[NW + j];
  }
}

// Coefficient i of the w-basis (element = sum a_i w^i) is the tower slot
// (h, j) = (i % 2, i / 2).
BN_INLINE fq2& fq12_wcoeff(fq12& a, int i) {
  fq6& half = (i & 1) ? a.c1 : a.c0;
  return i < 2 ? half.c0 : (i < 4 ? half.c1 : half.c2);
}
