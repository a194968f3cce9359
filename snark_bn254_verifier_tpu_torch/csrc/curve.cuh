// G1 Jacobian arithmetic of kernel K2 (msm.cuh), one point per thread, and
// the G2 on-curve mask of the fused K1 (kernels.cu::g2_on_curve_kernel).
//
// Formulas and edge handling follow ops/curve.py: dbl-2009-l,
// madd-2007-bl and add-2007-bl, where P == Q doubles, P == -Q gives
// infinity and an infinite operand yields the other one. Infinity is
// Z == 0; the affine result maps it to (0, 0, inf).
#pragma once

#include "tower.cuh"

#define MSM_WINDOW 4
#define MSM_TABLE (1 << MSM_WINDOW)

// The G1 functions are inlined into K2, so their branches on lane data
// (infinity, P == +-Q) hold no __noinline__ call and no barrier (see the
// rule in tower.cuh): built __noinline__, K2 faulted whenever a warp's
// lanes diverged through them. In K2's team the threads of a warp hold
// different points, so they diverge there by design.

struct g1j {
  fp x, y, z;
};

BN_INLINE void g1_inf(g1j& r) {
  fp_one<FQ>(r.x);
  fp_one<FQ>(r.y);
  fp_zero(r.z);
}

BN_INLINE void g1_dbl(g1j& r, const g1j& p) {
  fp a, b, c, d, e, t, x3, y3, z3;
  fp_sq<FQ>(a, p.x);
  fp_sq<FQ>(b, p.y);
  fp_sq<FQ>(c, b);
  fp_add<FQ>(t, p.x, b);
  fp_sq<FQ>(t, t);
  fp_sub<FQ>(t, t, a);
  fp_sub<FQ>(t, t, c);
  fp_dbl<FQ>(d, t);            // D = 2((X+B)^2 - A - C)
  fp_dbl<FQ>(e, a);
  fp_add<FQ>(e, e, a);         // E = 3A
  fp_sq<FQ>(x3, e);
  fp_dbl<FQ>(t, d);
  fp_sub<FQ>(x3, x3, t);       // X3 = E^2 - 2D
  fp_sub<FQ>(t, d, x3);
  fp_mul<FQ>(y3, e, t);
  fp_dbl<FQ>(c, c);
  fp_dbl<FQ>(c, c);
  fp_dbl<FQ>(c, c);
  fp_sub<FQ>(y3, y3, c);       // Y3 = E(D - X3) - 8C
  fp_mul<FQ>(z3, p.y, p.z);
  fp_dbl<FQ>(z3, z3);          // Z3 = 2YZ
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// Shared tail of both additions: h = U2 - U1, rr = 2(S2 - S1).
BN_INLINE void g1_add_core(g1j& r, const fp& h, const fp& rr, const fp& u1,
                           const fp& s1, const fp& zz_h_factor, bool mixed) {
  fp i, j, v, x3, y3, z3, t;
  if (mixed) {
    fp_sq<FQ>(i, h);
    fp_dbl<FQ>(i, i);
    fp_dbl<FQ>(i, i);          // I = 4 H^2
  } else {
    fp_dbl<FQ>(t, h);
    fp_sq<FQ>(i, t);           // I = (2H)^2
  }
  fp_mul<FQ>(j, h, i);
  fp_mul<FQ>(v, u1, i);
  fp_sq<FQ>(x3, rr);
  fp_sub<FQ>(x3, x3, j);
  fp_dbl<FQ>(t, v);
  fp_sub<FQ>(x3, x3, t);       // X3 = rr^2 - J - 2V
  fp_sub<FQ>(t, v, x3);
  fp_mul<FQ>(y3, rr, t);
  fp_mul<FQ>(t, s1, j);
  fp_dbl<FQ>(t, t);
  fp_sub<FQ>(y3, y3, t);       // Y3 = rr (V - X3) - 2 S1 J
  fp_mul<FQ>(z3, zz_h_factor, h);
  r.x = x3;
  r.y = y3;
  r.z = z3;
}

// p + q for Jacobian p and affine q (q_inf marks infinity).
BN_INLINE void g1_add_mixed(g1j& r, const g1j& p, const fp& xq,
                              const fp& yq, bool q_inf) {
  if (q_inf) {
    r = p;
    return;
  }
  if (fp_is_zero(p.z)) {
    r.x = xq;
    r.y = yq;
    fp_one<FQ>(r.z);
    return;
  }
  fp z1z1, u2, s2, h, rr, t;
  fp_sq<FQ>(z1z1, p.z);
  fp_mul<FQ>(u2, xq, z1z1);
  fp_mul<FQ>(s2, yq, p.z);
  fp_mul<FQ>(s2, s2, z1z1);
  fp_sub<FQ>(h, u2, p.x);
  fp_sub<FQ>(rr, s2, p.y);
  if (fp_is_zero(h)) {
    if (fp_is_zero(rr)) {
      g1_dbl(r, p);
    } else {
      g1_inf(r);
    }
    return;
  }
  fp_dbl<FQ>(rr, rr);
  fp_dbl<FQ>(t, p.z);
  g1_add_core(r, h, rr, p.x, p.y, t, true);
}

BN_INLINE void g1_add(g1j& r, const g1j& p, const g1j& q) {
  if (fp_is_zero(p.z)) {
    r = q;
    return;
  }
  if (fp_is_zero(q.z)) {
    r = p;
    return;
  }
  fp z1z1, z2z2, u1, u2, s1, s2, h, rr, t;
  fp_sq<FQ>(z1z1, p.z);
  fp_sq<FQ>(z2z2, q.z);
  fp_mul<FQ>(u1, p.x, z2z2);
  fp_mul<FQ>(u2, q.x, z1z1);
  fp_mul<FQ>(s1, p.y, q.z);
  fp_mul<FQ>(s1, s1, z2z2);
  fp_mul<FQ>(s2, q.y, p.z);
  fp_mul<FQ>(s2, s2, z1z1);
  fp_sub<FQ>(h, u2, u1);
  fp_sub<FQ>(rr, s2, s1);
  if (fp_is_zero(h)) {
    if (fp_is_zero(rr)) {
      g1_dbl(r, p);
    } else {
      g1_inf(r);
    }
    return;
  }
  fp_dbl<FQ>(rr, rr);
  fp_mul<FQ>(t, p.z, q.z);
  fp_dbl<FQ>(t, t);
  g1_add_core(r, h, rr, u1, s1, t, false);
}

// Jacobian -> affine with one inversion; infinity -> (0, 0, true): the
// inverse maps Z = 0 to 0, which makes x = y = 0 there without a branch.
BN_INLINE void g1_to_affine(fp& x, fp& y, bool& inf, const g1j& p) {
  inf = fp_is_zero(p.z);
  fp zinv, zinv2, t;
  fq_inv_binary(zinv, p.z);
  fp_sq<FQ>(zinv2, zinv);
  fp_mul<FQ>(x, p.x, zinv2);
  fp_mul<FQ>(t, zinv, zinv2);
  fp_mul<FQ>(y, p.y, t);
}

// One lane of the G2 on-curve mask: valid && (inf || y^2 == x^3 + b') over
// Fq2, with x and y (16, 2, n) Montgomery limbs (limb k of component c at
// (2k + c) n + lane) and inf, valid (n,) bytes; ops/curve.py::
// is_on_curve_affine with the validity mask ANDed in. Two inlined Fq2
// squares and one product (7 Fp products) and no branch on lane data: inf
// and valid are folded in by select at the end, so every lane does the
// same work.
BN_INLINE uint8_t g2_on_curve_lane(const int32_t* x, const int32_t* y, const uint8_t* inf,
                                   const uint8_t* valid, int64_t n, int64_t lane) {
  fq2 px, py, lhs, rhs, b;
  load_fp(px.c0, x + lane, 2 * n);
  load_fp(px.c1, x + n + lane, 2 * n);
  load_fp(py.c0, y + lane, 2 * n);
  load_fp(py.c1, y + n + lane, 2 * n);
  fq2_sq_in(lhs, py);
  fq2_sq_in(rhs, px);
  fq2_mul_in(rhs, rhs, px);
  load_fq2_const(b, TWIST_B);
  fq2_add(rhs, rhs, b);
  const bool on = fp_eq(lhs.c0, rhs.c0) && fp_eq(lhs.c1, rhs.c1);
  return (uint8_t)((valid[lane] != 0) & ((inf[lane] != 0) | on));
}
