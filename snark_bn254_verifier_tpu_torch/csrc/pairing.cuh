// Per-lane bodies of kernels K3 (mixed Miller product), K4 (final
// exponentiation) and K5 (Miller product of variable pairs), with the step
// formulas of ops/pairing.py, so that the Miller outputs are limb-equal to
// the plain twins (and to the JAX package's miller_mixed_hostcall and
// miller_product_jit), not just equal after the final exponentiation.
#pragma once

#include "curve.cuh"

struct g2j {
  fq2 x, y, z;
};

// Sparse line f * ((l00, 0, 0) + (l10, l11, 0) w).
BN_NOINLINE void mul_by_l(fq12& f, const fq2& l00, const fq2& l10,
                          const fq2& l11) {
  const fq6& f0 = f.c0;
  const fq6& f1 = f.c1;
  fq2 b0, b1, b2, s0, p, q;
  fq2_add(b0, f0.c0, f1.c0);
  fq2_add(b1, f0.c1, f1.c1);
  fq2_add(b2, f0.c2, f1.c2);
  fq2_add(s0, l00, l10);
  fq6 t0, t1, s;
  fq2_mul(t0.c0, f0.c0, l00);
  fq2_mul(t0.c1, f0.c1, l00);
  fq2_mul(t0.c2, f0.c2, l00);
  // t1 = f1 * (l10, l11, 0)
  fq2_mul(p, f1.c0, l10);
  fq2_mul(q, f1.c2, l11);
  fq2_mul_xi(q, q);
  fq2_add(t1.c0, p, q);
  fq2_mul(p, f1.c1, l10);
  fq2_mul(q, f1.c0, l11);
  fq2_add(t1.c1, p, q);
  fq2_mul(p, f1.c2, l10);
  fq2_mul(q, f1.c1, l11);
  fq2_add(t1.c2, p, q);
  // s = (f0 + f1) * (l00 + l10, l11, 0)
  fq2_mul(p, b0, s0);
  fq2_mul(q, b2, l11);
  fq2_mul_xi(q, q);
  fq2_add(s.c0, p, q);
  fq2_mul(p, b1, s0);
  fq2_mul(q, b0, l11);
  fq2_add(s.c1, p, q);
  fq2_mul(p, b2, s0);
  fq2_mul(q, b1, l11);
  fq2_add(s.c2, p, q);
  // c1 = s - t0 - t1, c0 = t0 + v t1
  fq6_sub(s, s, t0);
  fq6_sub(f.c1, s, t1);
  fq6_mul_by_v(t1, t1);
  fq6_add(f.c0, t0, t1);
}

// Where ``on`` is false, replace the sparse line by (1, 0, 0): mul_by_l
// by it returns f limb for limb, so an infinite pair is skipped with the
// same calls on every lane of a warp (the rule in tower.cuh).
BN_INLINE void line_or_one(fq2& l00, fq2& l10, fq2& l11, bool on) {
  fq2 one, zero;
  fq2_one(one);
  fq2_zero(zero);
  fq2_select(l00, on, l00, one);
  fq2_select(l10, on, l10, zero);
  fq2_select(l11, on, l11, zero);
}

// Line (c0, c1, c3) evaluated at P: l00 = c0 yP, l10 = c1 xP, l11 = c3;
// f is left as it is where ``on`` is false.
BN_INLINE void mul_by_line(fq12& f, const fq2& c0, const fq2& c1,
                           const fq2& c3, const fp& xp, const fp& yp,
                           bool on) {
  fq2 l00, l10, l11 = c3;
  fq2_mul_fq(l00, c0, yp);
  fq2_mul_fq(l10, c1, xp);
  line_or_one(l00, l10, l11, on);
  mul_by_l(f, l00, l10, l11);
}

// Tangent step on the variable G2 point (Jacobian), with its line.
BN_NOINLINE void dbl_step(g2j& t, fq2& c0, fq2& c1, fq2& c3) {
  fq2 a, b, zz, yz, e, xb, c, f, xb2, zzz, ex, d, x3, z3, u;
  fq2_sq(a, t.x);
  fq2_sq(b, t.y);
  fq2_sq(zz, t.z);
  fq2_mul(yz, t.y, t.z);
  fq2_dbl(e, a);
  fq2_add(e, e, a);  // 3X^2
  fq2_add(xb, t.x, b);
  fq2_sq(c, b);
  fq2_sq(f, e);
  fq2_sq(xb2, xb);
  fq2_mul(zzz, zz, t.z);
  fq2_mul(ex, e, t.x);
  fq2_sub(d, xb2, a);
  fq2_sub(d, d, c);
  fq2_dbl(d, d);
  fq2_dbl(u, d);
  fq2_sub(x3, f, u);
  fq2_dbl(z3, yz);
  // line: c0 = Z3 Z^3, c1 = -E Z^3, c3 = Z (E X - 2B)
  fq2_mul(c0, z3, zzz);
  fq2_mul(c1, e, zzz);
  fq2_neg(c1, c1);
  fq2_dbl(u, b);
  fq2_sub(u, ex, u);
  fq2_mul(c3, t.z, u);
  // Y3 = E (D - X3) - 8C
  fq2_sub(u, d, x3);
  fq2_mul(u, e, u);
  fq2_dbl(c, c);
  fq2_dbl(c, c);
  fq2_dbl(c, c);
  fq2_sub(t.y, u, c);
  t.x = x3;
  t.z = z3;
}

// Chord step T + Q (Q affine), with its line.
BN_NOINLINE void add_step(g2j& t, const fq2& xq, const fq2& yq, fq2& c0,
                          fq2& c1, fq2& c3) {
  fq2 z1z1, u2, s2, h, rr, hh, rr2, i, j, v, z3, rxq, yqz3, z1d, x3, u;
  fq2_sq(z1z1, t.z);
  fq2_mul(u2, xq, z1z1);
  fq2_mul(s2, yq, z1z1);
  fq2_mul(s2, s2, t.z);
  fq2_sub(h, u2, t.x);
  fq2_sub(rr, s2, t.y);
  fq2_dbl(rr, rr);
  fq2_sq(hh, h);
  fq2_sq(rr2, rr);
  fq2_dbl(i, hh);
  fq2_dbl(i, i);
  fq2_dbl(z1d, t.z);
  fq2_mul(j, h, i);
  fq2_mul(v, t.x, i);
  fq2_mul(z3, z1d, h);
  fq2_mul(rxq, rr, xq);
  fq2_mul(yqz3, yq, z1d);
  fq2_mul(yqz3, yqz3, h);
  fq2_sub(x3, rr2, j);
  fq2_dbl(u, v);
  fq2_sub(x3, x3, u);
  // Y3 = rr (V - X3) - 2 Y1 J
  fq2_sub(u, v, x3);
  fq2_mul(u, rr, u);
  fq2_mul(j, t.y, j);
  fq2_dbl(j, j);
  fq2_sub(t.y, u, j);
  t.x = x3;
  t.z = z3;
  c0 = z3;
  fq2_neg(c1, rr);
  fq2_sub(c3, rxq, yqz3);
}

// Precomputed affine line (c0 == 1) of a fixed pair: l00 = (yP, 0),
// l10 = c1 xP, l11 = c3. ``row`` points at a (c1, c3) pair of (16, 2)
// int32 limb blocks in global memory, read through the read-only path.
BN_INLINE void load_fq2_row(fq2& r, const int32_t* row) {
  for (int k = 0; k < NW; ++k) {
    for (int c = 0; c < 2; ++c) {
      const uint32_t lo = (uint32_t)BN_LDG(row + (2 * k) * 2 + c);
      const uint32_t hi = (uint32_t)BN_LDG(row + (2 * k + 1) * 2 + c);
      (c ? r.c1 : r.c0).w[k] = (lo & 0xFFFFu) | (hi << 16);
    }
  }
}

// P at infinity (the all-zero encoding) leaves f as it is.
BN_INLINE void fixed_line_apply(fq12& f, const int32_t* c1row,
                                const int32_t* c3row, const fp& xp,
                                const fp& yp) {
  fq2 c1, l00, l10, l11;
  load_fq2_row(c1, c1row);
  load_fq2_row(l11, c3row);
  l00.c0 = yp;
  fp_zero(l00.c1);
  fq2_mul_fq(l10, c1, xp);
  line_or_one(l00, l10, l11, !(fp_is_zero(xp) && fp_is_zero(yp)));
  mul_by_l(f, l00, l10, l11);
}

// Fixed pair j's line from ``rows`` (row block of its table) at P_j.
BN_INLINE void fixed_pair_apply(fq12& f, const int32_t* fpx,
                                const int32_t* fpy, int j, const int32_t* row,
                                int64_t row_stride, int64_t n, int64_t lane) {
  fp x, y;
  load_fp(x, fpx + (int64_t)j * 16 * n + lane, n);
  load_fp(y, fpy + (int64_t)j * 16 * n + lane, n);
  fixed_line_apply(f, row, row + row_stride, x, y);
}

BN_INLINE void g2_frobenius(fq2& x, fq2& y, const fq2& xq, const fq2& yq,
                            int power) {
  fq2 gx, gy;
  load_fq2_const(gx, &TWIST_FROB[(power - 1) * 4 * NW]);
  load_fq2_const(gy, &TWIST_FROB[(power - 1) * 4 * NW + 2 * NW]);
  if (power & 1) {
    fq2_conj(x, xq);
    fq2_conj(y, yq);
  } else {
    x = xq;
    y = yq;
  }
  fq2_mul(x, x, gx);
  fq2_mul(y, y, gy);
}

#define LINE_BLOCK 32  // int32 words of one (16, 2) line coefficient

// A variable pair of a Miller loop: P = (xp, yp) and Q = (xq, yq) affine,
// T the running multiple of Q in Jacobian coordinates. ``on`` is false
// where P or Q is at infinity (the all-zero encoding: the wrappers zero
// masked lanes); its lines are then (1, 0, 0), through the same calls as
// the other lanes, so the pair multiplies by one (e(O,Q) = e(P,O) = 1).
struct var_pair {
  fp xp, yp;
  fq2 xq, yq;
  g2j t;
  bool on;
};

// Loads one lane's pair: px, py point at the pair's (16, n) G1
// coordinates, qx, qy at its (16, 2, n) Fq2 ones.
BN_INLINE void var_pair_load(var_pair& v, const int32_t* px, const int32_t* py,
                             const int32_t* qx, const int32_t* qy, int64_t n,
                             int64_t lane) {
  load_fp(v.xp, px + lane, n);
  load_fp(v.yp, py + lane, n);
  load_fp(v.xq.c0, qx + lane, 2 * n);
  load_fp(v.xq.c1, qx + n + lane, 2 * n);
  load_fp(v.yq.c0, qy + lane, 2 * n);
  load_fp(v.yq.c1, qy + n + lane, 2 * n);
  const bool p_inf = fp_is_zero(v.xp) && fp_is_zero(v.yp);
  const bool q_inf = fq2_is_zero(v.xq) && fq2_is_zero(v.yq);
  v.on = !(p_inf || q_inf);
  v.t.x = v.xq;
  v.t.y = v.yq;
  fq2_one(v.t.z);
}

// The Miller schedule of f_{6x+2,Q}(P) with its two Frobenius lines, for m
// variable pairs v[0, m) and nf fixed pairs on one shared f-squaring chain.
// Fixed pairs: fpx, fpy (nf, 16, n); lines (nf, 4, STEPS, 16, 2) as rows
// (dbl_c1, dbl_c3, add_c1, add_c3); tails (nf, 2, 2, 16, 2) as (c1/c3,
// step). In exact arithmetic the shared chain equals the product of the
// separate Miller loops, and every value is fully reduced, so f is
// limb-equal to the plain twins (ops/pairing.py).
BN_INLINE void miller_chain(fq12& f, var_pair* v, int m, const int32_t* fpx,
                            const int32_t* fpy, int nf, const int32_t* lines,
                            const int32_t* tails, int64_t n, int64_t lane) {
  fq12_one(f);
  fq2 c0, c1, c3;
  for (int i = 0; i < BN_MILLER_STEPS; ++i) {
    fq12_sq(f, f);
    for (int j = 0; j < m; ++j) {
      dbl_step(v[j].t, c0, c1, c3);
      mul_by_line(f, c0, c1, c3, v[j].xp, v[j].yp, v[j].on);
    }
    for (int j = 0; j < nf; ++j)
      fixed_pair_apply(f, fpx, fpy, j,
                       lines + ((int64_t)(j * 4) * BN_MILLER_STEPS + i) * LINE_BLOCK,
                       BN_MILLER_STEPS * LINE_BLOCK, n, lane);
    if (!MILLER_BITS[i]) continue;  // add rows are zero where the bit is 0
    for (int j = 0; j < m; ++j) {
      add_step(v[j].t, v[j].xq, v[j].yq, c0, c1, c3);
      mul_by_line(f, c0, c1, c3, v[j].xp, v[j].yp, v[j].on);
    }
    for (int j = 0; j < nf; ++j)
      fixed_pair_apply(f, fpx, fpy, j,
                       lines + ((int64_t)(j * 4 + 2) * BN_MILLER_STEPS + i) * LINE_BLOCK,
                       BN_MILLER_STEPS * LINE_BLOCK, n, lane);
  }
  // Frobenius corrections: q1 = pi(Q), q2 = -pi^2(Q)
  for (int j = 0; j < m; ++j) {
    fq2 x1, y1, x2, y2;
    g2_frobenius(x1, y1, v[j].xq, v[j].yq, 1);
    g2_frobenius(x2, y2, v[j].xq, v[j].yq, 2);
    fq2_neg(y2, y2);
    add_step(v[j].t, x1, y1, c0, c1, c3);
    mul_by_line(f, c0, c1, c3, v[j].xp, v[j].yp, v[j].on);
    add_step(v[j].t, x2, y2, c0, c1, c3);
    mul_by_line(f, c0, c1, c3, v[j].xp, v[j].yp, v[j].on);
  }
  for (int k = 0; k < 2; ++k)
    for (int j = 0; j < nf; ++j)
      fixed_pair_apply(f, fpx, fpy, j, tails + ((int64_t)(j * 2) * 2 + k) * LINE_BLOCK,
                       2 * LINE_BLOCK, n, lane);
}

// One lane of kernel K3: at most one variable pair, px, py (16, n) and qx,
// qy (16, 2, n), or null; nf fixed pairs from their line tables.
BN_INLINE void miller_mixed_lane(const int32_t* px, const int32_t* py,
                                 const int32_t* qx, const int32_t* qy,
                                 const int32_t* fpx, const int32_t* fpy, int nf,
                                 const int32_t* lines, const int32_t* tails,
                                 int32_t* out, int64_t n, int64_t lane) {
  var_pair v[1];
  const int m = px != nullptr;
  if (m) var_pair_load(v[0], px, py, qx, qy, n, lane);
  fq12 f;
  miller_chain(f, v, m, fpx, fpy, nf, lines, tails, n, lane);
  store_fq12(out + lane, n, f);
}

#define MILLER_GROUP 4  // pairs per shared chain: 4 x (T, P, Q) = 1.5 KB of local memory

// One lane of kernel K5: the product over npairs >= 1 variable pairs, px, py
// (npairs, 16, n) and qx, qy (npairs, 16, 2, n), of their Miller values, as
// (16, 12, n). Groups of MILLER_GROUP pairs share one chain each; the group
// values are multiplied together (the work of the TPU's
// _fq12_product_kernel), so the output is limb-equal to
// ops/pairing.py::miller_product.
BN_INLINE void miller_product_lane(const int32_t* px, const int32_t* py,
                                   const int32_t* qx, const int32_t* qy,
                                   int npairs, int32_t* out, int64_t n,
                                   int64_t lane) {
  var_pair v[MILLER_GROUP];
  fq12 acc, f;
  for (int first = 0; first < npairs; first += MILLER_GROUP) {
    const int m = npairs - first < MILLER_GROUP ? npairs - first : MILLER_GROUP;
    for (int j = 0; j < m; ++j)
      var_pair_load(v[j], px + (int64_t)(first + j) * 16 * n,
                    py + (int64_t)(first + j) * 16 * n,
                    qx + (int64_t)(first + j) * 32 * n,
                    qy + (int64_t)(first + j) * 32 * n, n, lane);
    miller_chain(f, v, m, nullptr, nullptr, 0, nullptr, nullptr, n, lane);
    if (first == 0)
      acc = f;
    else
      fq12_mul(acc, acc, f);
  }
  store_fq12(out + lane, n, acc);
}

// a^x for the BN parameter x, a in the cyclotomic subgroup (rolled loop).
BN_NOINLINE void cyc_exp_x(fq12& r, const fq12& a) {
  fq12 acc = a;
  for (int i = 1; i < BN_X_NBITS; ++i) {
    fq12_cyclotomic_sq(acc, acc);
    if (X_BITS[i]) fq12_mul(acc, acc, a);
  }
  r = acc;
}

// acc -> sq(... sq(sq(acc) * e0) * e1 ...) * e3), then one more sq.
BN_NOINLINE void fe_ladder(fq12& acc, const fq12& e0, const fq12& e1,
                           const fq12& e2, const fq12& e3) {
  const fq12* e[4] = {&e0, &e1, &e2, &e3};
  for (int k = 0; k < 4; ++k) {
    fq12_cyclotomic_sq(acc, acc);
    fq12_mul(acc, acc, *e[k]);
  }
  fq12_cyclotomic_sq(acc, acc);
}

// f^((p^12 - 1) / r) by the x-chain (ops/pairing.py::final_exponentiation):
// m = f^((p^6-1)(p^2+1)); A, B, C = m^x, m^(x^2), m^(x^3);
// t0 = conj((C^18 B^15 A^9 m)^2), t1 = conj((C^18 B^9 A^6)^2) m,
// t2 = (B^3)^2 m; out = t0 t1^p t2^(p^2) m^(p^3).
// Any input, zero included, is well-defined arithmetic (no faults): the
// answer of a bad lane is masked by the caller.
BN_INLINE void final_exp_lane(const int32_t* fin, int32_t* out, int64_t n,
                              int64_t lane) {
  fq12 f, m, a, b, c, u, v, acc;
  load_fq12(f, fin + lane, n);
  fq12_conj(u, f);
  fq12_inv(v, f);
  fq12_mul(m, u, v);                  // ^(p^6 - 1)
  fq12_frobenius(u, m, 2);
  fq12_mul(m, u, m);                  // ^(p^2 + 1)
  cyc_exp_x(a, m);
  cyc_exp_x(b, a);
  cyc_exp_x(c, b);
  // acc0 ladder over (BA, B, CB, BAm)
  fq12 ba, cb, bam;
  fq12_mul(ba, b, a);
  fq12_mul(cb, c, b);
  fq12_mul(bam, ba, m);
  acc = c;
  fe_ladder(acc, ba, b, cb, bam);
  fq12_conj(f, acc);                  // t0
  // acc1 ladder over (B, A, CA, B)
  fq12_mul(u, c, a);
  acc = c;
  fe_ladder(acc, b, a, u, b);
  fq12_conj(acc, acc);
  fq12_mul(u, acc, m);                // t1
  fq12_frobenius(u, u, 1);
  fq12_mul(f, f, u);
  fq12_cyclotomic_sq(u, b);
  fq12_mul(u, u, b);
  fq12_cyclotomic_sq(u, u);
  fq12_mul(u, u, m);                  // t2
  fq12_frobenius(u, u, 2);
  fq12_mul(f, f, u);
  fq12_frobenius(u, m, 3);
  fq12_mul(f, f, u);
  store_fq12(out + lane, n, f);
}
