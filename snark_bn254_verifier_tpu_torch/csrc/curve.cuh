// G1 Jacobian arithmetic and the per-lane windowed MSM of kernel K2.
//
// Formulas and edge handling follow ops/curve.py: dbl-2009-l,
// madd-2007-bl and add-2007-bl, where P == Q doubles, P == -Q gives
// infinity and an infinite operand yields the other one. Infinity is
// Z == 0; the affine result maps it to (0, 0, inf).
#pragma once

#include "tower.cuh"

#define MSM_WINDOW 4
#define MSM_TABLE (1 << MSM_WINDOW)
#define MSM_GROUP 4  // points per Straus pass: 4 x 16 entries x 96 B of local memory

// The G1 functions are inlined into K2, so their branches on lane data
// (infinity, P == +-Q) hold no __noinline__ call (see the rule in
// tower.cuh): built __noinline__, K2 faulted whenever a warp's lanes
// diverged through them.

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

// Jacobian -> affine with one Fermat inversion; infinity -> (0, 0, true).
// Every lane inverts (a warp-uniform call): Fermat maps Z = 0 to 0, which
// makes x = y = 0 at infinity without a branch.
BN_INLINE void g1_to_affine(fp& x, fp& y, bool& inf, const g1j& p) {
  inf = fp_is_zero(p.z);
  fp zinv, zinv2, t;
  fq_inv(zinv, p.z);
  fp_sq<FQ>(zinv2, zinv);
  fp_mul<FQ>(x, p.x, zinv2);
  fp_mul<FQ>(t, zinv, zinv2);
  fp_mul<FQ>(y, p.y, t);
}

// Jacobian sum_j sc_j * P_j over points first .. first + m - 1 of one
// lane, m <= MSM_GROUP: windowed shared-doubling Straus with w = 4, as
// _msm_windowed_kernel computes one chunk. A 16-entry Jacobian table per
// point (even entries by doubling, odd by a mixed add), then per window,
// high first, 4 shared doublings and one add per point of the entry its
// digit selects; digit 0 selects the infinity entry.
BN_INLINE void msm_group(g1j& acc, const int32_t* px, const int32_t* py,
                         const uint8_t* pinf, const int32_t* sc, int first,
                         int m, int64_t n, int64_t lane) {
  g1j tbl[MSM_GROUP][MSM_TABLE];
  fp scal[MSM_GROUP];
  for (int j = 0; j < m; ++j) {
    const int64_t pt = first + j;
    fp x, y;
    load_fp(x, px + pt * 16 * n + lane, n);
    load_fp(y, py + pt * 16 * n + lane, n);
    const bool inf = pinf[pt * n + lane] != 0;
    load_fp(scal[j], sc + pt * 16 * n + lane, n);
    g1_inf(tbl[j][0]);
    tbl[j][1].x = x;
    tbl[j][1].y = y;
    if (inf)
      fp_zero(tbl[j][1].z);
    else
      fp_one<FQ>(tbl[j][1].z);
    for (int d = 2; d < MSM_TABLE; ++d) {
      if (d % 2 == 0)
        g1_dbl(tbl[j][d], tbl[j][d / 2]);
      else
        g1_add_mixed(tbl[j][d], tbl[j][d - 1], x, y, inf);
    }
  }
  g1_inf(acc);
  for (int win = 256 / MSM_WINDOW - 1; win >= 0; --win) {
    for (int k = 0; k < MSM_WINDOW; ++k) g1_dbl(acc, acc);
    const int bit = win * MSM_WINDOW;
    for (int j = 0; j < m; ++j) {
      const uint32_t dig = (scal[j].w[bit >> 5] >> (bit & 31)) & (MSM_TABLE - 1);
      g1_add(acc, acc, tbl[j][dig]);
    }
  }
}

// One lane of kernel K2: sum_j sc_j * P_j for any npts >= 1.
// px, py, sc: (npts, 16, n) limbs (sc canonical Fr); pinf: (npts, n).
// Groups of MSM_GROUP points run one Straus pass each; their Jacobian
// partials are summed, then one inversion gives the affine result, as
// _jacobian_combine_kernel sums the chunks of _msm_windowed_kernel.
BN_INLINE void msm_affine_lane(const int32_t* px, const int32_t* py,
                               const uint8_t* pinf, const int32_t* sc, int npts,
                               int32_t* ox, int32_t* oy, uint8_t* oinf,
                               int64_t n, int64_t lane) {
  g1j sum, part;
  g1_inf(sum);
  for (int first = 0; first < npts; first += MSM_GROUP) {
    const int m = npts - first < MSM_GROUP ? npts - first : MSM_GROUP;
    msm_group(part, px, py, pinf, sc, first, m, n, lane);
    g1_add(sum, sum, part);
  }
  fp x, y;
  bool inf;
  g1_to_affine(x, y, inf, sum);
  store_fp(ox + lane, n, x);
  store_fp(oy + lane, n, y);
  oinf[lane] = inf ? 1 : 0;
}
