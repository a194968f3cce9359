// The pieces of a Miller loop that the team kernels K3 and K5 (team.cuh)
// take per pair: the variable pair's load and its infinity flag, and the
// line (1, 0, 0) of a pair that is off. The step formulas are those of
// ops/pairing.py, run as rounds of products over the team (team.cuh).
#pragma once

#include "curve.cuh"

// 32-bit words of a line row (l00, l10, l11) as g2_lines writes it
#define LINE_ROW_WORDS 48

struct g2j {
  fq2 x, y, z;
};

// Where ``on`` is false, replace the sparse line by (1, 0, 0): f times it
// is f limb for limb, so an infinite pair is skipped with the same
// operations on every thread of a warp.
BN_INLINE void line_or_one(fq2& l00, fq2& l10, fq2& l11, bool on) {
  fq2 one, zero;
  fq2_one(one);
  fq2_zero(zero);
  fq2_select(l00, on, l00, one);
  fq2_select(l10, on, l10, zero);
  fq2_select(l11, on, l11, zero);
}

// A variable pair of a Miller loop: P = (xp, yp) and Q = (xq, yq) affine,
// T the running multiple of Q in Jacobian coordinates. ``on`` is false
// where P or Q is at infinity (the all-zero encoding: the wrappers zero
// masked lanes); its lines are then (1, 0, 0), through the same operations
// as the other pairs, so the pair multiplies by one (e(O,Q) = e(P,O) = 1).
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
