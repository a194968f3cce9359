// Kernel g2_lines on a team of GL_TEAM threads per lane: the G2 chain of
// a Miller loop's variable pair (P, Q), with each line evaluated at P.
// It writes the 102 lines of the pair's schedule (ops/lines.py::VAR_ROWS), in the order
// K3 multiplies them into f: per iteration of MILLER_BITS the tangent
// line, then the chord line where the bit is set, then the two Frobenius
// correction lines. A row is (l00, l10, l11) = (C0 yP, C1 xP, C3), the
// sparse line of ops/pairing.py::_mul_by_line; a lane where P or Q is at
// infinity (the all-zero encoding) writes the line (1, 0, 0) in every
// row, which is what pairing.cuh::line_or_one gives, so K3 multiplies
// every lane by every row with no flag. Output: (102, 3, 2, 8, n) 32-bit
// words, row word w of lane l at out[(row * 48 + w) * n + l],
// lane-minor so that the loads of K3 (team.cuh::miller_mixed_team), which
// keeps the same words in shared memory, coalesce.
//
// What it replaces: the G2 steps of pairing_pallas.py:99
// _miller_mixed_kernel, which that kernel runs inside its Miller loop.
// The chain never reads f, so it runs before the loop, as arkworks'
// G2Prepared does, and K3 reads its rows. K5 (team.cuh::team_miller)
// runs its pairs' steps in its team.
//
// What bounds it: a lane's chain of dependent Fq2 products, 64 tangent
// and 38 chord steps (about 4,500 Fp products a lane), not issue or
// bandwidth (19,584 B written a lane). Inside K3's 18-thread team, whose
// other work is Fq12 arithmetic, a round of 4-5 products left 13-17
// threads waiting at a block-wide barrier. What the design does about it:
// the steps are rounds of independent Fq2 products (the tables below, at
// most six a round), thread r of a lane's team taking products r,
// r + GL_TEAM, ...; the additions between rounds run on two threads, one
// Fq component each (every addition of a step is componentwise); the
// lines' products at P are rounds of their own kind, an Fq2 product by
// (xP, 0) or (yP, 0), placed in the rounds of the step so that the
// tangent step takes three rounds and the chord step five. A lane's team
// lies inside one warp and meets at warp barriers only. The slots sit
// in shared memory at an odd word stride per lane.
//
// Every value is fully reduced, so a field element has one form and the
// rows are limb-equal to the lines of ops/pairing.py's _dbl_step and
// _add_step times P, whatever the order of the products. The schedule
// depends on no lane data; threads of lanes past the end run on the last
// lane's inputs and store nothing.
#pragma once

#include "team.cuh"

// The team shape: threads per lane and lanes per block, chosen by
// measurement on an H100 (PERF.md records the shapes tried).
#define GL_TEAM 8
#define GL_LPB 16
static_assert(32 % GL_TEAM == 0, "a lane's team lies inside one warp");

#if defined(__CUDACC__)
#define LANE_SYNC() __syncwarp()
#else
#define LANE_SYNC() host_block_sync()  // a block's fibers, as TEAM_SYNC
#endif

enum {
  // T = (X, Y, Z); the chord step's Q (Q, then q1 and q2); P as the Fq2
  // values (xP, 0) and (yP, 0); the Frobenius images; the step's line.
  L_X, L_Y, L_Z, L_QX, L_QY, L_PX, L_PY, L_Q1X, L_Q1Y, L_Q2X, L_Q2Y,
  L_00, L_10, L_11, L_T0, L_SLOTS = L_T0 + 20
};
// a lane's slots, then its on flag: an odd stride
#define GL_LANE_WORDS (L_SLOTS * 16 + 1)
#define GT(i) (L_T0 + (i))

BN_HOST_DEVICE long long g2_lines_smem_bytes() { return 4ll * GL_LPB * GL_LANE_WORDS; }

// Tangent step (ops/pairing.py::_dbl_step): a b zz yz zx zy | c f xb2
// zzx zzy ex | y3m l00 l10' l11, with zx = Z xP, zzx = zz zx (so that
// l10 = -e zzx = C1 xP) and likewise for yP.
BN_CONST prod_op GL_DBL[3][6] = {
    {{GT(0), L_X, L_X}, {GT(1), L_Y, L_Y}, {GT(2), L_Z, L_Z}, {GT(3), L_Y, L_Z},
     {GT(4), L_Z, L_PX}, {GT(5), L_Z, L_PY}},
    {{GT(8), GT(1), GT(1)}, {GT(9), GT(6), GT(6)}, {GT(10), GT(7), GT(7)},
     {GT(11), GT(2), GT(4)}, {GT(12), GT(2), GT(5)}, {GT(13), GT(6), L_X}},
    {{GT(19), GT(6), GT(18)}, {L_00, GT(16), GT(12)}, {L_10, GT(6), GT(11)},
     {L_11, L_Z, GT(17)}},
};
BN_CONST uint8_t GL_DBL_COUNT[3] = {6, 6, 4};
// Chord step with Q = (QX, QY) (ops/pairing.py::_add_step): z1z1 yqz |
// u2 s2 | hh z3 rr2 rxq l10' | j v l00 yqzh | y3a y3b, with
// yq z3 = 2 yqz h.
BN_CONST prod_op GL_ADD[5][5] = {
    {{GT(0), L_Z, L_Z}, {GT(1), L_QY, L_Z}},
    {{GT(2), L_QX, GT(0)}, {GT(3), GT(1), GT(0)}},
    {{GT(7), GT(4), GT(4)}, {GT(8), GT(6), GT(4)}, {GT(9), GT(5), GT(5)},
     {GT(10), GT(5), L_QX}, {L_10, GT(5), L_PX}},
    {{GT(13), GT(4), GT(12)}, {GT(14), L_X, GT(12)}, {L_00, GT(8), L_PY},
     {GT(11), GT(1), GT(4)}},
    {{GT(17), GT(5), GT(16)}, {GT(18), L_Y, GT(13)}},
};
BN_CONST uint8_t GL_ADD_COUNT[5] = {2, 2, 5, 4, 2};
// Frobenius images of Q: q1 = pi(Q), q2 = pi^2(Q) (negated after).
BN_CONST prod_op GL_FROB[4] = {
    {L_Q1X, GT(4), GT(0)}, {L_Q1Y, GT(5), GT(1)}, {L_Q2X, L_QX, GT(2)}, {L_Q2Y, L_QY, GT(3)}};

// One round: the team's threads take its products in turn.
BN_INLINE void gl_products(int r, fq2* G, const prod_op* ops, int count) {
#pragma unroll 1
  for (int k = r; k < count; k += GL_TEAM) {
    const prod_op op = ops[k];
    fq2 p;
    fq2_mul_in(p, G[op.a], G[op.b]);
    G[op.out] = p;
  }
  LANE_SYNC();
}

// The additions between rounds: component c of slot s is S(s), and
// thread c < 2 runs every addition of a phase on its component (a team
// of one thread runs both).
#define GL_COMPONENTS(r) for (int c = (r); c < 2; c += GL_TEAM)
#define S(s) g[2 * (s) + c]

BN_INLINE void gl_dbl_step(int r, fq2* G) {
  fp* g = &G[0].c0;
  gl_products(r, G, GL_DBL[0], GL_DBL_COUNT[0]);
  GL_COMPONENTS(r) {
    fp_dbl<FQ>(S(GT(6)), S(GT(0)));
    fp_add<FQ>(S(GT(6)), S(GT(6)), S(GT(0)));    // e = 3a
    fp_add<FQ>(S(GT(7)), S(L_X), S(GT(1)));      // xb = X + b
  }
  LANE_SYNC();
  gl_products(r, G, GL_DBL[1], GL_DBL_COUNT[1]);
  GL_COMPONENTS(r) {
    fp u;
    fp_sub<FQ>(u, S(GT(10)), S(GT(0)));
    fp_sub<FQ>(u, u, S(GT(8)));
    fp_dbl<FQ>(S(GT(14)), u);                    // d = 2(xb^2 - a - c)
    fp_dbl<FQ>(u, S(GT(14)));
    fp_sub<FQ>(S(GT(15)), S(GT(9)), u);          // x3 = f - 2d
    fp_dbl<FQ>(S(GT(16)), S(GT(3)));             // z3 = 2 yz
    fp_dbl<FQ>(u, S(GT(1)));
    fp_sub<FQ>(S(GT(17)), S(GT(13)), u);         // ex - 2b
    fp_sub<FQ>(S(GT(18)), S(GT(14)), S(GT(15))); // d - x3
  }
  LANE_SYNC();
  gl_products(r, G, GL_DBL[2], GL_DBL_COUNT[2]);
  GL_COMPONENTS(r) {
    fp u;
    fp_neg<FQ>(S(L_10), S(L_10));
    fp_dbl<FQ>(u, S(GT(8)));
    fp_dbl<FQ>(u, u);
    fp_dbl<FQ>(u, u);
    fp_sub<FQ>(S(L_Y), S(GT(19)), u);            // Y3 = e (d - x3) - 8c
    S(L_X) = S(GT(15));
    S(L_Z) = S(GT(16));
  }
  LANE_SYNC();
}

// T + Q for Q in (QX, QY).
BN_INLINE void gl_add_step(int r, fq2* G) {
  fp* g = &G[0].c0;
  gl_products(r, G, GL_ADD[0], GL_ADD_COUNT[0]);
  gl_products(r, G, GL_ADD[1], GL_ADD_COUNT[1]);
  GL_COMPONENTS(r) {
    fp_sub<FQ>(S(GT(4)), S(GT(2)), S(L_X));      // h = u2 - X
    fp_sub<FQ>(S(GT(5)), S(GT(3)), S(L_Y));
    fp_dbl<FQ>(S(GT(5)), S(GT(5)));              // rr = 2(s2 - Y)
    fp_dbl<FQ>(S(GT(6)), S(L_Z));                // z1d = 2Z
  }
  LANE_SYNC();
  gl_products(r, G, GL_ADD[2], GL_ADD_COUNT[2]);
  GL_COMPONENTS(r) {
    fp_dbl<FQ>(S(GT(12)), S(GT(7)));
    fp_dbl<FQ>(S(GT(12)), S(GT(12)));            // i = 4hh
    fp_neg<FQ>(S(L_10), S(L_10));                // l10 = -rr xP
  }
  LANE_SYNC();
  gl_products(r, G, GL_ADD[3], GL_ADD_COUNT[3]);
  GL_COMPONENTS(r) {
    fp u;
    fp_sub<FQ>(S(GT(15)), S(GT(9)), S(GT(13)));
    fp_dbl<FQ>(u, S(GT(14)));
    fp_sub<FQ>(S(GT(15)), S(GT(15)), u);         // x3 = rr^2 - j - 2v
    fp_sub<FQ>(S(GT(16)), S(GT(14)), S(GT(15))); // v - x3
    fp_dbl<FQ>(u, S(GT(11)));                    // yq z3 = 2 yqz h
    fp_sub<FQ>(S(L_11), S(GT(10)), u);           // l11 = rr xQ - yQ Z3
  }
  LANE_SYNC();
  gl_products(r, G, GL_ADD[4], GL_ADD_COUNT[4]);
  GL_COMPONENTS(r) {
    fp u;
    fp_dbl<FQ>(u, S(GT(18)));
    fp_sub<FQ>(S(L_Y), S(GT(17)), u);            // Y3 = rr (v - x3) - 2 Y j
    S(L_X) = S(GT(15));
    S(L_Z) = S(GT(8));
  }
  LANE_SYNC();
}

// q1 = pi(Q) and q2 = -pi^2(Q) into (Q1X, Q1Y), (Q2X, Q2Y).
BN_INLINE void gl_frobenius(int r, fq2* G) {
  fp* g = &G[0].c0;
  GL_COMPONENTS(r) {
    for (int j = 0; j < 4; ++j)
      for (int k = 0; k < NW; ++k) S(GT(j)).w[k] = TWIST_FROB[(2 * j + c) * NW + k];
    fp n;
    fp_neg<FQ>(n, S(L_QX));
    fp_select(S(GT(4)), c == 1, n, S(L_QX));    // conj(xQ)
    fp_neg<FQ>(n, S(L_QY));
    fp_select(S(GT(5)), c == 1, n, S(L_QY));    // conj(yQ)
  }
  LANE_SYNC();
  gl_products(r, G, GL_FROB, 4);
  GL_COMPONENTS(r) fp_neg<FQ>(S(L_Q2Y), S(L_Q2Y));
  LANE_SYNC();
}

// The chord step's Q from slots (qx, qy).
BN_INLINE void gl_set_q(int r, fq2* G, int qx, int qy) {
  fp* g = &G[0].c0;
  GL_COMPONENTS(r) {
    S(L_QX) = S(qx);
    S(L_QY) = S(qy);
  }
  LANE_SYNC();
}
#undef S
#undef GL_COMPONENTS

// Row ``row`` of a lane from its line slots, (1, 0, 0) where the pair is
// off; thread r stores words r, r + GL_TEAM, ... The line is complete at
// the step's last barrier, and no slot of it is written again before the
// next step's third round, after two more.
BN_INLINE void gl_store_row(int r, const fq2* G, bool on, int32_t* out, long long n,
                            long long lane, int row) {
  if (lane >= n) return;
  const uint32_t* line = &G[L_00].c0.w[0];
#pragma unroll 1
  for (int w = r; w < LINE_ROW_WORDS; w += GL_TEAM) {
    const uint32_t off = w < NW ? FQ_ONE[w] : 0u;
    out[((long long)row * LINE_ROW_WORDS + w) * n + lane] = (int32_t)(on ? line[w] : off);
  }
}

// Thread ``tid`` of block ``block`` of kernel g2_lines: the pair's P
// (px, py (16, n)) and Q (qx, qy (16, 2, n)), Montgomery 16-bit limbs,
// zero where the pair is off; out as above; smem as g2_lines_smem_bytes().
BN_INLINE void g2_lines_team(int tid, long long block, uint32_t* smem, const int32_t* px,
                             const int32_t* py, const int32_t* qx, const int32_t* qy,
                             int32_t* out, long long n) {
  const int r = tid % GL_TEAM;
  const long long lane = block * GL_LPB + tid / GL_TEAM;
  const long long src = lane < n ? lane : n - 1;
  uint32_t* base = smem + (long long)(tid / GL_TEAM) * GL_LANE_WORDS;
  fq2* G = (fq2*)base;
  if (r == 0) {
    var_pair v;
    var_pair_load(v, px, py, qx, qy, n, src);
    G[L_X] = v.t.x;
    G[L_Y] = v.t.y;
    G[L_Z] = v.t.z;
    G[L_QX] = v.xq;
    G[L_QY] = v.yq;
    G[L_PX].c0 = v.xp;
    G[L_PY].c0 = v.yp;
    fp_zero(G[L_PX].c1);
    fp_zero(G[L_PY].c1);
    base[L_SLOTS * 16] = v.on;
  }
  LANE_SYNC();
  const bool on = base[L_SLOTS * 16] != 0;
  int row = 0;
#pragma unroll 1
  for (int i = 0; i < BN_MILLER_STEPS; ++i) {
    gl_dbl_step(r, G);
    gl_store_row(r, G, on, out, n, lane, row++);
    if (!MILLER_BITS[i]) continue;
    gl_add_step(r, G);
    gl_store_row(r, G, on, out, n, lane, row++);
  }
  gl_frobenius(r, G);
  for (int k = 0; k < 2; ++k) {
    gl_set_q(r, G, k ? L_Q2X : L_Q1X, k ? L_Q2Y : L_Q1Y);
    gl_add_step(r, G);
    gl_store_row(r, G, on, out, n, lane, row++);
  }
}
