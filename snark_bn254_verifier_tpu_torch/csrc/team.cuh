// Kernels K3 (mixed Miller product), K4 (final exponentiation) and K5
// (Miller product of variable pairs) on a team of TEAM threads per lane
// (K3 18, K4 12, K5 four chains of 18), with each lane's state in shared
// memory and every product inlined into registers. K2's team (msm.cuh)
// uses the barrier here.
//
// Why a team: one thread per lane left three of four schedulers idle on
// the 32 SMs that a batch of 1024 lanes reached, and each lane's chain of
// dependent products set the time. An Fq12 is held in the w-basis,
// a = sum a_i w^i with w^6 = XI, and thread (k, h) of the team owns
// coefficient k: a product c = a * b is c_k = sum_j b_j a_{k-j}, with
// XI on the terms where k - j wraps. That gives six independent
// coefficient sums (six Fq2 products each) that run side by side on one
// instruction stream: a thread's rank picks its operands by index, never
// by a branch on lane data. TEAM = 6 SPLIT: the SPLIT threads (k, h) of a
// coefficient take every SPLIT-th term of its sum and add their parts (a
// team of 6, one thread per coefficient, was slower on the H100 for both
// kernels: PERF.md). A sparse line (w-coefficients 0, 1 and 3) is three
// terms; the Granger-Scott cyclotomic squaring is nine Fq2 squarings over
// the team, then a linear step. The G2 steps of K5's variable pairs (one
// a chain) run as rounds of independent Fq2 products (the *_OPS tables
// below, one product per thread), with the few additions between rounds
// on one thread. K3 runs no G2 step: its variable pair's lines come from
// kernel g2_lines (g2_lines.cuh), a row a step, copied into the lane's
// slots while the team squares f. Every value is fully reduced,
// so the outputs are limb-equal to the per-lane formulas of
// ops/pairing.py: a field element has one reduced form, whatever the
// order of the products.
//
// Layout: a block holds LPB lanes of TEAM threads (thread r of lane l is
// threadIdx l * TEAM + r; K5's lane is MP_CHAINS such teams). Shared
// memory holds, per block, the fixed pairs' line tables (K3; staged once,
// every lane of the block reads the same rows), then per lane its Fq12
// values, a scratch area and its slots (K3: the fixed pairs' P and the
// variable pair's rows; K5: the G2 slots), at a stride of an odd number
// of words so that the lanes of a warp fall on different banks. The whole
// block meets at each barrier; the schedule depends on no lane data, and
// the threads of lanes past the end run on the last lane's inputs and
// store nothing.
#pragma once

#include "pairing.cuh"

#if defined(__CUDACC__)
#define TEAM_SYNC() __syncthreads()
#else
// The host build (host_check.cc) runs each thread of a block as a fiber;
// a sync switches to the block's next fiber, so the fibers meet where the
// card's threads meet at __syncthreads.
void host_block_sync();
#define TEAM_SYNC() host_block_sync()
#endif

#define NF_MAX 2                                  // fixed pairs K3 stages
#define TAB_ROWS (4 * BN_MILLER_STEPS + 4)        // Fq2 rows per fixed pair
#define TEAM_SCRATCH 18                           // Fq2 scratch slots per lane
#define LINE_BLOCK 32  // int32 words of one (16, 2) line coefficient in a table

// The kernels' shapes: threads per lane and lanes per block, chosen by
// measurement on an H100 (PERF.md records the shapes tried).
#define MM_TEAM 18  // K3
#define MM_LPB 8
#define FE_TEAM 12  // K4
#define FE_LPB 8
#define MP_TEAM 18   // K5: threads per chain
#define MP_CHAINS 4  // K5: chains per lane, one pair each
#define MP_LPB 1

template <int TEAM>
struct team_t {
  static_assert(TEAM == 12 || TEAM == 18, "a team is 12 or 18 threads");
  static constexpr int SPLIT = TEAM / 6;  // threads per coefficient sum
  int r;     // rank in the team, h * 6 + k
  int k;     // the w-coefficient this thread owns
  int h;     // its slice of each sum's terms
  bool lead; // rank 0: runs the additions between G2 product rounds
};

template <int TEAM>
BN_INLINE team_t<TEAM> make_team(int rank) {
  return team_t<TEAM>{rank, rank % 6, rank / 6, rank == 0};
}

// Tower component (16, 12, n) of w-coefficient i, part c: 6(i%2) + 2(i/2) + c.
BN_INLINE int wcomp(int i) { return 6 * (i & 1) + 2 * (i >> 1); }

// lo += y x_{k-j} where j <= k; hi += y x_{k-j+6} where j > k (to be
// multiplied by XI = w^6). Both sums are updated through selects.
BN_INLINE void mul_term(fq2& lo, fq2& hi, const fq2& y, int j, const fq2* x, int k) {
  fq2 p, base, s;
  const bool wrap = j > k;
  fq2_mul_in(p, y, x[wrap ? k - j + 6 : k - j]);
  fq2_select(base, wrap, hi, lo);
  fq2_add(s, base, p);
  fq2_select(hi, wrap, s, hi);
  fq2_select(lo, wrap, lo, s);
}

// Thread (k, h)'s part of coefficient k -> out[k], once the whole team has
// read the operands (out may alias them); ends with the team in step.
template <int TEAM>
BN_INLINE void team_store(const team_t<TEAM>& t, fq2* out, fq2* scratch,
                          const fq2& lo, const fq2& hi) {
  fq2 part, x;
  fq2_mul_xi(x, hi);
  fq2_add(part, lo, x);
  scratch[t.r] = part;
  TEAM_SYNC();
  if (t.h == 0) {
    fq2 sum = scratch[t.k];
    for (int q = 1; q < t.SPLIT; ++q) fq2_add(sum, sum, scratch[t.k + 6 * q]);
    out[t.k] = sum;
  }
  TEAM_SYNC();
}

// out = x * y (Fq12, w-basis).
template <int TEAM>
BN_INLINE void team_mul(const team_t<TEAM>& t, fq2* out, const fq2* x, const fq2* y,
                        fq2* scratch) {
  fq2 lo, hi;
  fq2_zero(lo);
  fq2_zero(hi);
#pragma unroll 1
  for (int s = 0; s < 6 / t.SPLIT; ++s) {
    const int j = t.h + t.SPLIT * s;
    mul_term(lo, hi, y[j], j, x, t.k);
  }
  team_store(t, out, scratch, lo, hi);
}

// f = f * (l00 + l10 w + l11 w^3), the sparse line of ops/pairing.py's
// mul_by_l; every thread holds the same l00, l10, l11.
template <int TEAM>
BN_INLINE void team_mul_line(const team_t<TEAM>& t, fq2* f, fq2* scratch, const fq2& l00,
                             const fq2& l10, const fq2& l11) {
  fq2 lo, hi;
  fq2_zero(lo);
  fq2_zero(hi);
#pragma unroll 1
  for (int s = 0; s < (3 + t.SPLIT - 1) / t.SPLIT; ++s) {
    const int term = t.h + t.SPLIT * s;  // terms 0, 1, 2 at w^0, w^1, w^3
    if (term < 3) {
      fq2 y;
      fq2_select(y, term == 0, l00, term == 1 ? l10 : l11);
      mul_term(lo, hi, y, term == 2 ? 3 : term, f, t.k);
    }
  }
  team_store(t, f, scratch, lo, hi);
}

// out = x^2 for x in the cyclotomic subgroup (Granger-Scott, the formula of
// ops/tower.py::fq12_cyclotomic_sq): the pairs (w_q, w_{q+3}), q < 3, are
// squared in Fq4 from x_m^2 and (x_q + x_{q+3})^2, then
// w'_m = 3 t -/+ 2 w_m with t the pair value that feeds m.
template <int TEAM>
BN_INLINE void team_cyc_sq(const team_t<TEAM>& t, fq2* out, const fq2* x, fq2* scratch) {
  const fq2 a = x[t.k];
  fq2 s, v, sq;
  fq2_add(s, a, x[t.k < 3 ? t.k + 3 : t.k - 3]);
  fq2_select(v, t.h == 0, a, s);
  fq2_mul_in(sq, v, v);
  scratch[t.r] = sq;  // h = 0: x_k^2; h >= 1: (x_k + x_{k+3})^2
  TEAM_SYNC();
  const int q = (3 - t.k % 3) % 3;  // the pair whose square feeds w_k
  const bool odd = t.k & 1;
  fq2 t0 = scratch[q], t1 = scratch[q + 3], t2 = scratch[6 + q], u, p0, p1, p;
  fq2_mul_xi(u, t1);
  fq2_add(p0, u, t0);       // t0 + XI t1
  fq2_sub(p1, t2, t0);
  fq2_sub(p1, p1, t1);      // t2 - t0 - t1
  fq2_select(p, odd, p1, p0);
  fq2_mul_xi(u, p);
  fq2_select(p, t.k == 1, u, p);  // w_1 takes XI * p1
  fq2 p3, a2, plus, minus, res;
  fq2_add(p3, p, p);
  fq2_add(p3, p3, p);
  fq2_add(a2, a, a);
  fq2_add(plus, p3, a2);
  fq2_sub(minus, p3, a2);
  fq2_select(res, odd, plus, minus);
  TEAM_SYNC();
  if (t.h == 0) out[t.k] = res;
  TEAM_SYNC();
}

// out = x^(p^power): conj^power of each coefficient times its gamma.
template <int TEAM>
BN_INLINE void team_frobenius(const team_t<TEAM>& t, fq2* out, const fq2* x, int power) {
  fq2 c = x[t.k], g, n;
  fq2_conj(n, c);
  fq2_select(c, power & 1, n, c);
  load_fq2_const(g, &FROB_GAMMA[((power - 1) * 6 + t.k) * 2 * NW]);
  fq2_mul_in(c, c, g);
  TEAM_SYNC();
  if (t.h == 0) out[t.k] = c;
  TEAM_SYNC();
}

// out = conj(x) (the odd w-coefficients negated), or a copy.
template <int TEAM>
BN_INLINE void team_conj(const team_t<TEAM>& t, fq2* out, const fq2* x, bool negate = true) {
  fq2 c = x[t.k], n;
  fq2_neg(n, c);
  fq2_select(c, negate && (t.k & 1), n, c);
  TEAM_SYNC();
  if (t.h == 0) out[t.k] = c;
  TEAM_SYNC();
}

// out = x^-1: each thread inverts the whole value (the same calls on every
// thread; it runs once per lane) and keeps its coefficient.
template <int TEAM>
BN_INLINE void team_inv(const team_t<TEAM>& t, fq2* out, const fq2* x) {
  fq12 a;
#pragma unroll
  for (int i = 0; i < 6; ++i) fq12_wcoeff(a, i) = x[i];
  fq12_inv(a, a);
  fq2 c = fq12_wcoeff(a, 0);
#pragma unroll
  for (int i = 1; i < 6; ++i) fq2_select(c, t.k == i, fq12_wcoeff(a, i), c);
  TEAM_SYNC();
  if (t.h == 0) out[t.k] = c;
  TEAM_SYNC();
}

// f = 1 (w-basis).
template <int TEAM>
BN_INLINE void team_set_one(const team_t<TEAM>& t, fq2* f) {
  if (t.h == 0) {
    fq2_zero(f[t.k]);
    if (t.k == 0) fq2_one(f[0]);
  }
}

// ------------------------------------------------------------ lane memory

// Odd word strides per lane, so the lanes of a warp use different banks.
#define FE_BUFS 11
#define FE_LANE_WORDS ((FE_BUFS * 6 + TEAM_SCRATCH) * 16 + 1)

enum {
  // A K5 chain's Fq2 slots:
  // the variable pair's T = (X, Y, Z) and Q, the last line (C0, C1, C3),
  // P (c0 = xP, c1 = yP), its on flag, the add step's Q operand, the
  // Frobenius images of Q, the line's products at P (team_lines), and
  // temporaries.
  G_X, G_Y, G_Z, G_XQ, G_YQ, G_C0, G_C1, G_C3, G_P, G_ON, G_AQX, G_AQY,
  G_Q1X, G_Q1Y, G_Q2X, G_Q2Y, G_L, G_T0 = G_L + 2, G_SLOTS = G_T0 + 16
};
// K3 per lane: its f, scratch and slots: the fixed pairs' P and their
// lines' products at P, then the variable pair's line rows of a step (its
// tangent row, then its chord row), which g2_lines wrote.
enum { M_FP, M_L = M_FP + NF_MAX, M_V = M_L + NF_MAX, M_SLOTS = M_V + 6 };
#define MM_LANE_FQ2 (6 + TEAM_SCRATCH + M_SLOTS)
#define MM_LANE_WORDS (MM_LANE_FQ2 * 16 + 1)
// K5 per chain: its f, a partial product, the lane's product, scratch and
// slots; per lane MP_CHAINS of them.
#define MP_CHAIN_FQ2 (18 + TEAM_SCRATCH + G_SLOTS)
#define MP_LANE_WORDS (MP_CHAINS * MP_CHAIN_FQ2 * 16 + 1)

// Shared bytes of a block (the launches size it on the host).

BN_HOST_DEVICE long long miller_mixed_smem_bytes(int nf) {
  return 4ll * ((long long)nf * TAB_ROWS * 16 + (long long)MM_LPB * MM_LANE_WORDS);
}

BN_HOST_DEVICE long long final_exp_smem_bytes() { return 4ll * FE_LPB * FE_LANE_WORDS; }

BN_HOST_DEVICE long long miller_product_smem_bytes() { return 4ll * MP_LPB * MP_LANE_WORDS; }

// ------------------------------------------------ G2 product rounds

// One round: thread r < count computes slot out = slot a * slot b. No
// round writes a slot it reads.
struct prod_op {
  uint8_t out, a, b;
};

#define T_(i) (G_T0 + (i))
// Tangent step (pairing.cuh::dbl_step): a b zz yz | c f xb2 zzz ex |
// c0 c1' c3 yy.
BN_CONST prod_op DBL_OPS[3][5] = {
    {{T_(0), G_X, G_X}, {T_(1), G_Y, G_Y}, {T_(2), G_Z, G_Z}, {T_(3), G_Y, G_Z}},
    {{T_(6), T_(1), T_(1)}, {T_(7), T_(4), T_(4)}, {T_(8), T_(5), T_(5)},
     {T_(9), T_(2), G_Z}, {T_(10), T_(4), G_X}},
    {{G_C0, T_(14), T_(9)}, {G_C1, T_(4), T_(9)}, {G_C3, G_Z, T_(15)}, {T_(0), T_(4), T_(12)}},
};
BN_CONST uint8_t DBL_COUNT[3] = {4, 5, 4};
// Chord step with Q = (AQX, AQY) (pairing.cuh::add_step): z1z1 yq.z1d |
// u2 s2' | s2 hh z3 yqz3 | rr2 j v rxq | u jy.
BN_CONST prod_op ADD_OPS[5][4] = {
    {{T_(1), G_Z, G_Z}, {T_(2), G_AQY, T_(0)}},
    {{T_(3), G_AQX, T_(1)}, {T_(4), G_AQY, T_(1)}},
    {{T_(6), T_(4), G_Z}, {T_(7), T_(5), T_(5)}, {T_(8), T_(0), T_(5)}, {T_(9), T_(2), T_(5)}},
    {{T_(12), T_(10), T_(10)}, {T_(13), T_(5), T_(11)}, {T_(14), G_X, T_(11)},
     {T_(15), T_(10), G_AQX}},
    {{T_(4), T_(10), T_(3)}, {T_(5), G_Y, T_(13)}},
};
BN_CONST uint8_t ADD_COUNT[5] = {2, 2, 4, 4, 2};
// Frobenius images of Q: q1 = pi(Q), q2 = pi^2(Q) (negated after).
BN_CONST prod_op FROB_OPS[4] = {
    {G_Q1X, T_(4), T_(0)}, {G_Q1Y, T_(5), T_(1)}, {G_Q2X, G_XQ, T_(2)}, {G_Q2Y, G_YQ, T_(3)}};

template <int TEAM>
BN_INLINE void team_products(const team_t<TEAM>& t, fq2* G, const prod_op* ops, int count) {
  if (t.r < count) {
    const prod_op op = ops[t.r];
    fq2 p;
    fq2_mul_in(p, G[op.a], G[op.b]);
    G[op.out] = p;
  }
  TEAM_SYNC();
}

template <int TEAM>
BN_INLINE void team_dbl_step(const team_t<TEAM>& t, fq2* G) {
  team_products(t, G, DBL_OPS[0], DBL_COUNT[0]);
  if (t.lead) {
    fq2_dbl(G[T_(4)], G[T_(0)]);
    fq2_add(G[T_(4)], G[T_(4)], G[T_(0)]);      // e = 3a
    fq2_add(G[T_(5)], G[G_X], G[T_(1)]);        // xb = X + b
  }
  TEAM_SYNC();
  team_products(t, G, DBL_OPS[1], DBL_COUNT[1]);
  if (t.lead) {
    fq2 d, u;
    fq2_sub(d, G[T_(8)], G[T_(0)]);
    fq2_sub(d, d, G[T_(6)]);
    fq2_dbl(d, d);                               // d = 2(xb^2 - a - c)
    fq2_dbl(u, d);
    fq2_sub(G[T_(13)], G[T_(7)], u);             // x3 = f - 2d
    fq2_dbl(G[T_(14)], G[T_(3)]);                // z3 = 2 yz
    fq2_dbl(u, G[T_(1)]);
    fq2_sub(G[T_(15)], G[T_(10)], u);            // ex - 2b
    fq2_sub(G[T_(12)], d, G[T_(13)]);            // d - x3
  }
  TEAM_SYNC();
  team_products(t, G, DBL_OPS[2], DBL_COUNT[2]);
  if (t.lead) {
    fq2 c;
    fq2_neg(G[G_C1], G[G_C1]);
    fq2_dbl(c, G[T_(6)]);
    fq2_dbl(c, c);
    fq2_dbl(c, c);
    fq2_sub(G[G_Y], G[T_(0)], c);                // Y3 = e (d - x3) - 8c
    G[G_X] = G[T_(13)];
    G[G_Z] = G[T_(14)];
  }
  TEAM_SYNC();
}

// T + Q for Q in slots (qx, qy).
template <int TEAM>
BN_INLINE void team_add_step(const team_t<TEAM>& t, fq2* G, int qx, int qy) {
  if (t.lead) {
    G[G_AQX] = G[qx];
    G[G_AQY] = G[qy];
    fq2_dbl(G[T_(0)], G[G_Z]);                   // z1d = 2Z
  }
  TEAM_SYNC();
  team_products(t, G, ADD_OPS[0], ADD_COUNT[0]);
  team_products(t, G, ADD_OPS[1], ADD_COUNT[1]);
  if (t.lead) fq2_sub(G[T_(5)], G[T_(3)], G[G_X]);  // h = u2 - X
  TEAM_SYNC();
  team_products(t, G, ADD_OPS[2], ADD_COUNT[2]);
  if (t.lead) {
    fq2_sub(G[T_(10)], G[T_(6)], G[G_Y]);
    fq2_dbl(G[T_(10)], G[T_(10)]);               // rr = 2(s2 - Y)
    fq2_dbl(G[T_(11)], G[T_(7)]);
    fq2_dbl(G[T_(11)], G[T_(11)]);               // i = 4hh
  }
  TEAM_SYNC();
  team_products(t, G, ADD_OPS[3], ADD_COUNT[3]);
  if (t.lead) {
    fq2 u;
    fq2_sub(G[T_(1)], G[T_(12)], G[T_(13)]);
    fq2_dbl(u, G[T_(14)]);
    fq2_sub(G[T_(1)], G[T_(1)], u);              // x3 = rr^2 - j - 2v
    fq2_sub(G[T_(3)], G[T_(14)], G[T_(1)]);      // v - x3
  }
  TEAM_SYNC();
  team_products(t, G, ADD_OPS[4], ADD_COUNT[4]);
  if (t.lead) {
    fq2 u;
    fq2_dbl(u, G[T_(5)]);
    fq2_sub(G[G_Y], G[T_(4)], u);                // Y3 = rr (v - x3) - 2 Y j
    G[G_X] = G[T_(1)];
    G[G_Z] = G[T_(8)];
    G[G_C0] = G[T_(8)];                          // line: c0 = Z3, c1 = -rr,
    fq2_neg(G[G_C1], G[T_(10)]);                 // c3 = rr xQ - yQ Z3
    fq2_sub(G[G_C3], G[T_(15)], G[T_(9)]);
  }
  TEAM_SYNC();
}

// One line stage of the schedule: the products the line needs at P, one
// per thread (l00 = C0 yP and l10 = C1 xP), then f times the line (one
// where the pair is off).
template <int TEAM>
BN_INLINE void team_lines(const team_t<TEAM>& t, fq2* f, fq2* scratch, fq2* G) {
  if (t.r < 2) {
    fq2 p;
    fq2_mul_fq(p, G[G_C0 + t.r], t.r == 0 ? G[G_P].c1 : G[G_P].c0);
    G[G_L + t.r] = p;
  }
  TEAM_SYNC();
  fq2 l00 = G[G_L], l10 = G[G_L + 1], l11 = G[G_C3];
  line_or_one(l00, l10, l11, G[G_ON].c0.w[0] != 0);
  team_mul_line(t, f, scratch, l00, l10, l11);
}

// ---------------------------------------------------- the Miller schedule

// The Miller schedule of f_{6x+2,Q}(P) with its two Frobenius lines, for
// the variable pair in G, on one f chain: f = f * its Miller value. Every
// value is fully reduced, so f is limb-equal to the plain twins.
template <int TEAM>
BN_INLINE void team_miller(const team_t<TEAM>& t, fq2* f, fq2* scratch, fq2* G) {
#pragma unroll 1
  for (int i = 0; i < BN_MILLER_STEPS; ++i) {
    team_mul(t, f, f, f, scratch);
    team_dbl_step(t, G);
    team_lines(t, f, scratch, G);
    if (!MILLER_BITS[i]) continue;
    team_add_step(t, G, G_XQ, G_YQ);
    team_lines(t, f, scratch, G);
  }
  // Frobenius images of Q: q1 = pi(Q), q2 = -pi^2(Q)
  if (t.lead) {
    load_fq2_const(G[T_(0)], &TWIST_FROB[0]);
    load_fq2_const(G[T_(1)], &TWIST_FROB[2 * NW]);
    load_fq2_const(G[T_(2)], &TWIST_FROB[4 * NW]);
    load_fq2_const(G[T_(3)], &TWIST_FROB[6 * NW]);
    fq2_conj(G[T_(4)], G[G_XQ]);
    fq2_conj(G[T_(5)], G[G_YQ]);
  }
  TEAM_SYNC();
  team_products(t, G, FROB_OPS, 4);
  if (t.lead) fq2_neg(G[G_Q2Y], G[G_Q2Y]);
  TEAM_SYNC();
  for (int k = 0; k < 2; ++k) {  // the correction lines
    team_add_step(t, G, k ? G_Q2X : G_Q1X, k ? G_Q2Y : G_Q1Y);
    team_lines(t, f, scratch, G);
  }
}

// A variable pair's slots from its inputs (pairing.cuh::var_pair_load).
BN_INLINE void var_pair_put(fq2* G, const int32_t* px, const int32_t* py, const int32_t* qx,
                            const int32_t* qy, long long n, long long src) {
  var_pair v;
  var_pair_load(v, px, py, qx, qy, n, src);
  G[G_P].c0 = v.xp;
  G[G_P].c1 = v.yp;
  G[G_XQ] = v.xq;
  G[G_YQ] = v.yq;
  G[G_X] = v.t.x;
  G[G_Y] = v.t.y;
  G[G_Z] = v.t.z;
  fq2_zero(G[G_ON]);
  G[G_ON].c0.w[0] = v.on;
}

// (16, 12, n) output of a lane's Fq12 f: thread (k, 0) stores coefficient k.
template <int TEAM>
BN_INLINE void team_store_out(const team_t<TEAM>& t, int32_t* out, long long n, long long lane,
                              const fq2* f) {
  if (t.h == 0 && lane < n) {
    store_fp(out + wcomp(t.k) * n + lane, 12 * n, f[t.k].c0);
    store_fp(out + (wcomp(t.k) + 1) * n + lane, 12 * n, f[t.k].c1);
  }
}

// ------------------------------------------------------------------ K3

// One 32-bit word from device memory into shared memory: cp.async on the
// card, so the copy runs under the thread's next products; a plain copy
// on the host. copy_wait() waits for the thread's copies.
BN_INLINE void copy_word(uint32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *dst = (uint32_t)*src;
#endif
}

BN_INLINE void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Rows row .. row + rows - 1 of the variable pair's lines (g2_lines'
// lane-minor words) into each lane's slots from M_V on; the block's
// threads take the (word, lane) pairs in turn, lane fastest, so a warp
// reads neighbouring lanes of one word.
BN_INLINE void mm_fetch_rows(int tid, long long block, uint32_t* lanes, const int32_t* vlines,
                             long long n, int row, int rows) {
  const int total = rows * LINE_ROW_WORDS * MM_LPB;
#pragma unroll 1
  for (int w = tid; w < total; w += MM_LPB * MM_TEAM) {
    const int l = w % MM_LPB, word = w / MM_LPB;
    const long long lane = block * MM_LPB + l < n ? block * MM_LPB + l : n - 1;
    copy_word(lanes + (long long)l * MM_LANE_WORDS + (6 + TEAM_SCRATCH + M_V) * 16 + word,
              vlines + ((long long)row * LINE_ROW_WORDS + word) * n + lane);
  }
}

// One line stage of K3: each fixed line's l10 = c1 xP_j (c1 from table
// row ``row``), one product a thread, then f times the variable pair's
// line V (its row, already (1, 0, 0) where the pair is off), then times
// each fixed pair's (yP_j, c1 xP_j, c3) with c3 from row ``row3`` (one
// where P_j is at infinity, the all-zero encoding). The thread's row
// copies are waited for before the barrier, so V is complete after it.
template <int TEAM>
BN_INLINE void mm_lines(const team_t<TEAM>& t, fq2* f, fq2* scratch, fq2* G, const fq2* V,
                        const fq2* tab, int nf, int row, int row3) {
  if (t.r < nf) {
    fq2 p;
    fq2_mul_fq(p, tab[t.r * TAB_ROWS + row], G[M_FP + t.r].c0);
    G[M_L + t.r] = p;
  }
  copy_wait();
  TEAM_SYNC();
  if (V) team_mul_line(t, f, scratch, V[0], V[1], V[2]);
  for (int j = 0; j < nf; ++j) {
    const fq2& pj = G[M_FP + j];
    fq2 l00, l10 = G[M_L + j], l11 = tab[j * TAB_ROWS + row3];
    l00.c0 = pj.c1;
    fp_zero(l00.c1);
    line_or_one(l00, l10, l11, !(fp_is_zero(pj.c0) && fp_is_zero(pj.c1)));
    team_mul_line(t, f, scratch, l00, l10, l11);
  }
}

// Thread ``tid`` of block ``block`` of kernel K3: f = the product of the
// Miller values of the variable pair, whose lines g2_lines wrote to
// vlines (null where there is no variable pair), and of nf <= NF_MAX
// fixed pairs (P in fpx, fpy (nf, 16, n); lines in the VK's tables), on
// one f chain, in the schedule of ops/pairing.py::miller_product_mixed
// (table rows per fixed pair: dbl c1, dbl c3, add c1, add c3, STEPS
// each, then the tails' c1 (2) and c3 (2)); smem as
// miller_mixed_smem_bytes(nf). The team runs no G2 step: a step's
// variable rows are copied into the lane's slots as it starts, and the
// copies complete under f^2. In exact arithmetic the shared chain equals
// the product of the separate loops, and every value is fully reduced, so
// f is limb-equal to the plain twin.
BN_INLINE void miller_mixed_team(int tid, long long block, uint32_t* smem, const int32_t* vlines,
                                 const int32_t* fpx, const int32_t* fpy, int nf,
                                 const int32_t* lines, const int32_t* tails, int32_t* out,
                                 long long n) {
  constexpr int TEAM = MM_TEAM;
  const team_t<TEAM> t = make_team<TEAM>(tid % TEAM);
  const long long lane = block * MM_LPB + tid / TEAM;
  const long long src = lane < n ? lane : n - 1;
  // the fixed pairs' line rows, converted to 32-bit limbs, once per block
  fq2* tab = (fq2*)smem;
  for (int w = tid; w < nf * TAB_ROWS * 16; w += MM_LPB * TEAM) {
    const int row = w / 16, q = w % 16, j = row / TAB_ROWS, rr = row % TAB_ROWS;
    const int32_t* s = rr < 4 * BN_MILLER_STEPS
                           ? lines + ((long long)j * 4 * BN_MILLER_STEPS + rr) * LINE_BLOCK
                           : tails + ((long long)j * 4 + rr - 4 * BN_MILLER_STEPS) * LINE_BLOCK;
    const int c = q / NW, kk = q % NW;
    smem[w] = ((uint32_t)BN_LDG(s + 4 * kk + c) & 0xFFFFu) |
              ((uint32_t)BN_LDG(s + 4 * kk + 2 + c) << 16);
  }
  uint32_t* lanes = smem + (long long)nf * TAB_ROWS * 16;
  fq2* f = (fq2*)(lanes + (long long)(tid / TEAM) * MM_LANE_WORDS);
  fq2* scratch = f + 6;
  fq2* G = scratch + TEAM_SCRATCH;
  const fq2* V = vlines ? G + M_V : nullptr;
  if (t.lead) {
    for (int j = 0; j < nf; ++j) {
      load_fp(G[M_FP + j].c0, fpx + (long long)j * 16 * n + src, n);
      load_fp(G[M_FP + j].c1, fpy + (long long)j * 16 * n + src, n);
    }
  }
  team_set_one(t, f);
  TEAM_SYNC();
  const int S = BN_MILLER_STEPS;
  int row = 0;  // the variable pair's next line row
#pragma unroll 1
  for (int i = 0; i < S; ++i) {
    const int rows = 1 + MILLER_BITS[i];
    if (V) mm_fetch_rows(tid, block, lanes, vlines, n, row, rows);
    row += rows;
    team_mul(t, f, f, f, scratch);
    mm_lines(t, f, scratch, G, V, tab, nf, i, S + i);
    if (rows == 2) mm_lines(t, f, scratch, G, V ? V + 3 : V, tab, nf, 2 * S + i, 3 * S + i);
  }
  if (V) mm_fetch_rows(tid, block, lanes, vlines, n, row, 2);
  for (int k = 0; k < 2; ++k)  // the correction lines, with the tails
    mm_lines(t, f, scratch, G, V ? V + 3 * k : V, tab, nf, 4 * S + k, 4 * S + 2 + k);
  team_store_out(t, out, n, lane, f);
}

// ------------------------------------------------------------------ K5

// Thread ``tid`` of block ``block`` of kernel K5: the product over
// npairs >= 1 variable pairs, px, py (npairs, 16, n) and qx, qy
// (npairs, 16, 2, n), of their Miller values, as (16, 12, n). A lane has
// MP_CHAINS teams of MP_TEAM threads, each running K3's schedule on one
// pair with its own f chain (a chain with no pair left runs pair 0 with
// its lines set to one); then every team forms f_0 f_1 f_2 f_3 as
// (f_c f_{c^1}) (f_{c^2} f_{c^3}) and multiplies it into the lane's
// product, MP_CHAINS pairs at a time (the work of the TPU's
// _fq12_product_kernel). In exact arithmetic that is the twin's product of
// separate loops, so the output is limb-equal to
// ops/pairing.py::miller_product. smem as miller_product_smem_bytes().
BN_INLINE void miller_product_team(int tid, long long block, uint32_t* smem, const int32_t* px,
                                   const int32_t* py, const int32_t* qx, const int32_t* qy,
                                   int npairs, int32_t* out, long long n) {
  constexpr int TEAM = MP_TEAM;
  static_assert(MP_CHAINS == 4, "the product pairs chains c and c^1, then c and c^2");
  const team_t<TEAM> t = make_team<TEAM>(tid % TEAM);
  const int chain = (tid / TEAM) % MP_CHAINS, slot = tid / (TEAM * MP_CHAINS);
  const long long lane = block * MP_LPB + slot;
  const long long src = lane < n ? lane : n - 1;
  fq2* base = (fq2*)(smem + (long long)slot * MP_LANE_WORDS);
  fq2* f = base + chain * MP_CHAIN_FQ2;
  fq2 *g = f + 6, *acc = f + 12, *scratch = f + 18, *G = scratch + TEAM_SCRATCH;
#pragma unroll 1
  for (int first = 0; first < npairs; first += MP_CHAINS) {
    const long long j = first + chain < npairs ? first + chain : 0;
    if (t.lead) {
      var_pair_put(G, px + j * 16 * n, py + j * 16 * n, qx + j * 32 * n, qy + j * 32 * n, n,
                   src);
      if (first + chain >= npairs) G[G_ON].c0.w[0] = 0;
    }
    team_set_one(t, f);
    TEAM_SYNC();
    team_miller(t, f, scratch, G);
    team_mul(t, g, f, base + (chain ^ 1) * MP_CHAIN_FQ2, scratch);
    team_mul(t, f, g, base + (chain ^ 2) * MP_CHAIN_FQ2 + 6, scratch);
    if (first)
      team_mul(t, acc, acc, f, scratch);
    else
      team_conj(t, acc, f, false);
  }
  if (chain == 0) team_store_out(t, out, n, lane, acc);
}

// ------------------------------------------------------------------ K4

template <int TEAM>
BN_INLINE void team_cyc_exp_x(const team_t<TEAM>& t, fq2* r, const fq2* a, fq2* scratch) {
  team_conj(t, r, a, false);
#pragma unroll 1
  for (int i = 1; i < BN_X_NBITS; ++i) {
    team_cyc_sq(t, r, r, scratch);
    if (X_BITS[i]) team_mul(t, r, r, a, scratch);
  }
}

template <int TEAM>
BN_INLINE void team_fe_ladder(const team_t<TEAM>& t, fq2* acc, const fq2* e0, const fq2* e1,
                              const fq2* e2, const fq2* e3, fq2* scratch) {
  const fq2* e[4] = {e0, e1, e2, e3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    team_cyc_sq(t, acc, acc, scratch);
    team_mul(t, acc, acc, e[k], scratch);
  }
  team_cyc_sq(t, acc, acc, scratch);
}

// Thread ``tid`` of block ``block`` of kernel K4: f^((p^12 - 1) / r) by
// the x-chain (ops/pairing.py::final_exp); smem as final_exp_smem_bytes().
BN_INLINE void final_exp_team(int tid, long long block, uint32_t* smem, const int32_t* fin,
                              int32_t* out, long long n) {
  constexpr int TEAM = FE_TEAM;
  const team_t<TEAM> t = make_team<TEAM>(tid % TEAM);
  const long long lane = block * FE_LPB + tid / TEAM;
  const long long src = lane < n ? lane : n - 1;
  fq2* base = (fq2*)(smem + (long long)(tid / TEAM) * FE_LANE_WORDS);
  fq2 *F = base, *U = base + 6, *V = base + 12, *M = base + 18, *A = base + 24,
      *B = base + 30, *C = base + 36, *BA = base + 42, *CB = base + 48, *BAM = base + 54,
      *ACC = base + 60, *S = base + 66;
  if (t.h == 0) {
    load_fp(F[t.k].c0, fin + wcomp(t.k) * n + src, 12 * n);
    load_fp(F[t.k].c1, fin + (wcomp(t.k) + 1) * n + src, 12 * n);
  }
  TEAM_SYNC();
  team_conj(t, U, F);
  team_inv(t, V, F);
  team_mul(t, M, U, V, S);                 // ^(p^6 - 1)
  team_frobenius(t, U, M, 2);
  team_mul(t, M, U, M, S);                 // ^(p^2 + 1)
  team_cyc_exp_x(t, A, M, S);
  team_cyc_exp_x(t, B, A, S);
  team_cyc_exp_x(t, C, B, S);
  team_mul(t, BA, B, A, S);
  team_mul(t, CB, C, B, S);
  team_mul(t, BAM, BA, M, S);
  team_conj(t, ACC, C, false);
  team_fe_ladder(t, ACC, BA, B, CB, BAM, S);
  team_conj(t, F, ACC);                    // t0
  team_mul(t, U, C, A, S);
  team_conj(t, ACC, C, false);
  team_fe_ladder(t, ACC, B, A, U, B, S);
  team_conj(t, ACC, ACC);
  team_mul(t, U, ACC, M, S);               // t1
  team_frobenius(t, U, U, 1);
  team_mul(t, F, F, U, S);
  team_cyc_sq(t, U, B, S);
  team_mul(t, U, U, B, S);
  team_cyc_sq(t, U, U, S);
  team_mul(t, U, U, M, S);                 // t2
  team_frobenius(t, U, U, 2);
  team_mul(t, F, F, U, S);
  team_frobenius(t, U, M, 3);
  team_mul(t, F, F, U, S);
  team_store_out(t, out, n, lane, F);
}
