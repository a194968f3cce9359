// Kernel msm_fixed on a team of FX_TEAM threads per lane: sum_j sc_j * P_j
// in affine form for points P_j fixed across the lanes, read from their
// window table: for each point j and window w of FX_WINDOW = 8 bits, the
// affine entries d * 2^(8 w) * P_j for d = 1 .. 255 (ops/pairing_cuda.py::
// fixed_base_table builds it once per VK). The width is fixed: of 4, 6
// and 8 bits, 8 was the fastest on the H100 at both Groth16 shapes
// (PERF.md), and it makes a digit one byte of the scalar. The Groth16
// prepared input's points are the VK's, so both Groth16 paths (the batch
// and the single call) take it; K2 (msm.cuh) keeps every MSM whose points
// vary by lane.
//
// What it replaces: pairing_pallas.py:206 _msm_windowed_kernel (with
// :271 _jacobian_combine_kernel) where its points are fixed. That kernel,
// and K2, double one shared chain 256 times a lane and build each
// point's table in every lane; here the table is built once and a lane's
// work is one mixed add (affine entry into a Jacobian sum) per nonzero
// digit, with no doubling at all.
//
// What bounds it: a lane's chain of dependent products and the latency
// of its gathers from the table (64 B an entry; 32 windows x 255 entries
// x 64 B, about 0.5 MB a point, so a VK's table stays in the 50 MB L2;
// ops/msm.py::use_fixed_table builds none past FIXED_MAX_POINTS), not
// issue or bandwidth. What the design does about it: the
// team's threads split the lane's (point, window) pairs, thread r taking
// pairs r, r + FX_TEAM, ..., so a thread's chain is a few mixed adds
// (8 at n = 4) where K2's is 256 doublings and 64 adds; the entry
// of a thread's next pair is loaded before its current add, so the
// gather's latency hides under the add. The threads' sums meet in
// shared memory (a Jacobian point a thread, 1.5 KB a lane) and are added
// in a tree; then every thread of the team converts the sum to affine
// (fp.cuh::fq_inv_binary) and rank 0 stores it, as in K2. Small shared
// memory leaves registers to set the occupancy.
//
// The affine result is unique, so this gives the limbs of K2 and of the
// plain twin (ops/msm.py::msm_fixed_plain). An entry at infinity (the
// table of a point at infinity) is all zero words: (0, 0) is not on the
// curve. The G1 functions branch on lane data (a zero digit, infinity,
// P == +-Q): they are inlined and hold no barrier, and every thread of
// the block reaches every TEAM_SYNC (the rule in tower.cuh). Threads of
// lanes past the end run on the last lane's scalars and store nothing.
#pragma once

#include "team.cuh"

// The kernel's shape: 16 threads take n = 4 points' 128 pairs 8 apiece.
#define FX_TEAM 16
#define FX_LPB 4
static_assert((FX_TEAM & (FX_TEAM - 1)) == 0, "the partials' tree needs a power of two");

#define FX_WINDOW 8                                 // bits a window (ops/msm.py::FIXED_WINDOW)
#define FX_WINDOWS (256 / FX_WINDOW)                // windows of a 256-bit scalar
#define FX_DIGITS ((1 << FX_WINDOW) - 1)            // entries a window, digits 1 .. 255
#define FX_ENTRY_WORDS 16                           // an affine entry: x, then y
#define FX_LANE_WORDS (FX_TEAM * 24 + 1)            // a Jacobian sum a thread, odd stride

BN_HOST_DEVICE long long msm_fixed_smem_bytes() { return 4ll * FX_LPB * FX_LANE_WORDS; }

// Window w of scalar j of lane src, its byte w; sc (npts, 16, n) 16-bit
// limbs.
BN_INLINE uint32_t fx_digit(const int32_t* sc, int j, int w, long long n, long long src) {
  const uint32_t limb = (uint32_t)BN_LDG(sc + ((long long)j * 16 + (w >> 1)) * n + src);
  return (limb >> (8 * (w & 1))) & 0xFF;
}

// Pair p's digit into d and, where it is nonzero, its table entry into
// (x, y); d = 0 past the lane's last pair.
BN_INLINE void fx_fetch(uint32_t& d, fp& x, fp& y, const uint32_t* table, const int32_t* sc,
                        int p, int pairs, long long n, long long src) {
  d = 0;
  if (p >= pairs) return;
  const int j = p / FX_WINDOWS, w = p % FX_WINDOWS;
  d = fx_digit(sc, j, w, n, src);
  if (d == 0) return;
  const uint32_t* e = table + ((long long)p * FX_DIGITS + d - 1) * FX_ENTRY_WORDS;
#if defined(__CUDACC__)
  const uint4* v = (const uint4*)e;  // 64 B an entry, 64-B aligned
  const uint4 a = __ldg(v), b = __ldg(v + 1), c2 = __ldg(v + 2), d2 = __ldg(v + 3);
  const uint4 q[4] = {a, b, c2, d2};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    fp& t = k < 2 ? x : y;
    const int o = 4 * (k & 1);
    t.w[o] = q[k].x;
    t.w[o + 1] = q[k].y;
    t.w[o + 2] = q[k].z;
    t.w[o + 3] = q[k].w;
  }
#else
  for (int k = 0; k < NW; ++k) {
    x.w[k] = e[k];
    y.w[k] = e[NW + k];
  }
#endif
}

// Thread ``tid`` of block ``block`` of kernel msm_fixed: table (npts,
// FX_WINDOWS, FX_DIGITS, 16) words (x then y, Montgomery, 32-bit words),
// sc (npts, 16, n) canonical Fr limbs; ox, oy (16, n), oinf (n); smem as
// msm_fixed_smem_bytes().
BN_INLINE void msm_fixed_team(int tid, long long block, uint32_t* smem, const uint32_t* table,
                              const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                              uint8_t* oinf, long long n) {
  const int r = tid % FX_TEAM;
  const long long lane = block * FX_LPB + tid / FX_TEAM;
  const long long src = lane < n ? lane : n - 1;
  g1j* part = (g1j*)(smem + (long long)(tid / FX_TEAM) * FX_LANE_WORDS);
  const int pairs = npts * FX_WINDOWS;
  g1j acc;
  g1_inf(acc);
  uint32_t d;
  fp ex, ey;
  fp_zero(ex);
  fp_zero(ey);
  fx_fetch(d, ex, ey, table, sc, r, pairs, n, src);
#pragma unroll 1
  for (int p = r; p < pairs; p += FX_TEAM) {
    const uint32_t dc = d;
    const fp x = ex, y = ey;
    fx_fetch(d, ex, ey, table, sc, p + FX_TEAM, pairs, n, src);
    if (dc != 0) g1_add_mixed(acc, acc, x, y, fp_is_zero(x) && fp_is_zero(y));
  }
  part[r] = acc;
  TEAM_SYNC();
#pragma unroll 1
  for (int step = 1; step < FX_TEAM; step *= 2) {
    if (r % (2 * step) == 0) {
      g1j a = part[r];
      const g1j b = part[r + step];
      g1_add(a, a, b);
      part[r] = a;
    }
    TEAM_SYNC();
  }
  const g1j total = part[0];
  fp x, y;
  bool inf;
  g1_to_affine(x, y, inf, total);
  if (r == 0 && lane < n) {
    store_fp(ox + lane, n, x);
    store_fp(oy + lane, n, y);
    oinf[lane] = inf ? 1 : 0;
  }
}
