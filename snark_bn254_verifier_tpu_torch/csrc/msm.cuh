// Kernel K2 (msm_affine) on a team of MSM_TEAM threads per lane:
// sum_j sc_j * P_j in affine form, for any npts >= 1.
//
// What bounds it: a lane's work is one chain of dependent Montgomery
// products (256 doublings and 64 adds of a 4-bit windowed Straus pass, 7
// and 16 products each), a few hundred bytes of input, so latency sets the
// time, not issue or memory. The TPU kernel (_msm_windowed_kernel) runs
// all points of a chunk on one shared doubling chain, then
// _jacobian_combine_kernel sums the chunks. Here thread r of the team takes
// points r, r + MSM_TEAM, ... (one pass per MSM_TEAM points): it builds the
// point's 16-entry Jacobian table in shared memory (even entries by
// doubling, odd by a mixed add, entry 0 infinity) and runs its own
// windowed pass over it, high window first, adding the entry each digit
// selects. So a lane's chain is one point's 256 doublings however many
// points it has (up to MSM_TEAM), not one per group of points. The
// threads' partial sums meet in shared memory and are added in a tree;
// then every thread of the team converts the sum to affine (one binary
// Euclid inversion, fp.cuh::fq_inv_binary) and rank 0 stores it.
//
// The affine result is unique, so any order of the group operations gives
// the limbs of ops/curve.py::msm_affine. The G1 functions branch on lane
// data (infinity, P == +-Q): they are inlined and hold no barrier, and
// every thread of the block, with a point or without, reaches every
// TEAM_SYNC. Threads of lanes past the end run on the last lane's inputs
// and store nothing.
#pragma once

#include "team.cuh"

// The kernel's shape, chosen by measurement on an H100 (PERF.md records
// the shapes tried): PlonK's largest MSM has 11 points, one pass.
#define MSM_TEAM 16
#define MSM_LPB 2
static_assert((MSM_TEAM & (MSM_TEAM - 1)) == 0, "the partials' tree needs a power of two");

#define G1_WORDS 24                                    // a Jacobian point
#define MSM_THREAD_WORDS (MSM_TABLE * G1_WORDS + 1)    // a table, odd stride
#define MSM_LANE_WORDS (MSM_TEAM * (MSM_THREAD_WORDS + G1_WORDS) + 1)

BN_HOST_DEVICE long long msm_affine_smem_bytes() { return 4ll * MSM_LPB * MSM_LANE_WORDS; }

// The table 0, P, ..., 15 P of point ``pt`` of lane ``src`` into tbl, and
// its scalar into s.
BN_INLINE void msm_table(g1j* tbl, fp& s, const int32_t* px, const int32_t* py,
                         const uint8_t* pinf, const int32_t* sc, long long pt, long long n,
                         long long src) {
  fp x, y;
  load_fp(x, px + pt * 16 * n + src, n);
  load_fp(y, py + pt * 16 * n + src, n);
  load_fp(s, sc + pt * 16 * n + src, n);
  const bool inf = pinf[pt * n + src] != 0;
  g1j e;
  g1_inf(e);
  tbl[0] = e;
  e.x = x;
  e.y = y;
  if (inf)
    fp_zero(e.z);
  else
    fp_one<FQ>(e.z);
  tbl[1] = e;
#pragma unroll 1
  for (int d = 2; d < MSM_TABLE; ++d) {
    if (d % 2 == 0) {
      const g1j h = tbl[d / 2];
      g1_dbl(e, h);
    } else {
      g1_add_mixed(e, e, x, y, inf);  // e holds entry d - 1
    }
    tbl[d] = e;
  }
}

// acc = s * P by the 4-bit windows of s over P's table.
BN_INLINE void msm_pass(g1j& acc, const g1j* tbl, const fp& s) {
  g1_inf(acc);
#pragma unroll 1
  for (int win = 256 / MSM_WINDOW - 1; win >= 0; --win) {
#pragma unroll 1
    for (int k = 0; k < MSM_WINDOW; ++k) g1_dbl(acc, acc);
    const int bit = win * MSM_WINDOW;
    const uint32_t dig = (s.w[bit >> 5] >> (bit & 31)) & (MSM_TABLE - 1);
    const g1j q = tbl[dig];
    g1_add(acc, acc, q);
  }
}

// Thread ``tid`` of block ``block`` of kernel K2: px, py, sc (npts, 16, n)
// limbs (sc canonical Fr), pinf (npts, n); ox, oy (16, n), oinf (n);
// smem as msm_affine_smem_bytes().
BN_INLINE void msm_affine_team(int tid, long long block, uint32_t* smem, const int32_t* px,
                               const int32_t* py, const uint8_t* pinf, const int32_t* sc,
                               int npts, int32_t* ox, int32_t* oy, uint8_t* oinf, long long n) {
  const int r = tid % MSM_TEAM;
  const long long lane = block * MSM_LPB + tid / MSM_TEAM;
  const long long src = lane < n ? lane : n - 1;
  uint32_t* base = smem + (long long)(tid / MSM_TEAM) * MSM_LANE_WORDS;
  g1j* tbl = (g1j*)(base + r * MSM_THREAD_WORDS);
  g1j* part = (g1j*)(base + MSM_TEAM * MSM_THREAD_WORDS);
  g1j acc;
  g1_inf(acc);
#pragma unroll 1
  for (int pt = r; pt < npts; pt += MSM_TEAM) {
    fp s;
    g1j sum;
    msm_table(tbl, s, px, py, pinf, sc, pt, n, src);
    msm_pass(sum, tbl, s);
    g1_add(acc, acc, sum);
  }
  part[r] = acc;
  TEAM_SYNC();
#pragma unroll 1
  for (int step = 1; step < MSM_TEAM; step *= 2) {
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
