// Kernel K6 (msm_pippenger): the bucket (Pippenger) MSM per lane,
// sum_j sc_j * P_j in affine form, for large point counts.
//
// What it replaces: ops/msm.py::msm_pippenger of snark_bn254_verifier_tpu,
// which is XLA (a segmented associative scan over the sorted digits) with
// no Pallas original. The JAX package never wrote this kernel
// (ARCHITECTURE.md:176-181 scopes it), so it is written here by hand.
//
// What bounds it on an H100: at N = 2^16 points and c = 8 a lane needs
// about 23 M Montgomery products (one mixed add, 11 products, per point
// and window) on about 13 MB of input, so integer multiply-add issue
// bounds it (about 0.37 ms at the card's peak), not memory. The products
// come as chains of dependent ones, so the number of chains in flight and
// their length set the time.
//
// The design: the digits, their sort per (lane, window) and the start of
// each bucket's run are torch glue on the card (ops/msm.py::bucket_order).
// Launch 1 runs a block per (lane, window) of pip_threads(c) threads;
// thread t takes the buckets [t m, (t + 1) m), m = 2^c / threads, high
// first, adds each bucket's points straight into its running sum (one
// mixed add a point) and the running sum into its total after every
// bucket but its lowest; then its share of sum_j j B_j is total + lo *
// running (double-and-add by the small integer lo = t m). The shares meet
// in a tree in shared memory and thread 0 stores the window's Jacobian
// sum. So all 2^c buckets of all windows run side by side (at c = 8 a
// thread a bucket, 256 points at N = 2^16), instead of a window's 255
// buckets on one chain. Launch 2 runs a thread per lane: Horner over the
// windows, high first (c doublings and one add a window), and the affine
// conversion by one binary Euclid inversion.
//
// The G1 functions branch on lane data (empty buckets, P == +-Q) and the
// runs differ in length, so the threads of a warp diverge: every call is
// inlined (the rule in tower.cuh), and every thread of a block, with
// buckets or without, reaches every TEAM_SYNC.
#pragma once

#include "msm.cuh"

#define PIP_THREADS 256  // threads of a (lane, window) block at most

// Threads of a (lane, window) block, windows and shared bytes a block.
BN_HOST_DEVICE int pip_threads(int c) { return c < 8 ? 1 << c : PIP_THREADS; }
BN_HOST_DEVICE int pip_windows(int c) { return (256 + c - 1) / c; }
BN_HOST_DEVICE long long pip_smem_bytes(int c) { return 4ll * pip_threads(c) * G1_WORDS; }

// r = k * p for a small k >= 0, double-and-add from k's top bit.
BN_INLINE void g1_mul_small(g1j& r, const g1j& p, uint32_t k) {
  g1_inf(r);
  int top = 31;
  while (top >= 0 && !((k >> top) & 1u)) --top;
#pragma unroll 1
  for (int bit = top; bit >= 0; --bit) {
    g1_dbl(r, r);
    if ((k >> bit) & 1u) g1_add(r, r, p);
  }
}

// Thread t of the block of row = lane * W + window (launch 1): px, py
// (npts, 16, n) Montgomery limbs; order (n, W, npts) point indices sorted
// by digit; starts (n, W, 2^c + 1) each bucket's first position in order;
// part the block's shared memory (pip_smem_bytes); wsum (n, W) Jacobian
// window sums of G1_WORDS words.
BN_INLINE void pippenger_window_team(int t, long long row, g1j* part, const int32_t* px,
                                     const int32_t* py, const int32_t* order,
                                     const int32_t* starts, int npts, int c, uint32_t* wsum,
                                     long long n) {
  const int nt = pip_threads(c);
  const int m = (1 << c) / nt;
  const int lo = t * m;
  const long long lane = row / pip_windows(c);
  const int32_t* ord = order + row * npts;
  const int32_t* st = starts + row * ((1 << c) + 1);
  g1j running, total;
  g1_inf(running);
  g1_inf(total);
#pragma unroll 1
  for (int j = lo + m - 1; j >= lo; --j) {
    if (j > 0) {  // digit 0 goes to no bucket
#pragma unroll 1
      for (int k = st[j]; k < st[j + 1]; ++k) {
        const long long pt = ord[k];
        fp x, y;
        load_fp(x, px + pt * 16 * n + lane, n);
        load_fp(y, py + pt * 16 * n + lane, n);
        g1_add_mixed(running, running, x, y, false);
      }
    }
    if (j > lo) g1_add(total, total, running);
  }
  g1j share;
  g1_mul_small(share, running, (uint32_t)lo);
  g1_add(share, share, total);
  part[t] = share;
  TEAM_SYNC();
#pragma unroll 1
  for (int step = 1; step < nt; step *= 2) {
    if (t % (2 * step) == 0) {
      g1j a = part[t];
      const g1j b = part[t + step];
      g1_add(a, a, b);
      part[t] = a;
    }
    TEAM_SYNC();
  }
  if (t == 0) {
    const g1j s = part[0];
    uint32_t* out = wsum + row * G1_WORDS;
    for (int i = 0; i < NW; ++i) {
      out[i] = s.x.w[i];
      out[NW + i] = s.y.w[i];
      out[2 * NW + i] = s.z.w[i];
    }
  }
}

// Lane ``lane`` of launch 2: Horner over its W window sums, high first,
// then the affine result into ox, oy (16, n) and oinf (n).
BN_INLINE void pippenger_horner_lane(long long lane, const uint32_t* wsum, int c, int32_t* ox,
                                     int32_t* oy, uint8_t* oinf, long long n) {
  const int w = pip_windows(c);
  g1j acc, q;
  const uint32_t* ws = wsum + lane * w * G1_WORDS;
#pragma unroll 1
  for (int win = w - 1; win >= 0; --win) {
    for (int i = 0; i < NW; ++i) {
      q.x.w[i] = ws[win * G1_WORDS + i];
      q.y.w[i] = ws[win * G1_WORDS + NW + i];
      q.z.w[i] = ws[win * G1_WORDS + 2 * NW + i];
    }
    if (win == w - 1) {
      acc = q;
      continue;
    }
#pragma unroll 1
    for (int k = 0; k < c; ++k) g1_dbl(acc, acc);
    g1_add(acc, acc, q);
  }
  fp x, y;
  bool inf;
  g1_to_affine(x, y, inf, acc);
  store_fp(ox + lane, n, x);
  store_fp(oy + lane, n, y);
  oinf[lane] = inf ? 1 : 0;
}
