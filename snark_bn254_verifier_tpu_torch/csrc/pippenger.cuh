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
// bounds it (about 0.36 ms at the card's peak), not memory. The products
// come as chains of dependent ones, so the number of chains in flight and
// their length set the time: the first design (a block per (lane, window),
// a thread per bucket) filled 32 of 132 SMs at batch one and ended in a
// 248-doubling Horner chain on one thread.
//
// The design, six launches over rows = (lane, window) pairs, W = ceil(256
// / c) windows of c bits, row = lane * W + window:
//   1. digits: a thread per (lane, point) cuts its scalar's 16-bit limbs
//      into W digits (a point at infinity takes digit 0);
//   2. sort: a block per row counts its 2^c digits in shared memory (in
//      global scratch above c = PIP_SORT_SMEM_C), scans the counts into
//      ``starts`` and scatters the point indices into ``order`` and the
//      digits into ``sdig``: ops/msm.py::bucket_order's contract. The
//      scatter takes its slots by atomic adds, so the order inside a
//      bucket differs from the stable sort's and from run to run; the
//      affine sum is unique, so the result does not;
//   3. buckets: the sorted entries of all rows together, digit 0 skipped,
//      are cut into fixed chunks of ``chunk`` entries, a thread a chunk,
//      so tens of thousands of threads on every SM share the 2 M mixed
//      adds at N = 2^16 whatever the rows' sizes. A thread adds its
//      entries into a running sum, one mixed add a point, and stores a
//      bucket's sum whenever its run ends inside the chunk. A run cut by
//      a chunk's edge leaves partial sums (the chunk's first run if it
//      began earlier, its last if it goes on);
//   4. merge: a thread per chunk whose last run goes on past its end adds
//      the next chunks' first-run partials until the run ends, and stores
//      that bucket;
//   5. reduction: a block per row (PIP_THREADS threads; PIP_NARROW from
//      PIP_WIDE_ROWS rows on, where many rows fill the card), every row's
//      block at once: thread t owns the buckets [t m, (t + 1) m), m = 2^c
//      / threads, high first, adds each bucket into its running sum and
//      the running sum into its total after every bucket but its lowest;
//      its share of sum_j j B_j is total + lo * running (double-and-add by
//      lo = t m), and the shares meet in a tree in shared memory;
//   6. combine (pippenger.cu's second unit, built with the unrolled
//      Montgomery product, which was faster for K4's chain at batch one):
//      a team of PIP_COMB_TEAM threads a lane adds k sets of window sums
//      window by window and runs Horner over the windows, high first. A
//      doubling's products (dbl-2009-l, a = 0) run in three rounds over
//      the team, {X^2, Y^2, Y Z}, then {B^2, (X + B)^2, E^2}, then E (D -
//      X3) on every thread, where one thread runs seven products in a
//      row; an add's 16 in five rounds; the team exchanges its values
//      through shared memory. The affine conversion (one binary Euclid
//      inversion) runs on every thread of the team alike. k > 1 is
//      parallel/sharded.py's sum of its ranks' window sums.
//
// What it does not use: tensor cores (a 256-bit modular product has no
// wgmma form that pays here: its 32 x 32 -> 64-bit carries are integer
// work), and copies by cp.async or TMA: points are gathered by index, 64
// bytes of each coordinate, and 2^16 points (8 MB) stay in the 50 MB L2.
//
// The G1 functions branch on lane data (empty buckets, P == +-Q) and the
// chunks' runs differ, so the threads of a warp diverge: every call is
// inlined (the rule in tower.cuh); every thread of a block reaches every
// TEAM_SYNC, and every thread of a warp every WARP_SYNC.
#pragma once

#include "msm.cuh"

#define PIP_THREADS 256       // threads of a row's reduction block at most
#define PIP_NARROW 32         // ... where there are PIP_WIDE_ROWS rows or more
#define PIP_WIDE_ROWS 1024
#define PIP_SORT_THREADS 1024 // threads of a row's sort block at most
#define PIP_SORT_SMEM_C 13    // the sort counts in shared memory up to this c
#define PIP_COMB_TEAM 4       // threads of a lane in the combine (three do products)
#define PIP_COMB_LPB 32       // lanes a combine block
#define PIP_XCH_WORDS (8 * NW + 1)  // a combine team's exchange slots, odd stride
static_assert(32 % PIP_COMB_TEAM == 0, "a combine team lies inside one warp");

#if defined(__CUDACC__)
#define WARP_SYNC() __syncwarp()
BN_INLINE uint32_t pip_atomic_add(uint32_t* p, uint32_t v) { return atomicAdd(p, v); }
#else
// The host build meets at the block's barrier wherever a warp meets.
#define WARP_SYNC() team_barrier->arrive_and_wait()
BN_INLINE uint32_t pip_atomic_add(uint32_t* p, uint32_t v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
#endif

// Windows, and the threads and shared bytes of a reduction block: few
// rows (batch one) take wide blocks, for a short chain a thread; many rows
// narrow ones, each thread taking more buckets, so more rows fit an SM.
BN_HOST_DEVICE int pip_windows(int c) { return (256 + c - 1) / c; }
BN_HOST_DEVICE int pip_threads(int c, long long rows) {
  const int cap = rows >= PIP_WIDE_ROWS ? PIP_NARROW : PIP_THREADS;
  return (1 << c) < cap ? 1 << c : cap;
}
BN_HOST_DEVICE long long pip_smem_bytes(int nt) { return 4ll * nt * G1_WORDS; }

// Threads and shared bytes of a sort block.
BN_HOST_DEVICE int pip_sort_threads(int npts) {
  return npts >= PIP_SORT_THREADS ? PIP_SORT_THREADS : (npts + 31) / 32 * 32;
}
BN_HOST_DEVICE bool pip_sort_in_smem(int c) { return c <= PIP_SORT_SMEM_C; }
BN_HOST_DEVICE long long pip_sort_smem_bytes(int c, int nt) {
  return 4ll * (nt + (pip_sort_in_smem(c) ? (1 << c) + 1 : 0));
}

// A bucket's slot in the bucket array: (row, digit) where a row has no
// more buckets than points, else the run's first position in order (so the
// array holds rows * min(2^c, npts) sums).
BN_HOST_DEVICE bool pip_dense(int c, int npts) { return (1ll << c) <= npts; }
BN_INLINE long long pip_slot(long long row, int d, const int32_t* starts, int npts, int c) {
  return pip_dense(c, npts) ? row * (1ll << c) + d
                            : row * npts + starts[row * ((1 << c) + 1) + d];
}

// The scratch of one call, carved from one buffer: the digits, the sort's
// outputs, its global counts above PIP_SORT_SMEM_C, the bucket sums, two
// partial sums and a flag word a chunk.
struct pip_scratch {
  uint16_t* digits;   // (rows, npts)
  int32_t* order;     // (rows, npts)
  uint16_t* sdig;     // (rows, npts), the digits in order
  int32_t* starts;    // (rows, 2^c + 1)
  uint32_t* counts;   // (rows, 2^c + 1), above PIP_SORT_SMEM_C only
  uint32_t* buckets;  // (slots, G1_WORDS)
  uint32_t* parts;    // (chunks, 2, G1_WORDS): first run, last run
  int32_t* flags;     // (chunks): 1 last run goes on, 2 first run goes on
};

BN_HOST_DEVICE long long pip_chunks(int npts, int c, long long n, int chunk) {
  return (n * pip_windows(c) * npts + chunk - 1) / chunk;
}

// Bytes of the scratch; with a base, also the regions' addresses.
BN_HOST_DEVICE long long pip_scratch_layout(pip_scratch* s, char* base, int npts, int c,
                                            long long n, int chunk) {
  const long long rows = n * pip_windows(c), nb1 = (1ll << c) + 1;
  const long long slots = rows * (pip_dense(c, npts) ? (1ll << c) : npts);
  const long long chunks = pip_chunks(npts, c, n, chunk);
  const long long sizes[8] = {2 * rows * npts, 4 * rows * npts, 2 * rows * npts, 4 * rows * nb1,
                              pip_sort_in_smem(c) ? 0 : 4 * rows * nb1, 4ll * G1_WORDS * slots,
                              8ll * G1_WORDS * chunks, 4 * chunks};
  void** regions[8] = {(void**)&s->digits, (void**)&s->order, (void**)&s->sdig,
                       (void**)&s->starts, (void**)&s->counts, (void**)&s->buckets,
                       (void**)&s->parts, (void**)&s->flags};
  long long off = 0;
  for (int i = 0; i < 8; ++i) {
    if (base) *regions[i] = base + off;
    off += (sizes[i] + 15) / 16 * 16;
  }
  return off;
}

BN_INLINE void load_g1w(g1j& r, const uint32_t* w) {
  for (int i = 0; i < NW; ++i) {
    r.x.w[i] = w[i];
    r.y.w[i] = w[NW + i];
    r.z.w[i] = w[2 * NW + i];
  }
}

BN_INLINE void store_g1w(uint32_t* w, const g1j& p) {
  for (int i = 0; i < NW; ++i) {
    w[i] = p.x.w[i];
    w[NW + i] = p.y.w[i];
    w[2 * NW + i] = p.z.w[i];
  }
}

// r = k * p for a small k >= 0, double-and-add from k's top bit (none
// for p at infinity: a row with few points has mostly empty buckets).
BN_INLINE void g1_mul_small(g1j& r, const g1j& p, uint32_t k) {
  g1_inf(r);
  if (fp_is_zero(p.z)) return;
  int top = 31;
  while (top >= 0 && !((k >> top) & 1u)) --top;
#pragma unroll 1
  for (int bit = top; bit >= 0; --bit) {
    g1_dbl(r, r);
    if ((k >> bit) & 1u) g1_add(r, r, p);
  }
}

// Stage 1, (lane, point) ``idx`` = lane * npts + pt: its W digits into
// digits[(lane W + window) npts + pt], 0 for a point at infinity; sc
// (npts, 16, n) canonical Fr limbs, pinf (npts, n) bytes.
BN_INLINE void pip_digits_thread(long long idx, const int32_t* sc, const uint8_t* pinf, int npts,
                                 int c, uint16_t* digits, long long n) {
  const long long lane = idx / npts, pt = idx % npts;
  const int w = pip_windows(c);
  uint32_t s[17];
  for (int k = 0; k < 16; ++k) s[k] = (uint32_t)sc[(pt * 16 + k) * n + lane] & 0xFFFFu;
  s[16] = 0;
  const bool inf = pinf[pt * n + lane] != 0;
  const uint32_t mask = (1u << c) - 1u;
  uint16_t* out = digits + lane * w * npts + pt;
#pragma unroll 1
  for (int win = 0; win < w; ++win) {
    const int bit = win * c, limb = bit >> 4, off = bit & 15;
    const uint32_t d = ((s[limb] | (s[limb + 1] << 16)) >> off) & mask;
    out[(long long)win * npts] = inf ? 0 : (uint16_t)d;
  }
}

// Stage 2, thread t of nt of the block of ``row``: the counting sort of
// the row's digits. smem as pip_sort_smem_bytes(c, nt).
BN_INLINE void pip_sort_team(int t, int nt, long long row, uint32_t* smem, int npts, int c,
                             const pip_scratch& s) {
  const int nb1 = (1 << c) + 1;
  uint32_t* part = smem;
  uint32_t* h = pip_sort_in_smem(c) ? smem + nt : s.counts + row * nb1;
  const uint16_t* dig = s.digits + row * npts;
  int32_t* st = s.starts + row * nb1;
  for (int j = t; j < nb1; j += nt) h[j] = 0;
  TEAM_SYNC();
  for (int i = t; i < npts; i += nt) pip_atomic_add(&h[dig[i]], 1u);
  TEAM_SYNC();
  // exclusive scan of the counts: thread t sums its segment, a
  // Hillis-Steele scan over the segments' sums, then each segment's starts
  const int seg = (nb1 + nt - 1) / nt;
  const int j0 = t * seg < nb1 ? t * seg : nb1;
  const int j1 = j0 + seg < nb1 ? j0 + seg : nb1;
  uint32_t sum = 0;
  for (int j = j0; j < j1; ++j) sum += h[j];
  part[t] = sum;
  TEAM_SYNC();
  for (int off = 1; off < nt; off *= 2) {
    const uint32_t v = t >= off ? part[t - off] : 0u;
    TEAM_SYNC();
    part[t] += v;
    TEAM_SYNC();
  }
  uint32_t at = part[t] - sum;
  for (int j = j0; j < j1; ++j) {
    const uint32_t cnt = h[j];
    st[j] = (int32_t)at;
    h[j] = at;
    at += cnt;
  }
  TEAM_SYNC();
  for (int i = t; i < npts; i += nt) {
    const uint16_t d = dig[i];
    const long long pos = row * npts + pip_atomic_add(&h[d], 1u);
    s.order[pos] = i;
    s.sdig[pos] = d;
  }
}

// Where the entries at flat positions p and q (of rows * npts) hold the
// same bucket: the same row and the same nonzero digit.
BN_INLINE bool pip_same_run(const uint16_t* sdig, long long p, long long q, int npts) {
  return sdig[p] != 0 && sdig[p] == sdig[q] && p / npts == q / npts;
}

// Stage 3, chunk k: entries [k chunk, (k + 1) chunk) of the rows' sorted
// entries; px, py (npts, 16, n) affine Montgomery limbs.
BN_INLINE void pip_chunk_thread(long long k, int chunk, const int32_t* px, const int32_t* py,
                                int npts, int c, const pip_scratch& s, long long n) {
  const int w = pip_windows(c);
  const long long total = n * w * npts, lo = k * chunk;
  const long long hi = lo + chunk < total ? lo + chunk : total;
  long long row = lo / npts, row_end = (row + 1) * npts;
  g1j acc;
  g1_inf(acc);
  int cur = 0;  // the digit of the open run; 0: none yet
  long long cur_row = 0;
  bool first = true, head_open = false;
  int32_t flags = 0;
#pragma unroll 1
  for (long long p = lo; p < hi; ++p) {
    if (p == row_end) {
      ++row;
      row_end += npts;
    }
    const int d = s.sdig[p];
    if (d == 0) continue;
    if (d != cur || row != cur_row) {
      if (cur) {  // the run of (cur_row, cur) ended inside the chunk
        if (first && head_open)
          store_g1w(s.parts + (2 * k) * G1_WORDS, acc);
        else
          store_g1w(s.buckets + pip_slot(cur_row, cur, s.starts, npts, c) * G1_WORDS, acc);
        first = false;
      } else {
        head_open = p == lo && p > 0 && pip_same_run(s.sdig, p - 1, p, npts);
      }
      cur = d;
      cur_row = row;
      g1_inf(acc);
    }
    const long long pt = s.order[p], lane = row / w;
    fp x, y;
    load_fp(x, px + pt * 16 * n + lane, n);
    load_fp(y, py + pt * 16 * n + lane, n);
    g1_add_mixed(acc, acc, x, y, false);
  }
  if (cur) {
    const bool tail_open = hi < total && pip_same_run(s.sdig, hi - 1, hi, npts);
    if (first && head_open) {
      store_g1w(s.parts + (2 * k) * G1_WORDS, acc);
      if (tail_open) flags |= 2;
    } else if (tail_open) {
      store_g1w(s.parts + (2 * k + 1) * G1_WORDS, acc);
      flags |= 1;
    } else {
      store_g1w(s.buckets + pip_slot(cur_row, cur, s.starts, npts, c) * G1_WORDS, acc);
    }
  }
  s.flags[k] = flags;
}

// Stage 4, chunk k: if its last run goes on past its end, that run's sum,
// its own partial and the next chunks' first-run partials up to the chunk
// where the run ends, into the run's bucket.
BN_INLINE void pip_merge_thread(long long k, int chunk, int npts, int c, const pip_scratch& s,
                                long long n) {
  if (!(s.flags[k] & 1)) return;
  const long long total = n * pip_windows(c) * npts;
  const long long last = (k + 1) * chunk - 1;  // in the run: the run goes on past it
  g1j acc, q;
  load_g1w(acc, s.parts + (2 * k + 1) * G1_WORDS);
#pragma unroll 1
  for (long long j = k + 1; j * chunk < total; ++j) {
    load_g1w(q, s.parts + (2 * j) * G1_WORDS);
    g1_add(acc, acc, q);
    if (!(s.flags[j] & 2)) break;
  }
  store_g1w(s.buckets + pip_slot(last / npts, s.sdig[last], s.starts, npts, c) * G1_WORDS, acc);
}

// Stage 5, thread t of the nt (pip_threads) of the block of ``row``: the
// row's window sum sum_j j B_j into wsum[row] (G1_WORDS words); part the
// block's shared memory (pip_smem_bytes(nt)).
BN_INLINE void pip_reduce_team(int t, int nt, long long row, g1j* part, int npts, int c,
                               const pip_scratch& s, uint32_t* wsum) {
  const int m = (1 << c) / nt;
  const int lo = t * m;
  const int32_t* st = s.starts + row * ((1 << c) + 1);
  g1j running, total, b;
  g1_inf(running);
  g1_inf(total);
#pragma unroll 1
  for (int j = lo + m - 1; j >= lo; --j) {
    if (j > 0 && st[j] < st[j + 1]) {  // digit 0 goes to no bucket
      load_g1w(b, s.buckets + pip_slot(row, j, s.starts, npts, c) * G1_WORDS);
      g1_add(running, running, b);
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
      const g1j other = part[t + step];
      g1_add(a, a, other);
      part[t] = a;
    }
    TEAM_SYNC();
  }
  if (t == 0) store_g1w(wsum + row * G1_WORDS, part[0]);
}

// One round of a combine team: rank r's value v (ranks below nv) into the
// round's slots of xs, then the whole team reads them. Rounds use two
// sets of four slots in turns (par), so one WARP_SYNC a round keeps every
// read of a set before its next write.
BN_INLINE const fp* team_round(int r, const fp& v, int nv, fp* xs, int& par) {
  fp* slots = xs + 4 * par;
  if (r < nv) slots[r] = v;
  WARP_SYNC();
  par ^= 1;
  return slots;
}

// out = the operand of rank r: v0, v1, v2, v3 for ranks 0-3.
BN_INLINE void team_pick(fp& out, int r, const fp& v0, const fp& v1, const fp& v2,
                         const fp& v3) {
  fp_select(out, r == 2, v2, v3);
  fp_select(out, r == 1, v1, out);
  fp_select(out, r == 0, v0, out);
}

// p = 2 p on a combine team (rank r; every thread holds p): dbl-2009-l's
// products in two rounds of three, {X^2, Y^2, Y Z}, then {B^2, (X + B)^2,
// E^2}, then E (D - X3) on every thread. Infinity stays infinity (Z3 =
// 2 Y Z), with no branch.
BN_INLINE void team_g1_dbl(int r, g1j& p, fp* xs, int& par) {
  fp u, v, prod;
  team_pick(u, r, p.x, p.y, p.y, p.y);
  team_pick(v, r, p.x, p.y, p.z, p.z);
  fp_mul<FQ>(prod, u, v);
  const fp* s1 = team_round(r, prod, 3, xs, par);
  const fp a = s1[0], b = s1[1], yz = s1[2];
  fp e, t;
  fp_dbl<FQ>(e, a);
  fp_add<FQ>(e, e, a);  // E = 3A
  fp_add<FQ>(t, p.x, b);
  team_pick(u, r, b, t, e, e);  // B^2 = C, (X + B)^2, E^2 = F
  fp_sq<FQ>(prod, u);
  const fp* s2 = team_round(r, prod, 3, xs, par);
  const fp cc = s2[0], xb2 = s2[1], f = s2[2];
  fp d, x3, y3;
  fp_sub<FQ>(d, xb2, a);
  fp_sub<FQ>(d, d, cc);
  fp_dbl<FQ>(d, d);  // D = 2((X+B)^2 - A - C)
  fp_dbl<FQ>(t, d);
  fp_sub<FQ>(x3, f, t);  // X3 = F - 2D
  fp_sub<FQ>(t, d, x3);
  fp_mul<FQ>(y3, e, t);
  fp_dbl<FQ>(t, cc);
  fp_dbl<FQ>(t, t);
  fp_dbl<FQ>(t, t);
  fp_sub<FQ>(p.y, y3, t);  // Y3 = E(D - X3) - 8C
  fp_dbl<FQ>(p.z, yz);     // Z3 = 2YZ
  p.x = x3;
}

// p = p + q on a combine team: add-2007-bl's 16 products (curve.cuh::
// g1_add) in five rounds, {Z1^2, Z2^2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2},
// {I, rr^2, Z1 Z2}, {J, V, Z3}, {rr (V - X3), S1 J}. Every rank runs
// every round; the edge cases (an operand at infinity, P == +-Q) are
// picked after them, the doubling on each thread alone (g1_dbl has no
// WARP_SYNC), so all threads of a warp meet at the same syncs.
BN_INLINE void team_g1_add(int r, g1j& p, const g1j& q, fp* xs, int& par) {
  fp u, v, prod;
  team_pick(u, r, p.z, q.z, p.y, q.y);
  team_pick(v, r, p.z, q.z, q.z, p.z);
  fp_mul<FQ>(prod, u, v);
  const fp* s1 = team_round(r, prod, 4, xs, par);
  const fp z1z1 = s1[0], z2z2 = s1[1], y1z2 = s1[2], y2z1 = s1[3];
  team_pick(u, r, p.x, q.x, y1z2, y2z1);
  team_pick(v, r, z2z2, z1z1, z2z2, z1z1);
  fp_mul<FQ>(prod, u, v);
  const fp* s2 = team_round(r, prod, 4, xs, par);
  const fp u1 = s2[0], u2 = s2[1], sa = s2[2], sb = s2[3];
  fp h, rr, h2;
  fp_sub<FQ>(h, u2, u1);
  fp_sub<FQ>(rr, sb, sa);
  const bool h0 = fp_is_zero(h), r0 = fp_is_zero(rr);
  fp_dbl<FQ>(rr, rr);
  fp_dbl<FQ>(h2, h);
  team_pick(u, r, h2, rr, p.z, p.z);
  team_pick(v, r, h2, rr, q.z, q.z);
  fp_mul<FQ>(prod, u, v);
  const fp* s3 = team_round(r, prod, 3, xs, par);
  const fp ii = s3[0], rr2 = s3[1];
  fp zz;
  fp_dbl<FQ>(zz, s3[2]);  // 2 Z1 Z2
  team_pick(u, r, h, u1, zz, zz);
  team_pick(v, r, ii, ii, h, h);
  fp_mul<FQ>(prod, u, v);
  const fp* s4 = team_round(r, prod, 3, xs, par);
  const fp j = s4[0], vv = s4[1], z3 = s4[2];
  fp x3, t;
  fp_sub<FQ>(x3, rr2, j);
  fp_dbl<FQ>(t, vv);
  fp_sub<FQ>(x3, x3, t);  // X3 = rr^2 - J - 2V
  fp_sub<FQ>(t, vv, x3);
  team_pick(u, r, rr, sa, sa, sa);
  team_pick(v, r, t, j, j, j);
  fp_mul<FQ>(prod, u, v);
  const fp* s5 = team_round(r, prod, 2, xs, par);
  fp y3;
  fp_dbl<FQ>(t, s5[1]);
  fp_sub<FQ>(y3, s5[0], t);  // Y3 = rr (V - X3) - 2 S1 J
  if (fp_is_zero(p.z)) {
    p = q;
  } else if (fp_is_zero(q.z)) {
    // p stays
  } else if (h0) {
    if (r0)
      g1_dbl(p, p);
    else
      g1_inf(p);
  } else {
    p.x = x3;
    p.y = y3;
    p.z = z3;
  }
}

// Stage 6, thread r of the team of ``lane`` (clamped to the last lane past
// the end, where ``store`` is false): the sum over k sets of window sums
// wsum (k, n, W, G1_WORDS words), window by window, with Horner over the
// windows, high first, then the affine result into ox, oy (16, n) and oinf
// (n). xs the team's exchange slots (PIP_XCH_WORDS words).
BN_INLINE void pip_combine_team(int r, long long lane, bool store, fp* xs, const uint32_t* wsum,
                                int k, int c, int32_t* ox, int32_t* oy, uint8_t* oinf,
                                long long n) {
  const int w = pip_windows(c);
  int par = 0;
  g1j acc, q, e;
#pragma unroll 1
  for (int win = w - 1; win >= 0; --win) {
    load_g1w(q, wsum + (lane * w + win) * G1_WORDS);
#pragma unroll 1
    for (int set = 1; set < k; ++set) {
      load_g1w(e, wsum + ((set * n + lane) * w + win) * G1_WORDS);
      team_g1_add(r, q, e, xs, par);
    }
    if (win == w - 1) {
      acc = q;
      continue;
    }
#pragma unroll 1
    for (int i = 0; i < c; ++i) team_g1_dbl(r, acc, xs, par);
    team_g1_add(r, acc, q, xs, par);
  }
  fp x, y;
  bool inf;
  g1_to_affine(x, y, inf, acc);
  if (store && r == 0) {
    store_fp(ox + lane, n, x);
    store_fp(oy + lane, n, y);
    oinf[lane] = inf ? 1 : 0;
  }
}
