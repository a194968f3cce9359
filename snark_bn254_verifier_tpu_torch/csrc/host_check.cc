// Host build of the kernels' code, for the CPU tests only
// (tests/test_torch_csrc_host.py): the same headers as kernels.cu, run on
// the host, so the 16<->32-bit limb conversion, the CIOS and the
// tower/curve/pairing formulas are checked without a card. K1 and its
// fused form, the G2 on-curve mask, run lane by lane; the team kernels
// (K2-K5) and K6's block stages run block by block, each thread of a block as a host thread,
// meeting at a barrier wherever the card's threads meet at __syncthreads.
// It is built twice, with each form of the Montgomery product
// (BN_ROLLED_CIOS, fp.cuh), so each kernel's tests run the form its unit
// runs on the card. The main path never loads this library.
#include <thread>
#include <vector>

#include "pippenger.cuh"

// Runs body(tid, block, smem) for every thread of the grid of a team
// kernel over n lanes (team threads per lane, lpb lanes per block), one
// block at a time: a block's threads are host threads, made once and
// meeting at a barrier after each block (as a grid of one resident block).
template <typename Body>
static void host_team_grid(long long n, int team, int lpb, long long smem_bytes, Body body) {
  const int nthreads = team * lpb;
  const long long blocks = (n + lpb - 1) / lpb;
  std::vector<uint32_t> smem(smem_bytes / 4 + 1);
  std::barrier<> bar(nthreads);
  std::vector<std::thread> threads;
  for (int tid = 0; tid < nthreads; ++tid)
    threads.emplace_back([&, tid] {
      team_barrier = &bar;
      for (long long block = 0; block < blocks; ++block) {
        body(tid, block, smem.data());
        bar.arrive_and_wait();  // the block ends before the next reuses smem
      }
    });
  for (auto& th : threads) th.join();
}

// x = x * y over (16, 12, n) Fq12 operands by team.cuh::team_mul, the Fq12
// product of K3, K4 and K5, on teams of TEAM threads, LPB lanes a block,
// with the product written over an operand as the kernels write it.
template <int TEAM, int LPB>
static void fq12_mul_team(const int32_t* a, const int32_t* b, int32_t* out, long long n) {
  constexpr long long lane_words = (12 + TEAM_SCRATCH) * 16 + 1;  // x, y, scratch
  host_team_grid(n, TEAM, LPB, 4 * LPB * lane_words,
                 [&](int tid, long long block, uint32_t* smem) {
                   const team_t<TEAM> t = make_team<TEAM>(tid % TEAM);
                   const long long lane = block * LPB + tid / TEAM;
                   const long long src = lane < n ? lane : n - 1;
                   fq2* x = (fq2*)(smem + (tid / TEAM) * lane_words);
                   fq2 *y = x + 6, *scratch = x + 12;
                   if (t.h == 0) {
                     load_fp(x[t.k].c0, a + wcomp(t.k) * n + src, 12 * n);
                     load_fp(x[t.k].c1, a + (wcomp(t.k) + 1) * n + src, 12 * n);
                     load_fp(y[t.k].c0, b + wcomp(t.k) * n + src, 12 * n);
                     load_fp(y[t.k].c1, b + (wcomp(t.k) + 1) * n + src, 12 * n);
                   }
                   TEAM_SYNC();
                   team_mul(t, x, x, y, scratch);
                   team_store_out(t, out, n, lane, x);
                 });
}

extern "C" {

// The team's Fq12 product at K4's shape (team 12) or K3's (team 18).
int host_fq12_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n, int team) {
  if (team == FE_TEAM)
    fq12_mul_team<FE_TEAM, FE_LPB>(a, b, out, n);
  else if (team == MM_TEAM)
    fq12_mul_team<MM_TEAM, MM_LPB>(a, b, out, n);
  else
    return 1;
  return 0;
}

// K1's lane, with the unrolled or the rolled CIOS (the form K2 and K5 run).
int host_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n, int field, int rolled) {
  for (long long i = 0; i < n; ++i) {
    if (field == FQ)
      rolled ? mont_mul_lane<FQ, true>(a, b, out, n, i) : mont_mul_lane<FQ, false>(a, b, out, n, i);
    else
      rolled ? mont_mul_lane<FR, true>(a, b, out, n, i) : mont_mul_lane<FR, false>(a, b, out, n, i);
  }
  return 0;
}

// The G2 on-curve mask of kernels.cu::g2_on_curve_kernel, lane by lane.
int host_g2_on_curve(const int32_t* x, const int32_t* y, const uint8_t* inf,
                     const uint8_t* valid, uint8_t* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = g2_on_curve_lane(x, y, inf, valid, n, i);
  return 0;
}

// The Fq inverse of Montgomery elements, by Fermat (fq_inv, K4's) or by
// the binary Euclid algorithm (fq_inv_binary, K2's).
int host_fq_inv(const int32_t* a, int32_t* out, long long n, int binary) {
  for (long long i = 0; i < n; ++i) {
    fp x, r;
    load_fp(x, a + i, n);
    if (binary)
      fq_inv_binary(r, x);
    else
      fq_inv(r, x);
    store_fp(out + i, n, r);
  }
  return 0;
}

int host_msm_affine(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                    const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                    uint8_t* oinf, long long n) {
  if (npts < 1) return 1;
  host_team_grid(n, MSM_TEAM, MSM_LPB, msm_affine_smem_bytes(),
                 [&](int tid, long long block, uint32_t* smem) {
                   msm_affine_team(tid, block, smem, px, py, pinf, sc, npts, ox, oy, oinf, n);
                 });
  return 0;
}

// K6's stages (pippenger.cuh) on one scratch buffer laid out as on the
// card: host_pip_layout gives its bytes and the regions' byte offsets
// (digits, order, sdig, starts, counts, buckets, parts, flags), so a test
// can read each stage's output. The sort and the reduction run block by
// block (a host thread a card thread), the per-thread stages thread by
// thread, the combine on teams of PIP_COMB_TEAM host threads.
long long host_pip_layout(int npts, int c, long long n, int chunk, long long* off) {
  pip_scratch s;
  const long long bytes = pip_scratch_layout(&s, (char*)16, npts, c, n, chunk);
  const void* regions[8] = {s.digits, s.order, s.sdig, s.starts, s.counts, s.buckets, s.parts,
                            s.flags};
  for (int i = 0; i < 8; ++i) off[i] = (const char*)regions[i] - (const char*)16;
  return bytes;
}

static pip_scratch host_scratch(char* base, int npts, int c, long long n, int chunk) {
  pip_scratch s;
  pip_scratch_layout(&s, base, npts, c, n, chunk);
  return s;
}

// Stages 1-2: the digits and their counting sort.
int host_pip_sort(const int32_t* sc, const uint8_t* pinf, int npts, int c, int chunk,
                  char* scratch, long long n) {
  if (npts < 1 || c < 1 || c > 16 || chunk < 1) return 1;
  const pip_scratch s = host_scratch(scratch, npts, c, n, chunk);
  for (long long idx = 0; idx < n * npts; ++idx)
    pip_digits_thread(idx, sc, pinf, npts, c, s.digits, n);
  const int nt = pip_sort_threads(npts);
  host_team_grid(n * pip_windows(c), nt, 1, pip_sort_smem_bytes(c, nt),
                 [&](int tid, long long block, uint32_t* smem) {
                   pip_sort_team(tid, nt, block, smem, npts, c, s);
                 });
  return 0;
}

// Stages 3-4: the chunks' bucket sums, then the merge of split runs.
int host_pip_buckets(const int32_t* px, const int32_t* py, int npts, int c, int chunk,
                     char* scratch, long long n) {
  const pip_scratch s = host_scratch(scratch, npts, c, n, chunk);
  const long long chunks = pip_chunks(npts, c, n, chunk);
  for (long long k = 0; k < chunks; ++k) pip_chunk_thread(k, chunk, px, py, npts, c, s, n);
  for (long long k = 0; k < chunks; ++k) pip_merge_thread(k, chunk, npts, c, s, n);
  return 0;
}

// Stage 5: the window sums into wsum (n, W, 24 words).
int host_pip_reduce(int npts, int c, int chunk, char* scratch, int32_t* wsum, long long n) {
  const pip_scratch s = host_scratch(scratch, npts, c, n, chunk);
  const long long rows = n * pip_windows(c);
  const int nt = pip_threads(c, rows);
  host_team_grid(rows, nt, 1, pip_smem_bytes(nt), [&](int tid, long long block, uint32_t* smem) {
    pip_reduce_team(tid, nt, block, (g1j*)smem, npts, c, s, (uint32_t*)wsum);
  });
  return 0;
}

// Stage 6: the affine sum of k sets of window sums (k, n, W, 24 words).
int host_pip_combine(const int32_t* wsum, int k, int c, int32_t* ox, int32_t* oy, uint8_t* oinf,
                     long long n) {
  if (k < 1 || c < 1 || c > 16) return 1;
  // a team a block: the teams are independent, and a host block meets at
  // one barrier wherever a card's warp does
  host_team_grid(n, PIP_COMB_TEAM, 1, 4ll * PIP_XCH_WORDS,
                 [&](int tid, long long lane, uint32_t* smem) {
                   pip_combine_team(tid, lane, true, (fp*)smem, (const uint32_t*)wsum, k, c, ox,
                                    oy, oinf, n);
                 });
  return 0;
}

// The whole MSM, as bn_msm_pippenger runs it on the card.
int host_msm_pippenger(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                       const int32_t* sc, int npts, int c, int chunk, char* scratch,
                       int32_t* wsum, int32_t* ox, int32_t* oy, uint8_t* oinf, long long n) {
  if (host_pip_sort(sc, pinf, npts, c, chunk, scratch, n)) return 1;
  host_pip_buckets(px, py, npts, c, chunk, scratch, n);
  host_pip_reduce(npts, c, chunk, scratch, wsum, n);
  return host_pip_combine(wsum, 1, c, ox, oy, oinf, n);
}

// K3, K4 and K5 at the kernels' shapes (team.cuh); K2's above (msm.cuh).
int host_miller_mixed(const int32_t* px, const int32_t* py, const int32_t* qx,
                      const int32_t* qy, const int32_t* fpx, const int32_t* fpy,
                      int nf, const int32_t* lines, const int32_t* tails,
                      int32_t* out, long long n) {
  if (nf < 0 || nf > NF_MAX) return 1;
  host_team_grid(n, MM_TEAM, MM_LPB, miller_mixed_smem_bytes(nf),
                 [&](int tid, long long block, uint32_t* smem) {
                   miller_mixed_team(tid, block, smem, px, py, qx, qy, fpx, fpy, nf, lines,
                                     tails, out, n);
                 });
  return 0;
}

int host_final_exp(const int32_t* f, int32_t* out, long long n) {
  host_team_grid(n, FE_TEAM, FE_LPB, final_exp_smem_bytes(),
                 [&](int tid, long long block, uint32_t* smem) {
                   final_exp_team(tid, block, smem, f, out, n);
                 });
  return 0;
}

int host_miller_product(const int32_t* px, const int32_t* py, const int32_t* qx,
                        const int32_t* qy, int npairs, int32_t* out,
                        long long n) {
  if (npairs < 1) return 1;
  host_team_grid(n, MP_TEAM * MP_CHAINS, MP_LPB, miller_product_smem_bytes(),
                 [&](int tid, long long block, uint32_t* smem) {
                   miller_product_team(tid, block, smem, px, py, qx, qy, npairs, out, n);
                 });
  return 0;
}

}  // extern "C"
