// Host build of the kernels' code, for the CPU tests only
// (tests/test_torch_csrc_host.py): the same headers as kernels.cu, run on
// the host, so the 16<->32-bit limb conversion, the CIOS and the
// tower/curve/pairing formulas are checked without a card. K1 and its
// fused form, the G2 on-curve mask, run lane by lane; the team kernels
// (K2-K5) and K6's bucket launch run block by block, each thread of a block as a host thread,
// meeting at a barrier wherever the card's threads meet at __syncthreads.
// It is built twice, with each form of the Montgomery product
// (BN_ROLLED_CIOS, fp.cuh), so each kernel's tests run the form its unit
// runs on the card. The main path never loads this library.
#include <thread>
#include <vector>

#include "pippenger.cuh"

// Runs body(tid, block, smem) for every thread of the grid of a team
// kernel over n lanes (team threads per lane, lpb lanes per block), one
// block at a time.
template <typename Body>
static void host_team_grid(long long n, int team, int lpb, long long smem_bytes, Body body) {
  const int nthreads = team * lpb;
  std::vector<uint32_t> smem(smem_bytes / 4 + 1);
  for (long long block = 0; block * lpb < n; ++block) {
    std::barrier<> bar(nthreads);
    std::vector<std::thread> threads;
    for (int tid = 0; tid < nthreads; ++tid)
      threads.emplace_back([&, tid] {
        team_barrier = &bar;
        body(tid, block, smem.data());
      });
    for (auto& th : threads) th.join();
  }
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

// K6's two launches: a block of pip_threads(c) host threads per (lane,
// window), then Horner lane by lane (pippenger.cuh).
int host_msm_pippenger(const int32_t* px, const int32_t* py, const int32_t* order,
                       const int32_t* starts, int npts, int c, int32_t* wsum, int32_t* ox,
                       int32_t* oy, uint8_t* oinf, long long n) {
  if (npts < 1 || c < 1 || c > 16) return 1;
  host_team_grid(n * pip_windows(c), pip_threads(c), 1, pip_smem_bytes(c),
                 [&](int tid, long long block, uint32_t* smem) {
                   pippenger_window_team(tid, block, (g1j*)smem, px, py, order, starts, npts, c,
                                         (uint32_t*)wsum, n);
                 });
  for (long long lane = 0; lane < n; ++lane)
    pippenger_horner_lane(lane, (const uint32_t*)wsum, c, ox, oy, oinf, n);
  return 0;
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
