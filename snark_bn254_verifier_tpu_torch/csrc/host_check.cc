// Host build of the kernels' code, for the CPU tests only
// (tests/test_torch_csrc_host.py): the same headers as kernels.cu, run on
// the host, so the 16<->32-bit limb conversion, the CIOS and the
// tower/curve/pairing formulas are checked without a card. The per-lane
// kernels (K1, K2, K5) run lane by lane; the team kernels (K3, K4) run
// block by block, each thread of a block as a host thread, meeting at a
// barrier wherever the card's threads meet at __syncthreads. The main path
// never loads this library.
#include <thread>
#include <vector>

#include "team.cuh"

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

extern "C" {

int host_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n, int field) {
  for (long long i = 0; i < n; ++i) {
    if (field == FQ)
      mont_mul_lane<FQ>(a, b, out, n, i);
    else
      mont_mul_lane<FR>(a, b, out, n, i);
  }
  return 0;
}

int host_fq12_mul(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n) {
  for (long long i = 0; i < n; ++i) {
    fq12 x, y;
    load_fq12(x, a + i, n);
    load_fq12(y, b + i, n);
    fq12_mul(x, x, y);
    store_fq12(out + i, n, x);
  }
  return 0;
}

int host_msm_affine(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                    const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                    uint8_t* oinf, long long n) {
  if (npts < 1) return 1;
  for (long long i = 0; i < n; ++i)
    msm_affine_lane(px, py, pinf, sc, npts, ox, oy, oinf, n, i);
  return 0;
}

// K3 and K4 at the kernels' shapes (team.cuh).
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
  for (long long i = 0; i < n; ++i)
    miller_product_lane(px, py, qx, qy, npairs, out, n, i);
  return 0;
}

}  // extern "C"
