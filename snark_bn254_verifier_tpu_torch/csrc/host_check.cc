// Host build of the kernels' per-lane code, for the CPU tests only
// (tests/test_torch_csrc_host.py): the same headers as kernels.cu, run
// lane by lane on the host, so the 16<->32-bit limb conversion, the CIOS
// and the tower/curve/pairing formulas are checked without a card. The
// main path never loads this library.
#include "pairing.cuh"

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

int host_miller_mixed(const int32_t* px, const int32_t* py, const int32_t* qx,
                      const int32_t* qy, const int32_t* fpx, const int32_t* fpy,
                      int nf, const int32_t* lines, const int32_t* tails,
                      int32_t* out, long long n) {
  for (long long i = 0; i < n; ++i)
    miller_mixed_lane(px, py, qx, qy, fpx, fpy, nf, lines, tails, out, n, i);
  return 0;
}

int host_final_exp(const int32_t* f, int32_t* out, long long n) {
  for (long long i = 0; i < n; ++i) final_exp_lane(f, out, n, i);
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
