// Kernel msm_fixed (msm_fixed.cuh), the fixed-base MSM of the Groth16
// prepared input, in a unit of its own so that K2's (team_kernels.cu
// with -DBN_TEAM_KERNEL=2) is built as before. Its products take the
// rolled Montgomery form, as K2's: both are chains of G1 additions, and
// the rolled form was the faster for K2 on the H100 (PERF.md). A plain C
// interface, loaded through ctypes (ops/_build.py).
//
//   msm_fixed   pairing_pallas.py:206 _msm_windowed_kernel (+ :271
//               _jacobian_combine_kernel) where the points are fixed
#include <cuda_runtime.h>

#define BN_ROLLED_CIOS 1
#include "msm_fixed.cuh"

static __global__ void msm_fixed_kernel(const uint32_t* table, const int32_t* sc, int npts,
                                        int32_t* ox, int32_t* oy, uint8_t* oinf, long long n) {
  extern __shared__ uint32_t smem[];
  msm_fixed_team(threadIdx.x, blockIdx.x, smem, table, sc, npts, ox, oy, oinf, n);
}

// table (npts, FX_WINDOWS, FX_DIGITS, 16) int32 words, 64-B aligned;
// sc (npts, 16, n); ox, oy (16, n); oinf (n).
extern "C" int bn_msm_fixed(const int32_t* table, const int32_t* sc, int npts, int32_t* ox,
                            int32_t* oy, uint8_t* oinf, long long n, void* stream) {
  if (npts < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + FX_LPB - 1) / FX_LPB);
  msm_fixed_kernel<<<grid, FX_TEAM * FX_LPB, (size_t)msm_fixed_smem_bytes(),
                     (cudaStream_t)stream>>>((const uint32_t*)table, sc, npts, ox, oy, oinf, n);
  return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared bytes,
// threads per lane and lanes per block, as team_kernels.cu's.
extern "C" int bn_msm_fixed_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, msm_fixed_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)msm_fixed_smem_bytes();
  out[4] = FX_TEAM;
  out[5] = FX_LPB;
  return 0;
}
