// Kernel K6 (msm_pippenger), the bucket MSM, for sm_90a with a plain C
// interface loaded through ctypes (ops/_build.py builds this unit by its
// own nvcc, beside the others). It replaces ops/msm.py::msm_pippenger of
// snark_bn254_verifier_tpu, which is XLA with no Pallas original; what
// bounds it and the design are in pippenger.cuh. Like K2 it runs the
// rolled form of the Montgomery product (fp.cuh).
#include <cuda_runtime.h>

#define BN_ROLLED_CIOS 1
#include "pippenger.cuh"

#define HORNER_BLOCK 64  // lanes a block of launch 2

static __global__ void msm_pippenger_kernel(const int32_t* px, const int32_t* py,
                                            const int32_t* order, const int32_t* starts,
                                            int npts, int c, uint32_t* wsum, long long n) {
  extern __shared__ uint32_t smem[];
  pippenger_window_team(threadIdx.x, blockIdx.x, (g1j*)smem, px, py, order, starts, npts, c,
                        wsum, n);
}

static __global__ void msm_pippenger_horner_kernel(const uint32_t* wsum, int c, int32_t* ox,
                                                   int32_t* oy, uint8_t* oinf, long long n) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) pippenger_horner_lane(lane, wsum, c, ox, oy, oinf, n);
}

// Two launches on ``stream``: the window sums of n lanes into wsum (n, W,
// 24 words of scratch), then Horner and the affine result. order and
// starts as ops/msm.py::bucket_order gives them, in int32.
extern "C" int bn_msm_pippenger(const int32_t* px, const int32_t* py, const int32_t* order,
                                const int32_t* starts, int npts, int c, int32_t* wsum,
                                int32_t* ox, int32_t* oy, uint8_t* oinf, long long n,
                                void* stream) {
  if (npts < 1 || c < 1 || c > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = n * pip_windows(c);
  msm_pippenger_kernel<<<(unsigned)rows, pip_threads(c), (size_t)pip_smem_bytes(c), s>>>(
      px, py, order, starts, npts, c, (uint32_t*)wsum, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_pippenger_horner_kernel<<<(unsigned)((n + HORNER_BLOCK - 1) / HORNER_BLOCK), HORNER_BLOCK,
                                0, s>>>((const uint32_t*)wsum, c, ox, oy, oinf, n);
  return (int)cudaGetLastError();
}

// Launch 1's registers, stack and shared bytes at c = 8, its threads a
// (lane, window) and one (lane, window) a block; out as the team kernels'.
extern "C" int bn_msm_pippenger_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, msm_pippenger_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)pip_smem_bytes(8);
  out[4] = pip_threads(8);
  out[5] = 1;
  return 0;
}
