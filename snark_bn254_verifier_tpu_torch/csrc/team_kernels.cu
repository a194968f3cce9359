// Kernel K3 (miller_mixed) or K4 (final_exp) at its team shape (team.cuh:
// MM_TEAM x MM_LPB, FE_TEAM x FE_LPB), with a plain C interface loaded
// through ctypes. ops/_build.py compiles this file once per kernel,
// -DBN_TEAM_KERNEL=3 or 4, each by its own nvcc, all at once: the team
// bodies inline every product, and one compilation of both kernels takes
// minutes. Each build exports bn_<kernel> and bn_<kernel>_attrs.
//
//   K3 miller_mixed    pairing_pallas.py:99 _miller_mixed_kernel
//   K4 final_exp       pairing_pallas.py:179 _fe_easy_expx_kernel
//                      + pairing_pallas.py:191 _fe_combine_kernel
//
// What bounds them, and the design, are in team.cuh.
#include <cuda_runtime.h>

#include "team.cuh"

// Launches ``kernel`` over n lanes, lpb lanes of team threads a block,
// with smem bytes of dynamic shared memory (above 48 KB only once allowed).
template <typename Kernel, typename... Args>
static int launch_team(Kernel kernel, int team, int lpb, long long smem, long long n,
                       cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + lpb - 1) / lpb);
  kernel<<<grid, team * lpb, (size_t)smem, s>>>(args..., n);
  return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared bytes, threads
// per lane and lanes per block.
template <typename Kernel>
static int kernel_attrs(Kernel kernel, int team, int lpb, long long smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = team;
  out[5] = lpb;
  return 0;
}

#if BN_TEAM_KERNEL == 3

static __global__ void miller_mixed_kernel(const int32_t* px, const int32_t* py,
                                           const int32_t* qx, const int32_t* qy,
                                           const int32_t* fpx, const int32_t* fpy, int nf,
                                           const int32_t* lines, const int32_t* tails,
                                           int32_t* out, long long n) {
  extern __shared__ uint32_t smem[];
  miller_mixed_team(threadIdx.x, blockIdx.x, smem, px, py, qx, qy, fpx, fpy, nf, lines, tails,
                    out, n);
}

extern "C" int bn_miller_mixed(const int32_t* px, const int32_t* py, const int32_t* qx,
                               const int32_t* qy, const int32_t* fpx, const int32_t* fpy,
                               int nf, const int32_t* lines, const int32_t* tails, int32_t* out,
                               long long n, void* stream) {
  if (nf < 0 || nf > NF_MAX) return (int)cudaErrorInvalidValue;
  return launch_team(miller_mixed_kernel, MM_TEAM, MM_LPB, miller_mixed_smem_bytes(nf), n,
                     (cudaStream_t)stream, px, py, qx, qy, fpx, fpy, nf, lines, tails, out);
}

// At NF_MAX fixed pairs.
extern "C" int bn_miller_mixed_attrs(int* out) {
  return kernel_attrs(miller_mixed_kernel, MM_TEAM, MM_LPB, miller_mixed_smem_bytes(NF_MAX),
                      out);
}

#elif BN_TEAM_KERNEL == 4

static __global__ void final_exp_kernel(const int32_t* f, int32_t* out, long long n) {
  extern __shared__ uint32_t smem[];
  final_exp_team(threadIdx.x, blockIdx.x, smem, f, out, n);
}

extern "C" int bn_final_exp(const int32_t* f, int32_t* out, long long n, void* stream) {
  return launch_team(final_exp_kernel, FE_TEAM, FE_LPB, final_exp_smem_bytes(), n,
                     (cudaStream_t)stream, f, out);
}

extern "C" int bn_final_exp_attrs(int* out) {
  return kernel_attrs(final_exp_kernel, FE_TEAM, FE_LPB, final_exp_smem_bytes(), out);
}

#else
#error "build with -DBN_TEAM_KERNEL=3 or 4"
#endif
