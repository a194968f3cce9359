// The team kernels K2 (msm_affine), K3 (miller_mixed), K4 (final_exp) and
// K5 (miller_product), each at its team shape (msm.cuh: MSM_TEAM x
// MSM_LPB; team.cuh: MM_TEAM x MM_LPB, FE_TEAM x FE_LPB, MP_TEAM x
// MP_CHAINS x MP_LPB), with a plain C interface loaded through ctypes.
// ops/_build.py compiles this file once per kernel, -DBN_TEAM_KERNEL=2, 3,
// 4 or 5, each by its own nvcc, all at once: the team bodies inline every
// product, and one compilation of all of them takes minutes. Each build
// exports bn_<kernel> and bn_<kernel>_attrs.
//
//   K2 msm_affine      pairing_pallas.py:206 _msm_windowed_kernel
//                      + pairing_pallas.py:271 _jacobian_combine_kernel
//   K3 miller_mixed    pairing_pallas.py:99 _miller_mixed_kernel
//   K4 final_exp       pairing_pallas.py:179 _fe_easy_expx_kernel
//                      + pairing_pallas.py:191 _fe_combine_kernel
//   K5 miller_product  pairing_pallas.py:84 _miller_kernel
//                      + pairing_pallas.py:171 _fq12_product_kernel
//
// What bounds them, and the designs, are in msm.cuh and team.cuh. K2 and
// K5 run the rolled form of the Montgomery product (fp.cuh), which was
// faster for them on the H100. K4 keeps the unrolled one, which was faster
// for it at batch one (PERF.md). K3 keeps it too: the rolled form
// measured faster for K3 while K3 ran its variable pair's G2 steps in the
// team, which kernel g2_lines now runs, so the choice waits for a
// measurement on K3's new schedule (ROADMAP).
#include <cuda_runtime.h>

#if BN_TEAM_KERNEL == 2 || BN_TEAM_KERNEL == 5
#define BN_ROLLED_CIOS 1
#endif
#include "msm.cuh"

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

// Blocks of the kernel resident on one SM at its launch shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0].
template <typename Kernel>
static int kernel_occupancy(Kernel kernel, int team, int lpb, long long smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, team * lpb,
                                                            (size_t)smem);
}

#if BN_TEAM_KERNEL == 2

static __global__ void msm_affine_kernel(const int32_t* px, const int32_t* py,
                                         const uint8_t* pinf, const int32_t* sc, int npts,
                                         int32_t* ox, int32_t* oy, uint8_t* oinf, long long n) {
  extern __shared__ uint32_t smem[];
  msm_affine_team(threadIdx.x, blockIdx.x, smem, px, py, pinf, sc, npts, ox, oy, oinf, n);
}

extern "C" int bn_msm_affine(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                             const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                             uint8_t* oinf, long long n, void* stream) {
  if (npts < 1) return (int)cudaErrorInvalidValue;
  return launch_team(msm_affine_kernel, MSM_TEAM, MSM_LPB, msm_affine_smem_bytes(), n,
                     (cudaStream_t)stream, px, py, pinf, sc, npts, ox, oy, oinf);
}

extern "C" int bn_msm_affine_attrs(int* out) {
  return kernel_attrs(msm_affine_kernel, MSM_TEAM, MSM_LPB, msm_affine_smem_bytes(), out);
}

extern "C" int bn_msm_affine_occupancy(int* out) {
  return kernel_occupancy(msm_affine_kernel, MSM_TEAM, MSM_LPB, msm_affine_smem_bytes(), out);
}

#elif BN_TEAM_KERNEL == 3

static __global__ void miller_mixed_kernel(const int32_t* vlines, const int32_t* fpx,
                                           const int32_t* fpy, int nf, const int32_t* lines,
                                           const int32_t* tails, int32_t* out, long long n) {
  extern __shared__ uint32_t smem[];
  miller_mixed_team(threadIdx.x, blockIdx.x, smem, vlines, fpx, fpy, nf, lines, tails, out, n);
}

// vlines: the variable pair's line rows from g2_lines (g2_lines.cu), or
// null where there is no variable pair.
extern "C" int bn_miller_mixed(const int32_t* vlines, const int32_t* fpx, const int32_t* fpy,
                               int nf, const int32_t* lines, const int32_t* tails, int32_t* out,
                               long long n, void* stream) {
  if (nf < 0 || nf > NF_MAX) return (int)cudaErrorInvalidValue;
  return launch_team(miller_mixed_kernel, MM_TEAM, MM_LPB, miller_mixed_smem_bytes(nf), n,
                     (cudaStream_t)stream, vlines, fpx, fpy, nf, lines, tails, out);
}

// At NF_MAX fixed pairs.
extern "C" int bn_miller_mixed_attrs(int* out) {
  return kernel_attrs(miller_mixed_kernel, MM_TEAM, MM_LPB, miller_mixed_smem_bytes(NF_MAX),
                      out);
}

extern "C" int bn_miller_mixed_occupancy(int* out) {
  return kernel_occupancy(miller_mixed_kernel, MM_TEAM, MM_LPB,
                          miller_mixed_smem_bytes(NF_MAX), out);
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

#elif BN_TEAM_KERNEL == 5

static __global__ void miller_product_kernel(const int32_t* px, const int32_t* py,
                                             const int32_t* qx, const int32_t* qy, int npairs,
                                             int32_t* out, long long n) {
  extern __shared__ uint32_t smem[];
  miller_product_team(threadIdx.x, blockIdx.x, smem, px, py, qx, qy, npairs, out, n);
}

extern "C" int bn_miller_product(const int32_t* px, const int32_t* py, const int32_t* qx,
                                 const int32_t* qy, int npairs, int32_t* out, long long n,
                                 void* stream) {
  if (npairs < 1) return (int)cudaErrorInvalidValue;
  return launch_team(miller_product_kernel, MP_TEAM * MP_CHAINS, MP_LPB,
                     miller_product_smem_bytes(), n, (cudaStream_t)stream, px, py, qx, qy,
                     npairs, out);
}

extern "C" int bn_miller_product_attrs(int* out) {
  return kernel_attrs(miller_product_kernel, MP_TEAM * MP_CHAINS, MP_LPB,
                      miller_product_smem_bytes(), out);
}

#else
#error "build with -DBN_TEAM_KERNEL=2, 3, 4 or 5"
#endif
