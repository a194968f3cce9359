// Kernel g2_lines (g2_lines.cuh), the line rows of the Groth16 batch's
// variable pair for K3, in a unit of its own so that K3's (team_kernels.cu
// with -DBN_TEAM_KERNEL=3) stays apart. Its products take the rolled
// Montgomery form, as K2's and K5's: a chain of dependent products on few
// warps, for which the rolled form was 22% faster on the H100 (PERF.md).
// A plain C interface, loaded through ctypes (ops/_build.py).
//
//   g2_lines   the G2 steps of pairing_pallas.py:99 _miller_mixed_kernel
#include <cuda_runtime.h>

#define BN_ROLLED_CIOS 1
#include "g2_lines.cuh"

static __global__ void g2_lines_kernel(const int32_t* px, const int32_t* py, const int32_t* qx,
                                       const int32_t* qy, int32_t* out, long long n) {
  extern __shared__ uint32_t smem[];
  g2_lines_team(threadIdx.x, blockIdx.x, smem, px, py, qx, qy, out, n);
}

// px, py (16, n) and qx, qy (16, 2, n) Montgomery limbs, zero where the
// pair is off; out (102, 3, 2, 8, n) 32-bit words.
extern "C" int bn_g2_lines(const int32_t* px, const int32_t* py, const int32_t* qx,
                           const int32_t* qy, int32_t* out, long long n, void* stream) {
  const long long smem = g2_lines_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(g2_lines_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + GL_LPB - 1) / GL_LPB);
  g2_lines_kernel<<<grid, GL_TEAM * GL_LPB, (size_t)smem, (cudaStream_t)stream>>>(px, py, qx,
                                                                                 qy, out, n);
  return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared bytes,
// threads per lane and lanes per block, as team_kernels.cu's.
extern "C" int bn_g2_lines_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, g2_lines_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)g2_lines_smem_bytes();
  out[4] = GL_TEAM;
  out[5] = GL_LPB;
  return 0;
}

// Blocks resident on one SM at the launch shape, into out[0].
extern "C" int bn_g2_lines_occupancy(int* out) {
  const long long smem = g2_lines_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(g2_lines_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, g2_lines_kernel,
                                                            GL_TEAM * GL_LPB, (size_t)smem);
}
