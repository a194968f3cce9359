// The five CUDA kernels of the port (the batched Groth16 path and the
// single-proof backend), for sm_90a, with a plain C interface loaded
// through ctypes (ops/_build.py).
//
// Each kernel runs one thread per lane over the port's limb tensors and
// replaces TPU kernels of snark_bn254_verifier_tpu/ops:
//
//   K1 mont_mul        field_pallas.py:37 _mont_kernel
//   K2 msm_affine      pairing_pallas.py:206 _msm_windowed_kernel
//                      + pairing_pallas.py:271 _jacobian_combine_kernel
//   K3 miller_mixed    pairing_pallas.py:99 _miller_mixed_kernel
//   K4 final_exp       pairing_pallas.py:179 _fe_easy_expx_kernel
//                      + pairing_pallas.py:191 _fe_combine_kernel
//   K5 miller_product  pairing_pallas.py:84 _miller_kernel
//                      + pairing_pallas.py:171 _fq12_product_kernel
//
// What bounds them on an H100: K2-K5 do tens of thousands of dependent
// 32x32->64-bit multiply-adds per lane and touch a few hundred bytes of
// input, so they are bound by integer issue and latency, and at a batch
// of 1024 one thread per lane fills only 32 warps of the 132 SMs' 8448
// warp slots; at the single-proof backend's batch of one, one thread does
// all the work. Their state (Fq12 accumulators, the MSM table, K5's four
// G2 points) spills to local memory, which stays in L1/L2 at this size.
// The design keeps the simple form for now: one lane per thread, rolled
// loops, __noinline__ tower products, the MSM table built MSM_GROUP points
// at a time and K5's pairs MILLER_GROUP at a time on one shared chain
// (where the TPU ran one grid step per pair and a second kernel for the
// product); nothing is padded, the grid masks the ragged edge.
// K1 is a short elementwise pass bound by launch overhead at the mask's
// sizes. Carry chains in PTX, several threads per lane and a persistent
// grid are later work.
#include <cuda_runtime.h>

#include "pairing.cuh"

#define BLOCK_LIGHT 256  // K1
#define BLOCK_HEAVY 32   // K2-K5: one warp per block spreads lanes over SMs

static inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

template <int F>
__global__ void mont_mul_kernel(const int32_t* a, const int32_t* b,
                                int32_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mont_mul_lane<F>(a, b, out, n, i);
}

__global__ void msm_affine_kernel(const int32_t* px, const int32_t* py,
                                  const uint8_t* pinf, const int32_t* sc,
                                  int npts, int32_t* ox, int32_t* oy,
                                  uint8_t* oinf, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) msm_affine_lane(px, py, pinf, sc, npts, ox, oy, oinf, n, i);
}

__global__ void miller_mixed_kernel(const int32_t* px, const int32_t* py,
                                    const int32_t* qx, const int32_t* qy,
                                    const int32_t* fpx, const int32_t* fpy,
                                    int nf, const int32_t* lines,
                                    const int32_t* tails, int32_t* out,
                                    long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    miller_mixed_lane(px, py, qx, qy, fpx, fpy, nf, lines, tails, out, n, i);
}

__global__ void final_exp_kernel(const int32_t* f, int32_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) final_exp_lane(f, out, n, i);
}

__global__ void miller_product_kernel(const int32_t* px, const int32_t* py,
                                      const int32_t* qx, const int32_t* qy,
                                      int npairs, int32_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) miller_product_lane(px, py, qx, qy, npairs, out, n, i);
}

extern "C" {

// Per-thread stack for the deep __noinline__ call chains of K2-K5, on the
// runtime's current device.
int bn_init(long long stack_bytes) {
  cudaDeviceSetLimit(cudaLimitStackSize, (size_t)stack_bytes);
  return (int)cudaGetLastError();
}

const char* bn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int bn_mont_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n,
                int field, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (field == FQ)
    mont_mul_kernel<FQ><<<grid_for(n, BLOCK_LIGHT), BLOCK_LIGHT, 0, s>>>(a, b, out, n);
  else
    mont_mul_kernel<FR><<<grid_for(n, BLOCK_LIGHT), BLOCK_LIGHT, 0, s>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

int bn_msm_affine(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                  const int32_t* sc, int npts, int32_t* ox, int32_t* oy,
                  uint8_t* oinf, long long n, void* stream) {
  if (npts < 1) return (int)cudaErrorInvalidValue;
  msm_affine_kernel<<<grid_for(n, BLOCK_HEAVY), BLOCK_HEAVY, 0,
                      (cudaStream_t)stream>>>(px, py, pinf, sc, npts, ox, oy,
                                              oinf, n);
  return (int)cudaGetLastError();
}

int bn_miller_mixed(const int32_t* px, const int32_t* py, const int32_t* qx,
                    const int32_t* qy, const int32_t* fpx, const int32_t* fpy,
                    int nf, const int32_t* lines, const int32_t* tails,
                    int32_t* out, long long n, void* stream) {
  miller_mixed_kernel<<<grid_for(n, BLOCK_HEAVY), BLOCK_HEAVY, 0,
                        (cudaStream_t)stream>>>(px, py, qx, qy, fpx, fpy, nf,
                                                lines, tails, out, n);
  return (int)cudaGetLastError();
}

int bn_final_exp(const int32_t* f, int32_t* out, long long n, void* stream) {
  final_exp_kernel<<<grid_for(n, BLOCK_HEAVY), BLOCK_HEAVY, 0,
                     (cudaStream_t)stream>>>(f, out, n);
  return (int)cudaGetLastError();
}

int bn_miller_product(const int32_t* px, const int32_t* py, const int32_t* qx,
                      const int32_t* qy, int npairs, int32_t* out, long long n,
                      void* stream) {
  if (npairs < 1) return (int)cudaErrorInvalidValue;
  miller_product_kernel<<<grid_for(n, BLOCK_HEAVY), BLOCK_HEAVY, 0,
                          (cudaStream_t)stream>>>(px, py, qx, qy, npairs, out,
                                                  n);
  return (int)cudaGetLastError();
}

}  // extern "C"
