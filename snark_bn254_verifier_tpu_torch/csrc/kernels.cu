// The per-lane CUDA kernels of the port (K1, K2, K5) and the runtime
// set-up, for sm_90a, with a plain C interface loaded through ctypes
// (ops/_build.py); K3 and K4 are built from team_kernels.cu. The five
// kernels replace TPU kernels of snark_bn254_verifier_tpu/ops:
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
// input, so they are bound by integer issue and latency. K2 and K5 keep
// the simple form: one lane per thread, rolled loops, __noinline__ tower
// products, the MSM table built MSM_GROUP points at a time and K5's pairs
// MILLER_GROUP at a time on one shared chain; at a batch of 1024 they fill
// 32 warps of the 132 SMs. K3 and K4 split each lane's Fq12 products over
// a team of 12 or 18 threads, keep the lane's state in shared memory and
// the products in registers, and stage K3's line tables once per block
// (team.cuh). Nothing is padded; the grid masks the ragged edge. K1 is a
// short elementwise pass bound by launch overhead at the mask's sizes.
#include <cuda_runtime.h>

#include "pairing.cuh"

#define BLOCK_LIGHT 256  // K1
#define BLOCK_HEAVY 32   // K2, K5: one warp per block spreads lanes over SMs

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

__global__ void miller_product_kernel(const int32_t* px, const int32_t* py,
                                      const int32_t* qx, const int32_t* qy,
                                      int npairs, int32_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) miller_product_lane(px, py, qx, qy, npairs, out, n, i);
}

extern "C" {

// Per-thread stack for the deep __noinline__ call chains of K2, K5 and
// K4's inverse, on the runtime's current device.
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

int bn_miller_product(const int32_t* px, const int32_t* py, const int32_t* qx,
                      const int32_t* qy, int npairs, int32_t* out, long long n,
                      void* stream) {
  if (npairs < 1) return (int)cudaErrorInvalidValue;
  miller_product_kernel<<<grid_for(n, BLOCK_HEAVY), BLOCK_HEAVY, 0,
                          (cudaStream_t)stream>>>(px, py, qx, qy, npairs, out,
                                                  n);
  return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared bytes of a
// kernel, for the report of chip_smoke.py (K1 at Fq).
static int attrs(const void* kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  return 0;
}

int bn_mont_mul_attrs(int* out) { return attrs((const void*)mont_mul_kernel<FQ>, out); }
int bn_msm_affine_attrs(int* out) { return attrs((const void*)msm_affine_kernel, out); }
int bn_miller_product_attrs(int* out) { return attrs((const void*)miller_product_kernel, out); }

}  // extern "C"
