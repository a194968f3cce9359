// Kernel K1 (mont_mul, and its fused form g2_on_curve) and the runtime
// set-up, for sm_90a, with a plain C interface loaded through ctypes
// (ops/_build.py). The team kernels K2-K5 are built from team_kernels.cu.
// The kernels replace TPU kernels of snark_bn254_verifier_tpu/ops:
//
//   K1 mont_mul        field_pallas.py:37 _mont_kernel
//      g2_on_curve     (the same, fused with the G2 mask's Fq2 glue)
//   K2 msm_affine      pairing_pallas.py:206 _msm_windowed_kernel
//                      + pairing_pallas.py:271 _jacobian_combine_kernel
//   K3 miller_mixed    pairing_pallas.py:99 _miller_mixed_kernel
//   K4 final_exp       pairing_pallas.py:179 _fe_easy_expx_kernel
//                      + pairing_pallas.py:191 _fe_combine_kernel
//   K5 miller_product  pairing_pallas.py:84 _miller_kernel
//                      + pairing_pallas.py:171 _fq12_product_kernel
//
// What bounds them on an H100: K2-K5 do thousands of dependent 32x32->64-bit
// multiply-adds per lane and touch a few hundred bytes of input, so they
// are bound by integer issue and latency. Each runs on a team of threads
// per lane (msm.cuh, team.cuh): K2 one point per thread, K3-K5 each Fq12
// product split over the team, the lane's state in shared memory and the
// products in registers. Nothing is padded; the grid masks the ragged
// edge. K1 is a short elementwise pass, one element per thread. On the
// TPU the G2 on-curve mask is one jitted program around K1's products; run
// as K1 launches between eager torch ops it cost hundreds of ATen calls a
// batch, so g2_on_curve does the whole check of a lane in one thread: 7 Fp
// products and 259 bytes a lane, bound by launch overhead at batch 1024.
// Neighbouring threads read neighbouring limbs, so the loads coalesce.
#include <cuda_runtime.h>

#include "curve.cuh"

#define BLOCK_LIGHT 256  // K1, g2_on_curve

static inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

template <int F>
__global__ void mont_mul_kernel(const int32_t* a, const int32_t* b,
                                int32_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mont_mul_lane<F>(a, b, out, n, i);
}

// Every called function is inlined (the rule in tower.cuh), so the
// ragged last block may simply mask its idle threads.
__global__ void g2_on_curve_kernel(const int32_t* x, const int32_t* y, const uint8_t* inf,
                                   const uint8_t* valid, uint8_t* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = g2_on_curve_lane(x, y, inf, valid, n, i);
}

extern "C" {

// Per-thread stack for the __noinline__ call chain of K4's Fq12 inverse,
// on the runtime's current device.
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

// out[i] = valid[i] && (inf[i] || y_i^2 == x_i^3 + b') over B = n lanes.
int bn_g2_on_curve(const int32_t* x, const int32_t* y, const uint8_t* inf,
                   const uint8_t* valid, uint8_t* out, long long n, void* stream) {
  g2_on_curve_kernel<<<grid_for(n, BLOCK_LIGHT), BLOCK_LIGHT, 0, (cudaStream_t)stream>>>(
      x, y, inf, valid, out, n);
  return (int)cudaGetLastError();
}

// Registers, local (stack) bytes, static and dynamic shared bytes of a
// kernel, for the report of chip_smoke.py.
static int light_attrs(const void* kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  return 0;
}

// K1 at Fq.
int bn_mont_mul_attrs(int* out) { return light_attrs((const void*)mont_mul_kernel<FQ>, out); }

int bn_g2_on_curve_attrs(int* out) { return light_attrs((const void*)g2_on_curve_kernel, out); }

}  // extern "C"
