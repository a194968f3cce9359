// Kernel K7, the PlonK batch's per-lane scalar pass (plonk.cuh), for
// sm_90a, with a plain C interface loaded through ctypes (ops/_build.py):
//
//   K7a plonk_lanes_a  no Pallas original: the host pass of
//                      snark_bn254_verifier_tpu/parallel/batch.py:642-733
//   K7b plonk_lanes_b  no Pallas original: the host fold at :575-600
//
// One thread a lane, PLONK_LPB lanes a block: at batch 1024 that is 32
// blocks of one warp each, one a scheduler on 32 SMs (a block of 128
// would put four warps on each of 8 SMs, one a scheduler as well). The
// lane bodies' products and compressions are __noinline__ calls, so the
// unit builds in seconds.
#include <cuda_runtime.h>

#include "plonk.cuh"

#define PLONK_LPB 32

static inline unsigned plonk_grid(long long n) {
  return (unsigned)((n + PLONK_LPB - 1) / PLONK_LPB);
}

// The thread's lane. The ragged last block's idle threads repeat the last
// lane, writing the same values to the same places, so every thread of a
// warp makes the same __noinline__ calls (the rule of tower.cuh).
static __device__ __forceinline__ long long plonk_lane(long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  return i < n ? i : n - 1;
}

__global__ void plonk_lanes_a_kernel(const uint8_t* raw, long long L, const int32_t* pub,
                                     const uint8_t* valid_in, const uint32_t* vkc,
                                     uint8_t* valid_out, int32_t* zeta, int32_t* px,
                                     int32_t* py, uint8_t* pinf, int32_t* lin, long long n) {
  plonk_lanes_a_lane(raw, L, pub, valid_in, vkc, valid_out, zeta, px, py, pinf, lin, n,
                     plonk_lane(n));
}

__global__ void plonk_lanes_b_kernel(const uint8_t* raw, long long L, const uint8_t* valid,
                                     const int32_t* zeta, const int32_t* rand,
                                     const int32_t* dx, const int32_t* dy, const uint8_t* dinf,
                                     const uint32_t* vkc, int32_t* sc, long long n) {
  plonk_lanes_b_lane(raw, L, valid, zeta, rand, dx, dy, dinf, vkc, sc, n, plonk_lane(n));
}

static int plonk_attrs(const void* kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  out[4] = 1;  // threads a lane
  out[5] = PLONK_LPB;
  return 0;
}

extern "C" {

int bn_plonk_lanes_a(const uint8_t* raw, long long L, const int32_t* pub,
                     const uint8_t* valid_in, const uint32_t* vkc, uint8_t* valid_out,
                     int32_t* zeta, int32_t* px, int32_t* py, uint8_t* pinf, int32_t* lin,
                     long long n, void* stream) {
  plonk_lanes_a_kernel<<<plonk_grid(n), PLONK_LPB, 0, (cudaStream_t)stream>>>(
      raw, L, pub, valid_in, vkc, valid_out, zeta, px, py, pinf, lin, n);
  return (int)cudaGetLastError();
}

int bn_plonk_lanes_b(const uint8_t* raw, long long L, const uint8_t* valid,
                     const int32_t* zeta, const int32_t* rand, const int32_t* dx,
                     const int32_t* dy, const uint8_t* dinf, const uint32_t* vkc, int32_t* sc,
                     long long n, void* stream) {
  plonk_lanes_b_kernel<<<plonk_grid(n), PLONK_LPB, 0, (cudaStream_t)stream>>>(
      raw, L, valid, zeta, rand, dx, dy, dinf, vkc, sc, n);
  return (int)cudaGetLastError();
}

int bn_plonk_lanes_a_attrs(int* out) { return plonk_attrs((const void*)plonk_lanes_a_kernel, out); }

int bn_plonk_lanes_b_attrs(int* out) { return plonk_attrs((const void*)plonk_lanes_b_kernel, out); }

}  // extern "C"
