// Kernel K7, the PlonK batch's per-lane scalar pass (plonk.cuh), for
// sm_90a, with a plain C interface loaded through ctypes (ops/_build.py):
//
//   K7a plonk_lanes_a  no Pallas original: the host pass of
//                      snark_bn254_verifier_tpu/parallel/batch.py:642-733
//   K7b plonk_lanes_b  no Pallas original: the host fold at :575-600
//
// A block is K7_LPB = 32 lanes and a warp a role over them (K7A_WARPS,
// K7B_WARPS), its stages split by __syncthreads; the same stage functions
// run on the host build (host_check.cc), block by block, stage by stage.
// The block's proof rows and its hand-over slots are dynamic shared
// memory, sized from the proof length L = 808 + 96 nb (ops/plonk_lanes.py::
// proof_bytes). The products, compressions and the inverse are
// __noinline__ calls, so the unit builds in seconds.
#include <cuda_runtime.h>

#include "plonk.cuh"

#define K7A_THREADS (K7A_WARPS * K7_LPB)
#define K7B_THREADS (K7B_WARPS * K7_LPB)

static inline unsigned plonk_grid(long long n) {
  return (unsigned)((n + K7_LPB - 1) / K7_LPB);
}

__global__ void plonk_lanes_a_kernel(k7a_args a) {
  extern __shared__ uint32_t k7_buf[];
  const k7_smem s = k7_layout(k7_buf, a.L);
  k7_stage_rows(a.raw, a.L, a.n, blockIdx.x, s, threadIdx.x, K7A_THREADS);
  __syncthreads();
  plonk_a_stage1(a, s, threadIdx.x, blockIdx.x);
  __syncthreads();
  plonk_a_stage2(a, s, threadIdx.x, blockIdx.x);
  __syncthreads();
  plonk_a_stage3(a, s, threadIdx.x, blockIdx.x);
}

__global__ void plonk_lanes_b_kernel(k7b_args a) {
  extern __shared__ uint32_t k7_buf[];
  const k7_smem s = k7_layout(k7_buf, a.L);
  k7_stage_rows(a.raw, a.L, a.n, blockIdx.x, s, threadIdx.x, K7B_THREADS);
  __syncthreads();
  plonk_b_stage1(a, s, threadIdx.x, blockIdx.x);
  __syncthreads();
  plonk_b_stage2(a, s, threadIdx.x, blockIdx.x);
}

// The dynamic shared bytes of a launch over rows of L bytes (0 when L is
// no proof length or the rows do not fit a block: more than k7_max_nb()
// commitments), after raising the kernel's limit where above 48 KB; the
// last launch's, for plonk_attrs.
static int k7a_smem_last = 0, k7b_smem_last = 0;

static int plonk_smem(const void* kernel, const uint8_t* raw, long long L, bool lanes_a,
                      int* last) {
  if (L < 808 || (L - 808) % 96 != 0 || ((uintptr_t)raw & 3)) return 0;
  const int nb = (int)((L - 808) / 96);
  const long long bytes = k7_smem_bytes(L, nb, lanes_a);
  if (nb > k7_max_nb() || bytes > K7_SMEM_MAX) return 0;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
          cudaSuccess)
    return 0;
  *last = (int)bytes;
  return (int)bytes;
}

static int plonk_attrs(const void* kernel, int warps, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem;     // dynamic: the last launch's rows and slots
  out[4] = warps;    // threads a lane, one in each warp (so warps a block)
  out[5] = K7_LPB;   // lanes a block
  return 0;
}

extern "C" {

int bn_plonk_lanes_a(const uint8_t* raw, long long L, const int32_t* pub,
                     const uint8_t* valid_in, const uint32_t* vkc, uint8_t* valid_out,
                     int32_t* zeta, int32_t* px, int32_t* py, uint8_t* pinf, int32_t* lin,
                     long long n, void* stream) {
  const int smem = plonk_smem((const void*)plonk_lanes_a_kernel, raw, L, true, &k7a_smem_last);
  if (!smem) return (int)cudaErrorInvalidValue;
  const k7a_args a = {raw, L, pub, valid_in, vkc, valid_out, zeta, px, py, pinf, lin, n};
  plonk_lanes_a_kernel<<<plonk_grid(n), K7A_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int bn_plonk_lanes_b(const uint8_t* raw, long long L, const uint8_t* valid,
                     const int32_t* zeta, const int32_t* rand, const int32_t* dx,
                     const int32_t* dy, const uint8_t* dinf, const uint32_t* vkc, int32_t* sc,
                     long long n, void* stream) {
  const int smem = plonk_smem((const void*)plonk_lanes_b_kernel, raw, L, false, &k7b_smem_last);
  if (!smem) return (int)cudaErrorInvalidValue;
  const k7b_args a = {raw, L, valid, zeta, rand, dx, dy, dinf, vkc, sc, n};
  plonk_lanes_b_kernel<<<plonk_grid(n), K7B_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int bn_plonk_max_nb(void) { return k7_max_nb(); }

int bn_plonk_lanes_a_attrs(int* out) {
  return plonk_attrs((const void*)plonk_lanes_a_kernel, K7A_WARPS, k7a_smem_last, out);
}

int bn_plonk_lanes_b_attrs(int* out) {
  return plonk_attrs((const void*)plonk_lanes_b_kernel, K7B_WARPS, k7b_smem_last, out);
}

}  // extern "C"
