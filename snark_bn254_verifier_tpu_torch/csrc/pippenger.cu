// Kernel K6 (msm_pippenger), the bucket MSM, for sm_90a with a plain C
// interface loaded through ctypes. It replaces ops/msm.py::msm_pippenger
// of snark_bn254_verifier_tpu, which is XLA with no Pallas original; what
// bounds it and the design are in pippenger.cuh. ops/_build.py compiles
// this file twice, each by its own nvcc:
//   -DBN_PIP_COMBINE=0  stages 1-5 (digits, sort, buckets, merge,
//                       reduction) with the rolled Montgomery product (as
//                       K2): bn_msm_pippenger_windows, and bn_msm_pippenger,
//                       the whole MSM, which ends in the other unit's launch;
//   -DBN_PIP_COMBINE=1  stage 6, the combine, with the unrolled product (as
//                       K4, whose chain it made faster at batch one; the
//                       reduction, built so, ran slower on the H100):
//                       bn_msm_pippenger_combine.
#include <cuda_runtime.h>

#if BN_PIP_COMBINE
#define BN_ROLLED_CIOS 0
#else
#define BN_ROLLED_CIOS 1
#endif
#include "pippenger.cuh"

#define PIP_BLOCK 128  // threads a block of the per-thread stages (1, 3, 4)

static inline unsigned pip_grid(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

// Registers, stack bytes, threads a block and resident blocks an SM of
// each of nk kernels at its launch shape, four ints a kernel.
static int stage_attrs(const void* const* kernels, const int* threads, const long long* smem,
                       int nk, int* out) {
  for (int i = 0; i < nk; ++i) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernels[i]);
    if (err != cudaSuccess) return (int)err;
    out[4 * i] = a.numRegs;
    out[4 * i + 1] = (int)a.localSizeBytes;
    out[4 * i + 2] = threads[i];
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4 * i + 3], kernels[i], threads[i],
                                                        (size_t)smem[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The combine unit's launch, for the whole MSM of the other one.
extern "C" int pip_launch_combine(const uint32_t* wsum, int k, int c, int32_t* ox, int32_t* oy,
                                  uint8_t* oinf, long long n, cudaStream_t s);

#if BN_PIP_COMBINE

static __global__ void pip_combine_kernel(const uint32_t* wsum, int k, int c, int32_t* ox,
                                          int32_t* oy, uint8_t* oinf, long long n) {
  __shared__ uint32_t xch[PIP_COMB_LPB * PIP_XCH_WORDS];
  const int slot = threadIdx.x / PIP_COMB_TEAM;
  const long long lane = (long long)blockIdx.x * PIP_COMB_LPB + slot;
  pip_combine_team(threadIdx.x % PIP_COMB_TEAM, lane < n ? lane : n - 1, lane < n,
                   (fp*)(xch + slot * PIP_XCH_WORDS), wsum, k, c, ox, oy, oinf, n);
}

extern "C" int pip_launch_combine(const uint32_t* wsum, int k, int c, int32_t* ox, int32_t* oy,
                                  uint8_t* oinf, long long n, cudaStream_t s) {
  pip_combine_kernel<<<pip_grid(n, PIP_COMB_LPB), PIP_COMB_TEAM * PIP_COMB_LPB, 0, s>>>(
      wsum, k, c, ox, oy, oinf, n);
  return (int)cudaGetLastError();
}

// The affine sum of k sets of window sums of n lanes: wsum (k, n, W, 24
// words) as bn_msm_pippenger_windows writes them, summed window by window,
// then Horner and the affine form into ox, oy (16, n), oinf (n).
extern "C" int bn_msm_pippenger_combine(const int32_t* wsum, int k, int c, int32_t* ox,
                                        int32_t* oy, uint8_t* oinf, long long n, void* stream) {
  if (k < 1 || c < 1 || c > 16) return (int)cudaErrorInvalidValue;
  return pip_launch_combine((const uint32_t*)wsum, k, c, ox, oy, oinf, n, (cudaStream_t)stream);
}

// Stage 6, as bn_msm_pippenger_stage_attrs.
extern "C" int bn_msm_pippenger_combine_attrs(int* out) {
  const void* kernels[1] = {(const void*)pip_combine_kernel};
  const int threads[1] = {PIP_COMB_TEAM * PIP_COMB_LPB};
  const long long smem[1] = {0};
  return stage_attrs(kernels, threads, smem, 1, out);
}

#else

static __global__ void pip_digits_kernel(const int32_t* sc, const uint8_t* pinf, int npts, int c,
                                         uint16_t* digits, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n * npts) pip_digits_thread(idx, sc, pinf, npts, c, digits, n);
}

static __global__ void __launch_bounds__(PIP_SORT_THREADS)
    pip_sort_kernel(int npts, int c, pip_scratch s) {
  extern __shared__ uint32_t smem[];
  pip_sort_team(threadIdx.x, blockDim.x, blockIdx.x, smem, npts, c, s);
}

// Stage 3, the bucket sums: a thread a chunk.
static __global__ void msm_pippenger_kernel(int chunk, const int32_t* px, const int32_t* py,
                                            int npts, int c, pip_scratch s, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < pip_chunks(npts, c, n, chunk)) pip_chunk_thread(k, chunk, px, py, npts, c, s, n);
}

static __global__ void pip_merge_kernel(int chunk, int npts, int c, pip_scratch s, long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < pip_chunks(npts, c, n, chunk)) pip_merge_thread(k, chunk, npts, c, s, n);
}

static __global__ void pip_reduce_kernel(int npts, int c, pip_scratch s, uint32_t* wsum) {
  extern __shared__ uint32_t smem[];
  pip_reduce_team(threadIdx.x, blockDim.x, blockIdx.x, (g1j*)smem, npts, c, s, wsum);
}

// Bytes of the scratch of one call (pippenger.cuh::pip_scratch_layout).
extern "C" long long bn_msm_pippenger_scratch_bytes(int npts, int c, long long n, int chunk) {
  pip_scratch s;
  return pip_scratch_layout(&s, nullptr, npts, c, n, chunk);
}

// Stages 1-5: the window sums of n lanes into wsum (n, W, 24 words). With
// stage_ms, also each stage's ms by CUDA events (a sync).
static int pip_launch_windows(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                              const int32_t* sc, int npts, int c, int chunk, char* scratch,
                              uint32_t* wsum, long long n, float* stage_ms, cudaStream_t s) {
  if (npts < 1 || c < 1 || c > 16 || chunk < 1) return (int)cudaErrorInvalidValue;
  pip_scratch sp;
  pip_scratch_layout(&sp, scratch, npts, c, n, chunk);
  const long long rows = n * pip_windows(c), chunks = pip_chunks(npts, c, n, chunk);
  const int nt = pip_sort_threads(npts), nr = pip_threads(c, rows);
  cudaEvent_t ev[6];
  if (stage_ms) {
    for (int i = 0; i < 6; ++i) cudaEventCreate(&ev[i]);
    cudaEventRecord(ev[0], s);
  }
  cudaError_t err = cudaSuccess;
  for (int stage = 0; stage < 5 && err == cudaSuccess; ++stage) {
    if (stage == 0)
      pip_digits_kernel<<<pip_grid(n * npts, PIP_BLOCK), PIP_BLOCK, 0, s>>>(sc, pinf, npts, c,
                                                                          sp.digits, n);
    else if (stage == 1)
      pip_sort_kernel<<<(unsigned)rows, nt, (size_t)pip_sort_smem_bytes(c, nt), s>>>(npts, c,
                                                                                    sp);
    else if (stage == 2)
      msm_pippenger_kernel<<<pip_grid(chunks, PIP_BLOCK), PIP_BLOCK, 0, s>>>(chunk, px, py, npts,
                                                                           c, sp, n);
    else if (stage == 3)
      pip_merge_kernel<<<pip_grid(chunks, PIP_BLOCK), PIP_BLOCK, 0, s>>>(chunk, npts, c, sp, n);
    else
      pip_reduce_kernel<<<(unsigned)rows, nr, (size_t)pip_smem_bytes(nr), s>>>(npts, c, sp,
                                                                               wsum);
    err = cudaGetLastError();
    if (stage_ms) cudaEventRecord(ev[stage + 1], s);
  }
  if (stage_ms) {
    if (err == cudaSuccess) err = cudaEventSynchronize(ev[5]);
    for (int i = 0; i < 5 && err == cudaSuccess; ++i)
      err = cudaEventElapsedTime(&stage_ms[i], ev[i], ev[i + 1]);
    for (int i = 0; i < 6; ++i) cudaEventDestroy(ev[i]);
  }
  return (int)err;
}

// The window sums of n lanes (stages 1-5): points px, py (npts, 16, n),
// pinf (npts, n) bytes, scalars sc (npts, 16, n) canonical Fr limbs;
// scratch of bn_msm_pippenger_scratch_bytes; wsum (n, W, 24 words). With
// stage_ms (5 floats, or null), each stage's ms, after a sync.
extern "C" int bn_msm_pippenger_windows(const int32_t* px, const int32_t* py,
                                        const uint8_t* pinf, const int32_t* sc, int npts, int c,
                                        int chunk, void* scratch, int32_t* wsum, long long n,
                                        float* stage_ms, void* stream) {
  return pip_launch_windows(px, py, pinf, sc, npts, c, chunk, (char*)scratch, (uint32_t*)wsum,
                            n, stage_ms, (cudaStream_t)stream);
}

// The whole MSM of n lanes on ``stream``: stages 1-5 into wsum, then the
// combine (k = 1) into ox, oy (16, n), oinf (n).
extern "C" int bn_msm_pippenger(const int32_t* px, const int32_t* py, const uint8_t* pinf,
                                const int32_t* sc, int npts, int c, int chunk, void* scratch,
                                int32_t* wsum, int32_t* ox, int32_t* oy, uint8_t* oinf,
                                long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = pip_launch_windows(px, py, pinf, sc, npts, c, chunk, (char*)scratch,
                                     (uint32_t*)wsum, n, nullptr, s);
  if (err != 0) return err;
  return pip_launch_combine((const uint32_t*)wsum, 1, c, ox, oy, oinf, n, s);
}

// The bucket stage's registers, stack and shared bytes, its threads a
// block, 1; out as the team kernels'.
extern "C" int bn_msm_pippenger_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, msm_pippenger_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = 0;
  out[4] = PIP_BLOCK;
  out[5] = 1;
  return 0;
}

// Registers, stack bytes, threads a block and resident blocks an SM of
// stages 1-5 (digits, sort at npts >= 1024, buckets, merge, reduction in
// wide blocks; c = 8), four ints a stage.
extern "C" int bn_msm_pippenger_stage_attrs(int* out) {
  const void* kernels[5] = {(const void*)pip_digits_kernel, (const void*)pip_sort_kernel,
                            (const void*)msm_pippenger_kernel, (const void*)pip_merge_kernel,
                            (const void*)pip_reduce_kernel};
  const int threads[5] = {PIP_BLOCK, PIP_SORT_THREADS, PIP_BLOCK, PIP_BLOCK, PIP_THREADS};
  const long long smem[5] = {0, pip_sort_smem_bytes(8, PIP_SORT_THREADS), 0, 0,
                             pip_smem_bytes(PIP_THREADS)};
  return stage_attrs(kernels, threads, smem, 5, out);
}

#endif
