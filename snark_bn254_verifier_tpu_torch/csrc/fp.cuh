// Montgomery arithmetic over the BN254 base field Fq and scalar field Fr on
// 8 x 32-bit limbs, one field element per thread.
//
// The same headers compile two ways: under nvcc every function is a
// __device__ function of the kernels in kernels.cu; under a host C++
// compiler (host_check.cc) they are plain host functions, so the limb
// conversion and the CIOS can be checked without a card.
//
// Boundary layout: the port's tensors hold 16-bit limbs in int32 lanes,
// limb-major with the batch axis last, so limb k of lane i sits at
// ptr[k * stride + i]. Montgomery R = 2^256 for 16- and 32-bit limbs
// alike, so converting at load and store keeps results bit-identical to
// the plain PyTorch twins and the JAX package. Every result is fully
// reduced into [0, modulus), as theirs are.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define BN_INLINE __device__ __forceinline__
#define BN_NOINLINE __device__ __noinline__
#define BN_CONST __constant__
#define BN_LDG(p) __ldg(p)
#else
#define BN_INLINE static inline
#define BN_NOINLINE static
#define BN_CONST static const
#define BN_LDG(p) (*(p))
#endif

// Generated from oracle/bn254.py at build time (ops/_build.py): moduli,
// Montgomery constants, Frobenius coefficients and loop bit schedules.
#include "bn254_consts.h"

#define NW 8  // 32-bit limbs per element

struct fp {
  uint32_t w[NW];
};

enum { FQ = 0, FR = 1 };

template <int F>
BN_INLINE uint32_t mod_word(int i) {
  return F == FQ ? FQ_MOD[i] : FR_MOD[i];
}

template <int F>
BN_INLINE uint32_t mod_n0() {
  return F == FQ ? BN_FQ_N0 : BN_FR_N0;
}

BN_INLINE void fp_zero(fp& r) {
  for (int j = 0; j < NW; ++j) r.w[j] = 0;
}

template <int F>
BN_INLINE void fp_one(fp& r) {
  for (int j = 0; j < NW; ++j) r.w[j] = F == FQ ? FQ_ONE[j] : FR_ONE[j];
}

BN_INLINE bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
  for (int j = 0; j < NW; ++j) acc |= a.w[j];
  return acc == 0;
}

BN_INLINE bool fp_eq(const fp& a, const fp& b) {
  uint32_t acc = 0;
  for (int j = 0; j < NW; ++j) acc |= a.w[j] ^ b.w[j];
  return acc == 0;
}

BN_INLINE void fp_select(fp& r, bool c, const fp& a, const fp& b) {
  for (int j = 0; j < NW; ++j) r.w[j] = c ? a.w[j] : b.w[j];
}

// t (+ extra * 2^256) -> t - modulus if that value is >= modulus, else t.
// The value must be below twice the modulus.
template <int F>
BN_INLINE void fp_cond_sub(fp& r, const uint32_t* t, uint32_t extra) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)t[j] - mod_word<F>(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = extra != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.w[j] = take ? d[j] : t[j];
}

template <int F>
BN_INLINE void fp_add(fp& r, const fp& a, const fp& b) {
  uint32_t t[NW];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.w[j] + b.w[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  fp_cond_sub<F>(r, t, (uint32_t)c);
}

template <int F>
BN_INLINE void fp_sub(fp& r, const fp& a, const fp& b) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)a.w[j] - b.w[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add the modulus back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t s = (uint64_t)d[j] + (mod_word<F>(j) & mask) + c;
    r.w[j] = (uint32_t)s;
    c = s >> 32;
  }
}

template <int F>
BN_INLINE void fp_neg(fp& r, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub<F>(r, z, a);
}

template <int F>
BN_INLINE void fp_dbl(fp& r, const fp& a) {
  fp_add<F>(r, a, a);
}

// CIOS Montgomery product a * b * 2^-256 mod modulus with n0' = -p^-1 mod
// 2^32. Every step stays below 2^64: t + a_i*b_j + c <= 2^64 - 1. r may
// alias a or b: it is written only after the last read.
template <int F>
BN_INLINE void fp_mul(fp& r, const fp& a, const fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[i] * b.w[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * mod_n0<F>();
    s = (uint64_t)t[0] + (uint64_t)m * mod_word<F>(0);
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * mod_word<F>(j) + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  fp_cond_sub<F>(r, t, t[NW]);
}

template <int F>
BN_INLINE void fp_sq(fp& r, const fp& a) {
  fp_mul<F>(r, a, a);
}

// Fermat inversion a^(p-2) in Fq, square-and-multiply over the exponent's
// bits from the top (rolled loop); zero maps to zero.
BN_NOINLINE void fq_inv(fp& r, const fp& a) {
  fp acc;
  fp_one<FQ>(acc);
  for (int i = BN_FQ_PM2_NBITS - 1; i >= 0; --i) {
    fp_mul<FQ>(acc, acc, acc);
    if ((FQ_PM2[i >> 5] >> (i & 31)) & 1u) fp_mul<FQ>(acc, acc, a);
  }
  r = acc;
}

// --- boundary conversion: 16-bit limbs in int32 lanes <-> 32-bit limbs ---

BN_INLINE void load_fp(fp& r, const int32_t* p, int64_t stride) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t lo = (uint32_t)p[(2 * k) * stride];
    const uint32_t hi = (uint32_t)p[(2 * k + 1) * stride];
    r.w[k] = (lo & 0xFFFFu) | (hi << 16);
  }
}

BN_INLINE void store_fp(int32_t* p, int64_t stride, const fp& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[(2 * k) * stride] = (int32_t)(a.w[k] & 0xFFFFu);
    p[(2 * k + 1) * stride] = (int32_t)(a.w[k] >> 16);
  }
}

// One lane of kernel K1: out = a * b * 2^-256 over (16, n) limb arrays.
template <int F>
BN_INLINE void mont_mul_lane(const int32_t* a, const int32_t* b, int32_t* out,
                             int64_t n, int64_t lane) {
  fp x, y;
  load_fp(x, a + lane, n);
  load_fp(y, b + lane, n);
  fp_mul<F>(x, x, y);
  store_fp(out + lane, n, x);
}
