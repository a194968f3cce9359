// Native host data-plane of the PyTorch port's batch verifier: a copy of
// the JAX package's native/bn254_host.cc, built by utils/native.py.
//
// Role: the CPU-side "data loader" feeding the device pipeline — batch
// parsing of gnark-serialized proofs and batch conversion of 32-byte
// big-endian field elements into the limb-major (16 x n) uint32 Montgomery
// tensors the device kernels consume (see ops/limbs.py for the layout
// contract). The reference delegates this tier to Rust (`substrate-bn`
// byte codecs, verifier/src/converter.rs); here it is C++ behind ctypes
// with a pure-Python fallback (utils/native.py).
//
// The 256-bit arithmetic uses 4x64-bit limbs with __uint128_t products and
// CIOS Montgomery multiplication. All modulus-derived constants (R^2, the
// -p^-1 mod 2^64 inverse) are computed at init from the modulus passed in
// by Python — the single source of truth stays in oracle/bn254.py.
//
// Build: g++ -O2 -shared -fPIC -o libbn254host.so bn254_host.cc

#include <cstdint>
#include <cstring>

namespace {

typedef unsigned __int128 u128;

struct Fp {
  uint64_t v[4];
};

struct Field {
  Fp mod;        // modulus
  Fp r2;         // R^2 mod p (R = 2^256)
  uint64_t n0inv;  // -p^-1 mod 2^64
  bool ready = false;
};

Field g_fq, g_fr;

bool fp_gte(const Fp &a, const Fp &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
  }
  return true;
}

void fp_sub_inplace(Fp &a, const Fp &b) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    a.v[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}

// a = 2*a mod p
void fp_double_mod(Fp &a, const Fp &p) {
  uint64_t carry = 0;
  for (int i = 0; i < 4; ++i) {
    uint64_t hi = a.v[i] >> 63;
    a.v[i] = (a.v[i] << 1) | carry;
    carry = hi;
  }
  if (carry || fp_gte(a, p)) fp_sub_inplace(a, p);
}

// CIOS Montgomery multiply: out = a*b*R^-1 mod p
void mont_mul(const Field &f, const Fp &a, const Fp &b, Fp &out) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + c;
      t[j] = (uint64_t)s;
      c = s >> 64;
    }
    u128 s = (u128)t[4] + c;
    t[4] = (uint64_t)s;
    t[5] = (uint64_t)(s >> 64);

    uint64_t m = t[0] * f.n0inv;
    c = ((u128)t[0] + (u128)m * f.mod.v[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * f.mod.v[j] + c;
      t[j - 1] = (uint64_t)s2;
      c = s2 >> 64;
    }
    s = (u128)t[4] + c;
    t[3] = (uint64_t)s;
    t[4] = t[5] + (uint64_t)(s >> 64);
  }
  Fp r;
  std::memcpy(r.v, t, sizeof(r.v));
  if (t[4] || fp_gte(r, f.mod)) fp_sub_inplace(r, f.mod);
  out = r;
}

void field_init(Field &f, const uint64_t p_limbs[4]) {
  std::memcpy(f.mod.v, p_limbs, sizeof(f.mod.v));
  // n0inv by Newton: x_{k+1} = x_k * (2 - p0 * x_k) mod 2^64
  uint64_t p0 = f.mod.v[0];
  uint64_t x = 1;
  for (int i = 0; i < 6; ++i) x *= 2 - p0 * x;
  f.n0inv = (uint64_t)(0 - x);
  // r2 = 2^512 mod p via 512 modular doublings of 1
  Fp r2 = {{1, 0, 0, 0}};
  for (int i = 0; i < 512; ++i) fp_double_mod(r2, f.mod);
  f.r2 = r2;
  f.ready = true;
}

// 32-byte big-endian -> 4x64 little-endian limbs
void be_to_fp(const uint8_t *in, Fp &out) {
  for (int i = 0; i < 4; ++i) {
    uint64_t w = 0;
    for (int j = 0; j < 8; ++j) w = (w << 8) | in[(3 - i) * 8 + j];
    out.v[i] = w;
  }
}

// 4x64 -> limb-major uint32x16 output at column `col` of an (16, n) matrix
void fp_to_limbs16(const Fp &a, uint32_t *out, size_t col, size_t n) {
  for (int i = 0; i < 4; ++i) {
    uint64_t w = a.v[i];
    for (int k = 0; k < 4; ++k) {
      out[(i * 4 + k) * n + col] = (uint32_t)((w >> (16 * k)) & 0xFFFF);
    }
  }
}

}  // namespace

extern "C" {

int bn254_host_init(const uint64_t fq_limbs[4], const uint64_t fr_limbs[4]) {
  field_init(g_fq, fq_limbs);
  field_init(g_fr, fr_limbs);
  return 0;
}

// Convert n 32-byte big-endian elements to a (16, n) limb-major uint32
// matrix. field_sel: 0 = Fq, 1 = Fr. to_mont: convert to Montgomery form.
// reduce: if nonzero, accept values >= p and reduce; else flag them.
// Returns the number of NON-canonical inputs encountered (0 if all ok);
// flags[i] is set to 0/1 per element if flags != nullptr.
int bn254_pack_batch(const uint8_t *in, size_t n, int field_sel, int to_mont,
                     int reduce, uint32_t *out, uint8_t *flags) {
  const Field &f = field_sel ? g_fr : g_fq;
  if (!f.ready) return -1;
  int bad = 0;
  for (size_t i = 0; i < n; ++i) {
    Fp a;
    be_to_fp(in + 32 * i, a);
    bool noncanon = fp_gte(a, f.mod);
    if (noncanon) {
      ++bad;
      if (reduce) {
        // one conditional subtract suffices for values < 2^256 < 2p only if
        // value < 2p; BN254 moduli are ~2^254 so up to 3 subtracts needed
        while (fp_gte(a, f.mod)) fp_sub_inplace(a, f.mod);
      }
    }
    if (flags) flags[i] = noncanon ? 1 : 0;
    if (to_mont) mont_mul(f, a, f.r2, a);
    fp_to_limbs16(a, out, i, n);
  }
  return bad;
}

// Batch-parse raw gnark Groth16 proofs (layout groth16/converter.rs:14-25:
// ar G1 [0..64), bs G2 [64..192), krs G1 [192..256)).
// proofs: b contiguous buffers of stride `stride` bytes (>= 256).
// Outputs (all limb-major (16, b) uint32, Montgomery form):
//   ar_x, ar_y, krs_x, krs_y, bs coords x1,x0,y1,y0 -> bs_x0,bs_x1,bs_y0,bs_y1
// valid[i] set to 0 if any coordinate is non-canonical or a point is
// off-curve (on-curve checks performed natively).
int bn254_parse_groth16_batch(const uint8_t *proofs, size_t stride, size_t b,
                              uint32_t *ar_x, uint32_t *ar_y,
                              uint32_t *bs_x0, uint32_t *bs_x1,
                              uint32_t *bs_y0, uint32_t *bs_y1,
                              uint32_t *krs_x, uint32_t *krs_y,
                              uint8_t *valid) {
  if (!g_fq.ready) return -1;
  const Field &f = g_fq;
  // b_mont = mont(3): curve constant for on-curve checks
  Fp three = {{3, 0, 0, 0}};
  Fp b_mont;
  mont_mul(f, three, f.r2, b_mont);

  for (size_t i = 0; i < b; ++i) {
    const uint8_t *p = proofs + stride * i;
    bool ok = true;
    Fp coords[8];  // ar.x, ar.y, bs.x1, bs.x0, bs.y1, bs.y0, krs.x, krs.y
    static const int offs[8] = {0, 32, 64, 96, 128, 160, 192, 224};
    for (int c = 0; c < 8; ++c) {
      be_to_fp(p + offs[c], coords[c]);
      if (fp_gte(coords[c], f.mod)) ok = false;
    }
    if (ok) {
      // to Montgomery
      for (int c = 0; c < 8; ++c) mont_mul(f, coords[c], f.r2, coords[c]);
      // G1 on-curve: y^2 == x^3 + 3 (Montgomery domain)
      auto g1_check = [&](const Fp &x, const Fp &y) {
        Fp y2, x2, x3;
        mont_mul(f, y, y, y2);
        mont_mul(f, x, x, x2);
        mont_mul(f, x2, x, x3);
        // x3 + b
        u128 carry = 0;
        Fp rhs;
        for (int k = 0; k < 4; ++k) {
          u128 s = (u128)x3.v[k] + b_mont.v[k] + carry;
          rhs.v[k] = (uint64_t)s;
          carry = s >> 64;
        }
        if (carry || fp_gte(rhs, f.mod)) fp_sub_inplace(rhs, f.mod);
        return std::memcmp(y2.v, rhs.v, sizeof(rhs.v)) == 0;
      };
      if (!g1_check(coords[0], coords[1])) ok = false;
      if (!g1_check(coords[6], coords[7])) ok = false;
      // G2 on-curve checked on device (Fq2 arithmetic); canonical range
      // checks already done above.
    }
    valid[i] = ok ? 1 : 0;
    if (!ok) {
      // write the G1/G2 generator pattern zeros; caller masks the lane
      std::memset(coords, 0, sizeof(coords));
    }
    fp_to_limbs16(coords[0], ar_x, i, b);
    fp_to_limbs16(coords[1], ar_y, i, b);
    fp_to_limbs16(coords[3], bs_x0, i, b);
    fp_to_limbs16(coords[2], bs_x1, i, b);
    fp_to_limbs16(coords[5], bs_y0, i, b);
    fp_to_limbs16(coords[4], bs_y1, i, b);
    fp_to_limbs16(coords[6], krs_x, i, b);
    fp_to_limbs16(coords[7], krs_y, i, b);
  }
  return 0;
}

}  // extern "C"
