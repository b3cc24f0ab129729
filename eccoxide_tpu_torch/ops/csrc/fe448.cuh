// Device arithmetic for FQ448 = 2^448 - 2^224 - 1 in the port's limb format.
//
// Same format, folded columns and carry as eccoxide_tpu_torch/field448.py,
// so the limbs are the same: 16 non-negative limbs of 28 bits, one value per
// thread, products accumulated in 64-bit unsigned registers, one 32x32->64
// multiply-add per partial product (madw.cuh). mul and sq
// return TIGHT limbs (field448.py TIGHT) from TIGHT inputs; field448.py
// asserts the bounds that make the 64-bit columns and the 32-bit second
// carry round exact.
#pragma once

#include <cstdint>

#include "madw.cuh"

namespace fe448 {

constexpr int kN = 16;
constexpr int kBits = 28;
constexpr int kHalf = 8;                 // 2^224 is limb 8
constexpr uint64_t kMask = (1ull << kBits) - 1;

struct fe {
  uint32_t v[kN];
};

__device__ __forceinline__ void load(fe& r, const int32_t* __restrict__ p,
                                     int64_t W, int64_t lane) {
#pragma unroll
  for (int i = 0; i < kN; ++i) r.v[i] = static_cast<uint32_t>(p[i * W + lane]);
}

__device__ __forceinline__ void store(int32_t* __restrict__ p, const fe& a,
                                      int64_t W, int64_t lane) {
#pragma unroll
  for (int i = 0; i < kN; ++i) p[i * W + lane] = static_cast<int32_t>(a.v[i]);
}

__device__ __forceinline__ void set_one(fe& r) {
  r.v[0] = 1;
#pragma unroll
  for (int i = 1; i < kN; ++i) r.v[i] = 0;
}

// The carry of field448.py ``_carry`` on the 16 folded columns: two
// parallel rounds, each limb keeping its low 28 bits and taking the bits
// above them from the limb below (limbs 0 and 8 both take limb 15's). The
// first round runs on 64-bit columns; its results are below 2^35
// (field448.py asserts it), so the second round's shifts, masks and adds
// are 32-bit.
__device__ __forceinline__ void carry(fe& r, const uint64_t h[kN]) {
  uint64_t g[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) g[i] = (h[i] & kMask) + (h[(i + kN - 1) % kN] >> kBits);
  g[kHalf] += h[kN - 1] >> kBits;
  uint32_t c[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) c[i] = static_cast<uint32_t>(g[i] >> kBits);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    r.v[i] = (static_cast<uint32_t>(g[i]) & static_cast<uint32_t>(kMask)) + c[(i + kN - 1) % kN];
  r.v[kHalf] += c[kN - 1];
}

// acc + column c (0..14) of the 8x8 product of the half-limb vectors x, y.
__device__ __forceinline__ uint64_t col(const uint32_t* x, const uint32_t* y, int c,
                                        uint64_t acc) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
    if (c - i >= 0 && c - i < kHalf) acc = madw(x[i], y[c - i], acc);
  return acc;
}

// acc + column c of the 8x8 square of x, the cross terms taking x2 = 2 x.
__device__ __forceinline__ uint64_t col_sq(const uint32_t* x, const uint32_t* x2, int c,
                                           uint64_t acc) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
    if (i < c - i && c - i < kHalf) acc = madw(x2[i], x[c - i], acc);
  if (c % 2 == 0 && c / 2 < kHalf) acc = madw(x[c / 2], x[c / 2], acc);
  return acc;
}

// The product by halves. With t = 2^224, a = a0 + a1 t, b = b0 + b1 t and
// t^2 = t + 1 mod p, the 16 folded columns of the schoolbook product (the
// columns of field448.py mul_col_bounds, _fold's order) are, for k = 0..7,
// with A = a0 b0, X = a0 b1 + a1 b0, M = a1 b1 as 8x8 column products
// (columns above 14 empty):
//   h_k     = A_k     + s,            s = M_k + X_{8+k} + M_{8+k}
//   h_{8+k} = A_{8+k} + X_k + s + M_{8+k}
// the same sums of the same 256 partial products, so the same columns and
// the same limbs; the fold is no pass of its own, and s is shared by both
// columns (field448.py mul_cols_by_halves asserts this schedule against
// the fold's).
__device__ __forceinline__ void mul(fe& r, const fe& a, const fe& b) {
  const uint32_t *a0 = a.v, *a1 = a.v + kHalf, *b0 = b.v, *b1 = b.v + kHalf;
  uint64_t h[kN];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const uint64_t m2 = col(a1, b1, kHalf + k, 0);
    const uint64_t s = col(a1, b1, k, col(a1, b0, kHalf + k, col(a0, b1, kHalf + k, m2)));
    h[k] = col(a0, b0, k, s);
    h[kHalf + k] = col(a1, b0, k, col(a0, b1, k, col(a0, b0, kHalf + k, s + m2)));
  }
  carry(r, h);
}

// The square by halves: A = a0^2, X = 2 a0 a1, M = a1^2, 136 partial
// products, the cross terms taking 2 a_i (below 2^32, field448.py asserts
// it): the columns of mul(r, a, a).
__device__ __forceinline__ void sq(fe& r, const fe& a) {
  uint32_t a2[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) a2[i] = 2 * a.v[i];
  const uint32_t *a0 = a.v, *a1 = a.v + kHalf, *d0 = a2, *d1 = a2 + kHalf;
  uint64_t h[kN];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const uint64_t m2 = col_sq(a1, d1, kHalf + k, 0);
    const uint64_t s = col_sq(a1, d1, k, col(d0, a1, kHalf + k, m2));
    h[k] = col_sq(a0, d0, k, s);
    h[kHalf + k] = col(d0, a1, k, col_sq(a0, d0, kHalf + k, s + m2));
  }
  carry(r, h);
}

}  // namespace fe448
