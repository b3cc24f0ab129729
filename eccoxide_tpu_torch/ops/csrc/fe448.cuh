// Device arithmetic for FQ448 = 2^448 - 2^224 - 1 in the port's limb format.
//
// Same format, fold and carry as eccoxide_tpu_torch/field448.py: 16
// non-negative limbs of 28 bits, one value per thread, products
// accumulated in 64-bit unsigned registers. mul and sq return TIGHT limbs
// (field448.py TIGHT) from TIGHT inputs; field448.py asserts the bounds
// that make the 64-bit columns exact.
#pragma once

#include <cstdint>

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

// field448.py _fold then _carry: column c >= 16 (2^448 = 2^224 + 1) is
// added into c - 16 and c - 8, from the top down, so the columns that land
// at 16..22 fold again; then two parallel carry rounds, each limb keeping
// its low 28 bits and taking the bits above them from the limb below
// (limbs 0 and 8 both take limb 15's).
__device__ __forceinline__ void fold_carry(fe& r, uint64_t h[2 * kN - 1]) {
#pragma unroll
  for (int c = 2 * kN - 2; c >= kN; --c) {
    h[c - kN] += h[c];
    h[c - kHalf] += h[c];
  }
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    uint64_t c[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      c[i] = h[i] >> kBits;
      h[i] &= kMask;
    }
#pragma unroll
    for (int i = 1; i < kN; ++i) h[i] += c[i - 1];
    h[0] += c[kN - 1];
    h[kHalf] += c[kN - 1];
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) r.v[i] = static_cast<uint32_t>(h[i]);
}

// Schoolbook product: 256 partial products, each one 32x32->64
// multiply-add into its column (IMAD.WIDE.U32 with a 64-bit addend).
__device__ __forceinline__ void mul(fe& r, const fe& a, const fe& b) {
  uint64_t h[2 * kN - 1];
#pragma unroll
  for (int k = 0; k < 2 * kN - 1; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = 0; j < kN; ++j) h[i + j] += static_cast<uint64_t>(a.v[i]) * b.v[j];
  }
  fold_carry(r, h);
}

// Square with the 136 products a_i a_j, i <= j, the cross terms taking
// 2 a_i (below 2^32, field448.py asserts it): the columns of mul(r, a, a).
__device__ __forceinline__ void sq(fe& r, const fe& a) {
  uint64_t h[2 * kN - 1];
#pragma unroll
  for (int k = 0; k < 2 * kN - 1; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const uint32_t a2 = 2 * a.v[i];
    h[2 * i] += static_cast<uint64_t>(a.v[i]) * a.v[i];
#pragma unroll
    for (int j = i + 1; j < kN; ++j) h[i + j] += static_cast<uint64_t>(a2) * a.v[j];
  }
  fold_carry(r, h);
}

}  // namespace fe448
