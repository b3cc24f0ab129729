// Device arithmetic for FQ = 2^255 - 19 in the port's limb format.
//
// Same format and same carry schedule as eccoxide_tpu_torch/field.py: 10
// non-negative limbs of alternating 26 and 25 bits (radix 2^25.5), one
// value per thread, products accumulated in 64-bit unsigned registers.
// Every function returns TIGHT limbs (field.py TIGHT) from TIGHT inputs;
// field.py asserts the bounds that make the 64-bit columns and the 32-bit
// sums exact.
#pragma once

#include <cstdint>

namespace fe25519 {

struct fe {
  uint32_t v[10];
};

// 2p limb-wise: dominates every TIGHT limb, so x + PAD - y stays >= 0.
__device__ __constant__ uint32_t kPad[10] = {
    0x7ffffda, 0x3fffffe, 0x7fffffe, 0x3fffffe, 0x7fffffe,
    0x3fffffe, 0x7fffffe, 0x3fffffe, 0x7fffffe, 0x3fffffe};

__device__ __forceinline__ void load(fe& r, const int32_t* __restrict__ p,
                                     int64_t W, int64_t lane) {
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = static_cast<uint32_t>(p[i * W + lane]);
}

__device__ __forceinline__ void store(int32_t* __restrict__ p, const fe& a,
                                      int64_t W, int64_t lane) {
#pragma unroll
  for (int i = 0; i < 10; ++i) p[i * W + lane] = static_cast<int32_t>(a.v[i]);
}

__device__ __forceinline__ void set_one(fe& r) {
  r.v[0] = 1;
#pragma unroll
  for (int i = 1; i < 10; ++i) r.v[i] = 0;
}

// The ripple of field.py _carry: limbs 0..9 in order, the carry out of
// limb 9 folded back times 19 (2^255 = 19 mod p), then one step 0 -> 1.
__device__ __forceinline__ void carry(fe& r, uint64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = (i & 1) ? 25 : 26;
    const uint64_t c = h[i] >> w;
    h[i] &= (1ull << w) - 1;
    h[i + 1] += c;
  }
  uint64_t c = h[9] >> 25;
  h[9] &= (1ull << 25) - 1;
  h[0] += 19 * c;
  c = h[0] >> 26;
  h[0] &= (1ull << 26) - 1;
  h[1] += c;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = static_cast<uint32_t>(h[i]);
}

// Schoolbook product: a_i b_j lands in column (i+j) mod 10, times 2 when
// both limbs are 25-bit and times 19 on the wrap past 2^255. All indices
// and factors are compile-time constants once the loops unroll.
__device__ __forceinline__ void mul(fe& r, const fe& a, const fe& b) {
  uint64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const uint64_t f = (((i & 1) && (j & 1)) ? 2u : 1u) * ((i + j >= 10) ? 19u : 1u);
      h[(i + j) % 10] += f * (static_cast<uint64_t>(a.v[i]) * b.v[j]);
    }
  }
  carry(r, h);
}

__device__ __forceinline__ void sq(fe& r, const fe& a) { mul(r, a, a); }

__device__ __forceinline__ void add(fe& r, const fe& a, const fe& b) {
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = static_cast<uint64_t>(a.v[i]) + b.v[i];
  carry(r, h);
}

__device__ __forceinline__ void sub(fe& r, const fe& a, const fe& b) {
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i)
    h[i] = static_cast<uint64_t>(a.v[i]) + kPad[i] - b.v[i];
  carry(r, h);
}

__device__ __forceinline__ void neg(fe& r, const fe& b) {
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = static_cast<uint64_t>(kPad[i]) - b.v[i];
  carry(r, h);
}

}  // namespace fe25519
