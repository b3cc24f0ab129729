// Device arithmetic for FQ = 2^255 - 19 in the port's limb format.
//
// Same format and same carry schedule as eccoxide_tpu_torch/field.py: 10
// non-negative limbs of alternating 26 and 25 bits (radix 2^25.5), one
// value per thread, products accumulated in 64-bit unsigned registers.
// Every function returns TIGHT limbs (field.py TIGHT) from TIGHT inputs,
// mul also from LAZY ones (add_or_sub_lazy); field.py asserts the bounds
// that make the 64-bit columns and the 32-bit sums exact.
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

// One carry step: the bits of limb i above its width move into limb i + 1,
// into limb 0 times 19 for i = 9 (2^255 = 19 mod p).
template <int i>
__device__ __forceinline__ void carry_step(uint64_t h[10]) {
  constexpr int w = (i & 1) ? 25 : 26;
  const uint64_t c = h[i] >> w;
  h[i] &= (1ull << w) - 1;
  h[(i + 1) % 10] += (i == 9 ? 19u : 1u) * c;
}

// field.py _carry, step for step (CARRY_STEPS): one ripple 0->1 .. 9->0,
// then 0->1 again. ref10's interleaved chains run one step more and
// measured slower in every kernel (PERF.md).
__device__ __forceinline__ void carry(fe& r, uint64_t h[10]) {
  carry_step<0>(h);
  carry_step<1>(h);
  carry_step<2>(h);
  carry_step<3>(h);
  carry_step<4>(h);
  carry_step<5>(h);
  carry_step<6>(h);
  carry_step<7>(h);
  carry_step<8>(h);
  carry_step<9>(h);
  carry_step<0>(h);
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = static_cast<uint32_t>(h[i]);
}

// Schoolbook product in ref10's form: a_i b_j lands in column (i+j) mod 10,
// times 2 when both limbs are 25-bit and times 19 on the wrap past 2^255.
// The factors are folded into 32-bit operands computed once per call
// (2 a_i for odd i, 19 b_j), so every partial product is one 32x32->64
// multiply-add into its column (IMAD.WIDE.U32 with a 64-bit addend).
// field.py mul_terms is this list of products; it asserts at import that
// every operand of LAZY input (TIGHT included) is below 2^32 and that the
// columns equal the plain version's.
__device__ __forceinline__ void mul(fe& r, const fe& a, const fe& b) {
  uint32_t a2[10], b19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    a2[i] = 2 * a.v[i];
    b19[i] = 19 * b.v[i];
  }
  uint64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const uint32_t x = ((i & 1) && (j & 1)) ? a2[i] : a.v[i];
      const uint32_t y = (i + j >= 10) ? b19[j] : b.v[j];
      h[(i + j) % 10] += static_cast<uint64_t>(x) * y;
    }
  }
  carry(r, h);
}

// Square with the 55 products a_i a_j, i <= j: the cross terms doubled on
// the a_i side, the odd-odd 2 and the wrap's 19 on the a_j side (operands
// a, 2a, 19a, 38a). Same columns as mul(r, a, a) (field.py sq_terms).
__device__ __forceinline__ void sq(fe& r, const fe& a) {
  uint32_t a2[10], a19[10], a38[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    a2[i] = 2 * a.v[i];
    a19[i] = 19 * a.v[i];
    a38[i] = 38 * a.v[i];
  }
  uint64_t h[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const bool odd = (i & 1) && (j & 1);
      const uint32_t x = (i != j) ? a2[i] : a.v[i];
      const uint32_t y = (i + j >= 10) ? (odd ? a38[j] : a19[j]) : (odd ? a2[j] : a.v[j]);
      h[(i + j) % 10] += static_cast<uint64_t>(x) * y;
    }
  }
  carry(r, h);
}

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

// a + 2p - b when minus, else a + b, with no carry: field.py add_lazy and
// sub_lazy. Limbs below 2^28 (field.py LAZY), so valid only as an operand
// of mul, whose columns and premultiplied operands field.py bounds for
// LAZY input. One code path for a sign that varies by warp.
__device__ __forceinline__ void add_or_sub_lazy(fe& r, const fe& a, const fe& b,
                                                bool minus) {
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = a.v[i] + (minus ? kPad[i] - b.v[i] : b.v[i]);
}

__device__ __forceinline__ void neg(fe& r, const fe& b) {
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = static_cast<uint64_t>(kPad[i]) - b.v[i];
  carry(r, h);
}

}  // namespace fe25519
