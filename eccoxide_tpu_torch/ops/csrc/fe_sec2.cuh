// Device arithmetic over one SEC2 coordinate prime in the port's limb
// format, a template on the prime: a struct Pr with the limb count Pr::N
// and the fold matrix Pr::kFold[j][i], the limbs of 2^(28 (N + j)) mod p,
// as compile-time constants (generated by ops/build.py from
// field_sec2._Format.FOLD).
//
// Same format, carry and fold as eccoxide_tpu_torch/field_sec2.py Field.mul,
// so the limbs are the same: N non-negative limbs of 28 bits (the top limb
// may hold more), one value per thread. A product's 2N columns run two
// parallel carry rounds (the top column keeps everything), then limb N + j
// is added times row j of the fold matrix, then two carry rounds over the N
// columns give TIGHT limbs. field_sec2.py asserts, per prime, that the
// columns stay below 2^63, that the carried columns (the limbs folded) are
// below 2^32 and that 2 a_i (the square's cross terms) is below 2^32.
//
// The schedule, for registers: after two parallel rounds, column k depends
// only on raw columns k, k - 1 and k - 2 (Carry2), so the columns are
// computed one at a time in product-scanning order (each a chain of
// multiply-adds into one 64-bit accumulator) and carried as they come;
// the 2N carried columns are kept as 32-bit values, and the fold and its
// carry run the same way over the N output limbs. At N = 20 a product
// holds its two operands and 40 32-bit columns, not 40 64-bit ones.
// The fold's constants are template arguments: a zero entry emits nothing,
// a product by a power of two is a shift.
#pragma once

#include <cstdint>
#include <utility>

#include "madw.cuh"

namespace fe_sec2 {

constexpr int kBits = 28;
constexpr uint32_t kMask = (1u << kBits) - 1;

template <int N>
struct fe {
  uint32_t v[N];
};

template <int N>
__device__ __forceinline__ void load(fe<N>& r, const int32_t* __restrict__ p,
                                     int64_t W, int64_t lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = static_cast<uint32_t>(p[i * W + lane]);
}

template <int N>
__device__ __forceinline__ void store(int32_t* __restrict__ p, const fe<N>& a,
                                      int64_t W, int64_t lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i * W + lane] = static_cast<int32_t>(a.v[i]);
}

template <int N>
__device__ __forceinline__ void set_one(fe<N>& r) {
  r.v[0] = 1;
#pragma unroll
  for (int i = 1; i < N; ++i) r.v[i] = 0;
}

// field_sec2.py _carry_rounds (two rounds) over columns fed low to high:
// round 1 gives h1_k = (raw_k & M) + (raw_{k-1} >> 28), round 2 gives
// (h1_k & M) + (h1_{k-1} >> 28); the top column is not masked.
struct Carry2 {
  uint64_t c1 = 0;  // raw_{k-1} >> 28 (below 2^35)
  uint32_t c2 = 0;  // h1_{k-1} >> 28 (below 2^8)

  __device__ __forceinline__ uint32_t push(uint64_t raw) {
    const uint64_t h1 = (raw & kMask) + c1;
    c1 = raw >> kBits;
    const uint32_t out = (static_cast<uint32_t>(h1) & kMask) + c2;
    c2 = static_cast<uint32_t>(h1 >> kBits);
    return out;
  }

  __device__ __forceinline__ uint32_t top(uint64_t raw) const {
    return static_cast<uint32_t>(raw + c1 + c2);
  }
};

// The 2N carried columns of a b: N^2 multiply-adds.
template <int N>
__device__ __forceinline__ void mul_columns(uint32_t (&h)[2 * N], const fe<N>& a,
                                            const fe<N>& b) {
  Carry2 c;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) {
    uint64_t col = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (k - i >= 0 && k - i < N) col = madw(a.v[i], b.v[k - i], col);
    h[k] = c.push(col);
  }
  h[2 * N - 1] = c.top(0);
}

// The same columns for a a: the N (N + 1) / 2 products a_i a_j, i <= j,
// the cross terms taking 2 a_i.
template <int N>
__device__ __forceinline__ void sq_columns(uint32_t (&h)[2 * N], const fe<N>& a) {
  uint32_t a2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a2[i] = 2 * a.v[i];
  Carry2 c;
#pragma unroll
  for (int k = 0; k < 2 * N - 1; ++k) {
    uint64_t col = 0;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < k - i && k - i < N) col = madw(a2[i], a.v[k - i], col);
    if (k % 2 == 0) col = madw(a.v[k / 2], a.v[k / 2], col);
    h[k] = c.push(col);
  }
  h[2 * N - 1] = c.top(0);
}

__host__ __device__ constexpr int log2_exact(uint32_t f) {
  int s = 0;
  while (f > 1) {
    f >>= 1;
    ++s;
  }
  return s;
}

// acc + x F for a fold entry F: nothing for 0, a shift for a power of two
// (P-521's every entry, 2^11), else one multiply-add.
template <uint32_t F>
__device__ __forceinline__ uint64_t fold_term(uint64_t acc, uint32_t x) {
  if constexpr (F == 0) {
    return acc;
  } else if constexpr ((F & (F - 1)) == 0) {
    return acc + (static_cast<uint64_t>(x) << log2_exact(F));
  } else {
    return madw(x, F, acc);
  }
}

// Output column I before its carry: h_I plus h_{N+j} times fold row j.
template <class Pr, int I, int... J>
__device__ __forceinline__ uint64_t fold_column(const uint32_t (&h)[2 * Pr::N],
                                                std::integer_sequence<int, J...>) {
  uint64_t acc = h[I];
  ((acc = fold_term<Pr::kFold[J][I]>(acc, h[Pr::N + J])), ...);
  return acc;
}

template <class Pr, int I>
__device__ __forceinline__ void out_limb(fe<Pr::N>& r, Carry2& c,
                                         const uint32_t (&h)[2 * Pr::N]) {
  const uint64_t col = fold_column<Pr, I>(h, std::make_integer_sequence<int, Pr::N>{});
  if constexpr (I + 1 < Pr::N) {
    r.v[I] = c.push(col);
  } else {
    r.v[I] = c.top(col);
  }
}

template <class Pr, int... I>
__device__ __forceinline__ void reduce(fe<Pr::N>& r, const uint32_t (&h)[2 * Pr::N],
                                       std::integer_sequence<int, I...>) {
  Carry2 c;
  (out_limb<Pr, I>(r, c, h), ...);
}

// r = a b (r may be a or b).
template <class Pr>
__device__ __forceinline__ void mul(fe<Pr::N>& r, const fe<Pr::N>& a, const fe<Pr::N>& b) {
  uint32_t h[2 * Pr::N];
  mul_columns<Pr::N>(h, a, b);
  reduce<Pr>(r, h, std::make_integer_sequence<int, Pr::N>{});
}

// r = a^2 (r may be a).
template <class Pr>
__device__ __forceinline__ void sq(fe<Pr::N>& r, const fe<Pr::N>& a) {
  uint32_t h[2 * Pr::N];
  sq_columns<Pr::N>(h, a);
  reduce<Pr>(r, h, std::make_integer_sequence<int, Pr::N>{});
}

}  // namespace fe_sec2
