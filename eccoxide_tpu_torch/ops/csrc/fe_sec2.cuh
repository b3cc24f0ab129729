// Device arithmetic over the SEC2 coordinate primes in the port's limb
// format, a template on the limb count N.
//
// Same format, carry and fold as eccoxide_tpu_torch/field_sec2.py: N
// non-negative limbs of 28 bits (the top limb may hold more), one value per
// thread, products accumulated in 64-bit unsigned registers. A product's 2N
// columns run two parallel carry rounds (the top column keeps everything),
// then limb N + j is added times row j of the fold matrix (the limbs of
// 2^(28 (N + j)) mod p, int32 (N, N) in device memory, read by every thread
// at the same address), then two carry rounds over the N columns give TIGHT
// limbs. field_sec2.py asserts, per prime, that the columns stay below
// 2^63, that the limbs folded are below 2^32 and that 2 a_i (the square's
// cross terms) is below 2^32.
#pragma once

#include <cstdint>

namespace fe_sec2 {

constexpr int kBits = 28;
constexpr uint64_t kMask = (1ull << kBits) - 1;

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

// field_sec2.py _carry_rounds: two parallel rounds; every column but the top
// keeps its low 28 bits and passes the rest to the column above.
template <int K>
__device__ __forceinline__ void carry(uint64_t h[K]) {
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    uint64_t c[K - 1];
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      c[i] = h[i] >> kBits;
      h[i] &= kMask;
    }
#pragma unroll
    for (int i = 0; i < K - 1; ++i) h[i + 1] += c[i];
  }
}

// field_sec2.py Field.mul after the schoolbook: carry the 2N columns, fold
// limbs N.. by the matrix, carry the N columns.
template <int N>
__device__ __forceinline__ void reduce(fe<N>& r, uint64_t h[2 * N],
                                       const int32_t* __restrict__ fold) {
  carry<2 * N>(h);
  uint64_t lo[N];
#pragma unroll
  for (int i = 0; i < N; ++i) lo[i] = h[i];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t hj = static_cast<uint32_t>(h[N + j]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      lo[i] += static_cast<uint64_t>(hj) * static_cast<uint32_t>(__ldg(fold + j * N + i));
  }
  carry<N>(lo);
#pragma unroll
  for (int i = 0; i < N; ++i) r.v[i] = static_cast<uint32_t>(lo[i]);
}

// Schoolbook product: N^2 partial products, each one 32x32->64 multiply-add
// into its column.
template <int N>
__device__ __forceinline__ void mul(fe<N>& r, const fe<N>& a, const fe<N>& b,
                                    const int32_t* __restrict__ fold) {
  uint64_t h[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) h[i + j] += static_cast<uint64_t>(a.v[i]) * b.v[j];
  }
  reduce<N>(r, h, fold);
}

// Square with the N (N + 1) / 2 products a_i a_j, i <= j, the cross terms
// taking 2 a_i: the columns of mul(r, a, a).
template <int N>
__device__ __forceinline__ void sq(fe<N>& r, const fe<N>& a,
                                   const int32_t* __restrict__ fold) {
  uint64_t h[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t a2 = 2 * a.v[i];
    h[2 * i] += static_cast<uint64_t>(a.v[i]) * a.v[i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) h[i + j] += static_cast<uint64_t>(a2) * a.v[j];
  }
  reduce<N>(r, h, fold);
}

}  // namespace fe_sec2
