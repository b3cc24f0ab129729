// The constant-exponent pow chain over one SEC2 coordinate prime as a CUDA
// kernel for sm_90a, with a plain C interface (loaded with ctypes by
// eccoxide_tpu_torch/ops/build.py; wrapper and plain PyTorch version in
// eccoxide_tpu_torch/ops/group.py, pow_sec2_kernel and pow_sec2_plain).
//
// One instance per prime: ops/build.py generates, for each limb count of
// the 15 SEC2 primes, a translation unit that includes this file, defines
// a struct per prime of that count (its limb count and fold matrix as
// constants, fe_sec2.cuh) and expands POW_SEC2_ENTRY(prime) into the entry
// point pow_sec2_launch_<prime>; the units build at once.
//
// Layout: a field batch is int32 (N, W) with W contiguous; limb i of lane
// `lane` is at i * W + lane. One thread per lane, ceil(W / 128) blocks of
// 128 threads, `if (lane < W)` guard, 64-bit offsets; the wrapper never
// launches for W == 0.
//
// Returns cudaGetLastError() after its launch.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fe_sec2.cuh"

namespace pow_sec2 {

constexpr int kThreads = 128;

// Replaces ops/pallas_group.py _pow_call (pallas_pow) instantiated for the
// SEC2 coordinate fields (curves/sec2.py): x^e for a public exponent given
// as 4-bit digits, most significant first, the chain of group.cu
// pow_kernel. Per digit: four squarings and, unless the digit is 0, one
// multiply by table[digit]; the first digit loads the table entry. Bound on
// the H100: operations (for p256r1, N = 11 and e = p - 2: a product needs
// 121 schoolbook and 87 fold multiply-adds (the nonzero entries of its fold
// matrix), a squaring 66 and 87; 14 products for the table, then 63 digits
// of 4 squarings and 32 products (31 digits are 0): 48,124 multiply-adds
// per lane against 88 bytes).
//
// The table x^0..x^15 (64 N bytes per thread) sits in local memory: its
// index is a digit of the public exponent, the same for every thread, so
// the per-thread slices are read coalesced. The branch on a zero digit is
// on the exponent too, taken the same way by every thread: the kernel
// takes no branch and no address from the base x, so it is constant-time
// in x.
template <class Pr>
__global__ void __launch_bounds__(kThreads)
    pow_sec2_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                    const int32_t* __restrict__ digits, int ndig, int64_t W) {
  constexpr int N = Pr::N;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  fe_sec2::fe<N> tab[16];
  fe_sec2::set_one<N>(tab[0]);
  fe_sec2::load<N>(tab[1], x, W, lane);
  for (int j = 2; j < 16; ++j) fe_sec2::mul<Pr>(tab[j], tab[j - 1], tab[1]);
  fe_sec2::fe<N> acc = tab[__ldg(digits)];
  for (int i = 1; i < ndig; ++i) {
    fe_sec2::sq<Pr>(acc, acc);
    fe_sec2::sq<Pr>(acc, acc);
    fe_sec2::sq<Pr>(acc, acc);
    fe_sec2::sq<Pr>(acc, acc);
    const int d = __ldg(digits + i);
    if (d != 0) fe_sec2::mul<Pr>(acc, acc, tab[d]);
  }
  fe_sec2::store<N>(o, acc, W, lane);
}

template <class Pr>
int launch(const int32_t* x, int32_t* o, const int32_t* digits, int ndig, int64_t W,
           void* stream) {
  const auto blocks = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  pow_sec2_kernel<Pr><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, digits, ndig, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pow_sec2

#define POW_SEC2_ENTRY(PRIME)                                                  \
  extern "C" int pow_sec2_launch_##PRIME(const int32_t* x, int32_t* o,         \
                                         const int32_t* digits, int ndig,      \
                                         int64_t W, void* stream) {            \
    return pow_sec2::launch<PRIME>(x, o, digits, ndig, W, stream);             \
  }
