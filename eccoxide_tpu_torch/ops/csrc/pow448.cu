// The constant-exponent pow chain over FQ448 = 2^448 - 2^224 - 1 as a CUDA
// kernel for sm_90a, with a plain C interface (loaded with ctypes by
// eccoxide_tpu_torch/ops/build.py; wrapper and plain PyTorch version in
// eccoxide_tpu_torch/ops/group.py, pow448_kernel and pow448_plain).
//
// Layout: a field batch is int32 (16, W) with W contiguous; limb i of lane
// `lane` is at i * W + lane, so 32 neighbouring lanes read 32 neighbouring
// words per limb. One thread per lane, ceil(W / 128) blocks of 128 threads,
// `if (lane < W)` guard, 64-bit offsets; the wrapper never launches for
// W == 0.
//
// Returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "fe448.cuh"

namespace {

constexpr int kThreads = 128;

// Replaces ops/pallas_group.py _pow_call (pallas_pow) instantiated for the
// field of curve448 (curves/curve448.py FQ): x^e for a public exponent
// given as 4-bit digits, most significant first, the chain of
// group.cu pow_kernel. Per digit: four squarings and, unless the digit is
// 0, one multiply by table[digit]; the first digit loads the table entry.
// Bound on the H100: operations (for e = p - 2: 14 products of 256
// multiply-adds for the table, then 111 digits of 4 squarings of 136 and
// one product of 256, 92,384 multiply-adds per lane against 128 bytes).
// The products and squarings run by halves with the fold merged into the
// columns (fe448.cuh).
//
// The table x^0..x^15 (1 KB per thread) sits in local memory: its index
// changes at run time, so it cannot be registers. Its index is a digit of
// the public exponent, the same for every thread, so the per-thread
// slices are read coalesced; the branch on a zero digit is on the
// exponent too. The kernel takes no branch and no address from the base
// x: it is constant-time in x.
__global__ void __launch_bounds__(kThreads)
    pow448_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                  const int32_t* __restrict__ digits, int ndig, int64_t W) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  fe448::fe tab[16];
  fe448::set_one(tab[0]);
  fe448::load(tab[1], x, W, lane);
  for (int j = 2; j < 16; ++j) fe448::mul(tab[j], tab[j - 1], tab[1]);
  fe448::fe acc = tab[__ldg(digits)];
  for (int i = 1; i < ndig; ++i) {
    fe448::sq(acc, acc);
    fe448::sq(acc, acc);
    fe448::sq(acc, acc);
    fe448::sq(acc, acc);
    const int d = __ldg(digits + i);
    if (d != 0) fe448::mul(acc, acc, tab[d]);
  }
  fe448::store(o, acc, W, lane);
}

}  // namespace

extern "C" {

int pow448_launch(const int32_t* x, int32_t* o, const int32_t* digits, int ndig,
                  int64_t W, void* stream) {
  const auto blocks = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  pow448_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, digits, ndig, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
