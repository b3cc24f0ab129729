// The constant-exponent pow chain over the SEC2 coordinate primes as a CUDA
// kernel for sm_90a, with a plain C interface (loaded with ctypes by
// eccoxide_tpu_torch/ops/build.py; wrapper and plain PyTorch version in
// eccoxide_tpu_torch/ops/group.py, pow_sec2_kernel and pow_sec2_plain).
//
// One template on the limb count N (fe_sec2.cuh), one entry point
// pow_sec2_launch_<N> per limb count of the 15 primes (build.py
// POW_SEC2_LIMBS). The prime enters only through its fold matrix, an int32
// (N, N) operand in device memory.
//
// Layout: a field batch is int32 (N, W) with W contiguous; limb i of lane
// `lane` is at i * W + lane. One thread per lane, ceil(W / 128) blocks of
// 128 threads, `if (lane < W)` guard, 64-bit offsets; the wrapper never
// launches for W == 0.
//
// Returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "fe_sec2.cuh"

namespace {

constexpr int kThreads = 128;

// Replaces ops/pallas_group.py _pow_call (pallas_pow) instantiated for the
// SEC2 coordinate fields (curves/sec2.py): x^e for a public exponent given
// as 4-bit digits, most significant first, the chain of group.cu
// pow_kernel. Per digit: four squarings and one multiply by table[digit];
// the first digit loads the table entry. Bound on the H100: operations
// (for p256r1, N = 11 and e = p - 2: a product needs 121 schoolbook and 87
// fold multiply-adds (the nonzero entries of the fold matrix), a squaring
// 66 and 87; 14 products for the table, then 63 digits of 4 squarings and
// 32 products (31 digits are 0), 48,124 multiply-adds per lane against 88
// bytes). The kernel runs the dense fold: 121 multiply-adds.
//
// The table x^0..x^15 (64 N bytes per thread) sits in local memory: its
// index is a digit of the public exponent, the same for every thread, so
// the per-thread slices are read coalesced, and the kernel takes no branch
// and no address from the base x: it is constant-time in x.
template <int N>
__global__ void __launch_bounds__(kThreads)
    pow_sec2_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                    const int32_t* __restrict__ digits, int ndig,
                    const int32_t* __restrict__ fold, int64_t W) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  fe_sec2::fe<N> tab[16];
  fe_sec2::set_one<N>(tab[0]);
  fe_sec2::load<N>(tab[1], x, W, lane);
  for (int j = 2; j < 16; ++j) fe_sec2::mul<N>(tab[j], tab[j - 1], tab[1], fold);
  fe_sec2::fe<N> acc = tab[__ldg(digits)];
  for (int i = 1; i < ndig; ++i) {
    fe_sec2::sq<N>(acc, acc, fold);
    fe_sec2::sq<N>(acc, acc, fold);
    fe_sec2::sq<N>(acc, acc, fold);
    fe_sec2::sq<N>(acc, acc, fold);
    fe_sec2::mul<N>(acc, acc, tab[__ldg(digits + i)], fold);
  }
  fe_sec2::store<N>(o, acc, W, lane);
}

template <int N>
int launch(const int32_t* x, int32_t* o, const int32_t* digits, int ndig,
           const int32_t* fold, int64_t W, void* stream) {
  const auto blocks = static_cast<unsigned>((W + kThreads - 1) / kThreads);
  pow_sec2_kernel<N><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, digits, ndig, fold, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define POW_SEC2_ENTRY(N)                                                      \
  extern "C" int pow_sec2_launch_##N(const int32_t* x, int32_t* o,             \
                                     const int32_t* digits, int ndig,          \
                                     const int32_t* fold, int64_t W,           \
                                     void* stream) {                           \
    return launch<N>(x, o, digits, ndig, fold, W, stream);                     \
  }

// the limb counts of build.py POW_SEC2_LIMBS
POW_SEC2_ENTRY(6)
POW_SEC2_ENTRY(7)
POW_SEC2_ENTRY(9)
POW_SEC2_ENTRY(10)
POW_SEC2_ENTRY(11)
POW_SEC2_ENTRY(15)
POW_SEC2_ENTRY(20)
