// A probe of the rate of the pow kernels' product instruction on this card:
// IMAD.WIDE.U32 with a 64-bit addend (madw.cuh), one per partial product.
// CUDA C++ for sm_90a with a plain C interface (loaded with ctypes by
// eccoxide_tpu_torch/ops/build.py; wrapper and plain version in
// eccoxide_tpu_torch/ops/probe.py). chip_smoke.py times it and prices the
// operation bounds of the kernels at the lower of this rate and the
// 32-bit IMAD rate of the data sheet.
//
// Each thread runs kChains independent chains acc_k += x_k z_u over kUnroll
// multipliers z_u = y + 2u per trip, then moves each x_k on by the low word
// of the next chain's accumulator: every step is one multiply-add whose
// operands do not wait on its chain, as in a field product's column, and
// ptxas compiles the steps as it compiles the kernels' products (an
// IMAD.WIDE.U32 each, their sums two at a time by IADD3 and IADD3.X).
// No step has a closed form the compiler could fold, and every accumulator
// is stored at the end, so none is dropped. Launched with enough blocks to
// fill every SM.

#include <cstdint>

#include <cuda_runtime.h>

#include "madw.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
    imad_probe_kernel(uint64_t* __restrict__ out, uint32_t y, int trips) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint64_t acc[kChains];
  uint32_t x[kChains], z[kUnroll];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    acc[k] = static_cast<uint64_t>(t) * kChains + k + 1;
    x[k] = static_cast<uint32_t>(t) * 7 + k;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) z[u] = y + 2 * u;
  for (int i = 0; i < trips; ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kChains; ++k) acc[k] = madw(x[k], z[u], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kChains; ++k) x[k] += static_cast<uint32_t>(acc[(k + 1) % kChains]);
  }
#pragma unroll
  for (int k = 0; k < kChains; ++k) out[t * kChains + k] = acc[k];
}

}  // namespace

extern "C" {

// out: blocks * 256 * 8 uint64; the kernel runs blocks * 256 * 8 * 16 * trips
// multiply-adds.
int imad_probe_launch(uint64_t* out, uint32_t y, int trips, int blocks, void* stream) {
  imad_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(out, y, trips);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
