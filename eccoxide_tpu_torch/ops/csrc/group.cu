// The Edwards group law and the constant-exponent pow chain for
// edwards25519 as CUDA kernels for sm_90a, with a plain C interface (loaded
// with ctypes by eccoxide_tpu_torch/ops/build.py; wrappers and their plain
// PyTorch versions in eccoxide_tpu_torch/ops/group.py).
//
// Layout: a field batch is int32 (10, W) with W contiguous; a point is
// (4, 10, W) = X|Y|Z|T. One thread per batch lane: thread `lane` reads limb
// i of coordinate c at (c * 10 + i) * W + lane, so a warp reads 32
// neighbouring words per limb. Coordinates live in registers. The grid is
// ceil(W / 128) blocks with an `if (lane < W)` guard, so no width needs
// padding; the wrapper never launches for W == 0.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_runtime.h>

#include "fe25519.cuh"

using fe25519::fe;

namespace {

constexpr int kThreads = 128;

// 2d mod p, d = -121665/121666 (edwards25519).
__device__ __constant__ uint32_t kD2[10] = {
    0x2b2f159, 0x1a6e509, 0x22add7a, 0xd4141d, 0x38052,
    0xf3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x901b67};

// Replaces ops/pallas_group.py _add_call (pallas_add): complete a=-1
// addition add-2008-hwcd-3 in extended coordinates, T included.
// Bound on the H100: bytes, by the roofline count. Per lane it does 9 field
// products (900 limb multiply-adds) against 480 bytes moved, below the
// card's ~5 int32 multiply-adds per byte. So the design reads each input
// word once with coalesced loads, keeps every intermediate in registers,
// and writes each output word once; the carries and 64-bit accumulation
// the count leaves out are what the measured time adds to the bound.
__global__ void __launch_bounds__(kThreads)
    ed_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ o, int64_t W) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const int64_t s = 10 * W;
  fe x1, y1, x2, y2, a, b, t0, t1;
  fe25519::load(x1, p, W, lane);
  fe25519::load(y1, p + s, W, lane);
  fe25519::load(x2, q, W, lane);
  fe25519::load(y2, q + s, W, lane);
  fe25519::sub(t0, y1, x1);
  fe25519::sub(t1, y2, x2);
  fe25519::mul(a, t0, t1);                    // A = (Y1-X1)(Y2-X2)
  fe25519::add(t0, y1, x1);
  fe25519::add(t1, y2, x2);
  fe25519::mul(b, t0, t1);                    // B = (Y1+X1)(Y2+X2)
  fe c, d, d2;
  fe25519::load(t0, p + 3 * s, W, lane);
  fe25519::load(t1, q + 3 * s, W, lane);
  fe25519::mul(c, t0, t1);
#pragma unroll
  for (int i = 0; i < 10; ++i) d2.v[i] = kD2[i];
  fe25519::mul(c, c, d2);                     // C = T1 T2 2d
  fe25519::load(t0, p + 2 * s, W, lane);
  fe25519::load(t1, q + 2 * s, W, lane);
  fe25519::mul(d, t0, t1);
  fe25519::add(d, d, d);                      // D = 2 Z1 Z2
  fe e, f, g, h;
  fe25519::sub(e, b, a);
  fe25519::sub(f, d, c);
  fe25519::add(g, d, c);
  fe25519::add(h, b, a);
  fe25519::mul(t0, e, f);
  fe25519::store(o, t0, W, lane);
  fe25519::mul(t0, g, h);
  fe25519::store(o + s, t0, W, lane);
  fe25519::mul(t0, f, g);
  fe25519::store(o + 2 * s, t0, W, lane);
  fe25519::mul(t0, e, h);
  fe25519::store(o + 3 * s, t0, W, lane);
}

// Replaces ops/pallas_group.py _double_call (pallas_double): dbl-2008-hwcd
// for a=-1, T included. Bound on the H100: bytes, by the roofline count
// (4 squarings and 4 products against 320 bytes per lane); same
// register-resident, read-once design as the add.
__global__ void __launch_bounds__(kThreads)
    ed_double_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ o,
                     int64_t W) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const int64_t s = 10 * W;
  fe x, y, a, b, c, t0;
  fe25519::load(x, p, W, lane);
  fe25519::load(y, p + s, W, lane);
  fe25519::sq(a, x);                          // A = X^2
  fe25519::sq(b, y);                          // B = Y^2
  fe25519::load(t0, p + 2 * s, W, lane);
  fe25519::sq(c, t0);
  fe25519::add(c, c, c);                      // C = 2 Z^2
  fe d, e, f, g, h;
  fe25519::neg(d, a);                         // D = -A
  fe25519::add(t0, x, y);
  fe25519::sq(e, t0);
  fe25519::sub(e, e, a);
  fe25519::sub(e, e, b);                      // E = (X+Y)^2 - A - B
  fe25519::add(g, d, b);                      // G = D + B
  fe25519::sub(f, g, c);                      // F = G - C
  fe25519::sub(h, d, b);                      // H = D - B
  fe25519::mul(t0, e, f);
  fe25519::store(o, t0, W, lane);
  fe25519::mul(t0, g, h);
  fe25519::store(o + s, t0, W, lane);
  fe25519::mul(t0, f, g);
  fe25519::store(o + 2 * s, t0, W, lane);
  fe25519::mul(t0, e, h);
  fe25519::store(o + 3 * s, t0, W, lane);
}

// Replaces ops/pallas_group.py _pow_call (pallas_pow): x^e for a public
// exponent given as 4-bit digits, most significant first. Per digit: four
// squarings and one multiply by table[digit]; the first digit loads the
// table entry. Bound on the H100: operations (about 21k 64-bit
// multiply-adds per lane for e = (p-5)/8 against 80 bytes), so nothing but
// the input and output touches device memory in bulk.
//
// The table x^0..x^15 (640 bytes per thread) sits in local memory: its
// index changes at run time, so it cannot be registers, and in shared
// memory 128 threads would need 80 KB per block, cutting occupancy to two
// blocks per SM for no gain, since the index is the same for every thread
// (a digit of the public exponent) and the per-thread slices are coalesced
// and stay in L1. The index comes from the exponent only, so the kernel is
// constant-time in the base x.
__global__ void __launch_bounds__(kThreads)
    pow_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
               const int32_t* __restrict__ digits, int ndig, int64_t W) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  fe tab[16];
  fe25519::set_one(tab[0]);
  fe25519::load(tab[1], x, W, lane);
  for (int j = 2; j < 16; ++j) fe25519::mul(tab[j], tab[j - 1], tab[1]);
  fe acc = tab[__ldg(digits)];
  for (int i = 1; i < ndig; ++i) {
    fe25519::sq(acc, acc);
    fe25519::sq(acc, acc);
    fe25519::sq(acc, acc);
    fe25519::sq(acc, acc);
    fe25519::mul(acc, acc, tab[__ldg(digits + i)]);
  }
  fe25519::store(o, acc, W, lane);
}

inline unsigned blocks_for(int64_t W) {
  return static_cast<unsigned>((W + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int ed_add_launch(const int32_t* p, const int32_t* q, int32_t* o, int64_t W,
                  void* stream) {
  ed_add_kernel<<<blocks_for(W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, q, o, W);
  return static_cast<int>(cudaGetLastError());
}

int ed_double_launch(const int32_t* p, int32_t* o, int64_t W, void* stream) {
  ed_double_kernel<<<blocks_for(W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, o, W);
  return static_cast<int>(cudaGetLastError());
}

int pow_launch(const int32_t* x, int32_t* o, const int32_t* digits, int ndig,
               int64_t W, void* stream) {
  pow_kernel<<<blocks_for(W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, digits, ndig, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
