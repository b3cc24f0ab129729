// The Edwards group law and the constant-exponent pow chain for
// edwards25519 as CUDA kernels for sm_90a, with a plain C interface (loaded
// with ctypes by eccoxide_tpu_torch/ops/build.py; wrappers and their plain
// PyTorch versions in eccoxide_tpu_torch/ops/group.py).
//
// Layout: a field batch is int32 (10, W) with W contiguous; a point is
// (4, 10, W) = X|Y|Z|T, the affine operand of a mixed addition (3, 10, W) =
// x|y|t. Limb i of row c of lane `lane` is at (c * 10 + i) * W + lane, so
// 32 neighbouring lanes read 32 neighbouring words per limb. Coordinates
// live in registers. The wrapper never launches for W == 0, and no width
// needs padding:
// - ed_double and pow: one thread per lane, ceil(W / 128) blocks of 128
//   threads, `if (lane < W)` guard. At W = 32768 the busiest SM holds 256
//   threads, the least any block size gives (249 lanes per SM, in warps).
// - ed_add: one lane on four threads, one in each warp of a 128-thread
//   block, so a block serves 32 lanes and there are ceil(W / 32) blocks:
//   four times the warps for the same width. Tail lanes load lane W - 1,
//   reach the block's barrier and store nothing.
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

constexpr int kAddLanes = 32;                // lanes per ed_add block
constexpr int kAddBlocksPerSM = 8;           // 1024 blocks at W = 32768 fill 132 SMs once

// Replaces ops/pallas_group.py _add_call (pallas_add): complete a=-1
// addition add-2008-hwcd-3 in extended coordinates. Two modes beside the
// full one: need_t == 0 writes zeros for T instead of computing E*H, and
// mixed != 0 takes an affine q = x|y|t (Z2 = 1, so D = 2 Z1 needs no
// product), as the reference's add_b and add_mixed_b.
//
// Bound on the H100: bytes, by the roofline count (9 products, 900 limb
// multiply-adds, against 480 bytes per lane in the full mode). One thread
// per lane ran the 9 products in series: at W = 32768 that left 8 warps
// per SM to hide one lane's dependent multiply-add chains, and at large W
// 140 registers left few warps to keep loads in flight. Here warp r of a
// block takes role r for the block's 32 lanes, so every branch on the role
// is uniform within a warp:
// - stage 1, one product each: A = (Y1-X1)(Y2-X2), B = (Y1+X1)(Y2+X2),
//   C = T1 T2 2d (two products, the stage's longest), D = 2 Z1 Z2; each
//   warp loads only the rows it needs, first thing;
// - exchange: A, B, C, D through 5 KB of shared memory, one barrier;
// - stage 2, one output row each: X3 = E F, Y3 = G H, Z3 = F G, T3 = E H,
//   with E = B-A, F = D-C, G = D+C, H = B+A, each stored coalesced.
// A lane's dependent path is 3 products instead of 9, a thread holds two
// operands and a product instead of eight field elements, and a width
// runs four times the warps. Products are symmetric limb for limb (same
// columns), so every warp runs one shared code path per stage. Past the
// lane's latency the kernel is bound by issued instructions (PERF.md), so
// the 12 sums that feed only a product skip their carry (add_or_sub_lazy):
// a lane runs 10 carries where one thread per lane ran 18.
__global__ void __launch_bounds__(4 * kAddLanes, kAddBlocksPerSM)
    ed_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ o, int mixed, int need_t, int64_t W) {
  __shared__ uint32_t abcd[4][10][kAddLanes];
  const int role = threadIdx.x / kAddLanes;
  const int l = threadIdx.x % kAddLanes;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kAddLanes + l;
  const int64_t at = lane < W ? lane : W - 1;
  const int64_t s = 10 * W;
  fe u, v, r;
  if (role < 2) {                             // (Y1 -+ X1), (Y2 -+ X2)
    fe x, y;
    fe25519::load(y, p + s, W, at);
    fe25519::load(x, p, W, at);
    fe25519::add_or_sub_lazy(u, y, x, role == 0);
    fe25519::load(y, q + s, W, at);
    fe25519::load(x, q, W, at);
    fe25519::add_or_sub_lazy(v, y, x, role == 0);
  } else if (role == 2) {                     // T1, T2
    fe25519::load(u, p + 3 * s, W, at);
    fe25519::load(v, q + (mixed ? 2 : 3) * s, W, at);
  } else {                                    // Z1, Z2
    fe25519::load(u, p + 2 * s, W, at);
    if (!mixed) fe25519::load(v, q + 2 * s, W, at);
  }
  if (role == 3 && mixed) {
    r = u;
  } else {
    fe25519::mul(r, u, v);
  }
  if (role == 2) {
#pragma unroll
    for (int i = 0; i < 10; ++i) v.v[i] = kD2[i];
    fe25519::mul(r, r, v);                    // C = T1 T2 2d
  } else if (role == 3) {
    fe25519::add(r, r, r);                    // D = 2 Z1 Z2
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) abcd[role][i][l] = r.v[i];
  __syncthreads();
  if (role == 3 && !need_t) {
#pragma unroll
    for (int i = 0; i < 10; ++i) r.v[i] = 0;
  } else {
    // role 0: (B-A)(D-C); 1: (D+C)(B+A); 2: (D-C)(D+C); 3: (B-A)(B+A)
    const int hi_u = (role == 0 || role == 3) ? 1 : 3;
    const int hi_v = (role & 1) ? 1 : 3;
    fe a, b;
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      a.v[i] = abcd[hi_u][i][l];
      b.v[i] = abcd[hi_u - 1][i][l];
    }
    fe25519::add_or_sub_lazy(u, a, b, role != 1);
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      a.v[i] = abcd[hi_v][i][l];
      b.v[i] = abcd[hi_v - 1][i][l];
    }
    fe25519::add_or_sub_lazy(v, a, b, role == 0);
    fe25519::mul(r, u, v);
  }
  if (lane < W) fe25519::store(o + role * s, r, W, lane);
}

// Replaces ops/pallas_group.py _double_call (pallas_double): [2^k]P by k
// steps of dbl-2008-hwcd for a=-1 in one launch (k = 1 is pallas_double).
// X, Y, Z are read once and X3, Y3, Z3 stay in registers between steps;
// T = E*H is computed after the last step only when need_t, else T is
// written as zeros (doubling reads no T, so the steps before the last
// never need it). Bound on the H100: operations, by the roofline count
// (per lane k * (4 squarings of 55 products + 3 products of 100), plus
// 100 for T, against 280 bytes), so a run of doublings costs one round
// trip to device memory and one launch instead of k.
__global__ void __launch_bounds__(kThreads)
    ed_double_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ o,
                     int k, int need_t, int64_t W) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  const int64_t s = 10 * W;
  fe x, y, z, e, h;
  fe25519::load(x, p, W, lane);
  fe25519::load(y, p + s, W, lane);
  fe25519::load(z, p + 2 * s, W, lane);
#pragma unroll 1
  for (int step = 0; step < k; ++step) {
    fe a, b, c, d, f, g;
    fe25519::sq(a, x);                        // A = X^2
    fe25519::sq(b, y);                        // B = Y^2
    fe25519::sq(c, z);
    fe25519::add(c, c, c);                    // C = 2 Z^2
    fe25519::neg(d, a);                       // D = -A
    fe25519::add(e, x, y);
    fe25519::sq(e, e);
    fe25519::sub(e, e, a);
    fe25519::sub(e, e, b);                    // E = (X+Y)^2 - A - B
    fe25519::add(g, d, b);                    // G = D + B
    fe25519::sub(f, g, c);                    // F = G - C
    fe25519::sub(h, d, b);                    // H = D - B
    fe25519::mul(x, e, f);                    // X3 = E F
    fe25519::mul(y, g, h);                    // Y3 = G H
    fe25519::mul(z, f, g);                    // Z3 = F G
  }
  fe25519::store(o, x, W, lane);
  fe25519::store(o + s, y, W, lane);
  fe25519::store(o + 2 * s, z, W, lane);
  if (need_t) {
    fe25519::mul(x, e, h);                    // T3 = E H
  } else {
#pragma unroll
    for (int i = 0; i < 10; ++i) x.v[i] = 0;
  }
  fe25519::store(o + 3 * s, x, W, lane);
}

// Replaces ops/pallas_group.py _pow_call (pallas_pow): x^e for a public
// exponent given as 4-bit digits, most significant first. Per digit: four
// squarings and, unless the digit is 0 (a branch on the public exponent,
// the same for every thread), one multiply by table[digit]; the first
// digit loads the table entry. Bound on the H100: operations (21,240 32x32->64
// multiply-adds per lane for e = (p-5)/8: 248 squarings of 55 products and
// 76 products of 100, against 80 bytes), so nothing but the input and
// output touches device memory in bulk.
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
    const int d = __ldg(digits + i);
    if (d != 0) fe25519::mul(acc, acc, tab[d]);
  }
  fe25519::store(o, acc, W, lane);
}

inline unsigned blocks_for(int64_t W) {
  return static_cast<unsigned>((W + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int ed_add_launch(const int32_t* p, const int32_t* q, int32_t* o, int mixed,
                  int need_t, int64_t W, void* stream) {
  const auto blocks = static_cast<unsigned>((W + kAddLanes - 1) / kAddLanes);
  ed_add_kernel<<<blocks, 4 * kAddLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      p, q, o, mixed, need_t, W);
  return static_cast<int>(cudaGetLastError());
}

int ed_double_launch(const int32_t* p, int32_t* o, int k, int need_t, int64_t W,
                     void* stream) {
  ed_double_kernel<<<blocks_for(W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, o, k, need_t, W);
  return static_cast<int>(cudaGetLastError());
}

int pow_launch(const int32_t* x, int32_t* o, const int32_t* digits, int ndig,
               int64_t W, void* stream) {
  pow_kernel<<<blocks_for(W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, o, digits, ndig, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
