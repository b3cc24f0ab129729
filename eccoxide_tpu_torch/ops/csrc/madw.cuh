// One 32x32->64 multiply-add, c + a b: PTX mad.wide.u32, which ptxas
// compiles to IMAD.WIDE.U32 for the product and sums the products two at a
// time into the 64-bit accumulator (three-input IADD3, IADD3.X). The field
// products of the pow kernels over 28-bit limbs (fe448.cuh, fe_sec2.cuh)
// and the rate probe (imad_probe.cu) use it. The C++ form,
// `c += uint64_t(a) * b`, compiled in those kernels to an extra 32-bit
// IMAD beside most products (a product of a high word the compiler did
// not prove zero); the asm states the operation as the 32x32->64 one.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint64_t madw(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}
