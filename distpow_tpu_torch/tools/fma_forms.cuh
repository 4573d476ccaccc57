// 64-bit sums and rotates, and a 32-bit rotate, in forms that put some of
// their work on Hopper's FMA pipe, for the probes (pipe_rates.cu) and the
// round variants (round_variants.cuh).  The kernels in csrc/ use none of
// them: each was slower there (PERF.md, section 6).  The factors 1 and 2^k come
// from kPow2 (hash_search.cuh), so ptxas cannot turn a product back into
// an add or a shift.  On the host the same arithmetic is plain C++.
#pragma once

#include <stdint.h>

#include "hash_search.cuh"

namespace distpow {

// 64-bit sums:
//   add64_carry(x, y)  the low limb as IADD3 with its carry, the high limb
//                      as IMAD.X: x_hi * 1 + y_hi + carry
//   add64_wide(x, y)   IMAD.WIDE.U32 x_lo * 1 + y (a 64-bit sum), then IMAD
//                      x_hi * 1 + its high limb
DISTPOW_HD uint64_t add64_carry(uint64_t x, uint64_t y) {
#if defined(__CUDA_ARCH__)
  uint64_t r;
  asm("{\n\t.reg .u32 xl, xh, yl, yh, rl, rh;\n\t"
      "mov.b64 {xl, xh}, %1;\n\tmov.b64 {yl, yh}, %2;\n\t"
      "add.cc.u32 rl, xl, yl;\n\tmadc.lo.u32 rh, xh, %3, yh;\n\t"
      "mov.b64 %0, {rl, rh};\n\t}"
      : "=l"(r) : "l"(x), "l"(y), "r"(kPow2[0]));
  return r;
#else
  const uint32_t lo = (uint32_t)x + (uint32_t)y;
  const uint32_t hi = (uint32_t)(x >> 32) + (uint32_t)(y >> 32) + (lo < (uint32_t)x);
  return (uint64_t)hi << 32 | lo;
#endif
}

DISTPOW_HD uint64_t add64_wide(uint64_t x, uint64_t y) {
#if defined(__CUDA_ARCH__)
  uint64_t r;
  asm("{\n\t.reg .u32 xl, xh, tl, th;\n\t.reg .u64 t;\n\t"
      "mov.b64 {xl, xh}, %1;\n\tmad.wide.u32 t, xl, %3, %2;\n\t"
      "mov.b64 {tl, th}, t;\n\tmad.lo.u32 th, xh, %3, th;\n\t"
      "mov.b64 %0, {tl, th};\n\t}"
      : "=l"(r) : "l"(x), "l"(y), "r"(kPow2[0]));
  return r;
#else
  const uint64_t t = (uint64_t)(uint32_t)x + y;
  return t + ((x >> 32) << 32);
#endif
}

// hi * 2^k + hi32(lo * 2^k) as IMAD and IMAD.HI, 0 < k < 32: the two terms
// share no bit, so + is | and this is (hi << k) | (lo >> (32 - k))
DISTPOW_HD uint32_t shl_or_fma(uint32_t hi, uint32_t lo, int k) {
#if defined(__CUDA_ARCH__)
  return hi * kPow2[k] + __umulhi(lo, kPow2[k]);
#else
  return hi * (1u << k) + (uint32_t)(((uint64_t)lo << k) >> 32);
#endif
}

// rotl32(x, s) + y for 0 < s < 32 on the FMA pipe: the 64-bit product
// x * 2^s holds x << s in its low word and x >> (32 - s) in its high word,
// which share no bit, so their sum is the rotate.  The high word plus y is
// one IMAD.HI (mad.hi), the low word plus that one IMAD: three FMA-pipe
// slots against one SHF (or, with y, one LEA.HI) on the ALU pipe.
DISTPOW_HD uint32_t rotl_fma(uint32_t x, int s, uint32_t y = 0) {
#if defined(__CUDA_ARCH__)
  const uint32_t p = kPow2[s];
  uint32_t hi;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(hi) : "r"(x), "r"(p), "r"(y));
  return x * p + hi;
#else
  const uint64_t p = (uint64_t)x * ((uint64_t)1 << s);
  return (uint32_t)p + ((uint32_t)(p >> 32) + y);
#endif
}

// rotr64 by S, 0 < S < 64, S != 32, as a rotate left by R = 64 - S of the
// limbs (h, l): swap them if R >= 32, then rotate left by K = R % 32:
//   l' = (l << K) | (h >> (32 - K)),   h' = (h << K) | (l >> (32 - K))
// ROT_SHF makes both limbs funnel shifts (rotr64), ROT_HALF h' as IMAD +
// IMAD.HI (shl_or_fma), ROT_FMA both limbs.
enum RotForm : int { ROT_SHF, ROT_HALF, ROT_FMA };

template <int F, int S>
DISTPOW_HD uint64_t rotr64_form(uint64_t x) {
  if constexpr (F == ROT_SHF) {
    return rotr64(x, S);
  } else {
    constexpr int R = 64 - S, K = R % 32;
    static_assert(K != 0, "a rotate by 32 is a swap");
    const uint32_t l = R >= 32 ? (uint32_t)(x >> 32) : (uint32_t)x;
    const uint32_t h = R >= 32 ? (uint32_t)x : (uint32_t)(x >> 32);
#if defined(__CUDA_ARCH__)
    const uint32_t lo = F == ROT_FMA ? shl_or_fma(l, h, K) : __funnelshift_l(h, l, K);
#else
    const uint32_t lo = shl_or_fma(l, h, K);
#endif
    return (uint64_t)shl_or_fma(h, l, K) << 32 | lo;
  }
}

}  // namespace distpow
