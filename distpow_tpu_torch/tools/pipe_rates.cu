// Issue-rate probes for Hopper's integer pipes, built and timed by
// pipe_rates.py (not a kernel of the port: csrc/ holds those).
//
// Each probe kernel runs CHAINS independent chains per thread through a
// loop of STEPS unrolled steps.  A step replaces every chain value by one
// instruction of the probe's kind, whose inputs are the chain, its
// neighbour and the launch's constant k (a kernel parameter, so ptxas cannot
// fold it, and multiplies by k stay multiplies); VIADD adds an immediate to
// the neighbour, so ptxas folds a chain of VIADDs alone and VIADD is probed
// only in mixes.  The "+" probes alternate
// the two kinds chain by chain, so each step issues both in equal numbers.
// Inline PTX fixes the instruction; cuobjdump shows what ptxas issued.
//
// probe64_kernel does the same over CHAINS 64-bit chains (register pairs),
// one 64-bit operation a chain a step: sums of two and three terms as
// nvcc's IADD3 + IADD3.X, with the high limb as IMAD.X (add64_carry), or
// through IMAD.WIDE (add64_wide); an XOR-and-rotate, the ALU-pipe work of
// a BLAKE2b G or a SHA-512 round, by funnel shifts, by byte permutes, or
// with one or both limbs as IMAD + IMAD.HI (rotr64_form).  Its "+" probes
// give the first N0 chains one operation and the others another.  These
// forms (fma_forms.cuh) are the candidates for moving a 64-bit hash's work
// onto the FMA pipe.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_forms.cuh"

using distpow::add64_carry;
using distpow::add64_wide;
using distpow::rotr64_form;
using distpow::ROT_FMA;
using distpow::ROT_HALF;

constexpr int CHAINS = 8;
constexpr int STEPS = 8;
constexpr int THREADS = 256;

// the instruction kinds
enum Op : int { LOP3, SHF, IADD3, IMAD, IMAD_HI, VIADD, IMAD_WIDE, PRMT };

template <int OP>
__device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b, uint32_t k) {
  uint32_t d;
  if constexpr (OP == LOP3) {  // majority(a, b, k)
    asm("lop3.b32 %0, %1, %2, %3, 0xE8;" : "=r"(d) : "r"(a), "r"(b), "r"(k));
  } else if constexpr (OP == SHF) {  // the high word of (b:a) << 7, a funnel shift
    asm("shf.l.wrap.b32 %0, %1, %2, 7;" : "=r"(d) : "r"(a), "r"(b));
  } else if constexpr (OP == IADD3) {
    asm("{ .reg .u32 t; add.u32 t, %1, %2; add.u32 %0, t, %3; }"
        : "=r"(d) : "r"(a), "r"(b), "r"(k));
  } else if constexpr (OP == IMAD) {  // a * k + b, low word
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(k), "r"(b));
  } else if constexpr (OP == IMAD_HI) {  // hi(a * k) + b
    asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(k), "r"(b));
  } else if constexpr (OP == VIADD) {  // b + an immediate
    asm("add.u32 %0, %1, 0x3779B9;" : "=r"(d) : "r"(b));
  } else if constexpr (OP == PRMT) {  // bytes 3..6 of (b:a), a byte funnel
    asm("prmt.b32 %0, %1, %2, 0x6543;" : "=r"(d) : "r"(a), "r"(b));
  } else {  // the high word of a * k + (b:a), a 64-bit product and sum
    asm("{ .reg .u64 t; .reg .u32 l; mov.b64 t, {%1, %2}; mad.wide.u32 t, %1, %3, t;"
        " mov.b64 {l, %0}, t; }"
        : "=r"(d) : "r"(a), "r"(b), "r"(k));
  }
  return d;
}

// the 64-bit operation kinds
enum Op64 : int { ADD64, ADD64_CARRY, ADD64_WIDE, ADD3_64, ADD3_64_CARRY, ADD3_64_WIDE, XROT64,
                  XROT64_PRMT, XROT64_HALF, XROT64_FMA };

__device__ __forceinline__ uint64_t add64_alu(uint64_t x, uint64_t y) {
  uint64_t r;
  asm("{\n\t.reg .u32 xl, xh, yl, yh, rl, rh;\n\t"
      "mov.b64 {xl, xh}, %1;\n\tmov.b64 {yl, yh}, %2;\n\t"
      "add.cc.u32 rl, xl, yl;\n\taddc.u32 rh, xh, yh;\n\t"
      "mov.b64 %0, {rl, rh};\n\t}"
      : "=l"(r) : "l"(x), "l"(y));
  return r;
}

// rotr64(a ^ b, 24): two LOP3 and two funnel shifts, or two byte permutes
template <bool BYTES>
__device__ __forceinline__ uint64_t xrot64(uint64_t a, uint64_t b) {
  uint64_t r;
  if constexpr (BYTES) {
    asm("{\n\t.reg .u32 al, ah, bl, bh, rl, rh;\n\t"
        "mov.b64 {al, ah}, %1;\n\tmov.b64 {bl, bh}, %2;\n\t"
        "xor.b32 al, al, bl;\n\txor.b32 ah, ah, bh;\n\t"
        "prmt.b32 rl, al, ah, 0x6543;\n\tprmt.b32 rh, al, ah, 0x2107;\n\t"
        "mov.b64 %0, {rl, rh};\n\t}"
        : "=l"(r) : "l"(a), "l"(b));
  } else {
    asm("{\n\t.reg .u32 al, ah, bl, bh, rl, rh;\n\t"
        "mov.b64 {al, ah}, %1;\n\tmov.b64 {bl, bh}, %2;\n\t"
        "xor.b32 al, al, bl;\n\txor.b32 ah, ah, bh;\n\t"
        "shf.r.wrap.b32 rl, al, ah, 24;\n\tshf.r.wrap.b32 rh, ah, al, 24;\n\t"
        "mov.b64 %0, {rl, rh};\n\t}"
        : "=l"(r) : "l"(a), "l"(b));
  }
  return r;
}

template <int OP>
__device__ __forceinline__ uint64_t op64(uint64_t a, uint64_t b, uint64_t c) {
  if constexpr (OP == ADD64) return add64_alu(a, b);
  else if constexpr (OP == ADD64_CARRY) return add64_carry(a, b);
  else if constexpr (OP == ADD64_WIDE) return add64_wide(a, b);
  else if constexpr (OP == ADD3_64) return add64_alu(add64_alu(a, b), c);
  else if constexpr (OP == ADD3_64_CARRY) return add64_carry(add64_carry(a, b), c);
  else if constexpr (OP == ADD3_64_WIDE) return add64_wide(add64_wide(a, b), c);
  else if constexpr (OP == XROT64) return xrot64<false>(a, b);
  else if constexpr (OP == XROT64_PRMT) return xrot64<true>(a, b);
  else if constexpr (OP == XROT64_HALF) return rotr64_form<ROT_HALF, 24>(a ^ b);
  else return rotr64_form<ROT_FMA, 24>(a ^ b);
}

// N0 chains of OP0, the others of OP1; four resident blocks, so the 16
// chain registers and their temporaries need not spill
template <int OP0, int N0, int OP1>
__global__ void __launch_bounds__(THREADS, 4)
probe64_kernel(uint32_t iters, uint32_t k, uint32_t* out) {
  uint64_t x[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i)
    x[i] = ((uint64_t)(threadIdx.x * k + i) << 32 | (blockIdx.x + i * 0x9E3779B9u)) * 0x85EBCA6Bull;
#pragma unroll 1
  for (uint32_t it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      uint64_t y[CHAINS];
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) {
        const uint64_t b = x[(i + 1) % CHAINS], c = x[(i + 2) % CHAINS];
        y[i] = i < N0 ? op64<OP0>(x[i], b, c) : op64<OP1>(x[i], b, c);
      }
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) x[i] = y[i];
    }
  }
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc ^= x[i];
  out[blockIdx.x * THREADS + threadIdx.x] = (uint32_t)acc ^ (uint32_t)(acc >> 32);
}

template <int OP0, int N0, int OP1>
void launch64(int grid, uint32_t iters, uint32_t k, uint32_t* out, cudaStream_t s) {
  probe64_kernel<OP0, N0, OP1><<<grid, THREADS, 0, s>>>(iters, k, out);
}

template <int EVEN, int ODD>
__global__ void __launch_bounds__(THREADS, 8)
probe_kernel(uint32_t iters, uint32_t k, uint32_t* out) {
  uint32_t x[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) x[i] = (threadIdx.x + i * 0x9E3779B9u) * 0x85EBCA6Bu + blockIdx.x;
#pragma unroll 1
  for (uint32_t it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      uint32_t y[CHAINS];
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) {
        const uint32_t b = x[(i + 1) % CHAINS];
        y[i] = i % 2 ? op<ODD>(x[i], b, k) : op<EVEN>(x[i], b, k);
      }
#pragma unroll
      for (int i = 0; i < CHAINS; ++i) x[i] = y[i];
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc ^= x[i];
  out[blockIdx.x * THREADS + threadIdx.x] = acc;
}

template <int EVEN, int ODD>
void launch(int grid, uint32_t iters, uint32_t k, uint32_t* out, cudaStream_t s) {
  probe_kernel<EVEN, ODD><<<grid, THREADS, 0, s>>>(iters, k, out);
}

// Launches probe p (the order of PROBES in pipe_rates.py) on grid blocks of
// 256 threads; out holds grid * 256 words.  Returns cudaGetLastError().
extern "C" int pipe_probe(int p, int grid, uint32_t iters, uint32_t k, void* out,
                          void* stream) {
  auto o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 0: launch<LOP3, LOP3>(grid, iters, k, o, s); break;
    case 1: launch<SHF, SHF>(grid, iters, k, o, s); break;
    case 2: launch<IADD3, IADD3>(grid, iters, k, o, s); break;
    case 3: launch<IMAD, IMAD>(grid, iters, k, o, s); break;
    case 4: launch<IMAD_HI, IMAD_HI>(grid, iters, k, o, s); break;
    case 5: launch<IMAD_WIDE, IMAD_WIDE>(grid, iters, k, o, s); break;
    case 6: launch<LOP3, IMAD>(grid, iters, k, o, s); break;
    case 7: launch<SHF, IMAD_HI>(grid, iters, k, o, s); break;
    case 8: launch<LOP3, VIADD>(grid, iters, k, o, s); break;
    case 9: launch<SHF, IMAD>(grid, iters, k, o, s); break;
    case 10: launch<IMAD, VIADD>(grid, iters, k, o, s); break;
    case 11: launch<PRMT, PRMT>(grid, iters, k, o, s); break;
    case 12: launch<PRMT, IMAD>(grid, iters, k, o, s); break;
    case 13: launch<PRMT, LOP3>(grid, iters, k, o, s); break;
    case 14: launch64<ADD64, CHAINS, ADD64>(grid, iters, k, o, s); break;
    case 15: launch64<ADD64_CARRY, CHAINS, ADD64_CARRY>(grid, iters, k, o, s); break;
    case 16: launch64<ADD64_WIDE, CHAINS, ADD64_WIDE>(grid, iters, k, o, s); break;
    case 17: launch64<ADD3_64, CHAINS, ADD3_64>(grid, iters, k, o, s); break;
    case 18: launch64<ADD3_64_CARRY, CHAINS, ADD3_64_CARRY>(grid, iters, k, o, s); break;
    case 19: launch64<ADD3_64_WIDE, CHAINS, ADD3_64_WIDE>(grid, iters, k, o, s); break;
    case 20: launch64<XROT64, CHAINS, XROT64>(grid, iters, k, o, s); break;
    case 21: launch64<XROT64_PRMT, CHAINS, XROT64_PRMT>(grid, iters, k, o, s); break;
    case 22: launch64<XROT64, 4, ADD64_CARRY>(grid, iters, k, o, s); break;
    case 23: launch64<XROT64, 4, ADD64_WIDE>(grid, iters, k, o, s); break;
    case 24: launch64<XROT64, 4, ADD3_64_CARRY>(grid, iters, k, o, s); break;
    case 25: launch64<XROT64, 4, ADD3_64_WIDE>(grid, iters, k, o, s); break;
    case 26: launch<LOP3, IMAD_HI>(grid, iters, k, o, s); break;
    case 27: launch64<XROT64_HALF, CHAINS, XROT64_HALF>(grid, iters, k, o, s); break;
    case 28: launch64<XROT64_FMA, CHAINS, XROT64_FMA>(grid, iters, k, o, s); break;
    case 29: launch64<XROT64, 4, XROT64_HALF>(grid, iters, k, o, s); break;
    case 30: launch64<XROT64_HALF, 4, XROT64_FMA>(grid, iters, k, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
