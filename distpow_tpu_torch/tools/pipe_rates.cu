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
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int CHAINS = 8;
constexpr int STEPS = 8;
constexpr int THREADS = 256;

// the instruction kinds
enum Op : int { LOP3, SHF, IADD3, IMAD, IMAD_HI, VIADD, IMAD_WIDE };

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
  } else {  // the high word of a * k + (b:a), a 64-bit product and sum
    asm("{ .reg .u64 t; .reg .u32 l; mov.b64 t, {%1, %2}; mad.wide.u32 t, %1, %3, t;"
        " mov.b64 {l, %0}, t; }"
        : "=r"(d) : "r"(a), "r"(b), "r"(k));
  }
  return d;
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
