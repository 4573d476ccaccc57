// MD5 proof-of-work search kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel distpow_tpu/ops/md5_pallas.py: _dyn_pallas_step
// (the scaffold: flat-index decode, message packing, mask check, min
// reduction) and _md5_tile (the unrolled MD5 rounds).
//
// What it computes: the smallest flat index f in [0, n) whose candidate
// nonce || tb || chunk meets the difficulty masks, or SENTINEL (0xFFFFFFFF).
// f decodes chunk-major, thread-byte-minor (md5.cuh decode), which is the
// reference enumeration order, so the minimum is the reference's first hit.
//
// What bounds it: instruction issue.  A candidate reads no memory (its
// message is built in registers from the flat index and a few words loaded
// once per thread), so the work is the ~64 rounds of add/logic/rotate per
// hash (nvcc fuses each rotate-and-add into one LEA.HI); the only memory
// traffic of a launch is the 4-byte result cell.  About a third of the
// loop's instructions place the variable bytes (a select per message word
// against the runtime var_word): the first thing a faster kernel removes.
//
// Design:
// * one candidate per thread per iteration of a grid-stride loop over the
//   launch's n = batch * launch_steps indices (n < 2^31, so f fits 32 bits
//   and f + stride cannot wrap); a thread stops at its first hit, which is
//   its own minimum because its f only grows;
// * MASK_WORDS (1..4), N_BLOCKS (1, 2) and POW2 (power-of-two thread-byte
//   run: shift and mask instead of a divide) are template parameters, so
//   the rounds that feed only unread digest words are dead code and the
//   loop holds no runtime branch on the configuration; the layout
//   (thread-byte word and shift, chunk width, tbc or log2 tbc) is a runtime
//   argument, since CUDA has no per-layout compile to amortize;
// * the TPU kernel carried its min across a sequential grid in one SMEM
//   cell; CUDA blocks run concurrently and in no order, so the min is a
//   three-step reduction: per thread, per warp (__reduce_min_sync), and one
//   atomicMin per block into a result cell that the caller set to SENTINEL
//   on the same stream before the launch;
// * 256 threads a block: 8 warps, two per SM sub-partition scheduler.  At
//   the 53-79 registers ptxas gives the specializations, 3-4 blocks (24-32
//   warps) fit on an SM: 6-8 independent round chains per scheduler to hide
//   the latency of each thread's dependent chain.  The grid is sized by the
//   caller (a few waves of blocks per SM), not by n.
//
// Interface: a plain C function, launched on the caller's stream; it does
// not synchronise and allocates nothing.  It returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "md5.cuh"

namespace distpow {

constexpr int BLOCK_THREADS = 256;

template <int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(BLOCK_THREADS)
md5_search_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                  const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                  uint32_t* __restrict__ out) {
  uint32_t init[4], base[16 * N_BLOCKS], masks[MASK_WORDS];
#pragma unroll
  for (int i = 0; i < 4; ++i) init[i] = __ldg(init_g + i);
#pragma unroll
  for (int i = 0; i < 16 * N_BLOCKS; ++i) base[i] = __ldg(base_g + i);
#pragma unroll
  for (int i = 0; i < MASK_WORDS; ++i) masks[i] = __ldg(masks_g + i);

  uint32_t best = SENTINEL;
  const uint32_t stride = gridDim.x * blockDim.x;
  // one hash per iteration (not unrolled), so the loop body in the SASS is
  // exactly one candidate's work: chip_smoke.py counts it beside the bound
#pragma unroll 1
  for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < n; f += stride) {
    uint32_t tb, chunk;
    decode<POW2>(L, f, tb, chunk);
    if (candidate_hits<MASK_WORDS, N_BLOCKS>(init, base, masks, L, tb, chunk)) {
      best = f;
      break;
    }
  }

  __shared__ uint32_t warp_min[BLOCK_THREADS / 32];
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m = warp_min[0];
#pragma unroll
    for (int w = 1; w < BLOCK_THREADS / 32; ++w) m = min(m, warp_min[w]);
    if (m != SENTINEL) atomicMin(out, m);
  }
}

template <int MASK_WORDS, int N_BLOCKS>
void launch(bool pow2, const uint32_t* init, const uint32_t* base, const uint32_t* masks,
            const Layout& L, uint32_t n, uint32_t* out, int grid, cudaStream_t stream) {
  if (pow2) {
    md5_search_kernel<MASK_WORDS, N_BLOCKS, true>
        <<<grid, BLOCK_THREADS, 0, stream>>>(init, base, masks, L, n, out);
  } else {
    md5_search_kernel<MASK_WORDS, N_BLOCKS, false>
        <<<grid, BLOCK_THREADS, 0, stream>>>(init, base, masks, L, n, out);
  }
}

template <int N_BLOCKS>
void launch_mw(int mask_words, bool pow2, const uint32_t* init, const uint32_t* base,
               const uint32_t* masks, const Layout& L, uint32_t n, uint32_t* out, int grid,
               cudaStream_t stream) {
  switch (mask_words) {
    case 1: launch<1, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    case 2: launch<2, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    case 3: launch<3, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    default: launch<4, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
  }
}

}  // namespace distpow

extern "C" {

// Launch one search over flat indices [0, n).  init[4], base[16*n_blocks]
// and masks[mask_words] are device arrays of uint32 words; out is the
// device result cell, already holding SENTINEL.  n_blocks is 1 or 2,
// mask_words 1..4, log_tbc = log2(tbc) or -1 when tbc is not a power of
// two (all checked by the caller).
int distpow_md5_search(const void* init, const void* base, const void* masks, int n_blocks,
                       int mask_words, uint32_t chunk0, uint32_t tb_lo, uint32_t tbc,
                       int log_tbc, int var_word, int var_shift, uint32_t chunk_mask,
                       uint32_t n, void* out, int grid, void* stream) {
  if (n == 0) return 0;
  distpow::Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint32_t*>(init);
  auto b = static_cast<const uint32_t*>(base);
  auto m = static_cast<const uint32_t*>(masks);
  auto o = static_cast<uint32_t*>(out);
  const bool pow2 = log_tbc >= 0;
  if (n_blocks == 1) {
    distpow::launch_mw<1>(mask_words, pow2, i, b, m, L, n, o, grid, s);
  } else {
    distpow::launch_mw<2>(mask_words, pow2, i, b, m, L, n, o, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
