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
// Interface: three plain C functions, the search of one request, the
// scheduler's search of a group of slots and one shard's launch of a mesh
// search, launched on the caller's stream; they do not synchronise and
// allocate nothing.  Each returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "md5.cuh"

namespace distpow {

constexpr int BLOCK_THREADS = 256;

// A thread's first hitting flat index in the grid-stride loop, or SENTINEL:
// the body of the solo and the mesh kernel.
template <int MASK_WORDS, int N_BLOCKS, bool POW2>
__device__ __forceinline__ uint32_t md5_thread_first_hit(const uint32_t* __restrict__ init_g,
                                                         const uint32_t* __restrict__ base_g,
                                                         const uint32_t* __restrict__ masks_g,
                                                         const Layout& L, uint32_t n) {
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
  return best;
}

template <int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(BLOCK_THREADS)
md5_search_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                  const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                  uint32_t* __restrict__ out) {
  block_min_to<BLOCK_THREADS>(
      md5_thread_first_hit<MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n), out);
}

// The mesh kernel: one shard's launch of a search spread over a mesh of
// devices (replaces distpow_tpu/parallel/mesh_search.py
// _dyn_pallas_mesh_step).  The solo body runs over the shard's slice L of
// the partition o (a run of thread bytes or a span of chunks, n flat
// indices); each thread's first hit becomes the partition's flat index
// (mesh_global_index) before the block min, so the least value across the
// shards' cells is the partition's first hit.
template <int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(BLOCK_THREADS)
md5_mesh_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                const uint32_t* __restrict__ masks_g, Layout L, MeshOrigin o, uint32_t n,
                uint32_t* __restrict__ out) {
  block_min_to<BLOCK_THREADS>(
      mesh_global_index<POW2>(
          L, o, md5_thread_first_hit<MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n)),
      out);
}

// The scheduler's kernel for md5: the search of a group of slots in one
// launch (replaces distpow_tpu/sched/lanes.py build_pallas_group_step).
// blockIdx.y is the slot; each slot searches its flat indices [0, batch)
// at its own prefix state, rows, masks of all four digest words, power-of-
// two run and cursor (slot_layout), with the solo kernel's design: operands
// in registers, the grid-stride loop, warp min and one atomicMin per block
// into out[s], which the wrapper set to SENTINEL.  The tail layout
// (N_BLOCKS, var_word, var_shift, chunk_mask) is the group's.
template <int N_BLOCKS>
__global__ void __launch_bounds__(BLOCK_THREADS)
md5_group_search_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                        const uint32_t* __restrict__ masks_g,
                        const uint32_t* __restrict__ tb_lo_g,
                        const uint32_t* __restrict__ log_tbc_g,
                        const uint32_t* __restrict__ chunk0_g, int var_word, int var_shift,
                        uint32_t chunk_mask, uint32_t batch, uint32_t* __restrict__ out) {
  const int s = blockIdx.y;
  const Layout L = slot_layout(__ldg(chunk0_g + s), __ldg(tb_lo_g + s), __ldg(log_tbc_g + s),
                               var_word, var_shift, chunk_mask);
  uint32_t init[4], base[16 * N_BLOCKS], masks[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) init[i] = __ldg(init_g + 4 * s + i);
#pragma unroll
  for (int i = 0; i < 16 * N_BLOCKS; ++i) base[i] = __ldg(base_g + 16 * N_BLOCKS * s + i);
#pragma unroll
  for (int i = 0; i < 4; ++i) masks[i] = __ldg(masks_g + 4 * s + i);

  uint32_t best = SENTINEL;
  const uint32_t stride = gridDim.x * blockDim.x;
#pragma unroll 1
  for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < batch; f += stride) {
    uint32_t tb, chunk;
    decode<true>(L, f, tb, chunk);
    if (candidate_hits<4, N_BLOCKS>(init, base, masks, L, tb, chunk)) {
      best = f;
      break;
    }
  }

  block_min_to<BLOCK_THREADS>(best, out + s);
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
  const distpow::Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return distpow::launch_keyed<4>(mask_words, n_blocks, log_tbc >= 0, n, [&](auto mw, auto nb,
                                                                            auto pow2) {
    distpow::md5_search_kernel<decltype(mw)::value, decltype(nb)::value, decltype(pow2)::value>
        <<<grid, distpow::BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            u(init), u(base), u(masks), L, n, static_cast<uint32_t*>(out));
  });
}

// Launch one shard of a mesh search (md5_mesh_kernel): the shard's run
// tb_lo .. tb_lo + tbc - 1 from cursor chunk0 over flat indices [0, n),
// its first hit written to out as the flat index of the partition whose
// cursor is origin_chunk0 and whose run is origin_tbc thread bytes from
// origin_tb_lo.  The other arguments are distpow_md5_search's.
int distpow_md5_mesh_search(const void* init, const void* base, const void* masks,
                            int n_blocks, int mask_words, uint32_t chunk0, uint32_t tb_lo,
                            uint32_t tbc, int log_tbc, int var_word, int var_shift,
                            uint32_t chunk_mask, uint32_t n, uint32_t origin_chunk0,
                            uint32_t origin_tb_lo, uint32_t origin_tbc, void* out, int grid,
                            void* stream) {
  const distpow::Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  const distpow::MeshOrigin o{origin_chunk0, origin_tb_lo, origin_tbc};
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return distpow::launch_keyed<4>(mask_words, n_blocks, log_tbc >= 0, n, [&](auto mw, auto nb,
                                                                            auto pow2) {
    distpow::md5_mesh_kernel<decltype(mw)::value, decltype(nb)::value, decltype(pow2)::value>
        <<<grid, distpow::BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            u(init), u(base), u(masks), L, o, n, static_cast<uint32_t*>(out));
  });
}

// The search of a group of n_slots slots, each over flat indices [0, batch)
// (md5_group_search_kernel).  init[n_slots][4], base[n_slots][16*n_blocks],
// masks[n_slots][4], tb_lo, log_tbc, chunk0 and out[n_slots] are device
// arrays; out already holds SENTINEL.  The grid is (grid_x, n_slots).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a configuration
// no kernel was built for.
int distpow_md5_group_search(const void* init, const void* base, const void* masks,
                             int n_blocks, int var_word, int var_shift, uint32_t chunk_mask,
                             const void* tb_lo, const void* log_tbc, const void* chunk0,
                             int n_slots, uint32_t batch, void* out, int grid_x, void* stream) {
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return distpow::launch_group(n_blocks, n_slots, batch, grid_x, [&](auto n_blk, dim3 grid) {
    distpow::md5_group_search_kernel<decltype(n_blk)::value>
        <<<grid, distpow::BLOCK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            u(init), u(base), u(masks), u(tb_lo), u(log_tbc), u(chunk0), var_word, var_shift,
            chunk_mask, batch, static_cast<uint32_t*>(out));
  });
}

}  // extern "C"
