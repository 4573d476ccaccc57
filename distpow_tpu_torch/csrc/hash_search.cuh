// Search scaffold of the sha256, sha256d, sha1 and ripemd160 kernels: the
// flat-index decode, the message words of a candidate in either byte order,
// the mask check, and (under nvcc) the kernel and its launcher.
//
// Replaces the scaffold of the TPU kernel, distpow_tpu/ops/md5_pallas.py
// _dyn_pallas_step, for the four hashes whose tiles are _sha256_tile,
// _sha256d_tile, _sha1_tile and _ripemd160_tile.  A hash is a struct H
// (sha256.cuh, sha1.cuh, ripemd160.cuh) with
//   STATE_WORDS, DIGEST_WORDS      uint32 words of the state and the digest
//   BIG_ENDIAN_WORDS               how message bytes map to message words
//   block(st, m)                   a full compression (not the last block)
//   last<MW>(st, m)                the last block and any finalize stage,
//                                  after which only the MW trailing digest
//                                  words of st are defined: the rounds that
//                                  feed only the others are never computed
//
// Layout, decode, rotl32 and SENTINEL come from md5.cuh, the first slice's
// header, whose MD5 kernel keeps its own scaffold for now.
//
// The host twin (the g++ build of the CPU tests) sees only the
// __host__ __device__ functions; the kernel is compiled by nvcc alone.
#pragma once

#include <stdint.h>

#include "md5.cuh"

#if defined(__CUDA_ARCH__)
#define DISTPOW_UNROLL _Pragma("unroll")
#else
#define DISTPOW_UNROLL
#endif

namespace distpow {

DISTPOW_HD uint32_t rotr32(uint32_t x, int s) { return rotl32(x, 32 - s); }

DISTPOW_HD uint32_t bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// The variable bytes of a candidate are one contiguous run in the tail:
// the thread byte, then chunk bytes 0..width-1.  The run spans the words
// L.var_word and L.var_word + 1; L.var_shift is the thread byte's bit shift
// in its word (8 * byte offset little-endian, 8 * (3 - offset) big-endian),
// and the two words' variable bits come out of one 64-bit window.
template <bool BIG_ENDIAN_WORDS>
DISTPOW_HD void var_words(const Layout& L, uint32_t tb, uint32_t chunk, uint32_t& first,
                          uint32_t& second) {
  const uint32_t c = chunk & L.chunk_mask;
  if constexpr (BIG_ENDIAN_WORDS) {
    // tb above the chunk bytes, chunk byte 0 first: byte-swapped chunk
    const uint64_t v = (((uint64_t)tb << 32) | bswap32(c)) << L.var_shift;
    first = (uint32_t)(v >> 32);
    second = (uint32_t)v;
  } else {
    const uint64_t v = ((uint64_t)tb | ((uint64_t)c << 8)) << L.var_shift;
    first = (uint32_t)v;
    second = (uint32_t)(v >> 32);
  }
}

// Message words of tail block blk: the constant words, with the variable
// bits ORed into the run's two words.
DISTPOW_HD void message_block(const uint32_t* base, const Layout& L, uint32_t first,
                              uint32_t second, int blk, uint32_t m[16]) {
  DISTPOW_UNROLL
  for (int w = 0; w < 16; ++w) {
    const int word = blk * 16 + w;
    m[w] = base[word] | (word == L.var_word ? first : 0u) |
           (word == L.var_word + 1 ? second : 0u);
  }
}

// The state after the N_BLOCKS tail blocks of candidate (tb, chunk), of
// which the MASK_WORDS trailing digest words are defined.  init holds the
// absorbed prefix state, base[16 * N_BLOCKS] the tail's constant words.
template <class H, int MASK_WORDS, int N_BLOCKS>
DISTPOW_HD void hash_tail_state(const uint32_t* init, const uint32_t* base, const Layout& L,
                                uint32_t tb, uint32_t chunk, uint32_t st[H::STATE_WORDS]) {
  uint32_t first, second, m[16];
  var_words<H::BIG_ENDIAN_WORDS>(L, tb, chunk, first, second);
  DISTPOW_UNROLL
  for (int i = 0; i < H::STATE_WORDS; ++i) st[i] = init[i];
  if constexpr (N_BLOCKS == 2) {
    message_block(base, L, first, second, 0, m);
    H::block(st, m);
  }
  message_block(base, L, first, second, N_BLOCKS - 1, m);
  H::template last<MASK_WORDS>(st, m);
}

// Does candidate (tb, chunk) meet the difficulty?  masks[] holds the
// MASK_WORDS trailing digest-word masks.
template <class H, int MASK_WORDS, int N_BLOCKS>
DISTPOW_HD bool hash_candidate_hits(const uint32_t* init, const uint32_t* base,
                                    const uint32_t* masks, const Layout& L, uint32_t tb,
                                    uint32_t chunk) {
  uint32_t st[H::STATE_WORDS];
  hash_tail_state<H, MASK_WORDS, N_BLOCKS>(init, base, L, tb, chunk, st);
  uint32_t acc = 0;
  DISTPOW_UNROLL
  for (int j = 0; j < MASK_WORDS; ++j) acc |= st[H::DIGEST_WORDS - MASK_WORDS + j] & masks[j];
  return acc == 0;
}

}  // namespace distpow

#if defined(__CUDACC__)
#include <cuda_runtime.h>

namespace distpow {

// The kernel: md5_search.cu's design, over any hash H.
// * One candidate per thread per iteration of a grid-stride loop over the
//   launch's n < 2^31 flat indices; a thread stops at its first hit, which
//   is its own minimum.
// * MASK_WORDS (1-4 or the full digest: the wrapper pads wider masks with
//   leading zero words, which every candidate passes), N_BLOCKS and POW2
//   are template keys, so the rounds that feed only unread digest words are
//   dead code; the layout is a runtime argument.
// * The min across the grid: per thread, per warp (__reduce_min_sync), then
//   one atomicMin per block into a cell the wrapper set to SENTINEL on the
//   same stream.
// What bounds it is instruction issue: a candidate reads no memory.
constexpr int HASH_BLOCK_THREADS = 256;

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_search_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                   const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                   uint32_t* __restrict__ out) {
  uint32_t init[H::STATE_WORDS], base[16 * N_BLOCKS], masks[MASK_WORDS];
#pragma unroll
  for (int i = 0; i < H::STATE_WORDS; ++i) init[i] = __ldg(init_g + i);
#pragma unroll
  for (int i = 0; i < 16 * N_BLOCKS; ++i) base[i] = __ldg(base_g + i);
#pragma unroll
  for (int i = 0; i < MASK_WORDS; ++i) masks[i] = __ldg(masks_g + i);

  uint32_t best = SENTINEL;
  const uint32_t stride = gridDim.x * blockDim.x;
  // one hash per iteration, so the loop body in the SASS is one candidate's
  // work: chip_smoke.py counts it beside the bound
#pragma unroll 1
  for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < n; f += stride) {
    uint32_t tb, chunk;
    decode<POW2>(L, f, tb, chunk);
    if (hash_candidate_hits<H, MASK_WORDS, N_BLOCKS>(init, base, masks, L, tb, chunk)) {
      best = f;
      break;
    }
  }

  __shared__ uint32_t warp_min[HASH_BLOCK_THREADS / 32];
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m = warp_min[0];
#pragma unroll
    for (int w = 1; w < HASH_BLOCK_THREADS / 32; ++w) m = min(m, warp_min[w]);
    if (m != SENTINEL) atomicMin(out, m);
  }
}

template <class H, int MASK_WORDS, int N_BLOCKS>
void launch_hash_kernel(bool pow2, const uint32_t* init, const uint32_t* base,
                        const uint32_t* masks, const Layout& L, uint32_t n, uint32_t* out,
                        int grid, cudaStream_t stream) {
  if (pow2) {
    hash_search_kernel<H, MASK_WORDS, N_BLOCKS, true>
        <<<grid, HASH_BLOCK_THREADS, 0, stream>>>(init, base, masks, L, n, out);
  } else {
    hash_search_kernel<H, MASK_WORDS, N_BLOCKS, false>
        <<<grid, HASH_BLOCK_THREADS, 0, stream>>>(init, base, masks, L, n, out);
  }
}

template <class H, int N_BLOCKS>
cudaError_t launch_hash_mw(int mask_words, bool pow2, const uint32_t* init,
                           const uint32_t* base, const uint32_t* masks, const Layout& L,
                           uint32_t n, uint32_t* out, int grid, cudaStream_t stream) {
  if (mask_words == H::DIGEST_WORDS) {
    launch_hash_kernel<H, H::DIGEST_WORDS, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid,
                                                     stream);
    return cudaSuccess;
  }
  switch (mask_words) {
    case 1: launch_hash_kernel<H, 1, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    case 2: launch_hash_kernel<H, 2, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    case 3: launch_hash_kernel<H, 3, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    case 4: launch_hash_kernel<H, 4, N_BLOCKS>(pow2, init, base, masks, L, n, out, grid, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The body of each kernel's extern "C" launcher (the *_search.cu files).
// init[STATE_WORDS], base[16 * n_blocks] and masks[mask_words] are device
// arrays; out is the device result cell, already holding SENTINEL.
// n_blocks is 1 or 2, mask_words 1-4 or DIGEST_WORDS, log_tbc = log2(tbc)
// or -1 when tbc is not a power of two.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a configuration no kernel was built for.
template <class H>
int launch_hash_search(const void* init, const void* base, const void* masks, int n_blocks,
                       int mask_words, uint32_t chunk0, uint32_t tb_lo, uint32_t tbc,
                       int log_tbc, int var_word, int var_shift, uint32_t chunk_mask,
                       uint32_t n, void* out, int grid, void* stream) {
  if (n == 0) return 0;
  if (n_blocks != 1 && n_blocks != 2) return static_cast<int>(cudaErrorInvalidValue);
  Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint32_t*>(init);
  auto b = static_cast<const uint32_t*>(base);
  auto m = static_cast<const uint32_t*>(masks);
  auto o = static_cast<uint32_t*>(out);
  const bool pow2 = log_tbc >= 0;
  const cudaError_t rc = n_blocks == 1
                             ? launch_hash_mw<H, 1>(mask_words, pow2, i, b, m, L, n, o, grid, s)
                             : launch_hash_mw<H, 2>(mask_words, pow2, i, b, m, L, n, o, grid, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace distpow
#endif  // __CUDACC__
