// Search scaffold of every kernel: the flat-index decode, the message words
// of a candidate in either byte order, the mask check, and (under nvcc) the
// kernels, their min across the grid and their launchers.
//
// Replaces the scaffold of the TPU kernel, distpow_tpu/ops/md5_pallas.py
// _dyn_pallas_step, for every hash: _md5_tile, _sha256_tile,
// _sha256d_tile, _sha1_tile, _ripemd160_tile, _sha512_tile, _sha384_tile,
// _sha3_tile and _blake2b_tile.  A hash is a struct H (md5.cuh,
// sha256.cuh, sha1.cuh, ripemd160.cuh, sha512.cuh, sha3.cuh, blake2b.cuh)
// with
//   STATE_WORDS, DIGEST_WORDS      uint32 words of the state and the digest
//   BLOCK_WORDS                    uint32 message words of a block
//   ROW_WORDS                      words of a tail block's row: the message
//                                  words, then the compression's parameter
//                                  words (blake2b's t and f0), which hold
//                                  no variable byte
//   BIG_ENDIAN_WORDS               how message bytes map to message words
//   block(st, m)                   a full compression (not the last block)
//   last<MW>(st, m)                the last block and any finalize stage,
//                                  after which only the MW trailing digest
//                                  words of st are defined: the rounds that
//                                  feed only the others are never computed
// and, where the hash wants it (sha3.cuh, sha256.cuh's Sha256 and Sha256d),
//   MIN_BLOCKS_PER_SM              resident 256-thread blocks per SM that
//                                  its kernel asks ptxas for; such a
//                                  kernel also reads the launch's
//                                  operands anew for every candidate
// A hash built for one tail layout (md5.cuh's Md5<VW>) also has
//   VAR_WORD                       the run's first message word, a
//                                  compile-time key of its kernels
//   builds(n_blocks)               whether a kernel exists for the tail
//                                  length at that var_word
//   Tail<N_BLOCKS>                 the launch's constants as the candidate
//                                  loop reads them, made once per thread
//                                  from the prefix state and the rows, with
//                                  state<MW>(L, tb, chunk, st) a candidate's
// and its kernels take the hash's own loop body (KeyedByVarWord below).
// All words are uint32; a 64-bit hash pairs them in its own limb order
// and works in uint64_t inside its struct.
//
// The host twin (the g++ build of the CPU tests) sees only the
// __host__ __device__ functions; the kernel is compiled by nvcc alone.
#pragma once

#include <stdint.h>

#include <type_traits>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define DISTPOW_HD __host__ __device__ __forceinline__
#else
#define DISTPOW_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define DISTPOW_UNROLL _Pragma("unroll")
#else
#define DISTPOW_UNROLL
#endif

namespace distpow {

// A miss: no candidate of the launch solves.
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

DISTPOW_HD uint32_t rotl32(uint32_t x, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, s);
#else
  return (x << s) | (x >> (32 - s));
#endif
}

// The search layout of one launch: what the TailSpec of the nonce and the
// thread-byte partition fix.  Words are the uint32 bit patterns.
//
// The variable bytes of a candidate are contiguous in every tail (thread
// byte, then chunk bytes 0..width-1), so the layout is the thread byte's
// word (var_words below) and bit shift; chunk_mask keeps the low 8*width
// bits of the chunk.
struct Layout {
  uint32_t chunk0;
  uint32_t tb_lo;
  uint32_t tbc;
  int32_t log_tbc;  // log2(tbc) when tbc is a power of two, else -1
  int32_t var_word;
  int32_t var_shift;
  uint32_t chunk_mask;
};

// The layout of one scheduler slot (the group kernel,
// hash_group_search_kernel): the group's shared tail layout (var_word,
// var_shift, chunk_mask) with the slot's own cursor and power-of-two
// thread-byte run tb_lo .. tb_lo + 2^log_tbc - 1.
DISTPOW_HD Layout slot_layout(uint32_t chunk0, uint32_t tb_lo, uint32_t log_tbc, int var_word,
                              int var_shift, uint32_t chunk_mask) {
  return Layout{chunk0, tb_lo, 1u << log_tbc, static_cast<int32_t>(log_tbc), var_word,
                var_shift, chunk_mask};
}

// Flat index -> (thread byte, chunk): chunk-major, thread-byte-minor, the
// reference enumeration order (worker.go:318-319).  POW2 takes the shift
// and mask of a power-of-two run; otherwise a divide.
template <bool POW2>
DISTPOW_HD void decode(const Layout& L, uint32_t f, uint32_t& tb, uint32_t& chunk) {
  if constexpr (POW2) {
    chunk = L.chunk0 + (f >> L.log_tbc);
    tb = L.tb_lo + (f & (L.tbc - 1u));
  } else {
    chunk = L.chunk0 + f / L.tbc;
    tb = L.tb_lo + f % L.tbc;
  }
}

// The partition a mesh shard searches part of (the mesh kernel,
// hash_mesh_kernel): the launch's cursor and the partition's thread-byte
// run tb_lo .. tb_lo + tbc - 1.  A shard's own Layout is a slice of it, a
// run of thread bytes or a span of chunks.
struct MeshOrigin {
  uint32_t chunk0;
  uint32_t tb_lo;
  uint32_t tbc;
};

// Candidate (tb, chunk) of the partition o as the partition's flat index.
DISTPOW_HD uint32_t origin_index(const MeshOrigin& o, uint32_t tb, uint32_t chunk) {
  return (chunk - o.chunk0) * o.tbc + (tb - o.tb_lo);
}

// A shard's local flat index f (or SENTINEL) as the partition's flat
// index: chunk-major over the whole run, (chunk - chunk0) * tbc + (tb -
// tb_lo), the same expression for a thread-byte slice and a chunk span, a
// power-of-two run or not.  Within a shard it grows with f, so the
// shard's first hit maps to its least partition index, and the least
// across shards is the partition's first hit.  The caller keeps every
// partition index of the launch below 2^31.
template <bool POW2>
DISTPOW_HD uint32_t mesh_global_index(const Layout& L, const MeshOrigin& o, uint32_t f) {
  if (f == SENTINEL) return SENTINEL;
  uint32_t tb, chunk;
  decode<POW2>(L, f, tb, chunk);
  return origin_index(o, tb, chunk);
}

// The persistent form of the solo and mesh kernels, the device side of the
// persistent search loop (parallel/search.py persistent_search; it replaces
// the XLA while_loop of distpow_tpu/ops/search_step.py
// persistent_search_step and parallel/mesh_search.py mesh_persistent_step).
// A launch covers whole segments of P.seg reported indices (a solo launch's
// flat indices, a mesh shard's partition indices) and leaves two words:
// out[0], the least hit or SENTINEL, and out[1], the segments executed: the
// hit's segment + 1; where a thread saw the search's stop flag, at most the
// segment it was about to start (0 when the flag was set before the
// launch); else the launch's segment count, which the wrapper wrote there.
// A null stop is the serial form, in which none of it runs.
struct Persist {
  const uint32_t* stop;  // the search's stop flag, a device word, or null
  uint32_t seg;          // reported indices per segment
  uint32_t batch;        // flat indices per segment of this launch
  uint32_t period_mask;  // 2^k - 1, 2^k >= the grid's threads (persistent_due)
};

// The check period's mask for a launch of `threads` threads whose segment
// holds `batch` flat indices: 2^k - 1 for the least 2^k at or above both,
// so a thread checks at least once a segment of its own loop.
DISTPOW_HD uint32_t persistent_period_mask(uint32_t batch, uint32_t threads) {
  uint32_t m = (batch > threads ? batch : threads) - 1;
  m |= m >> 1;
  m |= m >> 2;
  m |= m >> 4;
  m |= m >> 8;
  m |= m >> 16;
  return m;
}

// Is a persistent thread's check due before flat index f?  Where f's low k
// bits (period_mask = 2^k - 1) are below the grid's stride: once each 2^k
// flat indices of the thread's loop, since the loop steps by the stride,
// at most 2^k, and at its first index, which is below the stride.  The
// test needs no state carried through the loop.
DISTPOW_HD bool persistent_due(uint32_t f, uint32_t period_mask, uint32_t stride) {
  return (f & period_mask) < stride;
}

// What a persistent thread does before the candidate it reports as index g,
// from the launch's cell (out[0]) and the search's flag as it read them:
// test it (kTest); stop, because the cell holds a hit below g (kBelowHit); or
// stop on the flag (kStopped).  The cell only decreases, the reported index
// grows along a thread's loop, and every index a thread skips lies above a
// hit already published, so the least index is the serial kernel's.
enum PersistentStep : int { kTest = 0, kBelowHit = 1, kStopped = 2 };

DISTPOW_HD int persistent_step(uint32_t cell, uint32_t stop, uint32_t g) {
  return cell < g ? kBelowHit : stop != 0 ? kStopped : kTest;
}

// The hashes of 64-byte blocks and 16-word rows.
struct Block16 {
  static constexpr int BLOCK_WORDS = 16;
  static constexpr int ROW_WORDS = 16;
};

DISTPOW_HD uint32_t rotr32(uint32_t x, int s) { return rotl32(x, 32 - s); }

// 64-bit rotates, 0 <= s < 64; with a constant s nvcc emits two funnel
// shifts (none for s = 32 or 0).
DISTPOW_HD uint64_t rotr64(uint64_t x, int s) { return (x >> s) | (x << ((64 - s) & 63)); }
DISTPOW_HD uint64_t rotl64(uint64_t x, int s) { return (x << s) | (x >> ((64 - s) & 63)); }

// Integer work on the FMA pipe.  An SM retires 64 thread results a clock of
// the ALU pipe (LOP3, SHF, IADD3, LEA, ISETP, SEL, PRMT) and, besides, 64 of
// IMAD and VIADD on the FMA pipe (python3 -m
// distpow_tpu_torch.tools.pipe_rates); IMAD.HI runs there at half rate.  A
// product with a power of two that ptxas can see becomes a shift or an add
// on the ALU pipe again, so the factors are read from constant memory,
// whose values ptxas does not assume, as an IMAD operand.  On the host the
// same helpers are plain C++.
#if defined(__CUDACC__)
__constant__ uint32_t kPow2[32] = {
    0x1u, 0x2u, 0x4u, 0x8u, 0x10u, 0x20u, 0x40u, 0x80u, 0x100u, 0x200u, 0x400u,
    0x800u, 0x1000u, 0x2000u, 0x4000u, 0x8000u, 0x10000u, 0x20000u, 0x40000u, 0x80000u,
    0x100000u, 0x200000u, 0x400000u, 0x800000u, 0x1000000u, 0x2000000u, 0x4000000u,
    0x8000000u, 0x10000000u, 0x20000000u, 0x40000000u, 0x80000000u};
#endif

// x + y as one IMAD, x * 1 + y
DISTPOW_HD uint32_t add_fma(uint32_t x, uint32_t y) {
#if defined(__CUDA_ARCH__)
  return x * kPow2[0] + y;
#else
  return x + y;
#endif
}

// x >> s for 0 < s < 32 as one IMAD.HI, the high word of x * 2^(32 - s)
DISTPOW_HD uint32_t shr_fma(uint32_t x, int s) {
#if defined(__CUDA_ARCH__)
  return __umulhi(x, kPow2[32 - s]);
#else
  return x >> s;
#endif
}

DISTPOW_HD uint32_t bswap32(uint32_t x) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// The variable bytes of a candidate are one contiguous run in the tail:
// the thread byte, then chunk bytes 0..width-1.  The run spans the message
// words L.var_word and L.var_word + 1, counted over the tail's message
// words alone (BLOCK_WORDS per block, no parameter words), so the second
// word is the next block's first where the run crosses the boundary.
// L.var_shift is the thread byte's bit shift
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

// Does hash H ask for H::MIN_BLOCKS_PER_SM resident blocks per SM?  Its
// kernel then tells ptxas so (__launch_bounds__), which caps its registers
// at 65536 / (256 * blocks); the other hashes' kernels keep the bare
// __launch_bounds__(256), under which ptxas allocates as before.
template <class H, class = void>
struct AsksResidentBlocks : std::false_type {};
template <class H>
struct AsksResidentBlocks<H, std::void_t<decltype(H::MIN_BLOCKS_PER_SM)>> : std::true_type {};

// Is hash H built for one tail layout, its run's first message word
// H::VAR_WORD a compile-time key (md5.cuh's Md5<VW>)?  Its kernels then
// take the hash's own candidate body: H::Tail<N_BLOCKS> made once per
// thread before the candidate loop, its state<MW> once per candidate.
template <class H, class = void>
struct KeyedByVarWord : std::false_type {};
template <class H>
struct KeyedByVarWord<H, std::void_t<decltype(H::VAR_WORD)>> : std::true_type {};

// Is there a kernel of hash H for tails of n_blocks blocks?  Every tail
// length but where a hash built for one layout says otherwise.
template <class H>
constexpr bool builds_tail(int n_blocks) {
  if constexpr (KeyedByVarWord<H>::value) return H::builds(n_blocks);
  else return true;
}

// Word i of a launch operand (the prefix state, the tail's rows).  They are
// loop invariants, so the compiler keeps them in registers across the
// grid-stride loop (sha3_256's 84 words took 172 registers).  A hash that
// asks for resident blocks reads them anew for every candidate instead, a
// volatile read from shared memory, one LDS a word.
template <class H>
DISTPOW_HD uint32_t operand(const uint32_t* p, int i) {
  if constexpr (AsksResidentBlocks<H>::value) return static_cast<const volatile uint32_t*>(p)[i];
  else return p[i];
}

// ORs the run's words first and second into words k and k + 1 of a
// BLOCK-word block: k = -1 is a run that started in the block before (only
// second lands, in word 0), k = BLOCK - 1 one that goes on into the next
// (only first lands), any other k outside 0..BLOCK - 2 misses the block.
#define DISTPOW_PLACE(K) \
  case K: m[K] |= first; m[K + 1] |= second; break;
DISTPOW_HD void place_run16(int k, uint32_t first, uint32_t second, uint32_t* m) {
  switch (k) {
    case -1: m[0] |= second; break;
    DISTPOW_PLACE(0) DISTPOW_PLACE(1) DISTPOW_PLACE(2) DISTPOW_PLACE(3) DISTPOW_PLACE(4)
    DISTPOW_PLACE(5) DISTPOW_PLACE(6) DISTPOW_PLACE(7) DISTPOW_PLACE(8) DISTPOW_PLACE(9)
    DISTPOW_PLACE(10) DISTPOW_PLACE(11) DISTPOW_PLACE(12) DISTPOW_PLACE(13) DISTPOW_PLACE(14)
    case 15: m[15] |= first; break;
    default: break;
  }
}

DISTPOW_HD void place_run32(int k, uint32_t first, uint32_t second, uint32_t* m) {
  switch (k) {
    case -1: m[0] |= second; break;
    DISTPOW_PLACE(0) DISTPOW_PLACE(1) DISTPOW_PLACE(2) DISTPOW_PLACE(3) DISTPOW_PLACE(4)
    DISTPOW_PLACE(5) DISTPOW_PLACE(6) DISTPOW_PLACE(7) DISTPOW_PLACE(8) DISTPOW_PLACE(9)
    DISTPOW_PLACE(10) DISTPOW_PLACE(11) DISTPOW_PLACE(12) DISTPOW_PLACE(13) DISTPOW_PLACE(14)
    DISTPOW_PLACE(15) DISTPOW_PLACE(16) DISTPOW_PLACE(17) DISTPOW_PLACE(18) DISTPOW_PLACE(19)
    DISTPOW_PLACE(20) DISTPOW_PLACE(21) DISTPOW_PLACE(22) DISTPOW_PLACE(23) DISTPOW_PLACE(24)
    DISTPOW_PLACE(25) DISTPOW_PLACE(26) DISTPOW_PLACE(27) DISTPOW_PLACE(28) DISTPOW_PLACE(29)
    DISTPOW_PLACE(30)
    case 31: m[31] |= first; break;
    default: break;
  }
}
#undef DISTPOW_PLACE

// The row of tail block blk: the constant words, with the variable bits
// ORed into the run's two message words.  A per-word select against the
// runtime var_word costs two ISETP and two SEL a message word a candidate,
// all on the ALU pipe (64 a 16-word block, about 98 a 32-word one), so a
// 16- or 32-word row is read anew for every candidate (volatile LDS, so no
// register copy of it has to be restored) and the two words are ORed in
// with one switch on var_word, which is the same in every thread: ptxas
// makes it a short compare tree and a jump table, no divergence, a few
// instructions a candidate.  sha3_256's 34-word rows keep the selects.
template <class H>
DISTPOW_HD void message_block(const uint32_t* base, const Layout& L, uint32_t first,
                              uint32_t second, int blk, uint32_t m[H::ROW_WORDS]) {
  if constexpr (H::BLOCK_WORDS == 16 || H::BLOCK_WORDS == 32) {
    DISTPOW_UNROLL
    for (int w = 0; w < H::ROW_WORDS; ++w)
      m[w] = static_cast<const volatile uint32_t*>(base)[blk * H::ROW_WORDS + w];
    if constexpr (H::BLOCK_WORDS == 32)
      place_run32(L.var_word - blk * H::BLOCK_WORDS, first, second, m);
    else
      place_run16(L.var_word - blk * H::BLOCK_WORDS, first, second, m);
  } else {
    DISTPOW_UNROLL
    for (int w = 0; w < H::ROW_WORDS; ++w) {
      const int word = blk * H::BLOCK_WORDS + w;
      m[w] = operand<H>(base, blk * H::ROW_WORDS + w);
      if (w < H::BLOCK_WORDS)
        m[w] |= (word == L.var_word ? first : 0u) | (word == L.var_word + 1 ? second : 0u);
    }
  }
}

// The state after the N_BLOCKS tail blocks of candidate (tb, chunk), of
// which the MASK_WORDS trailing digest words are defined.  init holds the
// absorbed prefix state, base[ROW_WORDS * N_BLOCKS] the tail's rows.
template <class H, int MASK_WORDS, int N_BLOCKS>
DISTPOW_HD void hash_tail_state(const uint32_t* init, const uint32_t* base, const Layout& L,
                                uint32_t tb, uint32_t chunk, uint32_t st[H::STATE_WORDS]) {
  uint32_t first, second, m[H::ROW_WORDS];
  var_words<H::BIG_ENDIAN_WORDS>(L, tb, chunk, first, second);
  DISTPOW_UNROLL
  for (int i = 0; i < H::STATE_WORDS; ++i) st[i] = operand<H>(init, i);
  if constexpr (N_BLOCKS == 2) {
    message_block<H>(base, L, first, second, 0, m);
    H::block(st, m);
  }
  message_block<H>(base, L, first, second, N_BLOCKS - 1, m);
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

// The same test for a hash built for one tail layout: tail holds the
// launch's constants as H::Tail made them.
template <class H, int MASK_WORDS, int N_BLOCKS>
DISTPOW_HD bool keyed_candidate_hits(const typename H::template Tail<N_BLOCKS>& tail,
                                     const uint32_t* masks, const Layout& L, uint32_t tb,
                                     uint32_t chunk) {
  uint32_t st[H::STATE_WORDS];
  tail.template state<MASK_WORDS>(L, tb, chunk, st);
  uint32_t acc = 0;
  DISTPOW_UNROLL
  for (int j = 0; j < MASK_WORDS; ++j) acc |= st[H::DIGEST_WORDS - MASK_WORDS + j] & masks[j];
  return acc == 0;
}

}  // namespace distpow

#if defined(__CUDACC__)
namespace distpow {

// The kernels' min across the grid, after each thread's first hit: per warp
// (__reduce_min_sync), then one atomicMin per block into *out, which the
// wrapper set to SENTINEL on the same stream before the launch.  Every
// thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ void block_min_to(uint32_t best, uint32_t* out) {
  __shared__ uint32_t warp_min[THREADS / 32];
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m = warp_min[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) m = min(m, warp_min[w]);
    if (m != SENTINEL) atomicMin(out, m);
  }
}

// The host side of every solo and mesh search's C function: calls
// launch(MW, NB, POW2), each a std::integral_constant, at the kernel keys
// of a launch of n flat indices: mask_words 1-4 or H::DIGEST_WORDS,
// n_blocks 1 or 2 (where builds_tail), a power-of-two run or not.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// configuration no kernel was built for.
template <class H, class Launch>
int launch_keyed(int mask_words, int n_blocks, bool pow2, uint32_t n, Launch launch) {
  constexpr int FULL = H::DIGEST_WORDS;
  if (n == 0) return 0;
  auto at_mw = [&](auto nb) {
    if constexpr (!builds_tail<H>(decltype(nb)::value)) {
      return false;
    } else {
      auto go = [&](auto mw) {
        if (pow2) launch(mw, nb, std::true_type{});
        else launch(mw, nb, std::false_type{});
        return true;
      };
      if (mask_words == FULL) return go(std::integral_constant<int, FULL>{});
      switch (mask_words) {
        case 1: return go(std::integral_constant<int, 1>{});
        case 2: return go(std::integral_constant<int, 2>{});
        case 3: return go(std::integral_constant<int, 3>{});
        case 4: return go(std::integral_constant<int, 4>{});
        default: return false;
      }
    }
  };
  const bool built = n_blocks == 1   ? at_mw(std::integral_constant<int, 1>{})
                     : n_blocks == 2 ? at_mw(std::integral_constant<int, 2>{})
                                     : false;
  if (!built) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The host side of every group search's C function: checks the group's
// configuration, then calls launch(std::integral_constant<int, N_BLOCKS>,
// grid) with the (grid_x, n_slots) grid.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a configuration no kernel was built for.
template <class H, class Launch>
int launch_group(int n_blocks, int n_slots, uint32_t batch, int grid_x, Launch launch) {
  if (n_slots == 0 || batch == 0) return 0;
  if ((n_blocks != 1 && n_blocks != 2) || !(n_blocks == 1 ? builds_tail<H>(1) : builds_tail<H>(2)) ||
      n_slots < 0 || n_slots > 65535 || grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, n_slots);
  if (n_blocks == 1) {
    if constexpr (builds_tail<H>(1)) launch(std::integral_constant<int, 1>{}, grid);
  } else {
    if constexpr (builds_tail<H>(2)) launch(std::integral_constant<int, 2>{}, grid);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel, over any hash H.
// * One candidate per thread per iteration of a grid-stride loop over the
//   launch's n < 2^31 flat indices; a thread stops at its first hit, which
//   is its own minimum.
// * MASK_WORDS (1-4 or the full digest: the wrapper pads wider masks with
//   leading zero words, which every candidate passes), N_BLOCKS and POW2
//   are template keys, so the rounds that feed only unread digest words are
//   dead code; the layout is a runtime argument, but for a hash built for
//   one var_word (md5.cuh's Md5<VW>), whose var_word is a key too.
// * The launch's prefix state and constant rows are loop invariants that
//   every thread reads at the same index.  They sit in shared memory,
//   loaded once per block, where a read is a broadcast.  Copied into
//   registers instead (ptxas for sm_90a), SHA3-256's one-block kernels
//   spill 200-224 bytes at 128 registers and sha512's and sha384's
//   two-block ones 224-296 bytes; from shared memory no one-block kernel
//   spills at mask words 1-4, and the 32-bit hashes take 32-58 registers
//   instead of 56-98 (but see operand() above).
// * The min across the grid: per thread, per warp (__reduce_min_sync), then
//   one atomicMin per block into a cell the wrapper set to SENTINEL on the
//   same stream.
// * The persistent form (hash_persistent_kernel, Persist) is the same body
//   with a stop flag, a kernel of its own so that the serial loop stays as
//   it was (one check inside it cost md5's serial launch 7 %): a hit goes
//   into the cell at once, and each thread stops once a segment's check
//   finds a hit below its next index or the search's flag set, so a launch
//   ends about one segment after its first hit, and a launch still queued
//   when the driver sets the flag within one segment.  A launch expected
//   to hold a hit runs on one resident wave (resident_grid), so that the
//   threads reach the hit in index order.  The check costs md5's loop, the
//   shortest, about 6 % and the others about 2 %.
// What bounds it is instruction issue: a candidate reads no device memory.
constexpr int HASH_BLOCK_THREADS = 256;

// A word that other threads, launches or the host's copy engine change
// while the kernel runs: a relaxed load at GPU scope (from L2, never from
// L1), which the compiler neither hoists out of the loop nor merges.
__device__ __forceinline__ uint32_t live_word(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// A persistent thread's check before the candidate it reports as g, on the
// cell and flag as it read them: true if it stops (persistent_step).  The
// loads stall the warp for their latency once a segment; loads issued a
// check ahead, a countdown of iterations, a check after the hash test or
// in the same branch measured no faster (md5, sha1; PERF.md §6).
__device__ __forceinline__ bool persistent_stops(const Persist& P, uint32_t* out, uint32_t cell,
                                                 uint32_t stop, uint32_t g) {
  const int step = persistent_step(cell, stop, g);
  if (step == kStopped) atomicMin(out + 1, g / P.seg);
  return step != kTest;
}

// A persistent thread's hit, published at once, so that the others stop at
// their next check.
__device__ __forceinline__ void persistent_hit(const Persist& P, uint32_t* out, uint32_t g) {
  atomicMin(out, g);
  atomicMin(out + 1, g / P.seg + 1);
}

// The index a thread reports for candidate f = (tb, chunk): the flat index
// itself (solo), or the partition's (a mesh shard).
struct FlatIndex {
  DISTPOW_HD uint32_t operator()(uint32_t f, uint32_t, uint32_t) const { return f; }
};
struct PartitionIndex {
  MeshOrigin o;
  DISTPOW_HD uint32_t operator()(uint32_t, uint32_t tb, uint32_t chunk) const {
    return origin_index(o, tb, chunk);
  }
};

// The thread's first hitting flat index in its grid-stride loop, or SENTINEL.
// In the persistent form (PERSISTENT) the thread checks the cell and the
// flag where persistent_due says, about once a segment of its own loop, and
// publishes a hit into out at once (report gives the index out holds).  A
// check keeps no state in the loop, so md5's per-thread table keeps its
// registers.  The serial form compiles none of it, so its loop is the one
// it was before the persistent form.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, bool PERSISTENT, class Report>
__device__ __forceinline__ uint32_t thread_first_hit(const uint32_t* init, const uint32_t* base,
                                                     const uint32_t* masks, const Layout& L,
                                                     uint32_t n, const Persist& P,
                                                     uint32_t* out, Report report) {
  const uint32_t stride = gridDim.x * blockDim.x;
  // one hash per iteration, so the loop body in the SASS is one candidate's
  // work: chip_smoke.py counts it beside the bound
  if constexpr (KeyedByVarWord<H>::value) {
    // the launch's constants, once per thread
    const typename H::template Tail<N_BLOCKS> tail(init, base);
#pragma unroll 1
    for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < n; f += stride) {
      uint32_t tb, chunk;
      decode<POW2>(L, f, tb, chunk);
      if constexpr (PERSISTENT) {
        if (persistent_due(f, P.period_mask, stride) &&
            persistent_stops(P, out, live_word(out), live_word(P.stop), report(f, tb, chunk)))
          return SENTINEL;
      }
      if (keyed_candidate_hits<H, MASK_WORDS, N_BLOCKS>(tail, masks, L, tb, chunk)) {
        if constexpr (PERSISTENT) persistent_hit(P, out, report(f, tb, chunk));
        return f;
      }
    }
    return SENTINEL;
  } else {
#pragma unroll 1
    for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < n; f += stride) {
      uint32_t tb, chunk;
      decode<POW2>(L, f, tb, chunk);
      if constexpr (PERSISTENT) {
        if (persistent_due(f, P.period_mask, stride) &&
            persistent_stops(P, out, live_word(out), live_word(P.stop), report(f, tb, chunk)))
          return SENTINEL;
      }
      if (hash_candidate_hits<H, MASK_WORDS, N_BLOCKS>(init, base, masks, L, tb, chunk)) {
        if constexpr (PERSISTENT) persistent_hit(P, out, report(f, tb, chunk));
        return f;
      }
    }
    return SENTINEL;
  }
}

// A thread's first hit in one block's search, the launch's operands loaded
// into shared memory first: the body of the solo, group and mesh kernels.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, bool PERSISTENT = false,
          class Report = FlatIndex>
__device__ __forceinline__ uint32_t hash_block_first_hit(const uint32_t* __restrict__ init_g,
                                                         const uint32_t* __restrict__ base_g,
                                                         const uint32_t* __restrict__ masks_g,
                                                         const Layout& L, uint32_t n,
                                                         const Persist& P = Persist{},
                                                         uint32_t* out = nullptr,
                                                         Report report = Report{}) {
  constexpr int BASE_WORDS = H::ROW_WORDS * N_BLOCKS;
  uint32_t masks[MASK_WORDS];
#pragma unroll
  for (int i = 0; i < MASK_WORDS; ++i) masks[i] = __ldg(masks_g + i);

  __shared__ uint32_t init[H::STATE_WORDS], base[BASE_WORDS];
  for (int i = threadIdx.x; i < H::STATE_WORDS; i += blockDim.x) init[i] = init_g[i];
  for (int i = threadIdx.x; i < BASE_WORDS; i += blockDim.x) base[i] = base_g[i];
  __syncthreads();
  return thread_first_hit<H, MASK_WORDS, N_BLOCKS, POW2, PERSISTENT>(init, base, masks, L, n, P,
                                                                     out, report);
}

// The kernels' body, one block's search, serial or persistent.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, bool PERSISTENT = false>
__device__ __forceinline__ void hash_search_block(const uint32_t* __restrict__ init_g,
                                                  const uint32_t* __restrict__ base_g,
                                                  const uint32_t* __restrict__ masks_g,
                                                  const Layout& L, uint32_t n,
                                                  uint32_t* __restrict__ out,
                                                  const Persist& P = Persist{}) {
  block_min_to<HASH_BLOCK_THREADS>(
      hash_block_first_hit<H, MASK_WORDS, N_BLOCKS, POW2, PERSISTENT>(init_g, base_g, masks_g, L,
                                                                      n, P, out),
      out);
}

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_search_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                   const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                   uint32_t* __restrict__ out) {
  hash_search_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n, out);
}

// The same kernel for a hash that asks for H::MIN_BLOCKS_PER_SM blocks.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_search_kernel(const uint32_t* __restrict__ init_g,
                            const uint32_t* __restrict__ base_g,
                            const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                            uint32_t* __restrict__ out) {
  hash_search_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n, out);
}

// The persistent form of the solo kernel (Persist), and its resident twin.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_persistent_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                       const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                       uint32_t* __restrict__ out, Persist P) {
  hash_search_block<H, MASK_WORDS, N_BLOCKS, POW2, true>(init_g, base_g, masks_g, L, n, out, P);
}

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_persistent_kernel(const uint32_t* __restrict__ init_g,
                                const uint32_t* __restrict__ base_g,
                                const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                                uint32_t* __restrict__ out, Persist P) {
  hash_search_block<H, MASK_WORDS, N_BLOCKS, POW2, true>(init_g, base_g, masks_g, L, n, out, P);
}

// One resident wave of kernel: the blocks of HASH_BLOCK_THREADS that the
// current device's SMs hold at once, and no more than n flat indices fill.
// In one wave a thread's grid-stride loop walks the launch in index order
// beside every other thread's, so a published hit stops the whole launch
// near the hit's position; with several waves the blocks of a later wave
// start only once an earlier wave has swept the launch.  0 where the
// device cannot be asked (the launch then fails).
template <class Kernel>
int resident_grid(Kernel kernel, uint32_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, HASH_BLOCK_THREADS, 0) !=
          cudaSuccess)
    return 0;
  const long long blocks =
      (static_cast<long long>(n) + HASH_BLOCK_THREADS - 1) / HASH_BLOCK_THREADS;
  const long long wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<int>(blocks < wave ? blocks : wave);
}

// A persistent kernel's launch over n flat indices: grid blocks, or where
// grid <= 0 one resident wave (resident_grid); P's check period is set for
// the grid it runs on.  args are the kernel's arguments before P.
template <class Kernel, class... Args>
void launch_persistent(Kernel kernel, uint32_t n, int grid, cudaStream_t stream, Persist P,
                       Args... args) {
  if (grid <= 0) grid = resident_grid(kernel, n);
  P.period_mask =
      persistent_period_mask(P.batch, static_cast<uint32_t>(grid) * HASH_BLOCK_THREADS);
  kernel<<<grid, HASH_BLOCK_THREADS, 0, stream>>>(args..., P);
}

// The solo kernel's launch, serial or (PERSISTENT) persistent: two
// kernels, so that the serial one compiles to the loop it had before the
// persistent form.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, bool PERSISTENT = false>
void launch_search_kernel(const uint32_t* init, const uint32_t* base, const uint32_t* masks,
                          const Layout& L, uint32_t n, uint32_t* out, int grid,
                          cudaStream_t stream, const Persist& P = Persist{}) {
  if constexpr (PERSISTENT && AsksResidentBlocks<H>::value) {
    launch_persistent(resident_hash_persistent_kernel<H, MASK_WORDS, N_BLOCKS, POW2>, n, grid,
                      stream, P, init, base, masks, L, n, out);
  } else if constexpr (PERSISTENT) {
    launch_persistent(hash_persistent_kernel<H, MASK_WORDS, N_BLOCKS, POW2>, n, grid, stream, P,
                      init, base, masks, L, n, out);
  } else if constexpr (AsksResidentBlocks<H>::value) {
    resident_hash_search_kernel<H, MASK_WORDS, N_BLOCKS, POW2>
        <<<grid, HASH_BLOCK_THREADS, 0, stream>>>(init, base, masks, L, n, out);
  } else {
    hash_search_kernel<H, MASK_WORDS, N_BLOCKS, POW2>
        <<<grid, HASH_BLOCK_THREADS, 0, stream>>>(init, base, masks, L, n, out);
  }
}

// The scheduler's kernel: the search of a group of slots in one launch.
// Replaces distpow_tpu/sched/lanes.py build_pallas_group_step, which
// launched _dyn_pallas_step once per slot under one jit.  blockIdx.y is the
// slot; each slot searches its flat indices [0, batch) with its own prefix
// state, rows, masks of every digest word (so slots at any difficulty share
// the launch), power-of-two run and cursor (slot_layout), and its first hit
// goes to out[s], which the wrapper set to SENTINEL on the same stream.
// The tail layout (N_BLOCKS, var_word, var_shift, chunk_mask) is the
// group's.  Each block is hash_search_block at MASK_WORDS = DIGEST_WORDS
// and POW2, the solo kernel's full-digest specialization.
#define DISTPOW_GROUP_PARAMS                                                                  \
  const uint32_t *__restrict__ init_g, const uint32_t *__restrict__ base_g,                   \
      const uint32_t *__restrict__ masks_g, const uint32_t *__restrict__ tb_lo,               \
      const uint32_t *__restrict__ log_tbc, const uint32_t *__restrict__ chunk0, int var_word, \
      int var_shift, uint32_t chunk_mask, uint32_t batch, uint32_t *__restrict__ out
#define DISTPOW_GROUP_ARGS \
  init_g, base_g, masks_g, tb_lo, log_tbc, chunk0, var_word, var_shift, chunk_mask, batch, out

template <class H, int N_BLOCKS>
__device__ __forceinline__ void hash_group_search_slot(DISTPOW_GROUP_PARAMS) {
  const int s = blockIdx.y;
  const Layout L = slot_layout(__ldg(chunk0 + s), __ldg(tb_lo + s), __ldg(log_tbc + s), var_word,
                               var_shift, chunk_mask);
  hash_search_block<H, H::DIGEST_WORDS, N_BLOCKS, true>(
      init_g + s * H::STATE_WORDS, base_g + s * H::ROW_WORDS * N_BLOCKS,
      masks_g + s * H::DIGEST_WORDS, L, batch, out + s);
}

template <class H, int N_BLOCKS>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_group_search_kernel(DISTPOW_GROUP_PARAMS) {
  hash_group_search_slot<H, N_BLOCKS>(DISTPOW_GROUP_ARGS);
}

// The same kernel for a hash that asks for H::MIN_BLOCKS_PER_SM blocks.
template <class H, int N_BLOCKS>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_group_search_kernel(DISTPOW_GROUP_PARAMS) {
  hash_group_search_slot<H, N_BLOCKS>(DISTPOW_GROUP_ARGS);
}

template <class H, int N_BLOCKS>
void launch_group_kernel(dim3 grid, cudaStream_t stream, DISTPOW_GROUP_PARAMS) {
  if constexpr (AsksResidentBlocks<H>::value) {
    resident_hash_group_search_kernel<H, N_BLOCKS>
        <<<grid, HASH_BLOCK_THREADS, 0, stream>>>(DISTPOW_GROUP_ARGS);
  } else {
    hash_group_search_kernel<H, N_BLOCKS>
        <<<grid, HASH_BLOCK_THREADS, 0, stream>>>(DISTPOW_GROUP_ARGS);
  }
}

// The body of each kernel's second extern "C" function, the group search.
// init[n_slots][STATE_WORDS], base[n_slots][ROW_WORDS * n_blocks],
// masks[n_slots][DIGEST_WORDS], tb_lo, log_tbc, chunk0 and out[n_slots]
// are device arrays; out already holds SENTINEL.  The grid is (grid_x,
// n_slots).  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// configuration no kernel was built for.
template <class H>
int launch_hash_group_search(const void* init, const void* base, const void* masks,
                             int n_blocks, int var_word, int var_shift, uint32_t chunk_mask,
                             const void* tb_lo, const void* log_tbc, const void* chunk0,
                             int n_slots, uint32_t batch, void* out, int grid_x, void* stream) {
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return launch_group<H>(n_blocks, n_slots, batch, grid_x, [&](auto n_blk, dim3 grid) {
    launch_group_kernel<H, decltype(n_blk)::value>(
        grid, static_cast<cudaStream_t>(stream), u(init), u(base), u(masks), u(tb_lo),
        u(log_tbc), u(chunk0), var_word, var_shift, chunk_mask, batch,
        static_cast<uint32_t*>(out));
  });
}
#undef DISTPOW_GROUP_ARGS
#undef DISTPOW_GROUP_PARAMS

// The mesh kernel: one shard's launch of a search spread over a mesh of
// devices (replaces distpow_tpu/parallel/mesh_search.py
// _dyn_pallas_mesh_step, which ran _dyn_pallas_step on every device of a
// jax Mesh and took lax.pmin of the partition indices).  Each block is the
// solo kernel's body over the shard's slice L of the partition o (a run of
// thread bytes, or a span of chunks: n flat indices); each thread's first
// hit becomes the partition's flat index (mesh_global_index)
// before the block min, so the least value across the shards' cells is
// the partition's first hit.  The loop is the solo kernel's: the remap
// runs once per thread, after it.  In the persistent form each shard's
// threads check and publish against the shard's own cell in partition
// indices, which grow with the flat index within a shard, so the rule of
// persistent_step keeps each shard's least index.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, bool PERSISTENT = false>
__device__ __forceinline__ void hash_mesh_block(const uint32_t* __restrict__ init_g,
                                                const uint32_t* __restrict__ base_g,
                                                const uint32_t* __restrict__ masks_g,
                                                const Layout& L, const MeshOrigin& o, uint32_t n,
                                                uint32_t* __restrict__ out,
                                                const Persist& P = Persist{}) {
  block_min_to<HASH_BLOCK_THREADS>(
      mesh_global_index<POW2>(L, o,
                              hash_block_first_hit<H, MASK_WORDS, N_BLOCKS, POW2, PERSISTENT>(
                                  init_g, base_g, masks_g, L, n, P, out, PartitionIndex{o})),
      out);
}

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_mesh_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                 const uint32_t* __restrict__ masks_g, Layout L, MeshOrigin o, uint32_t n,
                 uint32_t* __restrict__ out) {
  hash_mesh_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, o, n, out);
}

// The same kernel for a hash that asks for H::MIN_BLOCKS_PER_SM blocks.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_mesh_kernel(const uint32_t* __restrict__ init_g,
                          const uint32_t* __restrict__ base_g,
                          const uint32_t* __restrict__ masks_g, Layout L, MeshOrigin o,
                          uint32_t n, uint32_t* __restrict__ out) {
  hash_mesh_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, o, n, out);
}

// The persistent form of the mesh kernel (Persist), and its resident twin.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_mesh_persistent_kernel(const uint32_t* __restrict__ init_g,
                            const uint32_t* __restrict__ base_g,
                            const uint32_t* __restrict__ masks_g, Layout L, MeshOrigin o,
                            uint32_t n, uint32_t* __restrict__ out, Persist P) {
  hash_mesh_block<H, MASK_WORDS, N_BLOCKS, POW2, true>(init_g, base_g, masks_g, L, o, n, out, P);
}

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_mesh_persistent_kernel(const uint32_t* __restrict__ init_g,
                                     const uint32_t* __restrict__ base_g,
                                     const uint32_t* __restrict__ masks_g, Layout L,
                                     MeshOrigin o, uint32_t n, uint32_t* __restrict__ out,
                                     Persist P) {
  hash_mesh_block<H, MASK_WORDS, N_BLOCKS, POW2, true>(init_g, base_g, masks_g, L, o, n, out, P);
}

// The body of each kernel's extern "C" launcher (the *_search.cu files).
// init[STATE_WORDS], base[ROW_WORDS * n_blocks] and masks[mask_words] are
// device arrays; out is the device result cell, already holding SENTINEL.
// var_word counts message words only (var_words above).
// n_blocks is 1 or 2, mask_words 1-4 or DIGEST_WORDS, log_tbc = log2(tbc)
// or -1 when tbc is not a power of two.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a configuration no kernel was built for.  P is
// the persistent form's (DISTPOW_PERSISTENT_FUNCTIONS); the default is the
// serial one.
template <class H>
int launch_hash_search(const void* init, const void* base, const void* masks, int n_blocks,
                       int mask_words, uint32_t chunk0, uint32_t tb_lo, uint32_t tbc,
                       int log_tbc, int var_word, int var_shift, uint32_t chunk_mask,
                       uint32_t n, void* out, int grid, void* stream,
                       const Persist& P = Persist{}) {
  const Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  return launch_keyed<H>(mask_words, n_blocks, log_tbc >= 0, n,
                         [&](auto mw, auto nb, auto pow2) {
    constexpr int MW = decltype(mw)::value, NB = decltype(nb)::value;
    constexpr bool P2 = decltype(pow2)::value;
    auto cell = static_cast<uint32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (P.stop != nullptr)
      launch_search_kernel<H, MW, NB, P2, true>(u(init), u(base), u(masks), L, n, cell, grid, s, P);
    else
      launch_search_kernel<H, MW, NB, P2>(u(init), u(base), u(masks), L, n, cell, grid, s);
  });
}

// The body of each kernel's third extern "C" function, one shard's launch
// of a mesh search: the shard's run tb_lo .. tb_lo + tbc - 1 from cursor
// chunk0 over flat indices [0, n), its first hit written to out as the
// flat index of the partition whose cursor is origin_chunk0 and whose run
// is origin_tbc thread bytes from origin_tb_lo.  The other arguments are
// launch_hash_search's.
template <class H>
int launch_hash_mesh_search(const void* init, const void* base, const void* masks,
                            int n_blocks, int mask_words, uint32_t chunk0, uint32_t tb_lo,
                            uint32_t tbc, int log_tbc, int var_word, int var_shift,
                            uint32_t chunk_mask, uint32_t n, uint32_t origin_chunk0,
                            uint32_t origin_tb_lo, uint32_t origin_tbc, void* out, int grid,
                            void* stream, const Persist& P = Persist{}) {
  const Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  const MeshOrigin o{origin_chunk0, origin_tb_lo, origin_tbc};
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  auto cell = static_cast<uint32_t*>(out);
  return launch_keyed<H>(mask_words, n_blocks, log_tbc >= 0, n,
                         [&](auto mw, auto nb, auto pow2) {
    constexpr int MW = decltype(mw)::value, NB = decltype(nb)::value;
    constexpr bool P2 = decltype(pow2)::value;
    constexpr bool RESIDENT = AsksResidentBlocks<H>::value;
    if (P.stop != nullptr) {
      if constexpr (RESIDENT)
        launch_persistent(resident_hash_mesh_persistent_kernel<H, MW, NB, P2>, n, grid, s, P,
                          u(init), u(base), u(masks), L, o, n, cell);
      else
        launch_persistent(hash_mesh_persistent_kernel<H, MW, NB, P2>, n, grid, s, P, u(init),
                          u(base), u(masks), L, o, n, cell);
    } else if constexpr (RESIDENT) {
      resident_hash_mesh_kernel<H, MW, NB, P2>
          <<<grid, HASH_BLOCK_THREADS, 0, s>>>(u(init), u(base), u(masks), L, o, n, cell);
    } else {
      hash_mesh_kernel<H, MW, NB, P2>
          <<<grid, HASH_BLOCK_THREADS, 0, s>>>(u(init), u(base), u(masks), L, o, n, cell);
    }
  });
}

// The persistent form's Persist from the C functions' arguments: the
// search's stop flag, the segment in reported indices and in the launch's
// flat indices (the check period follows at the launch, from the grid).
// An invalid one (no flag, a zero segment) is reported as a null stop,
// which DISTPOW_PERSISTENT_FUNCTIONS refuses.
inline Persist persistent_form(const void* stop, uint32_t seg, uint32_t batch) {
  if (stop == nullptr || seg == 0 || batch == 0) return Persist{};
  return Persist{static_cast<const uint32_t*>(stop), seg, batch, 0};
}

// The bodies of each kernel's fourth and fifth extern "C" functions, the
// persistent solo launch and the persistent launch of one mesh shard: the
// arguments of launch_hash_search and launch_hash_mesh_search, then the
// search's stop flag (a device word), the segment's size in reported
// indices (seg) and in the launch's flat indices (batch), and the two-word
// out, which the wrapper set to (SENTINEL, the segment count).  A grid <= 0
// launches one resident wave (resident_grid).
#define DISTPOW_PERSISTENT_FUNCTIONS(NAME, H, LAYOUT_OK)                                      \
  extern "C" int distpow_##NAME##_persistent_search(                                          \
      const void* init, const void* base, const void* masks, int n_blocks, int mask_words,    \
      uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word,               \
      int var_shift, uint32_t chunk_mask, uint32_t n, const void* stop, uint32_t seg,         \
      uint32_t batch, void* out, int grid, void* stream) {                                    \
    const distpow::Persist P = distpow::persistent_form(stop, seg, batch);                    \
    if (!(LAYOUT_OK) || P.stop == nullptr) return static_cast<int>(cudaErrorInvalidValue);    \
    return distpow::launch_hash_search<H>(init, base, masks, n_blocks, mask_words, chunk0,    \
                                          tb_lo, tbc, log_tbc, var_word, var_shift,           \
                                          chunk_mask, n, out, grid, stream, P);               \
  }                                                                                           \
  extern "C" int distpow_##NAME##_mesh_persistent_search(                                     \
      const void* init, const void* base, const void* masks, int n_blocks, int mask_words,    \
      uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word,               \
      int var_shift, uint32_t chunk_mask, uint32_t n, uint32_t origin_chunk0,                 \
      uint32_t origin_tb_lo, uint32_t origin_tbc, const void* stop, uint32_t seg,             \
      uint32_t batch, void* out, int grid, void* stream) {                                    \
    const distpow::Persist P = distpow::persistent_form(stop, seg, batch);                    \
    if (!(LAYOUT_OK) || P.stop == nullptr) return static_cast<int>(cudaErrorInvalidValue);    \
    return distpow::launch_hash_mesh_search<H>(init, base, masks, n_blocks, mask_words,       \
                                               chunk0, tb_lo, tbc, log_tbc, var_word,         \
                                               var_shift, chunk_mask, n, origin_chunk0,       \
                                               origin_tb_lo, origin_tbc, out, grid, stream,   \
                                               P);                                            \
  }

}  // namespace distpow
#endif  // __CUDACC__
