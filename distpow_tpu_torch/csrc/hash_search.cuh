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

#include <atomic>
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
// hit's segment + 1; where a block saw the search's stop flag, at most the
// segment of the tile it had claimed (0 when the flag was set before the
// launch); else the launch's segment count, which the wrapper wrote there.
// out[2] is the claim counter, which the wrapper zeroed: the tiles claimed.
//
// Work is handed out in index order.  A block claims the next tile of
// P.rounds * threads consecutive flat indices from the counter (claim c is
// the tile at c * P.rounds * threads), and its thread t tests the tile's
// indices claim_index(base, t, threads, j) for j < P.rounds, in ascending
// order, until its first hit.
struct Persist {
  const uint32_t* stop;  // the search's stop flag, a device word; null: the serial form
  uint32_t seg;          // reported indices per segment
  uint32_t rounds;       // candidates a thread tests of each tile (> 0; launch_rounds)
};

// Index j of thread t's part of the tile of threads * rounds flat indices
// that starts at base.
DISTPOW_HD uint32_t claim_index(uint32_t base, uint32_t t, uint32_t threads, uint32_t j) {
  return base + t + threads * j;
}

// The candidates a thread tests of each tile of a launch of n flat indices
// on `blocks` blocks of `threads`: as many as leave each block at least
// TILES_PER_BLOCK tiles, so that a launch of few tiles a wave still fills
// the wave and stops near its hit, and at least 1; at most `most`, the
// model's (hash_cuda.claim_rounds), which keeps a long launch's claims rare.
constexpr uint32_t TILES_PER_BLOCK = 8;

DISTPOW_HD uint32_t launch_rounds(uint32_t n, uint32_t blocks, uint32_t threads, uint32_t most,
                                  uint32_t tiles_per_block = TILES_PER_BLOCK) {
  const uint64_t r = n / (static_cast<uint64_t>(blocks > 0 ? blocks : 1) * threads *
                          tiles_per_block);
  return r < 1 ? 1 : r > most ? most : static_cast<uint32_t>(r);
}

// What a persistent block does with the tile it claimed, whose first index
// it reports as g, from the launch's cell (out[0]) and the search's flag as
// it read them: test it (kTest); drop it and stop, because the cell holds a
// hit below g (kBelowHit); or stop on the flag (kStopped).  Tiles leave the
// counter in ascending order, the reported index grows with the flat index,
// and the cell only decreases, so a tile is dropped only when every index
// in it lies above a hit already published, and so does every tile claimed
// after it: every index below the least hit is tested, and the least index
// is the serial kernel's.
enum PersistentStep : int { kTest = 0, kBelowHit = 1, kStopped = 2 };

DISTPOW_HD int persistent_step(uint32_t cell, uint32_t stop, uint32_t g) {
  return cell < g ? kBelowHit : stop != 0 ? kStopped : kTest;
}

// The group form's claims (hash_group_search_kernel): each slot of a group
// has a counter of claims, and claim c of a slot is the tile of `tile`
// consecutive flat indices at tile_index(c, tile), saturated at 2^32 - 1,
// which lies past any slot's batch (< 2^31).
DISTPOW_HD uint32_t tile_index(uint32_t c, uint32_t tile) {
  const uint64_t b = static_cast<uint64_t>(c) * tile;
  return b > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<uint32_t>(b);
}

// Does a group block test the tile it claimed at flat index b of a slot of
// batch indices, whose cell it read as cell?  Not where the tile starts past
// the batch, nor above a hit published in the cell (persistent_step, with
// no flag): every index below the slot's least hit is tested.
DISTPOW_HD bool group_tests(uint32_t cell, uint32_t batch, uint32_t b) {
  return b < batch && persistent_step(cell, 0, b) == kTest;
}

// Is a slot open: would the next tile claimed from its counter, which has
// made `claims`, be tested?  A slot that is not open never opens again: its
// counter only grows and its cell only falls.
DISTPOW_HD bool group_slot_open(uint32_t cell, uint32_t claims, uint32_t tile, uint32_t batch) {
  return group_tests(cell, batch, tile_index(claims, tile));
}

// A group block tests one slot: its home slot where that is open, else the
// first open slot after it in turn (open(t) reads slot t's cell and
// counter; -1 when none is), until that slot is no longer open.  The
// kernel reads 32 slots at once and takes the first open one in the same
// order.
DISTPOW_HD int group_home_slot(uint32_t block, int n_slots) {
  return static_cast<int>(block % static_cast<uint32_t>(n_slots));
}

template <class Open>
DISTPOW_HD int group_next_slot(int s, int n_slots, Open open) {
  for (int k = 1; k < n_slots; ++k) {
    const int t = (s + k) % n_slots;
    if (open(t)) return t;
  }
  return -1;
}

// The candidates a thread tests of each tile of a group launch of n flat
// indices in all (n_slots * batch) on one wave of `blocks` blocks:
// launch_rounds at twice the persistent form's tiles a block, and at most
// GROUP_MOST_ROUNDS, so that the launch's last tiles end close together
// whatever the hash's cost (md5's engine launch of 8 x 2^20 takes 2;
// tools/group_variants.py times 1 round beside it).
constexpr uint32_t GROUP_TILES_PER_BLOCK = 16;
constexpr uint32_t GROUP_MOST_ROUNDS = 2;

DISTPOW_HD uint32_t group_rounds(uint64_t n, uint32_t blocks, uint32_t threads, uint32_t most) {
  return launch_rounds(n > 0xFFFFFFFFull ? 0xFFFFFFFFu : static_cast<uint32_t>(n), blocks,
                       threads, most < GROUP_MOST_ROUNDS ? most : GROUP_MOST_ROUNDS,
                       GROUP_TILES_PER_BLOCK);
}

// Candidates a thread tests of each tile claimed in one launch, 1 to
// MAX_ROUNDS: the C functions refuse other values (persistent_form, the
// group launch).
constexpr uint32_t MAX_ROUNDS = 1u << 16;

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
// * The persistent form (hash_persistent_kernel, Persist) tests the same
//   candidates in a kernel of its own, so that the serial loop stays as it
//   was.  Its blocks claim tiles of consecutive flat indices in ascending
//   order (hash_persistent_block), so every block sweeps the launch low to
//   high whatever the number of waves, and it runs on one resident wave
//   (resident_wave), with tiles sized to the launch (launch_rounds).  A hit goes into the cell at once; the cell and the
//   search's flag are read once a tile, at the claim, not in the candidate
//   loop; so a launch ends about one tile after its first hit, and a launch
//   still queued when the driver sets the flag within one tile.
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

// A persistent thread's hit, published at once, so that no block tests a
// tile above it.
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

// The thread's first hitting flat index in its grid-stride loop, or
// SENTINEL: the serial kernels' loop.  Its two candidate tests are
// CandidateTest's (the persistent form's), written out here so that the
// serial loops' SASS stays as it was; a change to one goes into both.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__device__ __forceinline__ uint32_t thread_first_hit(const uint32_t* init, const uint32_t* base,
                                                     const uint32_t* masks, const Layout& L,
                                                     uint32_t n) {
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
      if (keyed_candidate_hits<H, MASK_WORDS, N_BLOCKS>(tail, masks, L, tb, chunk)) return f;
    }
    return SENTINEL;
  } else {
#pragma unroll 1
    for (uint32_t f = blockIdx.x * blockDim.x + threadIdx.x; f < n; f += stride) {
      uint32_t tb, chunk;
      decode<POW2>(L, f, tb, chunk);
      if (hash_candidate_hits<H, MASK_WORDS, N_BLOCKS>(init, base, masks, L, tb, chunk))
        return f;
    }
    return SENTINEL;
  }
}

// A thread's first hit in one block's search, the launch's operands loaded
// into shared memory first: the body of the solo and mesh kernels.
// Report, the index the kernel's cell holds (FlatIndex for the solo
// kernels, PartitionIndex for the mesh kernel), keys the shared
// arrays: the mesh kernels keep arrays of their own, apart from the solo
// kernels'.  ptxas lays out a kernel's shared memory by the arrays of the
// whole module, and with the arrays shared, md5's two-block kernels came
// out 4 instructions longer or shorter.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, class Report = FlatIndex>
__device__ __forceinline__ uint32_t hash_block_first_hit(const uint32_t* __restrict__ init_g,
                                                         const uint32_t* __restrict__ base_g,
                                                         const uint32_t* __restrict__ masks_g,
                                                         const Layout& L, uint32_t n) {
  constexpr int BASE_WORDS = H::ROW_WORDS * N_BLOCKS;
  uint32_t masks[MASK_WORDS];
#pragma unroll
  for (int i = 0; i < MASK_WORDS; ++i) masks[i] = __ldg(masks_g + i);

  __shared__ uint32_t init[H::STATE_WORDS], base[BASE_WORDS];
  for (int i = threadIdx.x; i < H::STATE_WORDS; i += blockDim.x) init[i] = init_g[i];
  for (int i = threadIdx.x; i < BASE_WORDS; i += blockDim.x) base[i] = base_g[i];
  __syncthreads();
  return thread_first_hit<H, MASK_WORDS, N_BLOCKS, POW2>(init, base, masks, L, n);
}

// The kernels' body, one block's search.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__device__ __forceinline__ void hash_search_block(const uint32_t* __restrict__ init_g,
                                                  const uint32_t* __restrict__ base_g,
                                                  const uint32_t* __restrict__ masks_g,
                                                  const Layout& L, uint32_t n,
                                                  uint32_t* __restrict__ out) {
  block_min_to<HASH_BLOCK_THREADS>(
      hash_block_first_hit<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n), out);
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

// The candidate test of the persistent form: for a hash built for one tail
// layout (KEYED) its own body, over the launch's constants made once per
// thread; else the generic one over the rows in shared memory.  The same two
// tests as thread_first_hit's two loops.
template <class H, int MASK_WORDS, int N_BLOCKS, bool KEYED = KeyedByVarWord<H>::value>
struct CandidateTest {
  const uint32_t *init, *base, *masks;
  __device__ __forceinline__ CandidateTest(const uint32_t* init_, const uint32_t* base_,
                                           const uint32_t* masks_)
      : init(init_), base(base_), masks(masks_) {}
  __device__ __forceinline__ bool operator()(const Layout& L, uint32_t tb, uint32_t chunk) const {
    return hash_candidate_hits<H, MASK_WORDS, N_BLOCKS>(init, base, masks, L, tb, chunk);
  }
};

template <class H, int MASK_WORDS, int N_BLOCKS>
struct CandidateTest<H, MASK_WORDS, N_BLOCKS, true> {
  const typename H::template Tail<N_BLOCKS> tail;
  const uint32_t* masks;
  __device__ __forceinline__ CandidateTest(const uint32_t* init, const uint32_t* base,
                                           const uint32_t* masks_)
      : tail(init, base), masks(masks_) {}
  __device__ __forceinline__ bool operator()(const Layout& L, uint32_t tb, uint32_t chunk) const {
    return keyed_candidate_hits<H, MASK_WORDS, N_BLOCKS>(tail, masks, L, tb, chunk);
  }
};

// Thread 0's check of the tile it claimed at flat index b (persistent_step
// on the cell and the flag as it reads them now): b, or SENTINEL where the
// block stops, because the counter has passed the launch's end, the cell
// holds a hit below the tile, or the flag is set (the segment word then
// falls to the tile's segment).
template <bool POW2, class Report>
__device__ __forceinline__ uint32_t persistent_claim(const Persist& P, uint32_t* out,
                                                     const Layout& L, uint32_t n, uint32_t b,
                                                     Report report) {
  const uint32_t cell = live_word(out), stop = live_word(P.stop);
  if (b >= n) return SENTINEL;
  uint32_t tb, chunk;
  decode<POW2>(L, b, tb, chunk);
  const uint32_t g = report(b, tb, chunk);
  const int step = persistent_step(cell, stop, g);
  if (step == kStopped) atomicMin(out + 1, g / P.seg);
  return step == kTest ? b : SENTINEL;
}

// One block of the persistent form: the launch's operands into shared
// memory, then tile after tile of P.rounds candidates a thread.
// * Thread 0 claims the block's next tile with one atomicAdd of 1 on the
//   counter (out[2]) as the block starts the tile before, so that the atomic's
//   latency hides behind that tile; it checks the claim at that tile's end
//   (persistent_claim, with fresh reads of the cell and the flag) and hands
//   its base to the block through shared memory, two slots in turn, so one
//   barrier a tile suffices.
// * Each thread tests its indices of the tile (claim_index) in ascending
//   order.  Tiles leave the counter in ascending order and a tile is
//   dropped only where the cell holds a hit below its base
//   (persistent_step), so every index below the least hit is tested, and
//   the words are the serial kernel's.
// * A thread that has hit tests nothing more, but stays in the loop until
//   its block stops, since every claim takes a barrier of the whole block.
//   Each hit is published at once (persistent_hit), so no block min follows.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2, class Report>
__device__ __forceinline__ void hash_persistent_block(const uint32_t* __restrict__ init_g,
                                                      const uint32_t* __restrict__ base_g,
                                                      const uint32_t* __restrict__ masks_g,
                                                      const Layout& L, uint32_t n,
                                                      uint32_t* __restrict__ out,
                                                      const Persist& P, Report report) {
  constexpr int BASE_WORDS = H::ROW_WORDS * N_BLOCKS;
  uint32_t masks[MASK_WORDS];
#pragma unroll
  for (int i = 0; i < MASK_WORDS; ++i) masks[i] = __ldg(masks_g + i);

  __shared__ uint32_t init[H::STATE_WORDS], base[BASE_WORDS], claimed[2];
  for (int i = threadIdx.x; i < H::STATE_WORDS; i += blockDim.x) init[i] = init_g[i];
  for (int i = threadIdx.x; i < BASE_WORDS; i += blockDim.x) base[i] = base_g[i];
  uint32_t* const counter = out + 2;  // tiles claimed
  const uint32_t tile = P.rounds * HASH_BLOCK_THREADS;
  uint32_t next = 0;  // thread 0's next tile's first index
  // claim * tile < n + grid * tile < 2^32 (launch_persistent)
  if (threadIdx.x == 0) next = atomicAdd(counter, 1u) * tile;
  __syncthreads();
  const CandidateTest<H, MASK_WORDS, N_BLOCKS> hits(init, base, masks);
  bool testing = true;
#pragma unroll 1
  for (int slot = 0;; slot ^= 1) {
    if (threadIdx.x == 0) {
      const uint32_t b = persistent_claim<POW2>(P, out, L, n, next, report);
      claimed[slot] = b;
      if (b != SENTINEL) next = atomicAdd(counter, 1u) * tile;
    }
    __syncthreads();
    const uint32_t b = claimed[slot];
    if (b == SENTINEL) return;
    if (testing) {
      // b + tile < n + grid * tile < 2^32 (launch_persistent)
      const uint32_t end = min(b + tile, n);
      // one hash per iteration, as in the serial loop
#pragma unroll 1
      for (uint32_t f = claim_index(b, threadIdx.x, HASH_BLOCK_THREADS, 0); f < end;
           f += HASH_BLOCK_THREADS) {
        uint32_t tb, chunk;
        decode<POW2>(L, f, tb, chunk);
        if (hits(L, tb, chunk)) {
          persistent_hit(P, out, report(f, tb, chunk));
          testing = false;
          break;
        }
      }
    }
  }
}

// The persistent form of the solo kernel (Persist), and its resident twin.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_persistent_kernel(const uint32_t* __restrict__ init_g, const uint32_t* __restrict__ base_g,
                       const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                       uint32_t* __restrict__ out, Persist P) {
  hash_persistent_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n, out, P,
                                                       FlatIndex{});
}

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_persistent_kernel(const uint32_t* __restrict__ init_g,
                                const uint32_t* __restrict__ base_g,
                                const uint32_t* __restrict__ masks_g, Layout L, uint32_t n,
                                uint32_t* __restrict__ out, Persist P) {
  hash_persistent_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n, out, P,
                                                       FlatIndex{});
}

// One resident wave of kernel: the blocks of HASH_BLOCK_THREADS that the
// current device's SMs hold at once.  0 where the device cannot be asked
// (the launch then fails).
template <class Kernel>
int resident_wave(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, HASH_BLOCK_THREADS, 0) !=
          cudaSuccess)
    return 0;
  return (per_sm > 0 ? per_sm : 1) * sms;
}

// A persistent kernel's launch over n flat indices: grid blocks, or where
// grid <= 0 one resident wave (resident_wave) cut to the launch's tiles.
// The tile takes launch_rounds(n, those blocks, ..., P.rounds) candidates
// a thread.  A block claims at most one tile past the launch's end, so the
// claimed tiles' indices stay below n + grid * tile; the grid is cut so
// that this fits 32 bits.  args are the kernel's arguments before P.
template <class Kernel, class... Args>
void launch_persistent(Kernel kernel, uint32_t n, int grid, cudaStream_t stream, Persist P,
                       Args... args) {
  const int blocks = grid > 0 ? grid : resident_wave(kernel);
  P.rounds = launch_rounds(n, blocks, HASH_BLOCK_THREADS, P.rounds);
  const uint32_t tile = P.rounds * HASH_BLOCK_THREADS;
  if (grid <= 0) {
    const long long tiles = (static_cast<long long>(n) + tile - 1) / tile;
    grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  }
  const unsigned long long room = (0xFFFFFFFFull - n) / tile;
  if (static_cast<unsigned long long>(grid) > room) grid = static_cast<int>(room);
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
// launched _dyn_pallas_step once per slot under one jit.  Each slot s
// searches its flat indices [0, batch) with its own prefix state, rows,
// masks of every digest word (so slots at any difficulty share the
// launch), power-of-two run and cursor (slot_layout); its least hit goes
// to out[s], which the wrapper set to SENTINEL, and out[n_slots + s] counts
// the tiles claimed of it, which the wrapper set to 0.  The tail layout
// (N_BLOCKS, var_word, var_shift, chunk_mask) is the group's, the
// candidate test the solo kernel's at MASK_WORDS = DIGEST_WORDS and POW2
// (CandidateTest).  It claims work as the persistent form does:
// * blocks claim tiles of `rounds` x 256 consecutive flat indices of one
//   slot from the slot's counter, in index order; the rounds are
//   group_rounds over the whole group on one resident wave (group_wave),
//   so that each block of the wave gets GROUP_TILES_PER_BLOCK tiles or more;
// * a tile above the slot's published least hit is dropped (group_tests),
//   so a slot stops about one tile after its first hit, and every index
//   below that hit is tested: the words are the serial kernel's;
// * each block tests one slot: the first open one from its home slot on
//   (group_home_slot, group_slot_open), until it is no longer open, and
//   then ends.  The grid is GROUP_WAVES resident waves (cut to the group's
//   tiles, at least a block a slot): a block that starts as another ends
//   takes the next open slot, so work moves from the slots that are done
//   to those that are not, and the grid's blocks past the first wave that
//   find no open slot end at once;
// * a block loads its slot's operands into shared memory and makes its
//   launch constants once (md5's Md5Tail), outside any loop: with the
//   constants made inside a loop over slots (tools/group_slot_loop.cuh),
//   ptxas recomputes md5's K[i] + m sums every candidate (UIADD3, VIADD)
//   where it keeps them in uniform registers here (tools/group_variants.py
//   builds and times both);
// * no stop flag: the engine cancels at launch boundaries.
constexpr int GROUP_WAVES = 3;

#define DISTPOW_GROUP_PARAMS                                                                  \
  const uint32_t *__restrict__ init_g, const uint32_t *__restrict__ base_g,                   \
      const uint32_t *__restrict__ masks_g, const uint32_t *__restrict__ tb_lo,               \
      const uint32_t *__restrict__ log_tbc, const uint32_t *__restrict__ chunk0, int var_word, \
      int var_shift, uint32_t chunk_mask, int n_slots, uint32_t batch, uint32_t rounds,       \
      uint32_t *__restrict__ out
#define DISTPOW_GROUP_ARGS                                                                  \
  init_g, base_g, masks_g, tb_lo, log_tbc, chunk0, var_word, var_shift, chunk_mask, n_slots, \
      batch, rounds, out

// A tile handed to a group block: its slot and first flat index, or slot
// -1 when no slot is open.
struct GroupTile {
  int slot;
  uint32_t b;
};

// Thread 0's check of the claim it made a tile ahead, claim number `claim`
// of slot s, against the slot's cell as it read it (group_tests): where the
// tile is to be tested, its first flat index, and the next claim is made at
// once; else SENTINEL.  The claim is kept as the counter gave it and turned
// into an index only at its check, so that no instruction waits for the
// atomic before the tile's barrier: its latency hides behind the tile.
__device__ __forceinline__ uint32_t group_claim(int s, uint32_t& claim, uint32_t cell,
                                                uint32_t* out, int n_slots, uint32_t batch,
                                                uint32_t tile) {
  const uint32_t b = tile_index(claim, tile);
  if (!group_tests(cell, batch, b)) return SENTINEL;
  claim = atomicAdd(out + n_slots + s, 1u);
  return b;
}

// Warp 0's choice of a block's slot as the block starts: its home slot
// where that is open, else the first open one after it in turn
// (group_next_slot's order; the warp reads the cells and counters of 32
// slots at once), where lane 0 claims a tile and checks it (group_claim).
// A slot that is not open never opens again, so the loop ends after at
// most n_slots moves.  Returns the tile to test, or slot -1; lane 0 keeps
// its claim ahead in `claim`.
__device__ __forceinline__ GroupTile group_start(uint32_t& claim, uint32_t* out, int n_slots,
                                                 uint32_t batch, uint32_t tile) {
  uint32_t* const counters = out + n_slots;
  const int lane = threadIdx.x & 31;
  int slot = group_home_slot(blockIdx.x, n_slots);
  bool open = group_slot_open(live_word(out + slot), live_word(counters + slot), tile, batch);
#pragma unroll 1
  for (;;) {
    if (open) {
      uint32_t b = SENTINEL;  // a tile to test starts below batch < 2^31
      if (lane == 0) {
        claim = atomicAdd(counters + slot, 1u);
        b = group_claim(slot, claim, live_word(out + slot), out, n_slots, batch, tile);
      }
      b = __shfl_sync(0xFFFFFFFFu, b, 0);
      if (b != SENTINEL) return GroupTile{slot, b};
    }
    int to = -1;
#pragma unroll 1
    for (int k = 1; k < n_slots && to < 0; k += 32) {
      const int i = k + lane, t = (slot + i) % n_slots;
      const bool o = i < n_slots && group_slot_open(live_word(out + t), live_word(counters + t),
                                                    tile, batch);
      const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, o);
      if (ballot != 0) to = (slot + k + __ffs(ballot) - 1) % n_slots;
    }
    if (to < 0) return GroupTile{-1, SENTINEL};
    slot = to;
    open = true;
  }
}

// One block of the group kernel.
// * Warp 0 picks the block's slot and first tile (group_start) and hands
//   them to the block through shared memory.
// * The block loads the slot's operands into shared memory and each thread
//   makes the candidate test (CandidateTest: md5's constants from them).
// * Between tiles, thread 0 checks the claim it made a tile ahead
//   (group_claim) and hands the tile over, two words of shared memory in
//   turn, so one barrier a tile suffices; the block ends where the claim is
//   dropped.  It checks against the slot's cell as it read it when the
//   tile began, the read's latency hidden behind the tile (so a block
//   tests at most one tile more past a hit), but for a hash built for one
//   tail layout (md5's), which reads it at the tile's end: each form ran
//   the faster for its hashes on the H100, as ptxas scheduled their loops
//   (tools/group_variants.py times md5's both ways).
// * Each thread tests its indices of the tile (claim_index) in ascending
//   order until its first hit, which goes into the slot's cell at once; it
//   tests no more tiles, all of which lie above its hit.
template <class H, int N_BLOCKS>
__device__ __forceinline__ void hash_group_block(DISTPOW_GROUP_PARAMS) {
  constexpr int D = H::DIGEST_WORDS, BASE_WORDS = H::ROW_WORDS * N_BLOCKS;
  __shared__ uint32_t init[H::STATE_WORDS], base[BASE_WORDS];
  __shared__ GroupTile handed[2];
  const uint32_t tile = rounds * HASH_BLOCK_THREADS;
  uint32_t claim = 0;  // thread 0's claim ahead
  if (threadIdx.x < 32) {
    const GroupTile t = group_start(claim, out, n_slots, batch, tile);
    if (threadIdx.x == 0) handed[0] = t;
  }
  __syncthreads();
  const int s = handed[0].slot;
  if (s < 0) return;
  uint32_t b = handed[0].b;
  for (int i = threadIdx.x; i < H::STATE_WORDS; i += blockDim.x)
    init[i] = init_g[s * H::STATE_WORDS + i];
  for (int i = threadIdx.x; i < BASE_WORDS; i += blockDim.x) base[i] = base_g[s * BASE_WORDS + i];
  uint32_t masks[D];
#pragma unroll
  for (int i = 0; i < D; ++i) masks[i] = __ldg(masks_g + s * D + i);
  const Layout L = slot_layout(__ldg(chunk0 + s), __ldg(tb_lo + s), __ldg(log_tbc + s), var_word,
                               var_shift, chunk_mask);
  __syncthreads();
  const CandidateTest<H, D, N_BLOCKS> hits(init, base, masks);
  constexpr bool EARLY = !KeyedByVarWord<H>::value;  // the cell read as the tile begins
  bool testing = true;
#pragma unroll 1
  for (int buf = 1; b != SENTINEL; buf ^= 1) {
    const uint32_t seen = EARLY && threadIdx.x == 0 ? live_word(out + s) : 0u;
    if (testing) {
      // b + tile < 2^31 + 2^24 (MAX_ROUNDS)
      const uint32_t end = min(b + tile, batch);
      // one hash per iteration, as in the serial loop
#pragma unroll 1
      for (uint32_t f = claim_index(b, threadIdx.x, HASH_BLOCK_THREADS, 0); f < end;
           f += HASH_BLOCK_THREADS) {
        uint32_t tb, chunk;
        decode<true>(L, f, tb, chunk);
        if (hits(L, tb, chunk)) {
          atomicMin(out + s, f);
          testing = false;
          break;
        }
      }
    }
    if (threadIdx.x == 0)
      handed[buf].b = group_claim(s, claim, EARLY ? seen : live_word(out + s), out, n_slots,
                                  batch, tile);
    __syncthreads();
    b = handed[buf].b;
  }
}

template <class H, int N_BLOCKS>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_group_search_kernel(DISTPOW_GROUP_PARAMS) {
  hash_group_block<H, N_BLOCKS>(DISTPOW_GROUP_ARGS);
}

// The same kernel for a hash that asks for H::MIN_BLOCKS_PER_SM blocks.
template <class H, int N_BLOCKS>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_group_search_kernel(DISTPOW_GROUP_PARAMS) {
  hash_group_block<H, N_BLOCKS>(DISTPOW_GROUP_ARGS);
}

template <class H, int N_BLOCKS>
auto group_kernel() {
  if constexpr (AsksResidentBlocks<H>::value) return resident_hash_group_search_kernel<H, N_BLOCKS>;
  else return hash_group_search_kernel<H, N_BLOCKS>;
}

// One resident wave of the group kernel on the current device
// (resident_wave), asked of the device at its first launch there and kept,
// so that a launch's only query is cudaGetDevice.
template <class H, int N_BLOCKS>
int group_wave() {
  constexpr int DEVICES = 64;
  static std::atomic<int> waves[DEVICES];  // 0: not asked yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 0 || dev >= DEVICES) return resident_wave(group_kernel<H, N_BLOCKS>());
  int wave = waves[dev].load(std::memory_order_relaxed);
  if (wave <= 0) {
    wave = resident_wave(group_kernel<H, N_BLOCKS>());
    waves[dev].store(wave, std::memory_order_relaxed);
  }
  return wave;
}

// A group launch on `grid` blocks, or where grid <= 0 on GROUP_WAVES
// resident waves cut to the group's tiles; at least a block a slot, so that
// every slot is some block's home.  The tile takes group_rounds, over the
// group's n_slots * batch indices on one wave (or the grid asked for), of
// the `rounds` asked for.
template <class H, int N_BLOCKS>
void launch_group_kernel(int grid, cudaStream_t stream, DISTPOW_GROUP_PARAMS) {
  const int blocks = grid > 0 ? grid : group_wave<H, N_BLOCKS>();
  rounds = group_rounds(static_cast<uint64_t>(n_slots) * batch, blocks, HASH_BLOCK_THREADS, rounds);
  if (grid <= 0) {
    const uint64_t tile = static_cast<uint64_t>(rounds) * HASH_BLOCK_THREADS;
    const uint64_t tiles = static_cast<uint64_t>(n_slots) * ((batch + tile - 1) / tile);
    const uint64_t most = static_cast<uint64_t>(blocks) * GROUP_WAVES;
    grid = static_cast<int>(tiles < most ? tiles : most);
  }
  if (grid < n_slots) grid = n_slots;
  const auto kernel = group_kernel<H, N_BLOCKS>();
  kernel<<<grid, HASH_BLOCK_THREADS, 0, stream>>>(DISTPOW_GROUP_ARGS);
}

// The body of each kernel's second extern "C" function, the group search.
// init[n_slots][STATE_WORDS], base[n_slots][ROW_WORDS * n_blocks],
// masks[n_slots][DIGEST_WORDS], tb_lo, log_tbc, chunk0 and out[2 * n_slots]
// are device arrays; out holds n_slots SENTINELs, then n_slots zeros, the
// claim counters.  batch < 2^31; rounds is the most candidates a thread
// tests of each tile (1 to MAX_ROUNDS), grid the blocks (<= 0:
// GROUP_WAVES resident waves; at least n_slots).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a configuration no
// kernel was built for.
template <class H>
int launch_hash_group_search(const void* init, const void* base, const void* masks,
                             int n_blocks, int var_word, int var_shift, uint32_t chunk_mask,
                             const void* tb_lo, const void* log_tbc, const void* chunk0,
                             int n_slots, uint32_t batch, uint32_t rounds, void* out, int grid,
                             void* stream) {
  if (n_slots == 0 || batch == 0) return 0;
  if ((n_blocks != 1 && n_blocks != 2) ||
      !(n_blocks == 1 ? builds_tail<H>(1) : builds_tail<H>(2)) || n_slots < 0 ||
      n_slots > 65535 || batch >= 0x80000000u || rounds == 0 || rounds > MAX_ROUNDS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto u = [](const void* p) { return static_cast<const uint32_t*>(p); };
  auto go = [&](auto n_blk) {
    launch_group_kernel<H, decltype(n_blk)::value>(
        grid, static_cast<cudaStream_t>(stream), u(init), u(base), u(masks), u(tb_lo),
        u(log_tbc), u(chunk0), var_word, var_shift, chunk_mask, n_slots, batch, rounds,
        static_cast<uint32_t*>(out));
  };
  if (n_blocks == 1) {
    if constexpr (builds_tail<H>(1)) go(std::integral_constant<int, 1>{});
  } else {
    if constexpr (builds_tail<H>(2)) go(std::integral_constant<int, 2>{});
  }
  return static_cast<int>(cudaGetLastError());
}
#undef DISTPOW_GROUP_ARGS
#undef DISTPOW_GROUP_PARAMS

// Each kernel's second extern "C" function, distpow_<NAME>_group_search,
// over hash H: launch_hash_group_search's arguments; a layout that
// LAYOUT_OK refuses (md5's libraries are built per var_word) is
// cudaErrorInvalidValue.
#define DISTPOW_GROUP_FUNCTION(NAME, H, LAYOUT_OK)                                            \
  extern "C" int distpow_##NAME##_group_search(                                               \
      const void* init, const void* base, const void* masks, int n_blocks, int var_word,      \
      int var_shift, uint32_t chunk_mask, const void* tb_lo, const void* log_tbc,             \
      const void* chunk0, int n_slots, uint32_t batch, uint32_t rounds, void* out, int grid,  \
      void* stream) {                                                                         \
    if (!(LAYOUT_OK)) return static_cast<int>(cudaErrorInvalidValue);                        \
    return distpow::launch_hash_group_search<H>(init, base, masks, n_blocks, var_word,         \
                                                var_shift, chunk_mask, tb_lo, log_tbc, chunk0, \
                                                n_slots, batch, rounds, out, grid, stream);    \
  }

// The mesh kernel: one shard's launch of a search spread over a mesh of
// devices (replaces distpow_tpu/parallel/mesh_search.py
// _dyn_pallas_mesh_step, which ran _dyn_pallas_step on every device of a
// jax Mesh and took lax.pmin of the partition indices).  Each block is the
// solo kernel's body over the shard's slice L of the partition o (a run of
// thread bytes, or a span of chunks: n flat indices); each thread's first
// hit becomes the partition's flat index (mesh_global_index)
// before the block min, so the least value across the shards' cells is
// the partition's first hit.  The loop is the solo kernel's: the remap
// runs once per thread, after it.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__device__ __forceinline__ void hash_mesh_block(const uint32_t* __restrict__ init_g,
                                                const uint32_t* __restrict__ base_g,
                                                const uint32_t* __restrict__ masks_g,
                                                const Layout& L, const MeshOrigin& o, uint32_t n,
                                                uint32_t* __restrict__ out) {
  block_min_to<HASH_BLOCK_THREADS>(
      mesh_global_index<POW2>(L, o,
                              hash_block_first_hit<H, MASK_WORDS, N_BLOCKS, POW2, PartitionIndex>(
                                  init_g, base_g, masks_g, L, n)),
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

// The persistent form of the mesh kernel (Persist), and its resident twin:
// the solo persistent block over the shard's slice, claiming in the
// shard's flat order and reporting partition indices (PartitionIndex),
// which grow with the flat index within a shard, against the shard's own
// cell, so that the rule of persistent_step keeps each shard's least index.
template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS)
hash_mesh_persistent_kernel(const uint32_t* __restrict__ init_g,
                            const uint32_t* __restrict__ base_g,
                            const uint32_t* __restrict__ masks_g, Layout L, MeshOrigin o,
                            uint32_t n, uint32_t* __restrict__ out, Persist P) {
  hash_persistent_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n, out, P,
                                                       PartitionIndex{o});
}

template <class H, int MASK_WORDS, int N_BLOCKS, bool POW2>
__global__ void __launch_bounds__(HASH_BLOCK_THREADS, H::MIN_BLOCKS_PER_SM)
resident_hash_mesh_persistent_kernel(const uint32_t* __restrict__ init_g,
                                     const uint32_t* __restrict__ base_g,
                                     const uint32_t* __restrict__ masks_g, Layout L,
                                     MeshOrigin o, uint32_t n, uint32_t* __restrict__ out,
                                     Persist P) {
  hash_persistent_block<H, MASK_WORDS, N_BLOCKS, POW2>(init_g, base_g, masks_g, L, n, out, P,
                                                       PartitionIndex{o});
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
// search's stop flag, the segment in reported indices, and the most
// candidates a thread tests of each tile (rounds, 1 to MAX_ROUNDS; the
// launch takes launch_rounds of it).  An invalid one (no flag, a zero
// segment, rounds out of range) is reported as a null stop, which
// DISTPOW_PERSISTENT_FUNCTIONS refuses.
inline Persist persistent_form(const void* stop, uint32_t seg, uint32_t rounds) {
  if (stop == nullptr || seg == 0 || rounds == 0 || rounds > MAX_ROUNDS) return Persist{};
  return Persist{static_cast<const uint32_t*>(stop), seg, rounds};
}

// The bodies of each kernel's fourth and fifth extern "C" functions, the
// persistent solo launch and the persistent launch of one mesh shard: the
// arguments of launch_hash_search and launch_hash_mesh_search, then the
// search's stop flag (a device word), the segment's size in reported
// indices (seg), the most candidates a thread tests of each tile (rounds),
// and the three-word out, which the wrapper set to (SENTINEL, the segment
// count, 0).  A grid <= 0 launches one resident wave (resident_wave).
#define DISTPOW_PERSISTENT_FUNCTIONS(NAME, H, LAYOUT_OK)                                      \
  extern "C" int distpow_##NAME##_persistent_search(                                          \
      const void* init, const void* base, const void* masks, int n_blocks, int mask_words,    \
      uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word,               \
      int var_shift, uint32_t chunk_mask, uint32_t n, const void* stop, uint32_t seg,         \
      uint32_t rounds, void* out, int grid, void* stream) {                                   \
    const distpow::Persist P = distpow::persistent_form(stop, seg, rounds);                   \
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
      uint32_t rounds, void* out, int grid, void* stream) {                                   \
    const distpow::Persist P = distpow::persistent_form(stop, seg, rounds);                   \
    if (!(LAYOUT_OK) || P.stop == nullptr) return static_cast<int>(cudaErrorInvalidValue);    \
    return distpow::launch_hash_mesh_search<H>(init, base, masks, n_blocks, mask_words,       \
                                               chunk0, tb_lo, tbc, log_tbc, var_word,         \
                                               var_shift, chunk_mask, n, origin_chunk0,       \
                                               origin_tb_lo, origin_tbc, out, grid, stream,   \
                                               P);                                            \
  }

}  // namespace distpow
#endif  // __CUDACC__
