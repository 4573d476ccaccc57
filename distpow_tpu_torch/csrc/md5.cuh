// MD5 search body shared by the CUDA kernel (md5_search.cu, built by nvcc)
// and its host twin (the g++-built parity driver of the CPU tests).
//
// Everything here is a __host__ __device__ __forceinline__ function with
// compile-time round indices: md5_rounds<I> recurses over I, so every K[i],
// S[i] and message-word index is a constant after inlining.  The digest
// words the difficulty check does not read are dead code, so the MASK_WORDS
// template parameter of candidate_hits lets the compiler drop rounds 62-63
// and the dead final adds (mask_words 1 needs rounds 0..61, 2 needs 0..62).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include <type_traits>
#define DISTPOW_HD __host__ __device__ __forceinline__
#else
#define DISTPOW_HD inline
#endif

namespace distpow {

// A miss: no candidate of the launch solves.
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

// K[i] = floor(abs(sin(i + 1)) * 2^32)
DISTPOW_HD constexpr uint32_t md5_k(int i) {
  constexpr uint32_t k[64] = {
      0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu, 0xf57c0fafu, 0x4787c62au,
      0xa8304613u, 0xfd469501u, 0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
      0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u, 0xf61e2562u, 0xc040b340u,
      0x265e5a51u, 0xe9b6c7aau, 0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
      0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu, 0xa9e3e905u, 0xfcefa3f8u,
      0x676f02d9u, 0x8d2a4c8au, 0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
      0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u, 0x289b7ec6u, 0xeaa127fau,
      0xd4ef3085u, 0x04881d05u, 0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
      0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u, 0x655b59c3u, 0x8f0ccc92u,
      0xffeff47du, 0x85845dd1u, 0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
      0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u};
  return k[i];
}

DISTPOW_HD constexpr int md5_s(int i) {
  constexpr int s[16] = {7, 12, 17, 22, 5, 9, 14, 20, 4, 11, 16, 23, 6, 10, 15, 21};
  return s[(i / 16) * 4 + i % 4];
}

DISTPOW_HD constexpr int md5_g(int i) {
  return i < 16 ? i : i < 32 ? (5 * i + 1) % 16 : i < 48 ? (3 * i + 5) % 16 : (7 * i) % 16;
}

DISTPOW_HD uint32_t rotl32(uint32_t x, int s) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, s);
#else
  return (x << s) | (x >> (32 - s));
#endif
}

template <int I>
DISTPOW_HD void md5_rounds(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                           const uint32_t* m) {
  if constexpr (I < 64) {
    uint32_t f;
    if constexpr (I < 16) {
      f = (b & c) | (~b & d);
    } else if constexpr (I < 32) {
      f = (d & b) | (~d & c);
    } else if constexpr (I < 48) {
      f = b ^ c ^ d;
    } else {
      f = c ^ (b | ~d);
    }
    constexpr uint32_t k = md5_k(I);
    constexpr int g = md5_g(I);
    constexpr int s = md5_s(I);
    f = f + a + (k + m[g]);
    a = d;
    d = c;
    c = b;
    b = b + rotl32(f, s);
    md5_rounds<I + 1>(a, b, c, d, m);
  }
}

// One block compression: st <- st + rounds(st, m).
DISTPOW_HD void md5_compress(uint32_t st[4], const uint32_t* m) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  md5_rounds<0>(a, b, c, d, m);
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}

// The search layout of one launch: what the TailSpec of the nonce and the
// thread-byte partition fix.  Words are the uint32 bit patterns.
//
// The variable bytes of a candidate are contiguous in every MD5 tail
// (thread byte, then chunk bytes 0..width-1, little-endian), so the layout
// is the thread byte's word (0..31 over the two tail blocks) and bit shift;
// chunk_mask keeps the low 8*width bits of the chunk.
struct Layout {
  uint32_t chunk0;
  uint32_t tb_lo;
  uint32_t tbc;
  int32_t log_tbc;  // log2(tbc) when tbc is a power of two, else -1
  int32_t var_word;
  int32_t var_shift;
  uint32_t chunk_mask;
};

// The layout of one scheduler slot (the group kernels,
// hash_group_search_kernel and md5_group_search_kernel): the group's
// shared tail layout (var_word, var_shift, chunk_mask) with the slot's own
// cursor and power-of-two thread-byte run tb_lo .. tb_lo + 2^log_tbc - 1.
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

// The partition a mesh shard searches part of (the mesh kernels,
// hash_mesh_kernel and md5_mesh_kernel): the launch's cursor and the
// partition's thread-byte run tb_lo .. tb_lo + tbc - 1.  A shard's own
// Layout is a slice of it, a run of thread bytes or a span of chunks.
struct MeshOrigin {
  uint32_t chunk0;
  uint32_t tb_lo;
  uint32_t tbc;
};

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
  return (chunk - o.chunk0) * o.tbc + (tb - o.tb_lo);
}

// The MD5 state after the N_BLOCKS tail blocks of candidate (tb, chunk).
// init[4] is the absorbed prefix state, base[16 * N_BLOCKS] the tail's
// constant words.
template <int N_BLOCKS>
DISTPOW_HD void tail_state(const uint32_t* init, const uint32_t* base, const Layout& L,
                           uint32_t tb, uint32_t chunk, uint32_t st[4]) {
  // the variable bytes, placed at their shift: at most 5 bytes + 3 bytes of
  // offset, so they span the words var_word and var_word + 1
  const uint64_t v = ((uint64_t)tb | ((uint64_t)(chunk & L.chunk_mask) << 8))
                     << L.var_shift;
  const uint32_t lo = (uint32_t)v;
  const uint32_t hi = (uint32_t)(v >> 32);
  st[0] = init[0];
  st[1] = init[1];
  st[2] = init[2];
  st[3] = init[3];
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int blk = 0; blk < N_BLOCKS; ++blk) {
    uint32_t m[16];
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int w = 0; w < 16; ++w) {
      const int word = blk * 16 + w;
      m[w] = base[word] | (word == L.var_word ? lo : 0u) |
             (word == L.var_word + 1 ? hi : 0u);
    }
    md5_compress(st, m);
  }
}

// Does candidate (tb, chunk) meet the difficulty?  masks[] holds the
// MASK_WORDS trailing digest-word masks.
template <int MASK_WORDS, int N_BLOCKS>
DISTPOW_HD bool candidate_hits(const uint32_t* init, const uint32_t* base,
                               const uint32_t* masks, const Layout& L,
                               uint32_t tb, uint32_t chunk) {
  uint32_t st[4];
  tail_state<N_BLOCKS>(init, base, L, tb, chunk, st);
  uint32_t acc = 0;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int j = 0; j < MASK_WORDS; ++j) acc |= st[4 - MASK_WORDS + j] & masks[j];
  return acc == 0;
}

#if defined(__CUDACC__)
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
// of a launch of n flat indices: mask_words 1-4 or FULL (the digest's
// words), n_blocks 1 or 2, a power-of-two run or not.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a configuration no
// kernel was built for.
template <int FULL, class Launch>
int launch_keyed(int mask_words, int n_blocks, bool pow2, uint32_t n, Launch launch) {
  if (n == 0) return 0;
  auto at_mw = [&](auto nb) {
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
template <class Launch>
int launch_group(int n_blocks, int n_slots, uint32_t batch, int grid_x, Launch launch) {
  if (n_slots == 0 || batch == 0) return 0;
  if ((n_blocks != 1 && n_blocks != 2) || n_slots < 0 || n_slots > 65535 || grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, n_slots);
  if (n_blocks == 1) {
    launch(std::integral_constant<int, 1>{}, grid);
  } else {
    launch(std::integral_constant<int, 2>{}, grid);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // namespace distpow
