// SHA3-256 for the search scaffold (hash_search.cuh), shared by the CUDA
// kernel (sha3_256_search.cu) and its host twin (the g++ build of the CPU
// tests).
//
// Replaces the tile _sha3_tile of distpow_tpu/ops/md5_pallas.py.  Keccak is
// a sponge: a block is the 136-byte rate (17 lanes) XORed into the leading
// lanes of the 25-lane state, then Keccak-f[1600]'s 24 rounds.  As in the
// tile, the scaffold's interface stays in uint32 words, each 64-bit lane a
// (lo, hi) pair in little-endian order (state 50 words, a block 34, the
// digest the first 8, lanes 0-3); the permutation works in uint64_t.
//
// Theta mixes every lane into every other each round, so no chain can be
// cut short.  The tile's only pruning is the last round's chi and iota,
// computed just for the lanes the MW live digest words read
// (md5_pallas.py:583-596): at MW <= 2, lane 3 alone, whose chi reads the
// rho-pi outputs of lanes 18, 24 and 0.  Round indices are template
// parameters (keccak_rounds<R>), so each round constant is a constant.
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint64_t keccak_rc(int r) {
  constexpr uint64_t rc[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  return rc[r];
}

// rho's rotation of lane x + 5y
DISTPOW_HD constexpr int keccak_rot(int x, int y) {
  constexpr int rot[5][5] = {{0, 36, 3, 41, 18},
                             {1, 44, 10, 45, 2},
                             {62, 6, 43, 15, 61},
                             {28, 55, 25, 21, 56},
                             {27, 20, 39, 8, 14}};
  return rot[x][y];
}

// Rounds R..23 of Keccak-f[1600] on A; the last round's chi and iota write
// only the lanes in the bit mask LAST_LANES (bit i: lane i).
template <int R, uint32_t LAST_LANES>
DISTPOW_HD void keccak_rounds(uint64_t A[25]) {
  if constexpr (R < 24) {
    constexpr uint32_t lanes = R == 23 ? LAST_LANES : 0x1FFFFFFu;
    uint64_t C[5], B[25];
    DISTPOW_UNROLL
    for (int x = 0; x < 5; ++x) C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
    DISTPOW_UNROLL
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
      DISTPOW_UNROLL
      for (int y = 0; y < 5; ++y) {
        // theta, then rho and pi: lane (x, y) moves to (y, 2x + 3y)
        B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(A[x + 5 * y] ^ d, keccak_rot(x, y));
      }
    }
    DISTPOW_UNROLL
    for (int i = 0; i < 25; ++i) {
      if (lanes >> i & 1) {
        const int x = i % 5, y5 = i - x;
        A[i] = B[i] ^ (~B[(x + 1) % 5 + y5] & B[(x + 2) % 5 + y5]);
      }
    }
    if constexpr (lanes & 1) A[0] ^= keccak_rc(R);
    keccak_rounds<R + 1, LAST_LANES>(A);
  }
}

// Absorb the 34-word rate block m into the 50-word state st and permute; the
// lanes in LAST_LANES are defined afterwards (the others keep old values).
template <uint32_t LAST_LANES>
DISTPOW_HD void sha3_absorb(uint32_t st[50], const uint32_t m[34]) {
  uint64_t A[25];
  DISTPOW_UNROLL
  for (int i = 0; i < 25; ++i) {
    uint32_t lo = st[2 * i], hi = st[2 * i + 1];
    if (2 * i < 34) lo ^= m[2 * i];
    if (2 * i + 1 < 34) hi ^= m[2 * i + 1];
    A[i] = ((uint64_t)hi << 32) | lo;
  }
  keccak_rounds<0, LAST_LANES>(A);
  DISTPOW_UNROLL
  for (int i = 0; i < 25; ++i) {
    if (LAST_LANES >> i & 1) {
      st[2 * i] = (uint32_t)A[i];
      st[2 * i + 1] = (uint32_t)(A[i] >> 32);
    }
  }
}

struct Sha3_256 {
  static constexpr int STATE_WORDS = 50;
  static constexpr int DIGEST_WORDS = 8;
  static constexpr int BLOCK_WORDS = 34;
  static constexpr int ROW_WORDS = 34;
  static constexpr bool BIG_ENDIAN_WORDS = false;

  static DISTPOW_HD void block(uint32_t st[50], const uint32_t m[34]) {
    sha3_absorb<0x1FFFFFFu>(st, m);
  }

  // digest word w is limb w % 2 of lane w / 2: the live words 8 - MW..7
  // read lanes (8 - MW) / 2..3
  template <int MW>
  static DISTPOW_HD void last(uint32_t st[50], const uint32_t m[34]) {
    static_assert(MW >= 1 && MW <= 8, "1..8 live digest words");
    sha3_absorb<0xFu & (0xFu << (8 - MW) / 2)>(st, m);
  }
};

}  // namespace distpow
