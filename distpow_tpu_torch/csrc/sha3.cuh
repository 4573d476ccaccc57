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

// pi moves lane x + 5y to lane y + 5((2x + 3y) mod 5).  Lane 0 stays; the
// other 24 form one cycle, and keccak_cycle(i) is its i-th lane from lane 1.
DISTPOW_HD constexpr int keccak_cycle(int i) {
  constexpr int lanes[24] = {1,  10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24,
                             4,  15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6};
  return lanes[i % 24];
}

// Rounds R..23 of Keccak-f[1600] on A; the last round's chi and iota write
// only the lanes in the bit mask LAST_LANES (bit i: lane i).  The round
// works in place, so few 64-bit values are live at once: the 25 lanes, the
// five column sums C[x] and their rotates, and a temporary or two.  Theta
// is applied to each lane as rho and pi consume it, as one three-input XOR
// a half (A ^ C[x - 1] ^ rotl(C[x + 1], 1): D[x] is never formed); rho and
// pi walk pi's cycle, each lane taking the rotated value of the one before
// it; chi goes plane by plane, keeping the plane's first two lanes.
template <int R, uint32_t LAST_LANES>
DISTPOW_HD void keccak_rounds(uint64_t A[25]) {
  if constexpr (R < 24) {
    constexpr uint32_t lanes = R == 23 ? LAST_LANES : 0x1FFFFFFu;
    uint64_t C[5], Cr[5];
    DISTPOW_UNROLL
    for (int x = 0; x < 5; ++x) C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
    DISTPOW_UNROLL
    for (int x = 0; x < 5; ++x) Cr[x] = rotl64(C[x], 1);
    // theta of lane a in column x
#define KECCAK_THETA(a, x) ((a) ^ C[((x) + 4) % 5] ^ Cr[((x) + 1) % 5])
    uint64_t t = KECCAK_THETA(A[1], 1);
    DISTPOW_UNROLL
    for (int i = 1; i <= 24; ++i) {
      const int src = keccak_cycle(i - 1), dst = keccak_cycle(i);
      const uint64_t next = KECCAK_THETA(A[dst], dst % 5);  // unused at i = 24 (lane 1 again)
      A[dst] = rotl64(t, keccak_rot(src % 5, src / 5));
      t = next;
    }
    A[0] = KECCAK_THETA(A[0], 0);
#undef KECCAK_THETA
    DISTPOW_UNROLL
    for (int y5 = 0; y5 < 25; y5 += 5) {
      const uint64_t b0 = A[y5], b1 = A[y5 + 1];
      if (lanes >> y5 & 1) A[y5] = b0 ^ (~b1 & A[y5 + 2]);
      if (lanes >> (y5 + 1) & 1) A[y5 + 1] = b1 ^ (~A[y5 + 2] & A[y5 + 3]);
      if (lanes >> (y5 + 2) & 1) A[y5 + 2] ^= ~A[y5 + 3] & A[y5 + 4];
      if (lanes >> (y5 + 3) & 1) A[y5 + 3] ^= ~A[y5 + 4] & b0;
      if (lanes >> (y5 + 4) & 1) A[y5 + 4] ^= ~b0 & b1;
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

// Every instruction of the rounds (LOP3, SHF) issues on the ALU pipe, at
// 64 thread results a clock per SM, so the kernel needs enough resident
// warps to keep that pipe busy.  Left to itself ptxas kept the launch's 84
// operand words in registers across the grid-stride loop and took 172
// registers, one 256-thread block per SM.  MIN_BLOCKS_PER_SM = 2 reads
// them anew for every candidate (84 LDS a hash) and holds the kernel at
// two blocks (at most 128 registers; 90 at mask words 2, one tail block,
// and no specialization spills).  Moving rho's rotates to the FMA pipe as
// IMAD.WIDE pairs was slower, and a third block spills in the two-block
// tails.
struct Sha3_256 {
  static constexpr int MIN_BLOCKS_PER_SM = 2;
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
