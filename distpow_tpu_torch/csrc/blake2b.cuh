// BLAKE2b-256 for the search scaffold (hash_search.cuh), shared by the CUDA
// kernel (blake2b_256_search.cu) and its host twin (the g++ build of the
// CPU tests).
//
// Replaces the tile _blake2b_tile of distpow_tpu/ops/md5_pallas.py.  As in
// the tile, the scaffold's interface stays in uint32 words, each 64-bit
// word a (lo, hi) pair in little-endian order: the state is 16 words, a
// tail block's row 36 (32 message words, then t_lo, t_hi, f_lo, f_hi, the
// byte count through the block and the finalization word, which packing
// bakes per block), the digest the first 8.  The compression works in
// uint64_t: 12 rounds of 8 G mixes over v[16] = h ‖ IV, with v[12] ^= t
// and v[14] ^= f0.  Both come from the row, so a first tail block of two
// (t = absorbed + 128, f0 = 0) and a last one are the same code.
//
// Every round mixes every lane, so no chain can be cut short.  The tile's
// only pruning (md5_pallas.py:666-671): the last round's diagonal G calls
// that write no lane a live digest word reads are skipped.  Digest 64-bit
// word j is h[j] ^ v[j] ^ v[j + 8], with h the chaining value at the start
// of this (the last) block; at MW <= 2 only word 3 is live, read from v[3]
// (G(3, 4, 9, 14)) and v[11] (G(1, 6, 11, 12)), and two diagonals go.
// Round indices are template parameters (blake2b_rounds<R>), so every
// SIGMA entry, and with it every message index, is a constant.
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint64_t blake2b_iv(int i) {
  constexpr uint64_t iv[8] = {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull,
                              0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
                              0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
                              0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
  return iv[i];
}

// SIGMA row r % 10, entry k: the message word of G k / 2's input k % 2
DISTPOW_HD constexpr int blake2b_sigma(int r, int k) {
  constexpr int s[10][16] = {{0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
                             {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
                             {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
                             {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
                             {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
                             {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
                             {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
                             {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
                             {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
                             {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};
  return s[r % 10][k];
}

// The lanes (a, b, c, d) of G g of a round: four columns, four diagonals.
DISTPOW_HD constexpr int blake2b_lane(int g, int k) {
  constexpr int lanes[8][4] = {{0, 4, 8, 12}, {1, 5, 9, 13}, {2, 6, 10, 14}, {3, 7, 11, 15},
                               {0, 5, 10, 15}, {1, 6, 11, 12}, {2, 7, 8, 13}, {3, 4, 9, 14}};
  return lanes[g][k];
}

// Does G g write one of the v lanes j and j + 8 of a 64-bit digest word j
// in the bit mask LIVE?
DISTPOW_HD constexpr bool blake2b_g_live(int g, uint32_t live) {
  bool any = false;
  for (int k = 0; k < 4; ++k) any = any || (live >> (blake2b_lane(g, k) % 8) & 1);
  return any;
}

DISTPOW_HD void blake2b_g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t x,
                          uint64_t y) {
  a = a + b + x;
  d = rotr64(d ^ a, 32);
  c = c + d;
  b = rotr64(b ^ c, 24);
  a = a + b + y;
  d = rotr64(d ^ a, 16);
  c = c + d;
  b = rotr64(b ^ c, 63);
}

// Rounds R..11 on v; the last round runs its four columns and only the
// diagonals that write a lane of a 64-bit digest word in LIVE (bit j:
// word j).
template <int R, uint32_t LIVE>
DISTPOW_HD void blake2b_rounds(uint64_t v[16], const uint64_t m[16]) {
  if constexpr (R < 12) {
    DISTPOW_UNROLL
    for (int g = 0; g < 8; ++g) {
      if (R < 11 || g < 4 || blake2b_g_live(g, LIVE)) {
        blake2b_g(v[blake2b_lane(g, 0)], v[blake2b_lane(g, 1)], v[blake2b_lane(g, 2)],
                  v[blake2b_lane(g, 3)], m[blake2b_sigma(R, 2 * g)],
                  m[blake2b_sigma(R, 2 * g + 1)]);
      }
    }
    blake2b_rounds<R + 1, LIVE>(v, m);
  }
}

// One compression of the 36-word row m into the 16-word state st; the
// 64-bit words in LIVE (bit j: word j) are defined afterwards.
template <uint32_t LIVE>
DISTPOW_HD void blake2b_compress(uint32_t st[16], const uint32_t m[36]) {
  uint64_t h[8], v[16], w[16];
  DISTPOW_UNROLL
  for (int i = 0; i < 8; ++i) {
    h[i] = ((uint64_t)st[2 * i + 1] << 32) | st[2 * i];
    v[i] = h[i];
    v[i + 8] = blake2b_iv(i);
  }
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = ((uint64_t)m[2 * i + 1] << 32) | m[2 * i];
  v[12] ^= ((uint64_t)m[33] << 32) | m[32];  // t; its high 64 bits are 0
  v[14] ^= ((uint64_t)m[35] << 32) | m[34];  // f0
  blake2b_rounds<0, LIVE>(v, w);
  DISTPOW_UNROLL
  for (int j = 0; j < 8; ++j) {
    if (LIVE >> j & 1) {
      const uint64_t out = h[j] ^ v[j] ^ v[j + 8];
      st[2 * j] = (uint32_t)out;
      st[2 * j + 1] = (uint32_t)(out >> 32);
    }
  }
}

// The loop is ALU-pipe work at that pipe's rate: a G is 8 LOP3, 6 SHF
// and 6 IADD3 (ptxas already puts the high limbs of c + d on the FMA pipe
// as IMAD.X; a three-term sum keeps two ALU-pipe instructions in any
// form, and a rotate's limb on the FMA pipe needs IMAD.HI, which does not
// issue beside ALU work: python3 -m distpow_tpu_torch.tools.pipe_rates;
// tools/round_variants.py times each such form of the rounds, all slower).
// So the kernel cuts what is not the hash: a 32-word block places the
// run's two words with one branch on the launch's var_word instead of a
// select for each message word (hash_search.cuh message_block), about 120
// ALU-pipe instructions a candidate fewer.
struct Blake2b_256 {
  static constexpr int STATE_WORDS = 16;
  static constexpr int DIGEST_WORDS = 8;
  static constexpr int BLOCK_WORDS = 32;
  static constexpr int ROW_WORDS = 36;
  static constexpr bool BIG_ENDIAN_WORDS = false;

  static DISTPOW_HD void block(uint32_t st[16], const uint32_t m[36]) {
    blake2b_compress<0xFFu>(st, m);
  }

  // digest word w is limb w % 2 of 64-bit word w / 2: the live words
  // 8 - MW..7 read 64-bit words (8 - MW) / 2..3
  template <int MW>
  static DISTPOW_HD void last(uint32_t st[16], const uint32_t m[36]) {
    static_assert(MW >= 1 && MW <= 8, "1..8 live digest words");
    blake2b_compress<0xFu & (0xFu << (8 - MW) / 2)>(st, m);
  }
};

}  // namespace distpow
