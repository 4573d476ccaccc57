// MD5 for the search scaffold (hash_search.cuh), shared by the CUDA kernel
// (md5_search.cu) and its host twin (the g++ build of the CPU tests).
//
// Replaces the tile _md5_tile of distpow_tpu/ops/md5_pallas.py, which was
// compiled once per tail layout (TailSpec): its _round_key folded K[i] +
// m[g] for every message word the layout fixes.  The kernels here are
// built the same way, once per var_word, the run's first message word
// (Md5<VW>; the other layout numbers, var_shift and chunk_mask, stay
// runtime arguments since they only form the run's two words).  With the
// run's words known to the compiler:
// * no select places the run: the candidate's two words are ORed into the
//   rows' words VW and VW + 1 once a candidate;
// * every other word is a launch constant, so K[i] + m[g] of each round
//   that reads one is a loop invariant (Md5Tail::kc), made once per thread
//   before the candidate loop;
// * the rounds of the first block before round VW read constants only (the
//   first 16 rounds read words 0..15 in order), so the state after them is
//   made once per thread too (Md5Tail::hoisted).
// A round then is f = F(b, c, d) (one LOP3), t = a + kc (an IMAD with the
// factor 1 from constant memory, add_fma: off the round's critical path,
// since a is known three rounds early, and on the FMA pipe), u = f + t
// (an IMAD too, Md5Keyed's FT_FMA, else an IADD3 on the ALU pipe) and b +
// rotl(u, s) (one LEA.HI).  Round indices are template parameters, so
// every K[i], S[i] and message-word index is a constant after inlining, and
// the rounds that feed only digest words the difficulty check does not
// read are dead code (mask_words 1 needs rounds 0..61, 2 needs 0..62).
#pragma once

#include "hash_search.cuh"

namespace distpow {

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

template <int I>
DISTPOW_HD uint32_t md5_f(uint32_t b, uint32_t c, uint32_t d) {
  if constexpr (I < 16) return (b & c) | (~b & d);
  else if constexpr (I < 32) return (d & b) | (~d & c);
  else if constexpr (I < 48) return b ^ c ^ d;
  else return c ^ (b | ~d);
}

// Rounds I..END-1 of a compression of block m, in the plain form.
template <int I, int END>
DISTPOW_HD void md5_rounds(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                           const uint32_t* m) {
  if constexpr (I < END) {
    const uint32_t f = md5_f<I>(b, c, d) + a + (md5_k(I) + m[md5_g(I)]);
    a = d;
    d = c;
    c = b;
    b = b + rotl32(f, md5_s(I));
    md5_rounds<I + 1, END>(a, b, c, d, m);
  }
}

// One block compression: st <- st + rounds(st, m).
DISTPOW_HD void md5_compress(uint32_t st[4], const uint32_t* m) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  md5_rounds<0, 64>(a, b, c, d, m);
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
}

// Rounds I..63 of block BLK of a tail whose run starts at message word VW:
// a round that reads word VW or VW + 1 adds K[i] and the candidate's word
// (m0 or m1).  Every other one, in the first block, adds its loop-invariant
// kc[I] = K[I] + m[g] (KC_TABLE; kc is the table, or an object whose
// operator[] reads it), or with !KC_TABLE the row word itself, rows[g],
// with K[I] an immediate of u's add.  The second block of a
// two-block tail reads its row words anew from the rows (volatile LDS, see
// Md5Tail).
template <int I, int BLK, int VW, bool FT_FMA, bool KC_TABLE, class Kc, class Rows>
DISTPOW_HD void md5_keyed_rounds(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d, Kc kc,
                                 Rows rows, uint32_t m0, uint32_t m1) {
  if constexpr (I < 64) {
    constexpr int word = 16 * BLK + md5_g(I);
    constexpr uint32_t k = md5_k(I);
    const uint32_t f = md5_f<I>(b, c, d);
    uint32_t u;
    if constexpr (word == VW || word == VW + 1) {
      const uint32_t t = a + k + (word == VW ? m0 : m1);
      u = FT_FMA ? add_fma(f, t) : f + t;
    } else if constexpr (BLK == 0 && KC_TABLE) {
      const uint32_t t = add_fma(a, kc[I]);
      u = FT_FMA ? add_fma(f, t) : f + t;
    } else {
      u = f + add_fma(a, rows[md5_g(I)]) + k;
    }
    a = d;
    d = c;
    c = b;
    b = b + rotl32(u, md5_s(I));
    md5_keyed_rounds<I + 1, BLK, VW, FT_FMA, KC_TABLE>(a, b, c, d, kc, rows, m0, m1);
  }
}

// The launch's constants of an N_BLOCKS-block tail whose run starts at
// message word VW, as the candidate loop reads them: made once per thread
// from the prefix state init[4] and the rows base[16 * N_BLOCKS] (shared
// memory in the kernels).  The first block's table of K[i] + m[g] takes 56
// registers or so; with the second block's too, ptxas gave the two-block
// kernels 128-149 registers, some spilling, so a two-block tail's second
// row is read anew from the rows for every candidate instead.
template <int VW, int N_BLOCKS, bool FT_FMA, bool KC_TABLE = true, class KcRead = void>
struct Md5Tail {
  static_assert(VW >= 0 && VW < 16, "the run starts in the first block");
  uint32_t init[4];
  // a, b, c, d after the first block's rounds 0..VW-1
  uint32_t hoisted[4];
  // K[i] + m[g] of the first block's round i (the run's rounds' entries
  // are never read)
  uint32_t kc[64];
  // the first block's row (read where !KC_TABLE)
  uint32_t row[16];
  // the rows' words VW and VW + 1 (0 past the tail)
  uint32_t row0, row1;
  // the second block's row
  const uint32_t* rows1;

  DISTPOW_HD Md5Tail(const uint32_t* init_, const uint32_t* base) : rows1(base + 16) {
    DISTPOW_UNROLL
    for (int i = 0; i < 4; ++i) init[i] = init_[i];
    DISTPOW_UNROLL
    for (int i = 0; i < 16; ++i) row[i] = base[i];
    DISTPOW_UNROLL
    for (int i = 0; i < 64; ++i) kc[i] = md5_k(i) + base[md5_g(i)];
    row0 = base[VW];
    row1 = VW + 1 < 16 * N_BLOCKS ? base[VW + 1] : 0u;
    uint32_t a = init[0], b = init[1], c = init[2], d = init[3];
    md5_rounds<0, VW>(a, b, c, d, base);
    hoisted[0] = a;
    hoisted[1] = b;
    hoisted[2] = c;
    hoisted[3] = d;
  }

  // The state after the tail blocks of candidate (tb, chunk), of which the
  // MW trailing digest words are defined.
  template <int MW>
  DISTPOW_HD void state(const Layout& L, uint32_t tb, uint32_t chunk, uint32_t st[4]) const {
    uint32_t first, second;
    var_words<false>(L, tb, chunk, first, second);
    const uint32_t m0 = row0 | first, m1 = row1 | second;
    uint32_t a = hoisted[0], b = hoisted[1], c = hoisted[2], d = hoisted[3];
    if constexpr (std::is_void_v<KcRead>)
      md5_keyed_rounds<VW, 0, VW, FT_FMA, KC_TABLE>(a, b, c, d, kc, row, m0, m1);
    else
      md5_keyed_rounds<VW, 0, VW, FT_FMA, KC_TABLE>(a, b, c, d, KcRead{kc}, row, m0, m1);
    st[0] = init[0] + a;
    st[1] = init[1] + b;
    st[2] = init[2] + c;
    st[3] = init[3] + d;
    if constexpr (N_BLOCKS == 2) {
      a = st[0], b = st[1], c = st[2], d = st[3];
      md5_keyed_rounds<0, 1, VW, FT_FMA, KC_TABLE>(
          a, b, c, d, kc, static_cast<const volatile uint32_t*>(rows1), m0, m1);
      st[0] += a;
      st[1] += b;
      st[2] += c;
      st[3] += d;
    }
  }
};

// MD5 built for tails whose run starts at message word VW (Md5<VW> below),
// with u = f + t in the form FT_FMA, the first block's K[i] + m[g] from a
// table (KC_TABLE; the Tail's own, or read by KcRead{table}[i]) or added at
// each round.  A one-block tail holds the run, the 0x80 byte and the 8-byte
// length, so its run starts at word 13 at the latest; a two-block tail's
// starts anywhere in the first block.
template <int VW, bool FT_FMA, bool KC_TABLE = true, class KcRead = void>
struct Md5Keyed : Block16 {
  static constexpr int STATE_WORDS = 4;
  static constexpr int DIGEST_WORDS = 4;
  static constexpr bool BIG_ENDIAN_WORDS = false;
  static constexpr int VAR_WORD = VW;

  static constexpr bool builds(int n_blocks) { return n_blocks == 2 || VW <= 13; }

  template <int N_BLOCKS>
  using Tail = Md5Tail<VW, N_BLOCKS, FT_FMA, KC_TABLE, KcRead>;

  static DISTPOW_HD void block(uint32_t st[4], const uint32_t m[16]) { md5_compress(st, m); }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[4], const uint32_t m[16]) {
    md5_compress(st, m);
  }
};

// md5's kernels: the FMA-pipe form of u = f + t and the first block's
// table.  tools/round_variants.py times the other forms beside it: u as
// an IADD3 ran 1.9 % slower, the row word added per round 0.3 % faster
// (within the turns' spread), the table in constant memory 0.8 % faster
// at 29 registers, which the kernels cannot take (a __constant__ table is
// one for all streams; PERF.md).
template <int VW>
struct Md5 : Md5Keyed<VW, true> {};

}  // namespace distpow
