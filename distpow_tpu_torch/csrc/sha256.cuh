// SHA-256 and double SHA-256 (sha256d) for the search scaffold
// (hash_search.cuh), shared by the CUDA kernels (sha256_search.cu,
// sha256d_search.cu) and their host twin (the g++ build of the CPU tests).
//
// Replaces the tiles _sha256_tile and _sha256d_tile of
// distpow_tpu/ops/md5_pallas.py.  The same functional A/E form: with A[r]
// and E[r] the new a and e of round r (A[-1..-4] = a0..d0, E[-1..-4] =
// e0..h0), one round is
//   t1   = E[r-4] + S1(E[r-1]) + Ch(E[r-1], E[r-2], E[r-3]) + (K[r] + w[r])
//   E[r] = A[r-4] + t1
//   A[r] = t1 + S0(A[r-1]) + Maj(A[r-1], A[r-2], A[r-3])
// and digest word j is init[j] + A[63-j] (j < 4) or init[j] + E[67-j].
// With MW trailing digest words live the E chain stops at
// MAX_E = 59 + min(MW, 4), the A chain at MAX_A (MAX_E - 4, or 55 + MW for
// MW > 4), and the schedule at MAX_E: the rounds that feed only dead words
// are never written, whatever the compiler would find.  Round indices are
// template parameters (sha256_rounds<R>), so every K[r], every array index
// and every branch on r is a constant after inlining.
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint32_t sha256_k(int i) {
  constexpr uint32_t k[64] = {
      0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
      0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
      0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
      0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
      0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
      0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
      0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
      0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
      0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
      0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
      0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};
  return k[i];
}

// FMA = true routes sha256_rounds' adds and shifts to the FMA pipe: every
// sum of two or three terms as IMADs (add_fma), the schedule's plain
// shifts as IMAD.HI (shr_fma).  false is the plain form, all on the ALU
// pipe but a few VIADDs (tools/round_variants.py times it beside the
// kernels).
template <bool FMA>
DISTPOW_HD uint32_t add2(uint32_t x, uint32_t y) {
  if constexpr (FMA) return add_fma(x, y);
  else return x + y;
}

template <bool FMA>
DISTPOW_HD uint32_t shr(uint32_t x, int s) {
  if constexpr (FMA) return shr_fma(x, s);
  else return x >> s;
}

// In sha256d's second compression (SECOND) the initial state and message
// words 8-15 are compile-time constants.  Sums of constants fold, so they
// are never routed: a factor read from memory would make them cost an
// instruction.  Is schedule word i such a constant?
DISTPOW_HD constexpr bool sha256_const_word(bool second, int i) {
  return i < 16 ? second && i >= 8
                : sha256_const_word(second, i - 2) && sha256_const_word(second, i - 7) &&
                      sha256_const_word(second, i - 15) && sha256_const_word(second, i - 16);
}

// A[R + 4] and E[R + 4] hold chain index R; w[R] the schedule word of round
// R.
template <int R, int MAX_A, int MAX_E, bool FMA, bool SECOND>
DISTPOW_HD void sha256_rounds(uint32_t* A, uint32_t* E, uint32_t* w) {
  if constexpr (R <= MAX_E) {
    if constexpr (R >= 16) {
      constexpr bool c2 = sha256_const_word(SECOND, R - 2), c7 = sha256_const_word(SECOND, R - 7);
      constexpr bool c15 = sha256_const_word(SECOND, R - 15);
      constexpr bool c16 = sha256_const_word(SECOND, R - 16);
      const uint32_t w15 = w[R - 15], w2 = w[R - 2];
      const uint32_t s1 = rotr32(w2, 17) ^ rotr32(w2, 19) ^ (c2 ? w2 >> 10 : shr<FMA>(w2, 10));
      const uint32_t s0 = rotr32(w15, 7) ^ rotr32(w15, 18) ^ (c15 ? w15 >> 3 : shr<FMA>(w15, 3));
      w[R] = c16 || (c2 && c7 && c15) ? s1 + w[R - 7] + s0 + w[R - 16]
                                      : add2<FMA>(s1 + w[R - 7] + s0, w[R - 16]);
    }
    const uint32_t e1 = E[R + 3], f1 = E[R + 2], g1 = E[R + 1], h1 = E[R];
    constexpr uint32_t k = sha256_k(R);
    const uint32_t s1 = rotr32(e1, 6) ^ rotr32(e1, 11) ^ rotr32(e1, 25), ch = (e1 & f1) ^ (~e1 & g1);
    // h1 (and A[R]) are state words, constants in SECOND, for R < 4; all of
    // h1..e1 only at R = 0
    constexpr bool h_const = SECOND && R < 4, p_const = SECOND && R == 0;
    const uint32_t p = h_const || !FMA ? h1 + s1 + ch : add_fma(add_fma(h1, s1), ch);
    const uint32_t t1 = p_const || sha256_const_word(SECOND, R) ? p + (k + w[R])
                                                                : add2<FMA>(p, k + w[R]);
    E[R + 4] = h_const ? A[R] + t1 : add2<FMA>(A[R], t1);
    if constexpr (R <= MAX_A) {
      const uint32_t a1 = A[R + 3], b1 = A[R + 2], c1 = A[R + 1];
      const uint32_t s0 = rotr32(a1, 2) ^ rotr32(a1, 13) ^ rotr32(a1, 22);
      const uint32_t maj = (a1 & b1) ^ (a1 & c1) ^ (b1 & c1);
      A[R + 4] = p_const || !FMA ? t1 + s0 + maj : add_fma(t1, add_fma(s0, maj));
    }
    sha256_rounds<R + 1, MAX_A, MAX_E, FMA, SECOND>(A, E, w);
  }
}

// One compression of block m into st, of which the MW trailing digest words
// are defined afterwards (the others keep their old values).
template <int MW, bool FMA = false, bool SECOND = false>
DISTPOW_HD void sha256_compress(uint32_t st[8], const uint32_t m[16]) {
  static_assert(MW >= 1 && MW <= 8, "1..8 live digest words");
  constexpr int MAX_E = 59 + (MW < 4 ? MW : 4);
  constexpr int MAX_A = MW > 4 ? 55 + MW : MAX_E - 4;
  uint32_t w[MAX_E + 1], A[MAX_A + 5], E[MAX_E + 5];
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  A[0] = st[3]; A[1] = st[2]; A[2] = st[1]; A[3] = st[0];
  E[0] = st[7]; E[1] = st[6]; E[2] = st[5]; E[3] = st[4];
  sha256_rounds<0, MAX_A, MAX_E, FMA, SECOND>(A, E, w);
  DISTPOW_UNROLL
  for (int j = 8 - MW; j < 8; ++j) {
    const uint32_t x = j < 4 ? A[67 - j] : E[71 - j];
    st[j] = SECOND ? st[j] + x : add2<FMA>(st[j], x);
  }
}

// The plain form is bound by the ALU pipe: every instruction but a few
// VIADDs issues there, at 64 thread results a clock per SM, while the FMA
// pipe beside it idles.  So the rounds put their sums (the two- and
// three-term adds of t1, E, A, each schedule word and the digest) on the
// FMA pipe as IMADs and the schedule's plain shifts as IMAD.HI (FMA =
// true), as sha256d's do: 1211 ALU-pipe instructions a hash become 936.
// Asking for four resident blocks keeps its 47 registers but reads the
// operands anew per candidate, and ran 1.1 % faster than the bare launch
// bounds, five blocks 0.3 % (tools/round_variants.py, PERF.md).
struct Sha256 : Block16 {
  static constexpr int STATE_WORDS = 8;
  static constexpr int DIGEST_WORDS = 8;
  static constexpr bool BIG_ENDIAN_WORDS = true;
  static constexpr int MIN_BLOCKS_PER_SM = 4;

  static DISTPOW_HD void block(uint32_t st[8], const uint32_t m[16]) {
    sha256_compress<8, true>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[8], const uint32_t m[16]) {
    sha256_compress<MW, true>(st, m);
  }
};

// sha256d(x) = sha256(sha256(x)): after the last block, a second SHA-256
// from the initial state over one fixed-layout block, the first digest
// (its words as they are: both stages are big-endian), 0x80, zeros and the
// bit length 256.  Stage 1 runs at full width, since every digest word feeds
// stage 2; the mask-word pruning applies to stage 2.  Words 8-15 of the
// second block and its initial state are constants, so their K + w and the
// first rounds' sums fold at compile time.
//
// Both stages take the FMA-pipe form of Sha256's rounds (FMA = true).
// That takes the timed loop from 2481 ALU-pipe instructions a hash to
// 1950, and 1140 on the FMA pipe.
// Those sums need more registers (64), so the kernel asks for five
// resident blocks (48 registers), which also reads the launch's operands
// anew for every candidate.
struct Sha256d : Block16 {
  static constexpr int STATE_WORDS = 8;
  static constexpr int DIGEST_WORDS = 8;
  static constexpr bool BIG_ENDIAN_WORDS = true;
  static constexpr int MIN_BLOCKS_PER_SM = 5;

  static DISTPOW_HD void block(uint32_t st[8], const uint32_t m[16]) {
    sha256_compress<8, true>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[8], const uint32_t m[16]) {
    sha256_compress<8, true>(st, m);
    const uint32_t m2[16] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                             0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u, 256u};
    st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
    st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
    sha256_compress<MW, true, true>(st, m2);
  }
};

}  // namespace distpow
