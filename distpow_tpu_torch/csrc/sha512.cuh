// SHA-512 and SHA-384 for the search scaffold (hash_search.cuh), shared by
// the CUDA kernels (sha512_search.cu, sha384_search.cu) and their host twin
// (the g++ build of the CPU tests).
//
// Replaces the tiles _sha512_tile and _sha384_tile of
// distpow_tpu/ops/md5_pallas.py (both over _sha512_tile_impl).  The TPU
// tile carries each 64-bit word as a (hi, lo) pair of uint32 values; here
// the scaffold's interface stays in uint32 words in that order (state 16
// words, a block 32, the digest 16 for sha512 and the first 12 for sha384),
// and the compression works in uint64_t.  Hopper has no 64-bit integer
// ALU, so nvcc splits each 64-bit add, xor and rotate into 32-bit
// instructions either way; uint64_t is the clearer source.
//
// The functional A/E form of sha256.cuh stretched to 80 rounds: with A[r]
// and E[r] the new a and e of round r (A[-1..-4] = a0..d0, E[-1..-4] =
// e0..h0), one round is
//   t1   = E[r-4] + S1(E[r-1]) + Ch(E[r-1], E[r-2], E[r-3]) + (K[r] + w[r])
//   E[r] = A[r-4] + t1
//   A[r] = t1 + S0(A[r-1]) + Maj(A[r-1], A[r-2], A[r-3])
// and 64-bit digest word j is init[j] + A[79-j] (j < 4) or init[j] + E[83-j].
// The tile's pruning: with MW trailing uint32 digest words of D live, the
// first live 64-bit word is J0 = (D - MW) / 2, the E chain and the
// schedule stop at MAX_E = min(79, 83 - J0) and the A chain at
// MAX_A = 79 - J0 (md5_pallas.py:488-495).  At MW = 1 of sha512 only the
// low word of the last 64-bit word is read, and the chains stop at E[76]
// and A[72].  Round indices are template parameters (sha512_rounds<R>), so
// every K[r], array index and branch on r is a constant after inlining.
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint64_t sha512_k(int i) {
  constexpr uint64_t k[80] = {
      0x428A2F98D728AE22ull, 0x7137449123EF65CDull, 0xB5C0FBCFEC4D3B2Full, 0xE9B5DBA58189DBBCull,
      0x3956C25BF348B538ull, 0x59F111F1B605D019ull, 0x923F82A4AF194F9Bull, 0xAB1C5ED5DA6D8118ull,
      0xD807AA98A3030242ull, 0x12835B0145706FBEull, 0x243185BE4EE4B28Cull, 0x550C7DC3D5FFB4E2ull,
      0x72BE5D74F27B896Full, 0x80DEB1FE3B1696B1ull, 0x9BDC06A725C71235ull, 0xC19BF174CF692694ull,
      0xE49B69C19EF14AD2ull, 0xEFBE4786384F25E3ull, 0x0FC19DC68B8CD5B5ull, 0x240CA1CC77AC9C65ull,
      0x2DE92C6F592B0275ull, 0x4A7484AA6EA6E483ull, 0x5CB0A9DCBD41FBD4ull, 0x76F988DA831153B5ull,
      0x983E5152EE66DFABull, 0xA831C66D2DB43210ull, 0xB00327C898FB213Full, 0xBF597FC7BEEF0EE4ull,
      0xC6E00BF33DA88FC2ull, 0xD5A79147930AA725ull, 0x06CA6351E003826Full, 0x142929670A0E6E70ull,
      0x27B70A8546D22FFCull, 0x2E1B21385C26C926ull, 0x4D2C6DFC5AC42AEDull, 0x53380D139D95B3DFull,
      0x650A73548BAF63DEull, 0x766A0ABB3C77B2A8ull, 0x81C2C92E47EDAEE6ull, 0x92722C851482353Bull,
      0xA2BFE8A14CF10364ull, 0xA81A664BBC423001ull, 0xC24B8B70D0F89791ull, 0xC76C51A30654BE30ull,
      0xD192E819D6EF5218ull, 0xD69906245565A910ull, 0xF40E35855771202Aull, 0x106AA07032BBD1B8ull,
      0x19A4C116B8D2D0C8ull, 0x1E376C085141AB53ull, 0x2748774CDF8EEB99ull, 0x34B0BCB5E19B48A8ull,
      0x391C0CB3C5C95A63ull, 0x4ED8AA4AE3418ACBull, 0x5B9CCA4F7763E373ull, 0x682E6FF3D6B2B8A3ull,
      0x748F82EE5DEFB2FCull, 0x78A5636F43172F60ull, 0x84C87814A1F0AB72ull, 0x8CC702081A6439ECull,
      0x90BEFFFA23631E28ull, 0xA4506CEBDE82BDE9ull, 0xBEF9A3F7B2C67915ull, 0xC67178F2E372532Bull,
      0xCA273ECEEA26619Cull, 0xD186B8C721C0C207ull, 0xEADA7DD6CDE0EB1Eull, 0xF57D4F7FEE6ED178ull,
      0x06F067AA72176FBAull, 0x0A637DC5A2C898A6ull, 0x113F9804BEF90DAEull, 0x1B710B35131C471Bull,
      0x28DB77F523047D84ull, 0x32CAAB7B40C72493ull, 0x3C9EBE0A15C9BEBCull, 0x431D67C49C100D4Cull,
      0x4CC5D4BECB3E42B6ull, 0x597F299CFC657E2Aull, 0x5FCB6FAB3AD6FAECull, 0x6C44198C4A475817ull};
  return k[i];
}

// A[R + 4] and E[R + 4] hold chain index R; w[R] the schedule word of round R.
template <int R, int MAX_A, int MAX_E>
DISTPOW_HD void sha512_rounds(uint64_t* A, uint64_t* E, uint64_t* w) {
  if constexpr (R <= MAX_E) {
    if constexpr (R >= 16) {
      const uint64_t w15 = w[R - 15], w2 = w[R - 2];
      w[R] = (rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6)) + w[R - 7] +
             (rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7)) + w[R - 16];
    }
    const uint64_t e1 = E[R + 3], f1 = E[R + 2], g1 = E[R + 1], h1 = E[R];
    constexpr uint64_t k = sha512_k(R);
    const uint64_t t1 = h1 + (rotr64(e1, 14) ^ rotr64(e1, 18) ^ rotr64(e1, 41)) +
                        ((e1 & f1) ^ (~e1 & g1)) + (k + w[R]);
    E[R + 4] = A[R] + t1;
    if constexpr (R <= MAX_A) {
      const uint64_t a1 = A[R + 3], b1 = A[R + 2], c1 = A[R + 1];
      A[R + 4] = t1 + (rotr64(a1, 28) ^ rotr64(a1, 34) ^ rotr64(a1, 39)) +
                 ((a1 & b1) ^ (a1 & c1) ^ (b1 & c1));
    }
    sha512_rounds<R + 1, MAX_A, MAX_E>(A, E, w);
  }
}

// One compression of the 32-word block m into the 16-word state st of a
// digest of D uint32 words (16, or 12 for sha384), of which the MW trailing
// digest words are defined afterwards (the other words keep old values).
template <int D, int MW>
DISTPOW_HD void sha512_compress(uint32_t st[16], const uint32_t m[32]) {
  static_assert((D == 16 || D == 12) && MW >= 1 && MW <= D, "1..D live digest words");
  constexpr int J0 = (D - MW) / 2;
  constexpr int MAX_E = J0 < 4 ? 79 : 83 - J0;
  constexpr int MAX_A = 79 - J0;
  uint64_t h[8], w[MAX_E + 1], A[MAX_A + 5], E[MAX_E + 5];
  DISTPOW_UNROLL
  for (int i = 0; i < 8; ++i) h[i] = ((uint64_t)st[2 * i] << 32) | st[2 * i + 1];
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = ((uint64_t)m[2 * i] << 32) | m[2 * i + 1];
  A[0] = h[3]; A[1] = h[2]; A[2] = h[1]; A[3] = h[0];
  E[0] = h[7]; E[1] = h[6]; E[2] = h[5]; E[3] = h[4];
  sha512_rounds<0, MAX_A, MAX_E>(A, E, w);
  DISTPOW_UNROLL
  for (int j = J0; j < D / 2; ++j) {
    const uint64_t v = h[j] + (j < 4 ? A[83 - j] : E[87 - j]);
    st[2 * j] = (uint32_t)(v >> 32);
    st[2 * j + 1] = (uint32_t)v;
  }
}

// As in blake2b.cuh: the rounds are ALU-pipe work at that pipe's rate (a
// round with its schedule word is about 24 SHF, 12 LOP3 and 10 IADD3, the
// high limbs of two-term sums already IMAD.X), and its 32-word block
// places the run by a switch, not by a select for each message word
// (hash_search.cuh message_block).
struct Sha512 {
  static constexpr int STATE_WORDS = 16;
  static constexpr int DIGEST_WORDS = 16;
  static constexpr int BLOCK_WORDS = 32;
  static constexpr int ROW_WORDS = 32;
  static constexpr bool BIG_ENDIAN_WORDS = true;

  static DISTPOW_HD void block(uint32_t st[16], const uint32_t m[32]) {
    sha512_compress<16, 16>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[16], const uint32_t m[32]) {
    sha512_compress<16, MW>(st, m);
  }
};

// SHA-384: the same compression from its own initial value (the prefix
// state the wrapper passes); the digest is the first 12 state words.
struct Sha384 : Sha512 {
  static constexpr int DIGEST_WORDS = 12;

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[16], const uint32_t m[32]) {
    sha512_compress<12, MW>(st, m);
  }
};

}  // namespace distpow
