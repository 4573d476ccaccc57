// SHA-1 for the search scaffold (hash_search.cuh), shared by the CUDA kernel
// (sha1_search.cu) and its host twin (the g++ build of the CPU tests).
//
// Replaces the tile _sha1_tile of distpow_tpu/ops/md5_pallas.py, in its
// functional single-chain form: with X[r] the new a of round r, the other
// registers are delayed, rotated copies of the chain, so round r reads
//   a = X[r-1], b = X[r-2], c = in(r-3), d = in(r-4), e = in(r-5)
// and computes only X[r] = rotl(a, 5) + f(b, c, d) + e + (K[r/20] + w[r]).
// The seam: X[-1..-5] are the raw init words a0..e0, and in(i) is X[i] for
// i <= -3 (c0, d0, e0 are already in place) and rotl(X[i], 30) for i >= -2.
// Digest word j is init[j] + X[79-j] (j < 2) or init[j] + rotl(X[79-j], 30).
// With MW trailing digest words live the chain and the schedule stop at
// round 74 + MW.  Round indices are template parameters (sha1_rounds<R>).
//
// A round issues a LOP3 for f, a SHF for in(r-3) and one LEA.HI for
// rotl(a, 5) + s; the schedule two LOP3 and a SHF a word, all on the ALU
// pipe.  In the plain form (FMA = false) so are the IADD3 of s = f + e +
// (K + w[r]), and the loop is bound by that pipe while the FMA pipe beside
// it idles.  FMA = true puts the sums on the FMA pipe as IMADs (add_fma): e
// and w[r] are known rounds before the chain needs them, so t = e + (K +
// w[r]) is off the critical path, and f + t is one IMAD ahead of the
// LEA.HI (ptxas puts K + w[r] on VIADD): 429 ALU-pipe instructions a hash
// and 236 FMA-pipe slots (the plain form 506 and 79).  Each in(i) is made
// once (Y below): rotl32 is __funnelshift_l, an asm volatile that the
// compiler does not merge, and rounds that rotated at each of the three
// reads compiled to 71 more ALU-pipe instructions.  The rotates
// stay funnel shifts: as rotl_fma on the FMA pipe (tools/fma_forms.cuh)
// every form tried was slower (tools/round_variants.py, PERF.md).
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint32_t sha1_k(int i) {
  return i < 20 ? 0x5A827999u : i < 40 ? 0x6ED9EBA1u : i < 60 ? 0x8F1BBCDCu : 0xCA62C1D6u;
}

// X[I + 5] holds chain index I, Y[I + 5] in(I), made once, at round I + 3,
// the first to read it.
template <int R, int LAST, bool FMA>
DISTPOW_HD void sha1_rounds(uint32_t* X, uint32_t* Y, uint32_t* w) {
  if constexpr (R <= LAST) {
    if constexpr (R >= 16) w[R] = rotl32(w[R - 3] ^ w[R - 8] ^ w[R - 14] ^ w[R - 16], 1);
    Y[R + 2] = R <= 0 ? X[R + 2] : rotl32(X[R + 2], 30);
    const uint32_t a = X[R + 4], b = X[R + 3], c = Y[R + 2], d = Y[R + 1], e = Y[R];
    uint32_t f;
    if constexpr (R < 20) {
      f = (b & c) | (~b & d);
    } else if constexpr (R >= 40 && R < 60) {
      f = (b & c) | (b & d) | (c & d);
    } else {
      f = b ^ c ^ d;
    }
    constexpr uint32_t k = sha1_k(R);
    if constexpr (FMA) X[R + 5] = rotl32(a, 5) + add_fma(f, add_fma(e, k + w[R]));
    else X[R + 5] = rotl32(a, 5) + f + e + (k + w[R]);
    sha1_rounds<R + 1, LAST, FMA>(X, Y, w);
  }
}

// One compression of block m into st, of which the MW trailing digest words
// are defined afterwards (the others keep their old values).
template <int MW, bool FMA = false>
DISTPOW_HD void sha1_compress(uint32_t st[5], const uint32_t m[16]) {
  static_assert(MW >= 1 && MW <= 5, "1..5 live digest words");
  constexpr int LAST = 74 + MW;
  uint32_t w[LAST + 1], X[LAST + 6], Y[LAST + 3];
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  X[0] = st[4]; X[1] = st[3]; X[2] = st[2]; X[3] = st[1]; X[4] = st[0];
  Y[0] = X[0]; Y[1] = X[1];
  sha1_rounds<0, LAST, FMA>(X, Y, w);
  DISTPOW_UNROLL
  for (int j = 5 - MW; j < 5; ++j) st[j] += j < 2 ? X[84 - j] : rotl32(X[84 - j], 30);
}

struct Sha1 : Block16 {
  static constexpr int STATE_WORDS = 5;
  static constexpr int DIGEST_WORDS = 5;
  static constexpr bool BIG_ENDIAN_WORDS = true;

  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress<5, true>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress<MW, true>(st, m);
  }
};

}  // namespace distpow
