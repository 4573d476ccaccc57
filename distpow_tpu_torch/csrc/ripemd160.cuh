// RIPEMD-160 for the search scaffold (hash_search.cuh), shared by the CUDA
// kernel (ripemd160_search.cu) and its host twin (the g++ build of the CPU
// tests).
//
// Replaces the tile _ripemd160_tile of distpow_tpu/ops/md5_pallas.py: two
// independent 80-round lines over the same 16 little-endian message words,
// each in the single-chain form of the SHA-1 tile.  With X[r] the value a
// line writes to b in round r, round r reads
//   b = X[r-1], c = X[r-2], d = in(r-3), e = in(r-4), a = in(r-5)
// and computes X[r] = rotl(a + f(b, c, d) + (K[r/16] + w[R[r]]), S[r]) + e.
// The seam: X[-1..-5] are the raw init words b0, c0, d0, e0, a0, and in(i)
// is X[i] for i <= -3 and rotl(X[i], 10) for i >= -2.  The right line runs
// the boolean functions in reverse order (f of round 79 - r).  The final
// combine crosses the lines: digest word j reads late chain values of both,
// so with MW trailing words live each line stops at the last chain index its
// live words read (the NEED table), which prunes one round of the right line
// for MW = 1.  Round indices are template parameters (ripemd160_line<R>).
//
// A round issues a LOP3 for f, a SHF for in(r-3) and one LEA.HI for
// rotl(t, S) + e, all on the ALU pipe.  In the plain form (FMA = false) so
// is the IADD3 of t = a + f + (K + w), and the loop is bound by that pipe
// while the FMA pipe beside it idles.  FMA = true puts the sums on the FMA
// pipe as IMADs (add_fma): a = in(r-5) is known rounds before the chain
// needs it, so a + (K + w) is off the critical path, and f + t is one IMAD
// ahead of the LEA.HI: 492 ALU-pipe instructions a hash and 456 FMA-pipe
// slots (the plain form 652 and 136).  The two lines stay
// independent, two chains for ptxas to interleave.  Each in(i) is made
// once (Y below), as in sha1.cuh.  The rotates stay funnel shifts and the
// + e stays in the LEA.HI: as rotl_fma on the FMA pipe, or the + e as an
// IMAD, every form tried was slower (tools/round_variants.py, PERF.md).
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint32_t ripemd160_k(bool right, int group) {
  constexpr uint32_t kl[5] = {0x00000000u, 0x5A827999u, 0x6ED9EBA1u, 0x8F1BBCDCu, 0xA953FD4Eu};
  constexpr uint32_t kr[5] = {0x50A28BE6u, 0x5C4DD124u, 0x6D703EF3u, 0x7A6D76E9u, 0x00000000u};
  return right ? kr[group] : kl[group];
}

// Message word read by round r.
DISTPOW_HD constexpr int ripemd160_word(bool right, int r) {
  constexpr int rl[80] = {
      0, 1, 2,  3,  4,  5,  6,  7,  8, 9, 10, 11, 12, 13, 14, 15,
      7, 4, 13, 1,  10, 6,  15, 3,  12, 0, 9,  5,  2,  14, 11, 8,
      3, 10, 14, 4, 9,  15, 8,  1,  2, 7, 0,  6,  13, 11, 5,  12,
      1, 9, 11, 10, 0,  8,  12, 4,  13, 3, 7,  15, 14, 5,  6,  2,
      4, 0, 5,  9,  7,  12, 2,  10, 14, 1, 3,  8,  11, 6,  15, 13};
  constexpr int rr[80] = {
      5,  14, 7,  0,  9,  2,  11, 4,  13, 6,  15, 8,  1,  10, 3,  12,
      6,  11, 3,  7,  0,  13, 5,  10, 14, 15, 8,  12, 4,  9,  1,  2,
      15, 5,  1,  3,  7,  14, 6,  9,  11, 8,  12, 2,  10, 0,  4,  13,
      8,  6,  4,  1,  3,  11, 15, 0,  5,  12, 2,  13, 9,  7,  10, 14,
      12, 15, 10, 4,  1,  5,  8,  7,  6,  2,  13, 14, 0,  3,  9,  11};
  return right ? rr[r] : rl[r];
}

// Rotation of round r.
DISTPOW_HD constexpr int ripemd160_shift(bool right, int r) {
  constexpr int sl[80] = {
      11, 14, 15, 12, 5,  8,  7,  9,  11, 13, 14, 15, 6,  7,  9,  8,
      7,  6,  8,  13, 11, 9,  7,  15, 7,  12, 15, 9,  11, 7,  13, 12,
      11, 13, 6,  7,  14, 9,  13, 15, 14, 8,  13, 6,  5,  12, 7,  5,
      11, 12, 14, 15, 14, 15, 9,  8,  9,  14, 5,  6,  8,  6,  5,  12,
      9,  15, 5,  11, 6,  8,  13, 12, 5,  12, 13, 14, 11, 8,  5,  6};
  constexpr int sr[80] = {
      8,  9,  9,  11, 13, 15, 15, 5,  7,  7,  8,  11, 14, 14, 12, 6,
      9,  13, 15, 7,  12, 8,  9,  11, 7,  7,  12, 7,  6,  15, 13, 11,
      9,  7,  15, 11, 8,  6,  6,  14, 12, 13, 5,  14, 13, 13, 7,  5,
      15, 5,  8,  11, 14, 14, 6,  14, 6,  9,  12, 9,  12, 5,  15, 8,
      8,  5,  12, 9,  12, 5,  14, 6,  8,  13, 6,  5,  15, 13, 11, 11};
  return right ? sr[r] : sl[r];
}

// The boolean function of round j (left-line order).
template <int J>
DISTPOW_HD uint32_t ripemd160_f(uint32_t x, uint32_t y, uint32_t z) {
  constexpr int g = J / 16;
  if constexpr (g == 0) {
    return x ^ y ^ z;
  } else if constexpr (g == 1) {
    return (x & y) | (~x & z);
  } else if constexpr (g == 2) {
    return (x | ~y) ^ z;
  } else if constexpr (g == 3) {
    return (x & z) | (y & ~z);
  } else {
    return x ^ (y | ~z);
  }
}

// X[I + 5] holds chain index I, Y[I + 5] in(I), made once, at round I + 3,
// the first to read it.
template <int R, int LAST, bool RIGHT, bool FMA>
DISTPOW_HD void ripemd160_line(uint32_t* X, uint32_t* Y, const uint32_t* m) {
  if constexpr (R <= LAST) {
    constexpr uint32_t k = ripemd160_k(RIGHT, R / 16);
    constexpr int word = ripemd160_word(RIGHT, R);
    constexpr int s = ripemd160_shift(RIGHT, R);
    Y[R + 2] = R <= 0 ? X[R + 2] : rotl32(X[R + 2], 10);
    const uint32_t b = X[R + 4], c = X[R + 3], d = Y[R + 2], e = Y[R + 1], a = Y[R];
    const uint32_t f = ripemd160_f<RIGHT ? 79 - R : R>(b, c, d);
    if constexpr (FMA) X[R + 5] = rotl32(add_fma(f, add_fma(a, k + m[word])), s) + e;
    else X[R + 5] = rotl32(a + f + (k + m[word]), s) + e;
    ripemd160_line<R + 1, LAST, RIGHT, FMA>(X, Y, m);
  }
}

// NEED[j] = the (left, right) chain indices digest word j reads.
DISTPOW_HD constexpr int ripemd160_need(int j, bool right) {
  constexpr int left[5] = {78, 77, 76, 75, 79};
  constexpr int rightn[5] = {77, 76, 75, 79, 78};
  return right ? rightn[j] : left[j];
}

DISTPOW_HD constexpr int ripemd160_last(int mw, bool right) {
  int last = 0;
  for (int j = 5 - mw; j < 5; ++j) {
    const int n = ripemd160_need(j, right);
    last = n > last ? n : last;
  }
  return last;
}

// One compression of block m into st, of which the MW trailing digest words
// are defined afterwards (the others keep their old values).
template <int MW, bool FMA = false>
DISTPOW_HD void ripemd160_compress(uint32_t st[5], const uint32_t m[16]) {
  static_assert(MW >= 1 && MW <= 5, "1..5 live digest words");
  constexpr int LAST_L = ripemd160_last(MW, false);
  constexpr int LAST_R = ripemd160_last(MW, true);
  uint32_t XL[LAST_L + 6], XR[LAST_R + 6], YL[LAST_L + 3], YR[LAST_R + 3];
  XL[0] = XR[0] = YL[0] = YR[0] = st[0];
  XL[1] = XR[1] = YL[1] = YR[1] = st[4];
  XL[2] = XR[2] = st[3];
  XL[3] = XR[3] = st[2];
  XL[4] = XR[4] = st[1];
  ripemd160_line<0, LAST_L, false, FMA>(XL, YL, m);
  ripemd160_line<0, LAST_R, true, FMA>(XR, YR, m);
  const uint32_t h0 = st[0], h1 = st[1], h2 = st[2], h3 = st[3], h4 = st[4];
  // chain index i is X[i + 5]; each word's terms are read only when it is live
  if constexpr (MW >= 5) st[0] = h1 + XL[83] + rotl32(XR[82], 10);
  if constexpr (MW >= 4) st[1] = h2 + rotl32(XL[82], 10) + rotl32(XR[81], 10);
  if constexpr (MW >= 3) st[2] = h3 + rotl32(XL[81], 10) + rotl32(XR[80], 10);
  if constexpr (MW >= 2) st[3] = h4 + rotl32(XL[80], 10) + XR[84];
  st[4] = h0 + XL[84] + XR[83];
}

struct Ripemd160 : Block16 {
  static constexpr int STATE_WORDS = 5;
  static constexpr int DIGEST_WORDS = 5;
  static constexpr bool BIG_ENDIAN_WORDS = false;

  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) {
    ripemd160_compress<5, true>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    ripemd160_compress<MW, true>(st, m);
  }
};

}  // namespace distpow
