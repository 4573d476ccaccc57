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
#pragma once

#include "hash_search.cuh"

namespace distpow {

DISTPOW_HD constexpr uint32_t sha1_k(int i) {
  return i < 20 ? 0x5A827999u : i < 40 ? 0x6ED9EBA1u : i < 60 ? 0x8F1BBCDCu : 0xCA62C1D6u;
}

// X[I + 5] holds chain index I.
template <int I>
DISTPOW_HD uint32_t sha1_in(const uint32_t* X) {
  if constexpr (I <= -3) {
    return X[I + 5];
  } else {
    return rotl32(X[I + 5], 30);
  }
}

template <int R, int LAST>
DISTPOW_HD void sha1_rounds(uint32_t* X, uint32_t* w) {
  if constexpr (R <= LAST) {
    if constexpr (R >= 16) w[R] = rotl32(w[R - 3] ^ w[R - 8] ^ w[R - 14] ^ w[R - 16], 1);
    const uint32_t a = X[R + 4], b = X[R + 3];
    const uint32_t c = sha1_in<R - 3>(X), d = sha1_in<R - 4>(X), e = sha1_in<R - 5>(X);
    uint32_t f;
    if constexpr (R < 20) {
      f = (b & c) | (~b & d);
    } else if constexpr (R >= 40 && R < 60) {
      f = (b & c) | (b & d) | (c & d);
    } else {
      f = b ^ c ^ d;
    }
    constexpr uint32_t k = sha1_k(R);
    X[R + 5] = rotl32(a, 5) + f + e + (k + w[R]);
    sha1_rounds<R + 1, LAST>(X, w);
  }
}

// One compression of block m into st, of which the MW trailing digest words
// are defined afterwards (the others keep their old values).
template <int MW>
DISTPOW_HD void sha1_compress(uint32_t st[5], const uint32_t m[16]) {
  static_assert(MW >= 1 && MW <= 5, "1..5 live digest words");
  constexpr int LAST = 74 + MW;
  uint32_t w[LAST + 1], X[LAST + 6];
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  X[0] = st[4]; X[1] = st[3]; X[2] = st[2]; X[3] = st[1]; X[4] = st[0];
  sha1_rounds<0, LAST>(X, w);
  DISTPOW_UNROLL
  for (int j = 5 - MW; j < 5; ++j) st[j] += j < 2 ? X[84 - j] : rotl32(X[84 - j], 30);
}

struct Sha1 : Block16 {
  static constexpr int STATE_WORDS = 5;
  static constexpr int DIGEST_WORDS = 5;
  static constexpr bool BIG_ENDIAN_WORDS = true;

  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) { sha1_compress<5>(st, m); }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress<MW>(st, m);
  }
};

}  // namespace distpow
