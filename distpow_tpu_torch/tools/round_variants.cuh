// Formulations of the MD5, SHA-256, SHA-1, RIPEMD-160, BLAKE2b-256 and
// SHA-512/384 rounds
// that move work onto Hopper's FMA pipe or off it, as hashes for the search
// scaffold (hash_search.cuh): the designs that round_variants.py builds
// and times beside the kernels in csrc/.  None of them is a kernel of the
// port.
//
// A variant differs from its csrc/ hash only in the form of its sums and
// rotates, and in the resident blocks it asks for (Resident):
//   Md5Keyed<VW, FT_FMA, KC_TABLE>, Md5KcConst<VW>
//       md5.cuh's rounds with u = f + t as an IMAD or an IADD3, K[i] + m[g]
//       from a table in registers, in constant memory, or added per round
//   Sha256Unbounded, Sha256Plain
//       sha256.cuh's Sha256 without its resident blocks, and in the plain
//       form (FMA = false) too
//   Sha1Plain, Ripemd160Plain
//       sha1.cuh's and ripemd160.cuh's rounds in the plain form (FMA =
//       false), all on the ALU pipe
//   Sha1As<Sha1Forms<SUMS, FT, ROT5, WROT, ROT30, CROT>>
//       SHA-1's rounds with e + (K + w[r]) as an IMAD (SUMS), f + t as an
//       IMAD (FT), and as rotl_fma in every ROT5-th round rotl(a, 5) + s,
//       in every WROT-th schedule word its rotl(x, 1), in every ROT30-th
//       chain value its rotl(x, 30) (0: never); the other rotates through
//       __funnelshift_l (rotl32), or with CROT as C shifts, (x << s) |
//       (x >> (32 - s)), which the compiler makes a funnel shift itself
//   Ripemd160As<RmdForms<SUMS, FT, E_IMAD, ROT, ROT10, CROT>>
//       RIPEMD-160's lines with a + (K + w) as an IMAD (SUMS), f + t as an
//       IMAD (FT), + e after a funnel shift as an IMAD (E_IMAD), and as
//       rotl_fma in every ROT-th round rotl(t, S) + e, in every ROT10-th
//       chain value its rotl(x, 10); CROT as SHA-1's
// and, for BLAKE2b-256 and SHA-512/384, their 64-bit sums (SumForm) and
// rotates (RotForm, fma_forms.cuh):
//   Blake2bAs<BlakeForms<SUM, R24, R16, R63, EVERY_OTHER>>
//       every sum of a G in form SUM, its rotates by 24, 16 and 63 in forms
//       R24, R16 and R63 (in every G, or with EVERY_OTHER in G 0, 2, 4 and
//       6 of a round only, the others funnel shifts); the rotate by 32 stays
//       a swap
//   Sha512As<ShaForms<SUM, BIG, SMALL, SHR_FMA>, D>
//       every sum of a round and of a schedule word in form SUM, the six
//       Sigma rotates in form BIG, the four sigma rotates in form SMALL,
//       with SHR_FMA the high limb of the schedule's >> 6 and >> 7 as
//       IMAD.HI; D = 16 is SHA-512, 12 SHA-384
// On the host the forms are plain arithmetic, so the g++ build of a
// variant computes the csrc/ hash exactly.
#pragma once

#include <type_traits>

#include "blake2b.cuh"
#include "fma_forms.cuh"
#include "md5.cuh"
#include "ripemd160.cuh"
#include "sha1.cuh"
#include "sha256.cuh"
#include "sha512.cuh"

namespace distpow {

enum SumForm : int { SUM_PLAIN, SUM_CARRY, SUM_WIDE };

template <int F>
DISTPOW_HD uint64_t add64_form(uint64_t x, uint64_t y) {
  if constexpr (F == SUM_CARRY) return add64_carry(x, y);
  else if constexpr (F == SUM_WIDE) return add64_wide(x, y);
  else return x + y;
}

// x >> S, 0 < S < 32, with the high limb as IMAD.HI (shr_fma) or not
template <bool FMA, int S>
DISTPOW_HD uint64_t shr64_form(uint64_t x) {
  if constexpr (FMA) {
    const uint32_t lo = (uint32_t)(x >> S), hi = shr_fma((uint32_t)(x >> 32), S);
    return (uint64_t)hi << 32 | lo;
  } else {
    return x >> S;
  }
}

// A hash that asks for N resident blocks: hash_search.cuh gives it
// resident_hash_search_kernel and reads its operands anew per candidate.
template <class H, int N>
struct Resident : H {
  static constexpr int MIN_BLOCKS_PER_SM = N;
};

// ---- MD5 and SHA-256 ----------------------------------------------------

// md5.cuh's Md5<VW> with u = f + t of every round as an IMAD (FT_FMA) or
// an IADD3, and the first block's K[i] + m[g] from the per-thread table or
// added at each round: Md5Keyed<VW, FT_FMA, KC_TABLE>, used as it is.  And
// with the table in constant memory (Md5KcConst<VW>), where an IMAD reads
// it as an operand, with no register and no instruction of its own: the
// kernel parameter block would give the same operand, but the kernels take
// the rows on the device, so the tool writes the table for each launch's
// rows (variant_set_kc, round_variants.cu) before it launches, one stream
// at a time.  On the host the variant reads the per-thread table.
#if defined(__CUDACC__)
__constant__ uint32_t kVariantKc[64];
#endif

struct ConstKc {
  const uint32_t* table;
  DISTPOW_HD uint32_t operator[](int i) const {
#if defined(__CUDA_ARCH__)
    return kVariantKc[i];
#else
    return table[i];
#endif
  }
};

template <int VW>
struct Md5KcConst : Md5Keyed<VW, true, true, ConstKc> {};

// sha256.cuh's Sha256 without its resident blocks (the bare launch
// bounds)
struct Sha256Unbounded : Block16 {
  static constexpr int STATE_WORDS = 8;
  static constexpr int DIGEST_WORDS = 8;
  static constexpr bool BIG_ENDIAN_WORDS = true;
  static DISTPOW_HD void block(uint32_t st[8], const uint32_t m[16]) { Sha256::block(st, m); }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[8], const uint32_t m[16]) {
    Sha256::template last<MW>(st, m);
  }
};

// and in the plain form too, all on the ALU pipe but a few VIADDs (the
// kernel before it took the FMA-pipe form)
struct Sha256Plain : Sha256Unbounded {
  static DISTPOW_HD void block(uint32_t st[8], const uint32_t m[16]) {
    sha256_compress<8, false>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[8], const uint32_t m[16]) {
    sha256_compress<MW, false>(st, m);
  }
};

// ---- SHA-1 and RIPEMD-160 ----------------------------------------------

// the kernels' rounds in the plain form (FMA = false)
struct Sha1Plain : Sha1 {
  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress<5, false>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress<MW, false>(st, m);
  }
};

struct Ripemd160Plain : Ripemd160 {
  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) {
    ripemd160_compress<5, false>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    ripemd160_compress<MW, false>(st, m);
  }
};

// Is the form that a variant takes in every EVERY-th round (0: never) the
// one of round or chain index i?
DISTPOW_HD constexpr bool every(int every_, int i) {
  return every_ > 0 && (i < 0 ? -i : i) % every_ == 0;
}

// x + y as an IMAD (FMA) or an add
template <bool FMA>
DISTPOW_HD uint32_t add_form(uint32_t x, uint32_t y) {
  if constexpr (FMA) return add_fma(x, y);
  else return x + y;
}

// rotl32(x, s) as C shifts (CROT) or through __funnelshift_l
template <bool CROT>
DISTPOW_HD uint32_t rotl_c(uint32_t x, int s) {
  if constexpr (CROT) return (x << s) | (x >> (32 - s));
  else return rotl32(x, s);
}

// rotl32(x, s) + y as rotl_fma (FMA) or a funnel shift and an add
template <bool FMA, bool CROT>
DISTPOW_HD uint32_t rotl_form(uint32_t x, int s, uint32_t y = 0) {
  if constexpr (FMA) return rotl_fma(x, s, y);
  else return rotl_c<CROT>(x, s) + y;
}

template <int SUMS_, int FT_, int ROT5_, int WROT_, int ROT30_, int CROT_>
struct Sha1Forms {
  static constexpr bool SUMS = SUMS_ != 0, FT = FT_ != 0, CROT = CROT_ != 0;
  static constexpr int ROT5 = ROT5_, WROT = WROT_, ROT30 = ROT30_;
};

// sha1.cuh's sha1_rounds in the forms of P.  Y[I + 5] holds in(I), made at
// round I + 3, the first to read it.
template <class P, int R, int LAST>
DISTPOW_HD void sha1_rounds_as(uint32_t* X, uint32_t* Y, uint32_t* w) {
  if constexpr (R <= LAST) {
    if constexpr (R >= 16)
      w[R] = rotl_form<every(P::WROT, R), P::CROT>(w[R - 3] ^ w[R - 8] ^ w[R - 14] ^ w[R - 16],
                                                   1);
    if constexpr (R - 3 <= -3) Y[R + 2] = X[R + 2];
    else Y[R + 2] = rotl_form<every(P::ROT30, R - 3), P::CROT>(X[R + 2], 30);
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
    constexpr bool rot5 = every(P::ROT5, R);
    if constexpr (!P::SUMS && !P::FT && !rot5) {
      X[R + 5] = rotl_c<P::CROT>(a, 5) + f + e + (k + w[R]);  // the plain form, as sha1.cuh has it
    } else {
      const uint32_t t = P::SUMS ? add_fma(e, k + w[R]) : e + (k + w[R]);
      X[R + 5] = rotl_form<rot5, P::CROT>(a, 5, add_form<P::FT>(f, t));
    }
    sha1_rounds_as<P, R + 1, LAST>(X, Y, w);
  }
}

// sha1.cuh's sha1_compress over sha1_rounds_as
template <class P, int MW>
DISTPOW_HD void sha1_compress_as(uint32_t st[5], const uint32_t m[16]) {
  constexpr int LAST = 74 + MW;
  uint32_t w[LAST + 1], X[LAST + 6], Y[LAST + 3];
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  X[0] = st[4]; X[1] = st[3]; X[2] = st[2]; X[3] = st[1]; X[4] = st[0];
  Y[0] = X[0]; Y[1] = X[1];
  sha1_rounds_as<P, 0, LAST>(X, Y, w);
  DISTPOW_UNROLL
  for (int j = 5 - MW; j < 5; ++j) st[j] += j < 2 ? X[84 - j] : rotl_c<P::CROT>(X[84 - j], 30);
}

template <class P>
struct Sha1As : Sha1 {
  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress_as<P, 5>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    sha1_compress_as<P, MW>(st, m);
  }
};

template <int SUMS_, int FT_, int E_IMAD_, int ROT_, int ROT10_, int CROT_>
struct RmdForms {
  static constexpr bool SUMS = SUMS_ != 0, FT = FT_ != 0, E_IMAD = E_IMAD_ != 0,
                        CROT = CROT_ != 0;
  static constexpr int ROT = ROT_, ROT10 = ROT10_;
};

// ripemd160.cuh's ripemd160_line in the forms of P.  Y[I + 5] holds in(I),
// made at round I + 3, the first to read it.
template <class P, int R, int LAST, bool RIGHT>
DISTPOW_HD void ripemd160_line_as(uint32_t* X, uint32_t* Y, const uint32_t* m) {
  if constexpr (R <= LAST) {
    constexpr uint32_t k = ripemd160_k(RIGHT, R / 16);
    constexpr int word = ripemd160_word(RIGHT, R);
    constexpr int s = ripemd160_shift(RIGHT, R);
    if constexpr (R - 3 <= -3) Y[R + 2] = X[R + 2];
    else Y[R + 2] = rotl_form<every(P::ROT10, R - 3), P::CROT>(X[R + 2], 10);
    const uint32_t b = X[R + 4], c = X[R + 3], d = Y[R + 2], e = Y[R + 1], a = Y[R];
    const uint32_t f = ripemd160_f<RIGHT ? 79 - R : R>(b, c, d);
    // the plain form's sum as ripemd160.cuh has it
    const uint32_t t = !P::SUMS && !P::FT ? a + f + (k + m[word])
                       : add_form<P::FT>(f, P::SUMS ? add_fma(a, k + m[word]) : a + (k + m[word]));
    if constexpr (every(P::ROT, R)) X[R + 5] = rotl_fma(t, s, e);
    else X[R + 5] = add_form<P::E_IMAD>(rotl_c<P::CROT>(t, s), e);
    ripemd160_line_as<P, R + 1, LAST, RIGHT>(X, Y, m);
  }
}

// ripemd160.cuh's ripemd160_compress over ripemd160_line_as
template <class P, int MW>
DISTPOW_HD void ripemd160_compress_as(uint32_t st[5], const uint32_t m[16]) {
  constexpr int LAST_L = ripemd160_last(MW, false);
  constexpr int LAST_R = ripemd160_last(MW, true);
  uint32_t XL[LAST_L + 6], XR[LAST_R + 6], YL[LAST_L + 3], YR[LAST_R + 3];
  XL[0] = XR[0] = YL[0] = YR[0] = st[0];
  XL[1] = XR[1] = YL[1] = YR[1] = st[4];
  XL[2] = XR[2] = st[3];
  XL[3] = XR[3] = st[2];
  XL[4] = XR[4] = st[1];
  ripemd160_line_as<P, 0, LAST_L, false>(XL, YL, m);
  ripemd160_line_as<P, 0, LAST_R, true>(XR, YR, m);
  const uint32_t h0 = st[0], h1 = st[1], h2 = st[2], h3 = st[3], h4 = st[4];
  constexpr bool C = P::CROT;
  if constexpr (MW >= 5) st[0] = h1 + XL[83] + rotl_c<C>(XR[82], 10);
  if constexpr (MW >= 4) st[1] = h2 + rotl_c<C>(XL[82], 10) + rotl_c<C>(XR[81], 10);
  if constexpr (MW >= 3) st[2] = h3 + rotl_c<C>(XL[81], 10) + rotl_c<C>(XR[80], 10);
  if constexpr (MW >= 2) st[3] = h4 + rotl_c<C>(XL[80], 10) + XR[84];
  st[4] = h0 + XL[84] + XR[83];
}

template <class P>
struct Ripemd160As : Ripemd160 {
  static DISTPOW_HD void block(uint32_t st[5], const uint32_t m[16]) {
    ripemd160_compress_as<P, 5>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[5], const uint32_t m[16]) {
    ripemd160_compress_as<P, MW>(st, m);
  }
};

// ---- BLAKE2b-256 -------------------------------------------------------

// (all int keys: chip_smoke.py reads a kernel's own keys from its mangled
// name as int, int, bool)
template <int SUM_, int R24_, int R16_, int R63_, int EVERY_OTHER_>
struct BlakeForms {
  static constexpr int SUM = SUM_, R24 = R24_, R16 = R16_, R63 = R63_;
  static constexpr bool EVERY_OTHER = EVERY_OTHER_ != 0;
};

// blake2b.cuh's blake2b_g in the forms of P (ROUTE false: rotates as
// funnel shifts)
template <class P, bool ROUTE>
DISTPOW_HD void blake2b_g_as(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t x,
                             uint64_t y) {
  constexpr int R24 = ROUTE ? P::R24 : ROT_SHF, R16 = ROUTE ? P::R16 : ROT_SHF,
                R63 = ROUTE ? P::R63 : ROT_SHF;
  a = add64_form<P::SUM>(add64_form<P::SUM>(a, b), x);
  d = rotr64(d ^ a, 32);
  c = add64_form<P::SUM>(c, d);
  b = rotr64_form<R24, 24>(b ^ c);
  a = add64_form<P::SUM>(add64_form<P::SUM>(a, b), y);
  d = rotr64_form<R16, 16>(d ^ a);
  c = add64_form<P::SUM>(c, d);
  b = rotr64_form<R63, 63>(b ^ c);
}

template <class P, int R, uint32_t LIVE>
DISTPOW_HD void blake2b_rounds_as(uint64_t v[16], const uint64_t m[16]) {
  if constexpr (R < 12) {
    DISTPOW_UNROLL
    for (int g = 0; g < 8; ++g) {
      if (R < 11 || g < 4 || blake2b_g_live(g, LIVE)) {
        uint64_t &a = v[blake2b_lane(g, 0)], &b = v[blake2b_lane(g, 1)],
                 &c = v[blake2b_lane(g, 2)], &d = v[blake2b_lane(g, 3)];
        const uint64_t x = m[blake2b_sigma(R, 2 * g)], y = m[blake2b_sigma(R, 2 * g + 1)];
        if (P::EVERY_OTHER && g % 2) blake2b_g_as<P, false>(a, b, c, d, x, y);
        else blake2b_g_as<P, true>(a, b, c, d, x, y);
      }
    }
    blake2b_rounds_as<P, R + 1, LIVE>(v, m);
  }
}

// blake2b.cuh's blake2b_compress over blake2b_rounds_as
template <class P, uint32_t LIVE>
DISTPOW_HD void blake2b_compress_as(uint32_t st[16], const uint32_t m[36]) {
  uint64_t h[8], v[16], w[16];
  DISTPOW_UNROLL
  for (int i = 0; i < 8; ++i) {
    h[i] = ((uint64_t)st[2 * i + 1] << 32) | st[2 * i];
    v[i] = h[i];
    v[i + 8] = blake2b_iv(i);
  }
  DISTPOW_UNROLL
  for (int i = 0; i < 16; ++i) w[i] = ((uint64_t)m[2 * i + 1] << 32) | m[2 * i];
  v[12] ^= ((uint64_t)m[33] << 32) | m[32];
  v[14] ^= ((uint64_t)m[35] << 32) | m[34];
  blake2b_rounds_as<P, 0, LIVE>(v, w);
  DISTPOW_UNROLL
  for (int j = 0; j < 8; ++j) {
    if (LIVE >> j & 1) {
      const uint64_t out = h[j] ^ v[j] ^ v[j + 8];
      st[2 * j] = (uint32_t)out;
      st[2 * j + 1] = (uint32_t)(out >> 32);
    }
  }
}

template <class P>
struct Blake2bAs : Blake2b_256 {
  static DISTPOW_HD void block(uint32_t st[16], const uint32_t m[36]) {
    blake2b_compress_as<P, 0xFFu>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[16], const uint32_t m[36]) {
    blake2b_compress_as<P, 0xFu & (0xFu << (8 - MW) / 2)>(st, m);
  }
};

// ---- SHA-512 and SHA-384 -----------------------------------------------

template <int SUM_, int BIG_, int SMALL_, int SHR_FMA_>
struct ShaForms {
  static constexpr int SUM = SUM_, BIG = BIG_, SMALL = SMALL_;
  static constexpr bool SHR_FMA = SHR_FMA_ != 0;
};

// sha512.cuh's sha512_rounds in the forms of P
template <class P, int R, int MAX_A, int MAX_E>
DISTPOW_HD void sha512_rounds_as(uint64_t* A, uint64_t* E, uint64_t* w) {
  constexpr int S = P::SUM, B = P::BIG, L = P::SMALL;
  if constexpr (R <= MAX_E) {
    if constexpr (R >= 16) {
      const uint64_t w15 = w[R - 15], w2 = w[R - 2];
      const uint64_t s1 = rotr64_form<L, 19>(w2) ^ rotr64_form<L, 61>(w2) ^
                          shr64_form<P::SHR_FMA, 6>(w2);
      const uint64_t s0 = rotr64_form<L, 1>(w15) ^ rotr64_form<L, 8>(w15) ^
                          shr64_form<P::SHR_FMA, 7>(w15);
      w[R] = add64_form<S>(add64_form<S>(add64_form<S>(s1, w[R - 7]), s0), w[R - 16]);
    }
    const uint64_t e1 = E[R + 3], f1 = E[R + 2], g1 = E[R + 1], h1 = E[R];
    constexpr uint64_t k = sha512_k(R);
    const uint64_t big1 = rotr64_form<B, 14>(e1) ^ rotr64_form<B, 18>(e1) ^ rotr64_form<B, 41>(e1);
    const uint64_t t1 = add64_form<S>(add64_form<S>(add64_form<S>(h1, big1),
                                                    (e1 & f1) ^ (~e1 & g1)),
                                      add64_form<S>(k, w[R]));
    E[R + 4] = add64_form<S>(A[R], t1);
    if constexpr (R <= MAX_A) {
      const uint64_t a1 = A[R + 3], b1 = A[R + 2], c1 = A[R + 1];
      const uint64_t big0 =
          rotr64_form<B, 28>(a1) ^ rotr64_form<B, 34>(a1) ^ rotr64_form<B, 39>(a1);
      A[R + 4] = add64_form<S>(add64_form<S>(t1, big0), (a1 & b1) ^ (a1 & c1) ^ (b1 & c1));
    }
    sha512_rounds_as<P, R + 1, MAX_A, MAX_E>(A, E, w);
  }
}

// sha512.cuh's sha512_compress over sha512_rounds_as
template <class P, int D, int MW>
DISTPOW_HD void sha512_compress_as(uint32_t st[16], const uint32_t m[32]) {
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
  sha512_rounds_as<P, 0, MAX_A, MAX_E>(A, E, w);
  DISTPOW_UNROLL
  for (int j = J0; j < D / 2; ++j) {
    const uint64_t v = h[j] + (j < 4 ? A[83 - j] : E[87 - j]);
    st[2 * j] = (uint32_t)(v >> 32);
    st[2 * j + 1] = (uint32_t)v;
  }
}

template <class P, int D>
struct Sha512As : std::conditional_t<D == 16, Sha512, Sha384> {
  static DISTPOW_HD void block(uint32_t st[16], const uint32_t m[32]) {
    sha512_compress_as<P, 16, 16>(st, m);
  }

  template <int MW>
  static DISTPOW_HD void last(uint32_t st[16], const uint32_t m[32]) {
    sha512_compress_as<P, D, MW>(st, m);
  }
};

}  // namespace distpow
