"""The round variants of ``tools/round_variants.cuh`` (the FMA-pipe forms
of the md5, sha256, sha1, ripemd160, blake2b_256, sha512 and sha384 rounds that
``tools/round_variants.py`` times on the card), built with g++.

On the host their sum and rotate forms (``tools/fma_forms.cuh``) are the
same integer arithmetic as on the card, written in C++: the carry of
``add.cc``/``madc``, the sum of ``mad.wide``, a rotate's limb as
``hi * 2^k + hi32(lo * 2^k)``, a 32-bit rotate (``rotl_fma``) as the
two words of ``x * 2^s``.  Every variant is held to its model's
kernel (``csrc/``) exactly, for a full compression and for the last block
at every mask-word count, with the state words the count leaves live; md5's,
built for one tail layout, by the state of a candidate of a one-block tail
at that layout."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from distpow_tpu_torch.tools.round_variants import VARIANTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "distpow_tpu_torch", "csrc")
TOOLS = os.path.join(REPO, "distpow_tpu_torch", "tools")
NAMES = list(VARIANTS)
DIGEST_WORDS = {"blake2b_256": 8, "sha512": 16, "sha384": 12, "md5": 4, "sha256": 8, "sha1": 5,
                "ripemd160": 5}
ROW_WORDS = {"blake2b_256": 36, "sha512": 32, "sha384": 32, "md5": 16, "sha256": 16, "sha1": 16,
             "ripemd160": 16}

DRIVER = r"""
#include "round_variants.cuh"
using namespace distpow;

// the MW trailing words of the state of candidate (tb, chunk) = (st[4] &
// 0xFF, st[5]) of a one-block tail of prefix state st[0..3] and row m, a run
// at V's var_word from byte 1, three chunk bytes
template <class V, int MW>
static void keyed_state(uint32_t* st, const uint32_t* m) {
  const typename V::template Tail<1> tail(st, m);
  const Layout L{0, 0, 1, 0, V::VAR_WORD, 8, 0xFFFFFFu};
  uint32_t out[4];
  tail.template state<MW>(L, st[4] & 0xFFu, st[5], out);
  for (int j = 4 - MW; j < 4; ++j) st[j] = out[j];
}

// V::last<mw>, or V::block for mw = 0 (for a hash built for one tail
// layout, keyed_state at mw, or at the full digest for mw = 0)
template <class V, int MW = 1>
static int compress(int mw, uint32_t* st, const uint32_t* m) {
  if (mw == 0) {
    if constexpr (KeyedByVarWord<V>::value) keyed_state<V, 4>(st, m);
    else V::block(st, m);
    return 0;
  }
  if constexpr (MW > V::DIGEST_WORDS) {
    return 1;
  } else {
    if (mw == MW) {
      if constexpr (KeyedByVarWord<V>::value) keyed_state<V, MW>(st, m);
      else V::template last<MW>(st, m);
      return 0;
    }
    return compress<V, MW + 1>(mw, st, m);
  }
}

extern "C" int run(int variant, int mw, uint32_t* st, const uint32_t* m) {
  switch (variant) {
CASES
    default: return 2;
  }
}
"""


@pytest.fixture(scope="module")
def variants_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("round_variants")
    src, lib = d / "variants.cpp", d / "libvariants.so"
    cases = "\n".join(f"    case {i}: return compress<{VARIANTS[n][1]}>(mw, st, m);"
                      for i, n in enumerate(NAMES))
    src.write_text(DRIVER.replace("CASES", cases))
    proc = subprocess.run([gxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-I", TOOLS, "-I", CSRC,
                           "-o", str(lib), str(src)], capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    dll.run.argtypes = [ctypes.c_int, ctypes.c_int, u32p, u32p]
    dll.run.restype = ctypes.c_int
    return dll


def _compress(dll, name, mw, st, m):
    st = np.ascontiguousarray(st, dtype=np.uint32).copy()
    m = np.ascontiguousarray(m, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    rc = dll.run(NAMES.index(name), mw, st.ctypes.data_as(u32p), m.ctypes.data_as(u32p))
    assert rc == 0, (name, mw, rc)
    return st


@pytest.mark.parametrize("name", [n for n in NAMES if n not in DIGEST_WORDS])
def test_variant_matches_kernel_rounds(variants_twin, name):
    """The variant's compression equals its model's kernel's: the whole
    state after a full block, and the MW trailing digest words after the
    last block at every MW from 1 to the digest (exact)."""
    model = VARIANTS[name][0]
    d = DIGEST_WORDS[model]
    rng = np.random.default_rng(len(name))
    for trial in range(3):
        st = rng.integers(0, 1 << 32, size=16, dtype=np.uint64).astype(np.uint32)
        m = rng.integers(0, 1 << 32, size=ROW_WORDS[model], dtype=np.uint64).astype(np.uint32)
        want = _compress(variants_twin, model, 0, st, m)
        assert _compress(variants_twin, name, 0, st, m).tolist() == want.tolist(), trial
        for mw in range(1, d + 1):
            want = _compress(variants_twin, model, mw, st, m)[d - mw:d]
            got = _compress(variants_twin, name, mw, st, m)[d - mw:d]
            assert got.tolist() == want.tolist(), (trial, mw)


def test_every_variant_names_a_served_model():
    """Each model's kernel as built is among the variants, and every other
    variant's name starts with its model's."""
    for model in DIGEST_WORDS:
        assert VARIANTS[model][0] == model
    for name, (model, _) in VARIANTS.items():
        assert name == model or name.startswith(model + "."), name


FORMS_DRIVER = r"""
#include "fma_forms.cuh"
using namespace distpow;

extern "C" uint64_t sum3(int wide, uint64_t x, uint64_t y, uint64_t z) {
  return wide ? add64_wide(add64_wide(x, y), z) : add64_carry(add64_carry(x, y), z);
}

template <int F>
static uint64_t rot(int s, uint64_t x) {
  switch (s) {
ROT_CASES
    default: return 0;
  }
}

extern "C" uint64_t rotr(int fma, int s, uint64_t x) {
  return fma ? rot<ROT_FMA>(s, x) : rot<ROT_HALF>(s, x);
}

extern "C" uint32_t rotl32_fma(uint32_t x, int s, uint32_t y) { return rotl_fma(x, s, y); }
extern "C" uint32_t rotl32_shf(uint32_t x, int s) { return rotl32(x, s); }
"""
# every rotate distance of a BLAKE2b G and a SHA-512 round but 32 (a swap)
ROTATES = (1, 8, 14, 16, 18, 19, 24, 28, 34, 39, 41, 61, 63)
M64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def forms_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("fma_forms")
    src, lib = d / "forms.cpp", d / "libforms.so"
    cases = "\n".join(f"    case {s}: return rotr64_form<F, {s}>(x);" for s in ROTATES)
    src.write_text(FORMS_DRIVER.replace("ROT_CASES", cases))
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", TOOLS, "-I", CSRC,
                           "-o", str(lib), str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    u64, i32 = ctypes.c_uint64, ctypes.c_int
    dll.sum3.argtypes, dll.sum3.restype = [i32, u64, u64, u64], u64
    dll.rotr.argtypes, dll.rotr.restype = [i32, i32, u64], u64
    u32 = ctypes.c_uint32
    dll.rotl32_fma.argtypes, dll.rotl32_fma.restype = [u32, i32, u32], u32
    dll.rotl32_shf.argtypes, dll.rotl32_shf.restype = [u32, i32], u32
    return dll


@pytest.mark.parametrize("wide", [0, 1])
@pytest.mark.parametrize("terms", [
    (0xFFFFFFFF, 1, 0),                    # the low limb's carry
    (M64, 1, 0),                           # both limbs all ones: wraps to 0
    (M64, M64, 0),
    (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),  # three terms that carry twice
    (M64, M64, M64),
    (0x00000001FFFFFFFF, 0xFFFFFFFF00000001, 0x80000000FFFFFFFF),
])
def test_fma_sums_match_uint64_addition(forms_twin, wide, terms):
    """The routed 64-bit sums (high limb through ``madc`` as IMAD.X, or
    through ``mad.wide``) are uint64 addition modulo 2^64 at the carry
    edges and on random terms (exact)."""
    x, y, z = terms
    assert forms_twin.sum3(wide, x, y, z) == (x + y + z) & M64
    rng = np.random.default_rng(wide)
    for x, y, z in rng.integers(0, 1 << 63, size=(50, 3), dtype=np.uint64).tolist():
        x, y = x << 1 | 1, y << 1  # use the top bit too
        assert forms_twin.sum3(wide, x, y, z) == (x + y + z) & M64


@pytest.mark.parametrize("fma", [0, 1])
@pytest.mark.parametrize("s", ROTATES)
def test_fma_rotates_match_rotr64(forms_twin, fma, s):
    """A rotate with one limb (ROT_HALF) or both (ROT_FMA) as IMAD +
    IMAD.HI is rotr64 for every distance the rounds use (exact)."""
    rng = np.random.default_rng(s)
    for x in [0, M64, 0x8000000000000001, *rng.integers(0, 1 << 63, size=40,
                                                        dtype=np.uint64).tolist()]:
        x = int(x)
        want = ((x >> s) | (x << (64 - s))) & M64
        assert forms_twin.rotr(fma, s, x) == want, hex(x)


@pytest.mark.parametrize("s", range(1, 32))
def test_fma_rotl32_matches_rotl32(forms_twin, s):
    """``rotl_fma(x, s)`` (the low and high words of x * 2^s, as IMAD and
    IMAD.HI on the card) is ``rotl32`` for every distance 1..31, and with an
    addend y it is ``rotl32(x, s) + y`` modulo 2^32 (exact)."""
    rng = np.random.default_rng(100 + s)
    words = [0, 1, 0xFFFFFFFF, 0x80000000, *rng.integers(0, 1 << 32, size=40,
                                                         dtype=np.uint64).tolist()]
    addends = rng.integers(0, 1 << 32, size=len(words), dtype=np.uint64).tolist()
    for x, y in zip(words, addends):
        x, y = int(x), int(y)
        want = ((x << s) | (x >> (32 - s))) & 0xFFFFFFFF
        assert forms_twin.rotl32_shf(x, s) == want, hex(x)
        assert forms_twin.rotl32_fma(x, s, 0) == want, hex(x)
        assert forms_twin.rotl32_fma(x, s, y) == (want + y) & 0xFFFFFFFF, (hex(x), hex(y))
