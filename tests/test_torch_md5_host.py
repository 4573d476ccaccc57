"""Host twin of the CUDA kernel body: ``csrc/md5.cuh`` built with g++.

The header's functions are ``__host__ __device__``; compiled for the host
they run the kernel's own decode, packing, MD5 rounds and mask check, one
candidate at a time.  Each ``(MASK_WORDS, N_BLOCKS, POW2)`` instantiation
is held to hashlib and to the port's plain step, exactly (integer hashing).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from distpow_tpu_torch.models.registry import MD5
from distpow_tpu_torch.ops.hash_cuda import kernel_layout
from distpow_tpu_torch.ops.operands import make_operands, u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec, pack_reference_bytes
from distpow_tpu_torch.ops.search_step import SENTINEL, plain_search

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "distpow_tpu_torch", "csrc")

DRIVER = r"""
#include "md5.cuh"
using namespace distpow;

template <int NB>
static void state_nb(const uint32_t* init, const uint32_t* base, const Layout& L,
                     uint32_t tb, uint32_t chunk, uint32_t* out) {
  tail_state<NB>(init, base, L, tb, chunk, out);
}

template <int MW, int NB, bool POW2>
static uint32_t search(const uint32_t* init, const uint32_t* base, const uint32_t* masks,
                       const Layout& L, uint32_t n) {
  for (uint32_t f = 0; f < n; ++f) {
    uint32_t tb, chunk;
    decode<POW2>(L, f, tb, chunk);
    if (candidate_hits<MW, NB>(init, base, masks, L, tb, chunk)) return f;
  }
  return SENTINEL;
}

template <int NB, bool POW2>
static uint32_t search_mw(int mw, const uint32_t* i, const uint32_t* b, const uint32_t* m,
                          const Layout& L, uint32_t n) {
  switch (mw) {
    case 1: return search<1, NB, POW2>(i, b, m, L, n);
    case 2: return search<2, NB, POW2>(i, b, m, L, n);
    case 3: return search<3, NB, POW2>(i, b, m, L, n);
    default: return search<4, NB, POW2>(i, b, m, L, n);
  }
}

extern "C" {
void host_tail_state(int n_blocks, const uint32_t* init, const uint32_t* base,
                     uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc,
                     int var_word, int var_shift, uint32_t chunk_mask,
                     uint32_t tb, uint32_t chunk, uint32_t* out) {
  Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  if (n_blocks == 1) state_nb<1>(init, base, L, tb, chunk, out);
  else state_nb<2>(init, base, L, tb, chunk, out);
}

uint32_t host_search(int n_blocks, int mask_words, const uint32_t* init,
                     const uint32_t* base, const uint32_t* masks, uint32_t chunk0,
                     uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word,
                     int var_shift, uint32_t chunk_mask, uint32_t n) {
  Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  const bool pow2 = log_tbc >= 0;
  if (n_blocks == 1)
    return pow2 ? search_mw<1, true>(mask_words, init, base, masks, L, n)
                : search_mw<1, false>(mask_words, init, base, masks, L, n);
  return pow2 ? search_mw<2, true>(mask_words, init, base, masks, L, n)
              : search_mw<2, false>(mask_words, init, base, masks, L, n);
}
}
"""

U32P = ctypes.POINTER(ctypes.c_uint32)


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twin cannot be built")
    d = tmp_path_factory.mktemp("md5_twin")
    src, lib = d / "twin.cpp", d / "libtwin.so"
    src.write_text(DRIVER)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    u32, i32 = ctypes.c_uint32, ctypes.c_int
    layout = [u32, u32, u32, i32, i32, i32, u32]
    dll.host_tail_state.argtypes = [i32, U32P, U32P, *layout, u32, u32, U32P]
    dll.host_tail_state.restype = None
    dll.host_search.argtypes = [i32, i32, U32P, U32P, U32P, *layout, u32]
    dll.host_search.restype = u32
    return dll


def _arr(values):
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint32).reshape(-1))
    return a, a.ctypes.data_as(U32P)


def _layout(spec, chunk0, tb_lo, tbc):
    var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, MD5)
    log_tbc = tbc.bit_length() - 1 if tbc & (tbc - 1) == 0 else -1
    return [chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask]


@pytest.mark.parametrize("nonce_len", [0, 4, 13, 54, 55, 56, 62, 63, 64, 100, 119, 120])
def test_twin_digest_matches_hashlib(twin, nonce_len):
    rng = np.random.default_rng(nonce_len)
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    for width in range(5):
        spec = build_tail_spec(nonce, width, MD5)
        init, init_p = _arr(spec.init_state)
        base, base_p = _arr(spec.base_words)
        out, out_p = _arr([0, 0, 0, 0])
        for _ in range(8):
            tb = int(rng.integers(0, 256))
            chunk = int(rng.integers(0, 256 ** width)) if width else 0
            twin.host_tail_state(spec.n_blocks, init_p, base_p,
                                 *_layout(spec, 0, 0, 256), tb, chunk, out_p)
            msg = pack_reference_bytes(nonce, tb, chunk, width)
            assert MD5.state_to_digest(out.tolist()) == hashlib.md5(msg).digest()


@pytest.mark.parametrize("mask_words", [1, 2, 3, 4])
@pytest.mark.parametrize("nonce_len", [5, 60])  # one and two tail blocks
@pytest.mark.parametrize("tb_lo,tbc", [(64, 64), (16, 96)])  # POW2 true and false
def test_twin_first_hit_matches_plain_step(twin, mask_words, nonce_len, tb_lo, tbc):
    rng = np.random.default_rng(1000 * mask_words + nonce_len + tbc)
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    spec = build_tail_spec(nonce, 3, MD5)
    assert spec.n_blocks == (1 if nonce_len < 56 else 2)
    # sparse masks over the trailing words: hits at a rate of 2^-9
    masks = [0] * mask_words
    for b in rng.choice(32 * mask_words, size=9, replace=False):
        masks[int(b) // 32] |= 1 << (int(b) % 32)
    chunk0, batch = 70000, 40 * tbc
    ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, "cpu")
    want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch, model=MD5))
    init, init_p = _arr(spec.init_state)
    base, base_p = _arr(spec.base_words)
    m, m_p = _arr(masks)
    got = twin.host_search(spec.n_blocks, mask_words, init_p, base_p, m_p,
                           *_layout(spec, chunk0, tb_lo, tbc), batch)
    assert got == want
    # a mask no candidate meets gives the miss value
    full, full_p = _arr([0xFFFFFFFF] * mask_words)
    assert twin.host_search(spec.n_blocks, mask_words, init_p, base_p, full_p,
                            *_layout(spec, chunk0, tb_lo, tbc), 256) == SENTINEL
