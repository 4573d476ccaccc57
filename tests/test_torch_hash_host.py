"""Host twins of every kernel but md5's: the scaffold
``csrc/hash_search.cuh`` with ``sha256.cuh``, ``sha1.cuh``,
``ripemd160.cuh``, ``sha512.cuh``, ``sha3.cuh`` and ``blake2b.cuh``, built
with g++.

The headers' functions are ``__host__ __device__``; compiled for the host
they run the kernels' own decode, byte placement (big-endian for the SHA-1
and SHA-2 families, little-endian for RIPEMD-160, SHA3-256 and
BLAKE2b-256), rows with parameter words (BLAKE2b's), rounds with their
mask-word pruning, and mask check, one candidate at a time.  Every
``(MASK_WORDS, N_BLOCKS, POW2)`` the launcher instantiates is held to the
port's plain step, and the full-width state to hashlib, exactly (integer
hashing).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from distpow_tpu_torch.models import puzzle
from distpow_tpu_torch.models.registry import get_hash_model
from distpow_tpu_torch.ops.hash_cuda import kernel_layout, kernel_mask_words
from distpow_tpu_torch.ops.operands import make_operands, u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec, pack_reference_bytes
from distpow_tpu_torch.ops.search_step import SENTINEL, plain_search

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "distpow_tpu_torch", "csrc")

# model -> (header, struct)
HASHES = {"sha256": ("sha256.cuh", "Sha256"), "sha256d": ("sha256.cuh", "Sha256d"),
          "sha1": ("sha1.cuh", "Sha1"), "ripemd160": ("ripemd160.cuh", "Ripemd160")}
# the 64-bit hashes, 128- and 136-byte blocks
WIDE = {"sha512": ("sha512.cuh", "Sha512"), "sha384": ("sha512.cuh", "Sha384"),
        "sha3_256": ("sha3.cuh", "Sha3_256"), "blake2b_256": ("blake2b.cuh", "Blake2b_256")}

DRIVER = r"""
#include HASH_HEADER
using namespace distpow;
using H = HASH;

template <int MW, int NB, bool POW2>
static uint32_t search(const uint32_t* init, const uint32_t* base, const uint32_t* masks,
                       const Layout& L, uint32_t n) {
  for (uint32_t f = 0; f < n; ++f) {
    uint32_t tb, chunk;
    decode<POW2>(L, f, tb, chunk);
    if (hash_candidate_hits<H, MW, NB>(init, base, masks, L, tb, chunk)) return f;
  }
  return SENTINEL;
}

// the launcher's dispatch: mask words 1-4 or the full digest
template <int NB, bool POW2>
static uint32_t search_mw(int mw, const uint32_t* i, const uint32_t* b, const uint32_t* m,
                          const Layout& L, uint32_t n) {
  if (mw == H::DIGEST_WORDS) return search<H::DIGEST_WORDS, NB, POW2>(i, b, m, L, n);
  switch (mw) {
    case 1: return search<1, NB, POW2>(i, b, m, L, n);
    case 2: return search<2, NB, POW2>(i, b, m, L, n);
    case 3: return search<3, NB, POW2>(i, b, m, L, n);
    case 4: return search<4, NB, POW2>(i, b, m, L, n);
    default: return 0xFFFFFFFEu;  // no kernel for this count
  }
}

extern "C" {
// the rows the kernel hashes for candidate (tb, chunk)
void host_rows(int n_blocks, const uint32_t* base, uint32_t chunk0, uint32_t tb_lo,
               uint32_t tbc, int log_tbc, int var_word, int var_shift, uint32_t chunk_mask,
               uint32_t tb, uint32_t chunk, uint32_t* out) {
  Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  uint32_t first, second;
  var_words<H::BIG_ENDIAN_WORDS>(L, tb, chunk, first, second);
  for (int b = 0; b < n_blocks; ++b) message_block<H>(base, L, first, second, b, out + b * H::ROW_WORDS);
}

void host_state(int n_blocks, const uint32_t* init, const uint32_t* base, uint32_t chunk0,
                uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word, int var_shift,
                uint32_t chunk_mask, uint32_t tb, uint32_t chunk, uint32_t* out) {
  Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  if (n_blocks == 1) hash_tail_state<H, H::DIGEST_WORDS, 1>(init, base, L, tb, chunk, out);
  else hash_tail_state<H, H::DIGEST_WORDS, 2>(init, base, L, tb, chunk, out);
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
def twins(tmp_path_factory):
    """One g++ build per hash, all started together."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("hash_twins")
    src = d / "twin.cpp"
    src.write_text(DRIVER)
    procs = {}
    for name, (header, struct) in {**HASHES, **WIDE}.items():
        lib = d / f"lib{name}.so"
        cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
               f'-DHASH_HEADER="{header}"', f"-DHASH={struct}", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                       lib)
    u32, i32 = ctypes.c_uint32, ctypes.c_int
    layout = [u32, u32, u32, i32, i32, i32, u32]
    dlls = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, out.decode()[-4000:]
        dll = ctypes.CDLL(str(lib))
        dll.host_rows.argtypes = [i32, U32P, *layout, u32, u32, U32P]
        dll.host_rows.restype = None
        dll.host_state.argtypes = [i32, U32P, U32P, *layout, u32, u32, U32P]
        dll.host_state.restype = None
        dll.host_search.argtypes = [i32, i32, U32P, U32P, U32P, *layout, u32]
        dll.host_search.restype = u32
        dlls[name] = dll
    return dlls


def _arr(values):
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint32).reshape(-1))
    return a, a.ctypes.data_as(U32P)


def _layout(spec, model, chunk0, tb_lo, tbc):
    var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, model)
    log_tbc = tbc.bit_length() - 1 if tbc & (tbc - 1) == 0 else -1
    return [chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask]


@pytest.mark.parametrize("name", sorted(HASHES))
@pytest.mark.parametrize("nonce_len", [0, 4, 13, 54, 55, 56, 62, 63, 64, 100, 119, 120])
def test_twin_digest_matches_hashlib(twins, name, nonce_len):
    model = get_hash_model(name)
    rng = np.random.default_rng(nonce_len)
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    for width in range(5):
        spec = build_tail_spec(nonce, width, model)
        init, init_p = _arr(spec.init_state)
        base, base_p = _arr(spec.base_words)
        out, out_p = _arr([0] * len(model.init_state))
        for _ in range(6):
            tb = int(rng.integers(0, 256))
            chunk = int(rng.integers(0, 256 ** width)) if width else 0
            twins[name].host_state(spec.n_blocks, init_p, base_p,
                                   *_layout(spec, model, 0, 0, 256), tb, chunk, out_p)
            h = puzzle.new_hash(name)
            h.update(pack_reference_bytes(nonce, tb, chunk, width))
            assert model.state_to_digest(out.tolist()) == h.digest(), (width, tb, chunk)


def _mask_word_cases():
    """(model, mask_words): every instantiated count, and for sha256 and
    sha256d one count the launcher pads to the full digest."""
    out = []
    for name in sorted(HASHES):
        d = get_hash_model(name).digest_words
        out += [(name, mw) for mw in sorted({1, 2, 3, 4, d, 6 if d == 8 else d})]
    return out


@pytest.mark.parametrize("name,mask_words", _mask_word_cases())
@pytest.mark.parametrize("nonce_len", [5, 60])  # one and two tail blocks
@pytest.mark.parametrize("tb_lo,tbc", [(64, 64), (16, 96)])  # POW2 true and false
def test_twin_first_hit_matches_plain_step(twins, name, mask_words, nonce_len, tb_lo, tbc):
    model = get_hash_model(name)
    rng = np.random.default_rng(1000 * mask_words + nonce_len + tbc + len(name))
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    spec = build_tail_spec(nonce, 3, model)
    assert spec.n_blocks == (1 if nonce_len < 56 else 2)
    # sparse masks over the trailing words: hits at a rate of 2^-9
    masks = [0] * mask_words
    for b in rng.choice(32 * mask_words, size=9, replace=False):
        masks[int(b) // 32] |= 1 << (int(b) % 32)
    chunk0, batch = 70000, 40 * tbc
    ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, "cpu")
    want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                  model=model))
    # the launcher's rule: wider masks are padded with leading zero words
    kmw = kernel_mask_words(mask_words, model)
    init, init_p = _arr(spec.init_state)
    base, base_p = _arr(spec.base_words)
    m, m_p = _arr([0] * (kmw - mask_words) + masks)
    layout = _layout(spec, model, chunk0, tb_lo, tbc)
    got = twins[name].host_search(spec.n_blocks, kmw, init_p, base_p, m_p, *layout, batch)
    assert got == want
    # a mask no candidate meets gives the miss value
    full, full_p = _arr([0xFFFFFFFF] * kmw)
    assert twins[name].host_search(spec.n_blocks, kmw, init_p, base_p, full_p,
                                   *layout, 256) == SENTINEL


def _wide_nonce_lens():
    """(model, nonce length): around one and two block boundaries; a
    sha512/384 tail takes a second block from 112 content bytes on, a
    sha3_256 one from 136, a blake2b_256 one above 128."""
    out = []
    for name in sorted(WIDE):
        b = get_hash_model(name).block_bytes
        out += [(name, n) for n in (0, 13, b - 18, b - 17, b - 5, b - 2, b - 1, b, b + 7,
                                    2 * b - 3, 2 * b + 40)]
    return out


@pytest.mark.parametrize("name,nonce_len", _wide_nonce_lens())
def test_wide_twin_digest_matches_hashlib(twins, name, nonce_len):
    model = get_hash_model(name)
    rng = np.random.default_rng(nonce_len + len(name))
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    for width in range(5):
        spec = build_tail_spec(nonce, width, model)
        init, init_p = _arr(spec.init_state)
        base, base_p = _arr(spec.base_words)
        out, out_p = _arr([0] * len(model.init_state))
        for _ in range(4):
            tb = int(rng.integers(0, 256))
            chunk = int(rng.integers(0, 256 ** width)) if width else 0
            twins[name].host_state(spec.n_blocks, init_p, base_p,
                                   *_layout(spec, model, 0, 0, 256), tb, chunk, out_p)
            h = puzzle.new_hash(name)
            h.update(pack_reference_bytes(nonce, tb, chunk, width))
            assert model.state_to_digest(out.tolist()) == h.digest(), (width, tb, chunk)


@pytest.mark.parametrize("name", sorted(HASHES) + sorted(WIDE))
def test_twin_rows_match_packing_at_every_offset(twins, name):
    """The rows the kernel hashes, its byte placement from
    ``kernel_layout``'s word and shift, equal packing's rows with the
    variable bytes at packing's own locations: every offset of the run in
    two blocks, every width.  For blake2b_256 a run that crosses the block
    boundary (offsets 124-127) skips block 0's four parameter words."""
    from distpow_tpu_torch.ops.packing import make_words

    model = get_hash_model(name)
    rng = np.random.default_rng(len(name))
    straddles = 0
    for nonce_len in range(2 * model.block_bytes):
        for width in range(5):
            spec = build_tail_spec(bytes(nonce_len), width, model)
            tb, chunk = int(rng.integers(0, 256)), int(rng.integers(0, 1 << 32))
            chunk &= (1 << (8 * width)) - 1
            base, base_p = _arr(spec.base_words)
            out, out_p = _arr([0] * base.size)
            twins[name].host_rows(spec.n_blocks, base_p, *_layout(spec, model, 0, 0, 256),
                                  tb, chunk, out_p)
            want = [int(w) for row in make_words(spec, tb, chunk) for w in row]
            assert out.tolist() == want, (nonce_len, width)
            straddles += bool(spec.chunk_locs) and spec.chunk_locs[-1][0] != spec.tb_loc[0]
    assert straddles


def _wide_mask_word_cases():
    """(model, mask_words): every instantiated count, and one count the
    launcher pads to the full digest."""
    out = []
    for name in sorted(WIDE):
        d = get_hash_model(name).digest_words
        out += [(name, mw) for mw in (1, 2, 3, 4, d - 1, d)]
    return out


@pytest.mark.parametrize("name,mask_words", _wide_mask_word_cases())
@pytest.mark.parametrize("tail", ["one_block", "two_blocks"])
@pytest.mark.parametrize("tb_lo,tbc", [(64, 64), (16, 96)])  # POW2 true and false
def test_wide_twin_first_hit_matches_plain_step(twins, name, mask_words, tail, tb_lo, tbc):
    """One-block tails, and two-block tails whose variable run crosses the
    block boundary (bytes B-2..B+1 of a B-byte block)."""
    model = get_hash_model(name)
    nonce_len = 5 if tail == "one_block" else model.block_bytes - 2
    rng = np.random.default_rng(1000 * mask_words + nonce_len + tbc + len(name))
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    spec = build_tail_spec(nonce, 3, model)
    assert spec.n_blocks == (1 if tail == "one_block" else 2)
    masks = [0] * mask_words
    for b in rng.choice(32 * mask_words, size=9, replace=False):
        masks[int(b) // 32] |= 1 << (int(b) % 32)
    chunk0, batch = 70000, 24 * tbc
    ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, "cpu")
    want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                  model=model))
    kmw = kernel_mask_words(mask_words, model)
    init, init_p = _arr(spec.init_state)
    base, base_p = _arr(spec.base_words)
    m, m_p = _arr([0] * (kmw - mask_words) + masks)
    layout = _layout(spec, model, chunk0, tb_lo, tbc)
    got = twins[name].host_search(spec.n_blocks, kmw, init_p, base_p, m_p, *layout, batch)
    assert got == want
    full, full_p = _arr([0xFFFFFFFF] * kmw)
    assert twins[name].host_search(spec.n_blocks, kmw, init_p, base_p, full_p,
                                   *layout, 256) == SENTINEL
