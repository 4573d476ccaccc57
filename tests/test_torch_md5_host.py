"""Host twin of the md5 kernel body: ``csrc/md5.cuh`` over the scaffold
``csrc/hash_search.cuh``, built with g++.

The headers' functions are ``__host__ __device__``; compiled for the host
they run the kernel's own decode, run placement, MD5 rounds built for the
tail's var_word (``Md5<VW>``, its per-thread constants ``Md5Tail``) and
mask check, one candidate at a time.  Every ``(n_blocks, var_word)`` layout
the build instantiates is held, at mask words 1-4 (md5's full digest), to
the port's plain step, to hashlib and to the JAX package's ``_md5_tile``
(run eagerly on the CPU) and XLA search step; the per-thread table of
``K[i] + m[g]`` and the hoisted rounds are held to a plain MD5 in numpy.
All exactly (integer hashing).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from distpow_tpu_torch.models.md5 import MD5_K
from distpow_tpu_torch.models.registry import MD5
from distpow_tpu_torch.ops.hash_cuda import KEYED_LAYOUTS, kernel_layout
from distpow_tpu_torch.ops.operands import make_operands, u32_value
from distpow_tpu_torch.ops.packing import build_tail_spec, pack_reference_bytes
from distpow_tpu_torch.ops.search_step import SENTINEL, plain_search, step_operands

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "distpow_tpu_torch", "csrc")

DRIVER = r"""
#include "md5.cuh"
using namespace distpow;

// f(Md5<vw>{}) for the kernels' var_word vw, as md5_search.cu dispatches
template <int VW = 0, class F>
static uint32_t at_var_word(int vw, F f) {
  if constexpr (VW > 15) return 0xFFFFFFFEu;  // a run starts in the first block
  else return vw == VW ? f(Md5<VW>{}) : at_var_word<VW + 1>(vw, f);
}

template <class H, int MW, int NB, bool POW2>
static uint32_t search(const uint32_t* init, const uint32_t* base, const uint32_t* masks,
                       const Layout& L, uint32_t n) {
  if constexpr (!H::builds(NB)) {
    return 0xFFFFFFFEu;  // no kernel for this layout
  } else {
    const typename H::template Tail<NB> tail(init, base);
    for (uint32_t f = 0; f < n; ++f) {
      uint32_t tb, chunk;
      decode<POW2>(L, f, tb, chunk);
      if (keyed_candidate_hits<H, MW, NB>(tail, masks, L, tb, chunk)) return f;
    }
    return SENTINEL;
  }
}

template <class H, int NB, bool POW2>
static uint32_t search_mw(int mw, const uint32_t* i, const uint32_t* b, const uint32_t* m,
                          const Layout& L, uint32_t n) {
  switch (mw) {
    case 1: return search<H, 1, NB, POW2>(i, b, m, L, n);
    case 2: return search<H, 2, NB, POW2>(i, b, m, L, n);
    case 3: return search<H, 3, NB, POW2>(i, b, m, L, n);
    default: return search<H, 4, NB, POW2>(i, b, m, L, n);
  }
}

extern "C" {
// the full state of candidate (tb, chunk); 1 for a layout with no kernel
int host_tail_state(int n_blocks, const uint32_t* init, const uint32_t* base,
                    uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc,
                    int var_word, int var_shift, uint32_t chunk_mask,
                    uint32_t tb, uint32_t chunk, uint32_t* out) {
  const Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  return (int)at_var_word(var_word, [&](auto h) -> uint32_t {
    using H = decltype(h);
    auto go = [&](auto nb) -> uint32_t {
      constexpr int NB = decltype(nb)::value;
      if constexpr (!H::builds(NB)) {
        return 1;
      } else {
        const typename H::template Tail<NB> tail(init, base);
        tail.template state<4>(L, tb, chunk, out);
        return 0;
      }
    };
    return n_blocks == 1 ? go(std::integral_constant<int, 1>{})
                         : go(std::integral_constant<int, 2>{});
  });
}

uint32_t host_search(int n_blocks, int mask_words, const uint32_t* init,
                     const uint32_t* base, const uint32_t* masks, uint32_t chunk0,
                     uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word,
                     int var_shift, uint32_t chunk_mask, uint32_t n) {
  const Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  const bool pow2 = log_tbc >= 0;
  return at_var_word(var_word, [&](auto h) -> uint32_t {
    using H = decltype(h);
    if (n_blocks == 1)
      return pow2 ? search_mw<H, 1, true>(mask_words, init, base, masks, L, n)
                  : search_mw<H, 1, false>(mask_words, init, base, masks, L, n);
    return pow2 ? search_mw<H, 2, true>(mask_words, init, base, masks, L, n)
                : search_mw<H, 2, false>(mask_words, init, base, masks, L, n);
  });
}

// the per-thread constants: kc[64] (the first block's), hoisted[4], rows[2]
int host_tail_table(int n_blocks, int var_word, const uint32_t* init, const uint32_t* base,
                    uint32_t* kc, uint32_t* hoisted, uint32_t* rows) {
  return (int)at_var_word(var_word, [&](auto h) -> uint32_t {
    using H = decltype(h);
    auto go = [&](auto nb) -> uint32_t {
      constexpr int NB = decltype(nb)::value;
      if constexpr (!H::builds(NB)) {
        return 1;
      } else {
        const typename H::template Tail<NB> tail(init, base);
        for (int i = 0; i < 64; ++i) kc[i] = tail.kc[i];
        for (int i = 0; i < 4; ++i) hoisted[i] = tail.hoisted[i];
        rows[0] = tail.row0;
        rows[1] = tail.row1;
        return 0;
      }
    };
    return n_blocks == 1 ? go(std::integral_constant<int, 1>{})
                         : go(std::integral_constant<int, 2>{});
  });
}

// which (n_blocks, var_word) layouts have a kernel
int host_builds(int n_blocks, int var_word) {
  return (int)at_var_word(var_word, [&](auto h) -> uint32_t {
    return decltype(h)::builds(n_blocks) ? 1 : 0;
  });
}
}
"""

U32P = ctypes.POINTER(ctypes.c_uint32)

# every layout the build instantiates
LAYOUTS = [(nb, vw) for nb, words in sorted(KEYED_LAYOUTS["md5"].items()) for vw in words]


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twin cannot be built")
    d = tmp_path_factory.mktemp("md5_twin")
    src, lib = d / "twin.cpp", d / "libtwin.so"
    src.write_text(DRIVER)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True, capture_output=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    u32, i32 = ctypes.c_uint32, ctypes.c_int
    layout = [u32, u32, u32, i32, i32, i32, u32]
    dll.host_tail_state.argtypes = [i32, U32P, U32P, *layout, u32, u32, U32P]
    dll.host_tail_state.restype = i32
    dll.host_search.argtypes = [i32, i32, U32P, U32P, U32P, *layout, u32]
    dll.host_search.restype = u32
    dll.host_tail_table.argtypes = [i32, i32, U32P, U32P, U32P, U32P, U32P]
    dll.host_tail_table.restype = i32
    dll.host_builds.argtypes = [i32, i32]
    dll.host_builds.restype = i32
    return dll


def _arr(values):
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint32).reshape(-1))
    return a, a.ctypes.data_as(U32P)


def _layout(spec, chunk0, tb_lo, tbc):
    var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, MD5)
    log_tbc = tbc.bit_length() - 1 if tbc & (tbc - 1) == 0 else -1
    return [chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask]


def layout_spec(n_blocks, var_word, seed):
    """A tail of ``n_blocks`` blocks whose run starts at message word
    ``var_word``: the nonce's remainder puts the thread byte there, the
    widest chunk that fits, and constant high chunk bytes (``extra``, as the
    driver's widths above 4 give them) push a short remainder into a second
    block.  Also a whole absorbed block before it for odd seeds."""
    rng = np.random.default_rng(seed)
    rem = 4 * var_word + int(rng.integers(0, 4))
    if n_blocks == 1:
        rem = min(rem, 53)  # room for a chunk byte
        width, extra = min(4, 54 - rem), b""
    else:
        width = int(rng.integers(1, 5))
        extra = bytes(rng.integers(1, 256, size=max(0, 56 - rem - 1 - width), dtype=np.uint8))
    nonce = rng.integers(0, 256, size=rem + 64 * (seed % 2), dtype=np.uint8).tobytes()
    spec = build_tail_spec(nonce, width, MD5, extra)
    assert (spec.n_blocks, kernel_layout(spec.tb_loc, spec.chunk_locs, MD5)[0]) == \
        (n_blocks, var_word)
    return nonce, width, extra, spec


def test_layouts_are_the_ones_packing_produces(twin):
    """The keyed set is every (n_blocks, var_word) that packing produces for
    md5 at any nonce length, width and constant high chunk bytes, and the
    twin's Md5<VW> builds exactly those."""
    seen = set()
    for rem in range(64):
        for width in range(5):
            for extra_len in range(0, 80, 3):
                spec = build_tail_spec(bytes(rem), width, MD5, bytes(extra_len))
                if spec.n_blocks > 2:
                    continue
                seen.add((spec.n_blocks, kernel_layout(spec.tb_loc, spec.chunk_locs, MD5)[0]))
    assert seen == set(LAYOUTS)
    for nb in (1, 2):
        for vw in range(16):
            assert twin.host_builds(nb, vw) == ((nb, vw) in seen), (nb, vw)


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
            assert twin.host_tail_state(spec.n_blocks, init_p, base_p,
                                        *_layout(spec, 0, 0, 256), tb, chunk, out_p) == 0
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


def _jax_tail_state(spec, tb, chunk):
    """The JAX package's _md5_tile, run eagerly, over the tail blocks of
    candidate (tb, chunk), at the full digest."""
    import jax.numpy as jnp

    from distpow_tpu.ops.md5_pallas import _md5_tile

    state = [jnp.uint32(x) for x in spec.init_state]
    blocks = [list(row) for row in spec.base_words]
    b, w, s = spec.tb_loc
    blocks[b][w] |= tb << s
    for j, (b, w, s) in enumerate(spec.chunk_locs):
        blocks[b][w] |= ((chunk >> (8 * j)) & 0xFF) << s
    for row in blocks:
        state = list(_md5_tile([jnp.uint32(x) for x in row], state, 4))
    return [int(x) for x in state]


@pytest.mark.parametrize("n_blocks,var_word", LAYOUTS)
def test_keyed_twin_matches_plain_hashlib_and_jax(twin, n_blocks, var_word):
    """The kernel body built for this layout: its first hit at mask words
    1-4 equals the plain step's (hits, and a miss), and its state of a few
    candidates equals hashlib's digest and the JAX tile's."""
    nonce, width, extra, spec = layout_spec(n_blocks, var_word, 31 * n_blocks + var_word)
    rng = np.random.default_rng(var_word)
    init, init_p = _arr(spec.init_state)
    base, base_p = _arr(spec.base_words)
    out, out_p = _arr([0, 0, 0, 0])
    for k in range(3):
        tb = int(rng.integers(0, 256))
        chunk = int(rng.integers(0, 256 ** width))
        assert twin.host_tail_state(n_blocks, init_p, base_p, *_layout(spec, 0, 0, 256), tb,
                                    chunk, out_p) == 0
        msg = pack_reference_bytes(nonce, tb, chunk, width, extra)
        assert MD5.state_to_digest(out.tolist()) == hashlib.md5(msg).digest()
        if k == 0:
            assert out.tolist() == _jax_tail_state(spec, tb, chunk)
    tb_lo, tbc = (0, 256) if var_word % 2 else (16, 96)
    chunk0, batch = max(0, 256 ** width - 300), 12 * tbc
    for mask_words in range(1, 5):
        masks = [0] * mask_words
        for b in rng.choice(32 * mask_words, size=8, replace=False):
            masks[int(b) // 32] |= 1 << (int(b) % 32)
        ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, "cpu")
        want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                      model=MD5))
        m, m_p = _arr(masks)
        got = twin.host_search(n_blocks, mask_words, init_p, base_p, m_p,
                               *_layout(spec, chunk0, tb_lo, tbc), batch)
        assert got == want, mask_words
    full, full_p = _arr([0xFFFFFFFF] * 4)
    assert twin.host_search(n_blocks, 4, init_p, base_p, full_p,
                            *_layout(spec, chunk0, tb_lo, tbc), 64) == SENTINEL


def _numpy_rounds(state, words, rounds):
    """Plain MD5 rounds 0..rounds-1 in numpy uint32 arithmetic."""
    s = (7, 12, 17, 22, 5, 9, 14, 20, 4, 11, 16, 23, 6, 10, 15, 21)
    a, b, c, d = (np.uint32(x) for x in state)
    with np.errstate(over="ignore"):
        for i in range(rounds):
            if i < 16:
                f, g = (b & c) | (~b & d), i
            elif i < 32:
                f, g = (d & b) | (~d & c), (5 * i + 1) % 16
            elif i < 48:
                f, g = b ^ c ^ d, (3 * i + 5) % 16
            else:
                f, g = c ^ (b | ~d), (7 * i) % 16
            f = f + a + np.uint32(MD5_K[i]) + np.uint32(words[g])
            r = s[(i // 16) * 4 + i % 4]
            a, d, c = d, c, b
            b = b + ((f << np.uint32(r)) | (f >> np.uint32(32 - r)))
    return [int(a), int(b), int(c), int(d)]


@pytest.mark.parametrize("n_blocks,var_word", LAYOUTS)
def test_tail_table_matches_numpy_md5(twin, n_blocks, var_word):
    """Md5Tail's per-thread constants: kc[i] = K[i] + m[g] of the first
    block's round i, the state after its rounds 0 .. var_word - 1 (a plain
    MD5 in numpy over the rows), and the rows' words var_word and var_word +
    1."""
    *_, spec = layout_spec(n_blocks, var_word, 7 * n_blocks + var_word + 1)
    rows = np.asarray(spec.base_words, dtype=np.uint32).reshape(-1)
    init, init_p = _arr(spec.init_state)
    base, base_p = _arr(rows)
    kc, kc_p = _arr([0] * 64)
    hoisted, hoisted_p = _arr([0] * 4)
    pair, pair_p = _arr([0, 0])
    assert twin.host_tail_table(n_blocks, var_word, init_p, base_p, kc_p, hoisted_p, pair_p) == 0
    g = [i if i < 16 else (5 * i + 1) % 16 if i < 32 else (3 * i + 5) % 16 if i < 48
         else (7 * i) % 16 for i in range(64)]
    want = [(MD5_K[i] + int(rows[g[i]])) & 0xFFFFFFFF for i in range(64)]
    assert kc.tolist() == want
    assert hoisted.tolist() == _numpy_rounds(spec.init_state, rows[:16], var_word)
    assert pair.tolist() == [int(rows[var_word]),
                             int(rows[var_word + 1]) if var_word + 1 < 16 * n_blocks else 0]


@pytest.mark.parametrize("n_blocks,var_word", [(1, 1), (1, 9), (2, 14)])
def test_keyed_twin_matches_jax_search_step(twin, n_blocks, var_word):
    """First hits of the JAX package's serving step (the XLA step, as
    tests/test_torch_search_step.py runs it on the CPU) at the same
    numpy-seeded nonce, difficulty and partition."""
    import jax.numpy as jnp

    from distpow_tpu.ops import search_step as jax_step

    nonce, width, extra, spec = layout_spec(n_blocks, var_word, 5 + var_word)
    init, init_p = _arr(spec.init_state)
    base, base_p = _arr(spec.base_words)
    chunks, chunk0 = 64, 256 ** (width - 1) + 77
    for d in (2, 3):
        ops = step_operands(spec, d, MD5, 0, 256, "cpu")
        want = int(jax_step.cached_search_step(nonce, width, d, 0, 256, chunks, "md5", extra,
                                               1)(jnp.uint32(chunk0)))
        m, m_p = _arr(ops.masks.numpy().view(np.uint32))
        got = twin.host_search(n_blocks, ops.mask_words, init_p, base_p, m_p,
                               *_layout(spec, chunk0, 0, 256), chunks * 256)
        assert got == want, d
