"""Host twins of the kernels: the scaffold ``csrc/hash_search.cuh`` with
``sha256.cuh``, ``sha1.cuh``, ``ripemd160.cuh``, ``sha512.cuh``,
``sha3.cuh`` and ``blake2b.cuh``, built with g++ (md5's, ``md5.cuh``, in
``test_torch_md5_host.py``, and here its group and mesh bodies).

The headers' functions are ``__host__ __device__``; compiled for the host
they run the kernels' own decode, byte placement (big-endian for the SHA-1
and SHA-2 families, little-endian for RIPEMD-160, SHA3-256 and
BLAKE2b-256), rows with parameter words (BLAKE2b's), rounds with their
mask-word pruning, and mask check, one candidate at a time.  Every
``(MASK_WORDS, N_BLOCKS, POW2)`` the launcher instantiates is held to the
port's plain step, and the full-width state to hashlib, exactly (integer
hashing).  The in-place Keccak permutation is also held, lane for lane, to
the straightforward formulation with a full rho-pi copy (kept here as the
reference) for every last-round lane mask the kernels use.  And one slot
of the scheduler's group kernel (its per-slot layout, ``slot_layout``, at
the full digest and a power-of-two run) for all nine hashes, md5's over
``md5.cuh``'s ``Md5<VW>`` at the launch's var_word, against the port's
plain group step; and one shard of the mesh kernel (the solo search over the shard's slice, its first hit remapped to
the partition's flat index by ``mesh_global_index``) for all nine, the
least across a mesh's shards held to the port's plain mesh step.  And the
persistent form's per-thread exit rule (``persistent_step``) over a
simulated grid, solo and on a mesh shard, with the launch's cell pre-set:
the least index and the segment word are the serial kernel's.
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

// one slot of the group kernel: its layout from the slot's scalars, the
// full digest, a power-of-two run
uint32_t host_group_slot(int n_blocks, const uint32_t* init, const uint32_t* base,
                         const uint32_t* masks, uint32_t chunk0, uint32_t tb_lo,
                         uint32_t log_tbc, int var_word, int var_shift, uint32_t chunk_mask,
                         uint32_t batch) {
  const Layout L = slot_layout(chunk0, tb_lo, log_tbc, var_word, var_shift, chunk_mask);
  if (n_blocks == 1) return search<H::DIGEST_WORDS, 1, true>(init, base, masks, L, batch);
  return search<H::DIGEST_WORDS, 2, true>(init, base, masks, L, batch);
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

// one shard of the mesh kernel: the solo search over the shard's run, its
// first hit as the flat index of the partition (origin_*)
uint32_t host_mesh_shard(int n_blocks, int mask_words, const uint32_t* init,
                         const uint32_t* base, const uint32_t* masks, uint32_t chunk0,
                         uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word, int var_shift,
                         uint32_t chunk_mask, uint32_t n, uint32_t origin_chunk0,
                         uint32_t origin_tb_lo, uint32_t origin_tbc) {
  const uint32_t f = host_search(n_blocks, mask_words, init, base, masks, chunk0, tb_lo, tbc,
                                 log_tbc, var_word, var_shift, chunk_mask, n);
  const Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  const MeshOrigin o{origin_chunk0, origin_tb_lo, origin_tbc};
  return log_tbc >= 0 ? mesh_global_index<true>(L, o, f) : mesh_global_index<false>(L, o, f);
}
}
"""

U32P = ctypes.POINTER(ctypes.c_uint32)
GROUP_SLOT_ARGS = [ctypes.c_int, U32P, U32P, U32P, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32]
MESH_SHARD_ARGS = [ctypes.c_int, ctypes.c_int, U32P, U32P, U32P, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]


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
        dll.host_group_slot.argtypes = GROUP_SLOT_ARGS
        dll.host_group_slot.restype = u32
        dll.host_mesh_shard.argtypes = MESH_SHARD_ARGS
        dll.host_mesh_shard.restype = u32
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


def _sha256d_width_cases():
    """(mask words, nonce length, tb_lo, tbc): mask words 1-4 and the full
    digest, one- and two-block tails, power-of-two and other thread-byte
    counts."""
    return [(mw, n, tb_lo, tbc) for mw in (1, 2, 3, 4, 8) for n in (9, 58)
            for tb_lo, tbc in ((0, 128), (40, 80))]


@pytest.mark.parametrize("mask_words,nonce_len,tb_lo,tbc", _sha256d_width_cases())
def test_sha256d_twin_first_hit_every_width(twins, mask_words, nonce_len, tb_lo, tbc):
    """sha256d's stage 2 folds its constant words and state, and puts the
    other sums on the FMA pipe; its first hit is the plain step's at every
    width (exact: an integer index)."""
    model = get_hash_model("sha256d")
    rng = np.random.default_rng(7 * mask_words + nonce_len + tbc)
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    for width in (1, 2, 4):
        spec = build_tail_spec(nonce, width, model)
        assert spec.n_blocks == (1 if nonce_len < 55 - width else 2)
        masks = [0] * mask_words
        for b in rng.choice(32 * mask_words, size=8, replace=False):
            masks[int(b) // 32] |= 1 << (int(b) % 32)
        chunk0, batch = 3 if width == 1 else 300, 30 * tbc
        ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, "cpu")
        want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                      model=model))
        init, init_p = _arr(spec.init_state)
        base, base_p = _arr(spec.base_words)
        m, m_p = _arr(masks)
        layout = _layout(spec, model, chunk0, tb_lo, tbc)
        got = twins["sha256d"].host_search(spec.n_blocks, mask_words, init_p, base_p, m_p,
                                           *layout, batch)
        assert got == want, width


# The Keccak rounds as the kernel had them before the in-place form: theta
# through D[x], then rho and pi into a full copy B, then chi from B.
KECCAK_SOURCE = r"""
#include "sha3.cuh"
using namespace distpow;

template <int R, uint32_t LAST_LANES>
static void reference_rounds(uint64_t A[25]) {
  if constexpr (R < 24) {
    constexpr uint32_t lanes = R == 23 ? LAST_LANES : 0x1FFFFFFu;
    uint64_t C[5], B[25];
    for (int x = 0; x < 5; ++x) C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
      for (int y = 0; y < 5; ++y)
        B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(A[x + 5 * y] ^ d, keccak_rot(x, y));
    }
    for (int i = 0; i < 25; ++i) {
      if (lanes >> i & 1) {
        const int x = i % 5, y5 = i - x;
        A[i] = B[i] ^ (~B[(x + 1) % 5 + y5] & B[(x + 2) % 5 + y5]);
      }
    }
    if constexpr (lanes & 1) A[0] ^= keccak_rc(R);
    reference_rounds<R + 1, LAST_LANES>(A);
  }
}

template <uint32_t MASK>
static void both(uint64_t* a, uint64_t* b) {
  keccak_rounds<0, MASK>(a);
  reference_rounds<0, MASK>(b);
}

extern "C" int permute(uint32_t mask, uint64_t* a, uint64_t* b) {
  switch (mask) {
    case 0x1FFFFFFu: both<0x1FFFFFFu>(a, b); return 0;
    case 0x8u: both<0x8u>(a, b); return 0;
    case 0xCu: both<0xCu>(a, b); return 0;
    case 0xEu: both<0xEu>(a, b); return 0;
    case 0xFu: both<0xFu>(a, b); return 0;
  }
  return 1;
}
"""

# Sha3_256::last<MW>'s lane masks (lanes (8 - MW) / 2..3) and block's (all)
KECCAK_MASKS = [0x1FFFFFF] + sorted({0xF & (0xF << (8 - mw) // 2) for mw in range(1, 9)})


@pytest.fixture(scope="module")
def keccak_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("keccak_twin")
    src, lib = d / "keccak.cpp", d / "libkeccak.so"
    src.write_text(KECCAK_SOURCE)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-o",
                           str(lib), str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    dll.permute.argtypes = [ctypes.c_uint32, u64p, u64p]
    dll.permute.restype = ctypes.c_int
    return dll


@pytest.mark.parametrize("mask", KECCAK_MASKS, ids=hex)
def test_keccak_in_place_matches_reference(keccak_twin, mask):
    """The in-place permutation equals the reference on random states in
    every lane the mask keeps (exact), and with all lanes live, the port's
    pure-Python Keccak-f."""
    from distpow_tpu_torch.models.sha3 import keccak_f

    assert mask in (0x1FFFFFF, 0x8, 0xC, 0xE, 0xF)
    rng = np.random.default_rng(mask)
    live = [i for i in range(25) if mask >> i & 1]
    for trial in range(48):
        state = rng.integers(0, 1 << 63, size=25, dtype=np.uint64) * np.uint64(2 - trial % 2)
        a, b = np.ascontiguousarray(state.copy()), np.ascontiguousarray(state.copy())
        u64p = ctypes.POINTER(ctypes.c_uint64)
        assert keccak_twin.permute(mask, a.ctypes.data_as(u64p), b.ctypes.data_as(u64p)) == 0
        assert a[live].tolist() == b[live].tolist(), trial
        if mask == 0x1FFFFFF:
            assert a.tolist() == keccak_f([int(v) for v in state]), trial


def _wide_width_cases():
    """(model, mask words, tail): blake2b_256, sha512 and sha384 at mask
    words 1-4 and their full digest, one and two tail blocks."""
    out = []
    for name in ("blake2b_256", "sha512", "sha384"):
        d = get_hash_model(name).digest_words
        out += [(name, mw, tail) for mw in (1, 2, 3, 4, d) for tail in ("one_block", "two_blocks")]
    return out


@pytest.mark.parametrize("name,mask_words,tail", _wide_width_cases())
def test_wide_twin_first_hit_every_width(twins, name, mask_words, tail):
    """The 64-bit hashes, which place the run by a switch on var_word:
    their first hit is the plain step's at every width 0-4 (exact: an
    integer index), on power-of-two and other thread-byte counts."""
    from distpow_tpu_torch.ops.search_step import plain_search_w0

    model = get_hash_model(name)
    rng = np.random.default_rng(11 * mask_words + len(name) + (tail == "two_blocks"))
    # two blocks: a run that starts at the end of the first block and, from
    # width 2 (blake2b_256: 1), crosses into the second; a blake2b_256 tail
    # of 128 bytes or fewer is one block, so its width 0 is
    two = name != "blake2b_256"
    nonce_len = 9 if tail == "one_block" else model.block_bytes - (2 if two else 1)
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    for width in range(5):
        spec = build_tail_spec(nonce, width, model)
        assert spec.n_blocks == (2 if tail == "two_blocks" and (two or width) else 1), width
        masks = [0] * mask_words
        for b in rng.choice(32 * mask_words, size=7, replace=False):
            masks[int(b) // 32] |= 1 << (int(b) % 32)
        for tb_lo, tbc in ((0, 128), (40, 80)):
            ops = make_operands(spec.init_state, spec.base_words, masks, tb_lo, tbc, "cpu")
            if width == 0:
                chunk0, batch = 0, tbc
                want = u32_value(plain_search_w0(ops, spec.tb_loc, spec.chunk_locs, model=model))
            else:
                chunk0, batch = (3 if width == 1 else 300), 12 * tbc
                want = u32_value(plain_search(ops, spec.tb_loc, spec.chunk_locs, chunk0, batch,
                                              model=model))
            init, init_p = _arr(spec.init_state)
            base, base_p = _arr(spec.base_words)
            m, m_p = _arr(masks)
            layout = _layout(spec, model, chunk0, tb_lo, tbc)
            got = twins[name].host_search(spec.n_blocks, mask_words, init_p, base_p, m_p,
                                          *layout, batch)
            assert got == want, (width, tb_lo, tbc)


# The run placed into a tail block's row by the switch on var_word
# (hash_search.cuh message_block, place_run16 and place_run32): a struct
# with the 32-bit hashes' block and row width, and one with the 64-bit
# hashes' block width and either row width.
PLACE_SOURCE = r"""
#include "hash_search.cuh"
using namespace distpow;

template <int BLOCK, int ROW>
struct Row {
  static constexpr int BLOCK_WORDS = BLOCK, ROW_WORDS = ROW;
};

extern "C" int place(int row_words, int var_word, int blk, uint32_t first, uint32_t second,
                     const uint32_t* base, uint32_t* m) {
  Layout L{0, 0, 1, 0, var_word, 0, 0};
  if (row_words == 16) message_block<Row<16, 16>>(base, L, first, second, blk, m);
  else if (row_words == 32) message_block<Row<32, 32>>(base, L, first, second, blk, m);
  else if (row_words == 36) message_block<Row<32, 36>>(base, L, first, second, blk, m);
  else return 1;
  return 0;
}
"""


@pytest.fixture(scope="module")
def place_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("place_twin")
    src, lib = d / "place.cpp", d / "libplace.so"
    src.write_text(PLACE_SOURCE)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-o",
                           str(lib), str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    u32 = ctypes.c_uint32
    dll.place.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, u32, u32, U32P, U32P]
    dll.place.restype = ctypes.c_int
    return dll


# the 16-word rows of md5's scaffold peers (sha256, sha256d, sha1,
# ripemd160), sha512/sha384's and blake2b_256's
@pytest.mark.parametrize("row_words", [16, 32, 36])
@pytest.mark.parametrize("blk", [0, 1])
def test_switch_placement_matches_selects(place_twin, row_words, blk):
    """The switch on var_word places the run's two words where a plain
    per-word placement does (word B * blk + w gets first if it is
    var_word, second if it is var_word + 1, B the block's message words),
    for every var_word of a two-block tail (and past it), in either block,
    with the parameter words of a 36-word row untouched: a run in one
    block, one that crosses into the next, one in the other block
    (exact)."""
    words = 16 if row_words == 16 else 32
    rng = np.random.default_rng(row_words + blk)
    base = rng.integers(0, 1 << 32, size=2 * row_words, dtype=np.uint64).astype(np.uint32)
    base_a, base_p = _arr(base)
    row = base[blk * row_words:(blk + 1) * row_words]
    placed = 0
    for var_word in range(-1, 2 * words + 2):
        first, second = (int(v) for v in rng.integers(1, 1 << 32, size=2, dtype=np.uint64))
        want = row.copy()
        for w in range(words):
            word = words * blk + w
            want[w] |= (first if word == var_word else 0) | (second if word == var_word + 1 else 0)
        m, m_p = _arr([0] * row_words)
        assert place_twin.place(row_words, var_word, blk, first, second, base_p, m_p) == 0
        assert m.tolist() == want.tolist(), var_word
        placed += m.tolist() != row.tolist()
    assert placed == words + 1  # var_word B * blk - 1 .. B * blk + B - 1 touch the block


# md5's group and mesh kernel bodies: the scaffold's per-slot and per-shard
# code over Md5<VW>, the hash built for the launch's var_word
MD5_GROUP_SOURCE = r"""
#include "md5.cuh"
using namespace distpow;

template <int VW = 0, class F>
static uint32_t at_var_word(int vw, F f) {
  if constexpr (VW > 15) return 0xFFFFFFFEu;  // a run starts in the first block
  else return vw == VW ? f(Md5<VW>{}) : at_var_word<VW + 1>(vw, f);
}

template <class H, int MW, int NB, bool POW2>
static uint32_t search(const uint32_t* init, const uint32_t* base, const uint32_t* masks,
                       const Layout& L, uint32_t n) {
  if constexpr (!H::builds(NB)) {
    return 0xFFFFFFFEu;
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
static uint32_t shard(int mw, const uint32_t* i, const uint32_t* b, const uint32_t* m,
                      const Layout& L, const MeshOrigin& o, uint32_t n) {
  uint32_t f;
  switch (mw) {
    case 1: f = search<H, 1, NB, POW2>(i, b, m, L, n); break;
    case 2: f = search<H, 2, NB, POW2>(i, b, m, L, n); break;
    case 3: f = search<H, 3, NB, POW2>(i, b, m, L, n); break;
    default: f = search<H, 4, NB, POW2>(i, b, m, L, n); break;
  }
  return mesh_global_index<POW2>(L, o, f);
}

extern "C" uint32_t host_mesh_shard(int n_blocks, int mask_words, const uint32_t* init,
                                    const uint32_t* base, const uint32_t* masks, uint32_t chunk0,
                                    uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word,
                                    int var_shift, uint32_t chunk_mask, uint32_t n,
                                    uint32_t origin_chunk0, uint32_t origin_tb_lo,
                                    uint32_t origin_tbc) {
  const Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  const MeshOrigin o{origin_chunk0, origin_tb_lo, origin_tbc};
  const bool pow2 = log_tbc >= 0;
  return at_var_word(var_word, [&](auto h) -> uint32_t {
    using H = decltype(h);
    if (n_blocks == 1)
      return pow2 ? shard<H, 1, true>(mask_words, init, base, masks, L, o, n)
                  : shard<H, 1, false>(mask_words, init, base, masks, L, o, n);
    return pow2 ? shard<H, 2, true>(mask_words, init, base, masks, L, o, n)
                : shard<H, 2, false>(mask_words, init, base, masks, L, o, n);
  });
}

extern "C" uint32_t host_group_slot(int n_blocks, const uint32_t* init, const uint32_t* base,
                                    const uint32_t* masks, uint32_t chunk0, uint32_t tb_lo,
                                    uint32_t log_tbc, int var_word, int var_shift,
                                    uint32_t chunk_mask, uint32_t batch) {
  const Layout L = slot_layout(chunk0, tb_lo, log_tbc, var_word, var_shift, chunk_mask);
  return at_var_word(var_word, [&](auto h) -> uint32_t {
    using H = decltype(h);
    return n_blocks == 1 ? search<H, 4, 1, true>(init, base, masks, L, batch)
                         : search<H, 4, 2, true>(init, base, masks, L, batch);
  });
}
"""


@pytest.fixture(scope="module")
def md5_group_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("md5_group_twin")
    src, lib = d / "md5_group.cpp", d / "libmd5_group.so"
    src.write_text(MD5_GROUP_SOURCE)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-o",
                           str(lib), str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    dll.host_group_slot.argtypes = GROUP_SLOT_ARGS
    dll.host_group_slot.restype = ctypes.c_uint32
    dll.host_mesh_shard.argtypes = MESH_SHARD_ARGS
    dll.host_mesh_shard.restype = ctypes.c_uint32
    return dll


@pytest.mark.parametrize("name", ["md5"] + sorted(HASHES) + sorted(WIDE))
@pytest.mark.parametrize("tail", ["one_block", "two_blocks"])
def test_group_slot_twin_matches_plain_group_step(twins, md5_group_twin, name, tail):
    """Each slot of a group (own nonce, difficulty, power-of-two run and
    cursor; the group's tail layout) searched by the group kernel's
    per-slot code equals the port's plain group step (exact), hits and a
    slot at the full digest's masks that cannot hit."""
    from distpow_tpu_torch.ops.difficulty import nibble_masks
    from distpow_tpu_torch.ops.operands import group_operands
    from distpow_tpu_torch.ops.search_step import plain_group_search

    model = get_hash_model(name)
    twin = md5_group_twin if name == "md5" else twins[name]
    rng = np.random.default_rng(len(name) + (tail == "two_blocks"))
    nonce_len = 5 if tail == "one_block" else model.block_bytes - 2
    width, batch = 3, 1 << 10
    specs, masks, tb_lo, log_tbc, chunk0 = [], [], [], [], []
    for s, lg in enumerate((0, 1, 4, 8)):
        nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
        specs.append(build_tail_spec(nonce, width, model))
        masks.append(nibble_masks(model.max_difficulty if s == 2 else 1 + s % 3, model))
        log_tbc.append(lg)
        tb_lo.append(int(rng.integers(0, 256 >> lg)) << lg)
        chunk0.append(256 ** (width - 1) + int(rng.integers(0, 1000)))
    sp = specs[0]
    assert sp.n_blocks == (1 if tail == "one_block" else 2)
    ops = group_operands([x.init_state for x in specs], [x.base_words for x in specs], masks,
                         tb_lo, log_tbc, chunk0)
    want = plain_group_search(model, ops, sp.tb_loc, sp.chunk_locs, batch).tolist()
    var_word, var_shift, chunk_mask = kernel_layout(sp.tb_loc, sp.chunk_locs, model)
    got = []
    for s, x in enumerate(specs):
        init, init_p = _arr(x.init_state)
        base, base_p = _arr(x.base_words)
        m, m_p = _arr(masks[s])
        got.append(twin.host_group_slot(x.n_blocks, init_p, base_p, m_p, chunk0[s], tb_lo[s],
                                        log_tbc[s], var_word, var_shift, chunk_mask, batch))
    assert got == want
    assert want[2] == SENTINEL and any(w != SENTINEL for w in want)


# (shards, tb_lo, tbc, tail): a thread-byte split into runs of 12, a chunk
# split of the full run over 3 shards, a chunk split of a run of 3, and a
# thread-byte split of 64 over 4 shards on a two-block tail
MESH_TWIN_CASES = [(8, 16, 96, 1), (3, 0, 256, 1), (8, 5, 3, 1), (4, 64, 64, 2)]


@pytest.mark.parametrize("name", ["md5"] + sorted(HASHES) + sorted(WIDE))
@pytest.mark.parametrize("n_dev,tb_lo,tbc,n_blocks", MESH_TWIN_CASES)
def test_mesh_shard_twin_matches_plain_mesh_step(twins, md5_group_twin, name, n_dev, tb_lo,
                                                 tbc, n_blocks):
    """The mesh kernel's per-shard code (the solo search over the shard's
    slice, then ``mesh_global_index``) over every shard of a launch of 2
    sub-batches, the least index across shards: equal to the port's plain
    mesh step (exact), at difficulties with and without a hit; the remap
    of a non-power-of-two run and of a chunk span included."""
    from distpow_tpu_torch.parallel.mesh_search import mesh_shards
    from distpow_tpu_torch.ops.search_step import MeshOrigin, plain_mesh_search, step_operands

    model = get_hash_model(name)
    twin = md5_group_twin if name == "md5" else twins[name]
    rng = np.random.default_rng(n_dev * 1000 + tbc + len(name))
    nonce_len = 5 if n_blocks == 1 else model.block_bytes - 2
    nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
    width = 3
    spec = build_tail_spec(nonce, width, model)
    assert spec.n_blocks == n_blocks
    var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, model)
    chunk0 = 256 ** width - 7  # the launch runs past the width's end
    split = tbc % n_dev == 0
    shards = mesh_shards(tb_lo, tbc, chunk0, n_dev, max(1, 1536 // (tbc * (1 if split else
                                                                          n_dev))), 2)
    origin = MeshOrigin(chunk0, tb_lo, tbc)
    found = []
    for d in (2, 3, model.max_difficulty):
        ops = step_operands(spec, d, model, tb_lo, tbc, "cpu")
        want = u32_value(plain_mesh_search(ops, spec.tb_loc, spec.chunk_locs, shards, origin,
                                           model=model))
        mw = kernel_mask_words(ops.mask_words, model)
        masks = [0] * (mw - ops.mask_words) + ops.masks.numpy().view(np.uint32).tolist()
        init, init_p = _arr(spec.init_state)
        base, base_p = _arr(spec.base_words)
        m, m_p = _arr(masks)
        got = min(twin.host_mesh_shard(
            spec.n_blocks, mw, init_p, base_p, m_p, sh.chunk0, sh.tb_lo, sh.tb_count,
            sh.tb_count.bit_length() - 1 if sh.tb_count & (sh.tb_count - 1) == 0 else -1,
            var_word, var_shift, chunk_mask, sh.batch * sh.launch_steps, *origin)
            for sh in shards)
        assert got == want, d
        found.append(want)
    assert found[-1] == SENTINEL and found[0] != SENTINEL


# The persistent form's per-thread exit rule (hash_search.cuh
# persistent_step) over a simulated grid: the threads of a grid-stride loop
# advance one candidate at a time in a seeded order, check the launch's
# cell and the search's flag where persistent_due says (before their first
# candidate, then once each period_mask + 1 indices, the mask the launcher
# sets from the segment's flat indices and the grid's threads), and publish
# a hit into the cell at once, as thread_first_hit does; the block's min of
# the threads' results follows.
PERSISTENT_SOURCE = r"""
#include <vector>
#include "hash_search.cuh"
using namespace distpow;

template <class Report>
static void grid(const uint8_t* hit, uint32_t n, uint32_t n_threads, uint32_t batch,
                 uint32_t seg, const uint32_t* order, uint32_t n_order, uint32_t stop,
                 uint32_t* out, uint32_t* tested, Report report) {
  const uint32_t period_mask = persistent_period_mask(batch, n_threads);
  std::vector<uint32_t> f(n_threads), best(n_threads, SENTINEL);
  std::vector<char> done(n_threads, 0);
  for (uint32_t t = 0; t < n_threads; ++t) f[t] = t;
  *tested = 0;
  uint32_t left = n_threads;
  auto advance = [&](uint32_t t) {
    if (done[t]) return;
    if (f[t] >= n) { done[t] = 1; --left; return; }
    const uint32_t g = report(f[t]);
    if (persistent_due(f[t], period_mask, n_threads)) {
      const int step = persistent_step(out[0], stop, g);
      if (step == kStopped && g / seg < out[1]) out[1] = g / seg;
      if (step != kTest) { done[t] = 1; --left; return; }
    }
    ++*tested;
    if (hit[f[t]]) {
      if (g < out[0]) out[0] = g;
      if (g / seg + 1 < out[1]) out[1] = g / seg + 1;
      best[t] = g;
      done[t] = 1;
      --left;
      return;
    }
    f[t] += n_threads;
  };
  for (uint32_t i = 0; i < n_order && left; ++i) advance(order[i]);
  while (left)
    for (uint32_t t = 0; t < n_threads; ++t) advance(t);
  for (uint32_t t = 0; t < n_threads; ++t)
    if (best[t] < out[0]) out[0] = best[t];  // block_min_to
}

extern "C" uint32_t host_period_mask(uint32_t batch, uint32_t threads) {
  return persistent_period_mask(batch, threads);
}

extern "C" void host_persistent_grid(const uint8_t* hit, uint32_t n, uint32_t n_threads,
                                     uint32_t batch, uint32_t seg, const uint32_t* order,
                                     uint32_t n_order, uint32_t stop, uint32_t* out,
                                     uint32_t* tested) {
  grid(hit, n, n_threads, batch, seg, order, n_order, stop, out, tested,
       [](uint32_t f) { return f; });
}

// one shard of a mesh launch: the shard's run tb_lo .. tb_lo + tbc - 1 from
// chunk0, reporting the partition's index (origin_index)
extern "C" void host_persistent_shard_grid(const uint8_t* hit, uint32_t n, uint32_t n_threads,
                                           uint32_t batch, uint32_t seg,
                                           const uint32_t* order,
                                           uint32_t n_order, uint32_t stop, uint32_t* out,
                                           uint32_t* tested, uint32_t chunk0, uint32_t tb_lo,
                                           uint32_t tbc, uint32_t o_chunk0, uint32_t o_tb_lo,
                                           uint32_t o_tbc) {
  const Layout L{chunk0, tb_lo, tbc, -1, 0, 0, 0};
  const MeshOrigin o{o_chunk0, o_tb_lo, o_tbc};
  grid(hit, n, n_threads, batch, seg, order, n_order, stop, out, tested,
       [&](uint32_t f) {
    uint32_t tb, chunk;
    decode<false>(L, f, tb, chunk);
    return origin_index(o, tb, chunk);
  });
}
"""


@pytest.fixture(scope="module")
def persistent_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("persistent_twin")
    src, lib = d / "persistent.cpp", d / "libpersistent.so"
    src.write_text(PERSISTENT_SOURCE)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-o",
                           str(lib), str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    u32, u8p = ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8)
    grid_args = [u8p, u32, u32, u32, u32, U32P, u32, u32, U32P, U32P]
    dll.host_persistent_grid.argtypes = grid_args
    dll.host_persistent_grid.restype = None
    dll.host_persistent_shard_grid.argtypes = grid_args + [u32] * 6
    dll.host_persistent_shard_grid.restype = None
    dll.host_period_mask.argtypes = [u32, u32]
    dll.host_period_mask.restype = u32
    return dll


def _run_grid(twin, hit, n_threads, seg, cell, segments, stop, rng, shard=(), batch=None):
    hits = np.ascontiguousarray(hit.astype(np.uint8))
    order, order_p = _arr(rng.integers(0, n_threads, size=20 * len(hit)))
    out, out_p = _arr([cell, segments])
    tested, tested_p = _arr([0])
    fn = twin.host_persistent_shard_grid if shard else twin.host_persistent_grid
    # batch: the segment in the launch's flat indices (a solo launch's seg)
    fn(hits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(hit), n_threads,
       seg if batch is None else batch, seg, order_p, order.size, stop, out_p, tested_p, *shard)
    return out.tolist(), int(tested[0])


@pytest.mark.parametrize("seed", range(12))
def test_persistent_exit_rule_keeps_the_least_index(persistent_twin, seed):
    """With the cell pre-set to SENTINEL or to a hit above the least (one a
    block published already), under random thread orders, grids, segments
    and hits sparse or dense: the launch's words are the least hit and its
    segment + 1, as the serial kernel's least index, and the threads test
    no more candidates than the serial kernel's."""
    rng = np.random.default_rng(seed)
    n, seg = int(rng.integers(500, 4000)), int(rng.integers(16, 300))
    segments = -(-n // seg)
    n = segments * seg
    hit = rng.random(n) < float(rng.choice([0.0005, 0.003, 0.05]))
    hit[int(rng.integers(n // 2, n))] = True  # at least one hit
    least = int(np.flatnonzero(hit)[0])
    later = np.flatnonzero(hit)[-1]
    n_threads = int(rng.choice([7, 32, 96, 256]))
    for cell in (SENTINEL, int(later)):
        words, tested = _run_grid(persistent_twin, hit, n_threads, seg, cell, segments, 0, rng)
        assert words == [least, least // seg + 1], (cell, n_threads, seg, n)
        # the serial kernel's threads test every index up to their own hit
        serial = sum(min(len(range(t, n, n_threads)),
                         next((i for i, f in enumerate(range(t, n, n_threads)) if hit[f]),
                              n) + 1) for t in range(n_threads))
        assert tested <= serial
    # no hit: every segment runs
    words, _ = _run_grid(persistent_twin, np.zeros(n, bool), n_threads, seg, SENTINEL,
                         segments, 0, rng)
    assert words == [SENTINEL, segments]
    # a flag set before the launch: nothing tested, (SENTINEL, 0)
    words, tested = _run_grid(persistent_twin, hit, n_threads, seg, SENTINEL, segments, 1, rng)
    assert words == [SENTINEL, 0] and tested == 0


@pytest.mark.parametrize("seed", range(6))
def test_persistent_exit_rule_on_a_mesh_shard(persistent_twin, seed):
    """One shard of a mesh launch (a run of 3 thread bytes inside the
    partition's run of 12, its cursor two chunks on), the cell in partition
    indices: the shard's least hit as the partition's index, whatever the
    cell held above it."""
    rng = np.random.default_rng(100 + seed)
    tb_lo, tbc, chunk0 = 6, 3, 1000 + 2
    origin = (1000, 0, 12)
    n = 3 * int(rng.integers(100, 400))
    hit = rng.random(n) < 0.01
    hit[n - 1] = True
    g = [((chunk0 + f // tbc) - origin[0]) * origin[2] + tb_lo + f % tbc - origin[1]
         for f in range(n)]
    least = g[int(np.flatnonzero(hit)[0])]
    seg = 12 * 8  # the partition's segment: 8 chunks over the whole run
    segments = -(-g[-1] // seg) + 1
    for cell in (SENTINEL, g[-1]):
        words, _ = _run_grid(persistent_twin, hit, 32, seg, cell, segments, 0, rng,
                             shard=(chunk0, tb_lo, tbc, *origin), batch=8 * tbc)
        assert words == [least, least // seg + 1]


@pytest.mark.parametrize("threads", [1, 7, 256, 96 * 256, 132 * 8 * 256, 132 * 16 * 256])
def test_persistent_period_covers_a_segment_and_the_grid(persistent_twin, threads):
    """The launcher's check period (hash_search.cuh persistent_period_mask,
    set from the grid it launches): the least power of two at or above
    both the segment's flat indices and the grid's threads, so that a
    thread checks at least once a segment of its own loop and at its first
    index."""
    for batch in (1, 2, 3, 255, 256, 4096, (1 << 20) - 1, 1 << 20, 3 << 19, 1 << 31):
        period = persistent_twin.host_period_mask(batch, threads) + 1
        assert period & (period - 1) == 0
        assert period == 1 << max(batch - 1, threads - 1).bit_length(), (batch, threads)
