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
persistent form's claim loop (``claim_index``, ``persistent_step``) over a
simulated launch of blocks claiming tiles in seeded interleavings, solo and
on a mesh shard, with the launch's cell pre-set and the search's flag set
before or during the launch: the least index and the segment word are the
serial kernel's, and blocks that keep pace stop about one tile past the
hit.
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


# The persistent form's claim loop (hash_search.cuh hash_persistent_block)
# over a simulated launch: blocks of `threads` threads claim tiles of
# rounds * threads flat indices from a counter of claims (claim c is the
# tile at c * rounds * threads), one tile ahead as the kernel
# does (the next claim made as a tile starts, checked with persistent_step
# on the cell and the flag as they stand when the tile ends), and a block
# in a tile runs one round at a time, each of its threads that has not hit
# testing its index claim_index(base, t, threads, j) and publishing a hit
# into the cell at once.  Which block acts at each step is drawn from
# `order` (round robin once it is used up); the search's flag turns on
# before step stop_at.
PERSISTENT_SOURCE = r"""
#include <vector>
#include "hash_search.cuh"
using namespace distpow;

struct Block {
  int state = 0;  // 0: start, 1: at a check, 2: in a tile, 3: stopped
  uint32_t next = 0, base = 0, j = 0;
  std::vector<char> hit;
};

template <class Report>
static void launch(const uint8_t* hit, uint32_t n, uint32_t n_blocks, uint32_t threads,
                   uint32_t rounds, uint32_t seg, const uint32_t* order, uint32_t n_order,
                   uint32_t stop_at, uint32_t* out, uint32_t* tested, Report report) {
  const uint32_t tile = rounds * threads;
  std::vector<Block> blocks(n_blocks);
  for (auto& b : blocks) b.hit.assign(threads, 0);
  uint32_t counter = 0, left = n_blocks, stop = 0;
  *tested = 0;
  auto act = [&](Block& b) {
    if (b.state == 0) {  // the claim before the first barrier
      b.next = counter++ * tile;
      b.state = 1;
    } else if (b.state == 1) {  // thread 0 at the claim: the check, the next claim
      const uint32_t c = b.next;
      int step = kBelowHit;
      if (c < n) {
        const uint32_t g = report(c);
        step = persistent_step(out[0], stop, g);
        if (step == kStopped && g / seg < out[1]) out[1] = g / seg;
      }
      if (c >= n || step != kTest) {
        b.state = 3;
        --left;
        return;
      }
      b.base = c;
      b.j = 0;
      b.next = counter++ * tile;
      b.state = 2;
    } else if (b.state == 2) {  // one round of the tile
      for (uint32_t t = 0; t < threads; ++t) {
        const uint32_t f = claim_index(b.base, t, threads, b.j);
        if (b.hit[t] || f >= n) continue;
        ++*tested;
        if (hit[f]) {
          const uint32_t g = report(f);
          if (g < out[0]) out[0] = g;
          if (g / seg + 1 < out[1]) out[1] = g / seg + 1;
          b.hit[t] = 1;
        }
      }
      if (++b.j == rounds) b.state = 1;
    }
  };
  uint32_t steps = 0;
  for (uint32_t i = 0; left; ++i) {
    if (steps++ == stop_at) stop = 1;
    Block& b = blocks[i < n_order ? order[i] % n_blocks : i % n_blocks];
    if (b.state != 3) act(b);
  }
  out[2] = counter;
}

extern "C" void host_persistent_launch(const uint8_t* hit, uint32_t n, uint32_t n_blocks,
                                       uint32_t threads, uint32_t rounds, uint32_t seg,
                                       const uint32_t* order, uint32_t n_order, uint32_t stop_at,
                                       uint32_t* out, uint32_t* tested) {
  launch(hit, n, n_blocks, threads, rounds, seg, order, n_order, stop_at, out, tested,
         [](uint32_t f) { return f; });
}

// one shard of a mesh launch: the shard's run tb_lo .. tb_lo + tbc - 1 from
// chunk0, reporting the partition's index (origin_index)
extern "C" void host_persistent_shard_launch(const uint8_t* hit, uint32_t n, uint32_t n_blocks,
                                             uint32_t threads, uint32_t rounds, uint32_t seg,
                                             const uint32_t* order, uint32_t n_order,
                                             uint32_t stop_at, uint32_t* out, uint32_t* tested,
                                             uint32_t chunk0, uint32_t tb_lo, uint32_t tbc,
                                             uint32_t o_chunk0, uint32_t o_tb_lo,
                                             uint32_t o_tbc) {
  const Layout L{chunk0, tb_lo, tbc, -1, 0, 0, 0};
  const MeshOrigin o{o_chunk0, o_tb_lo, o_tbc};
  launch(hit, n, n_blocks, threads, rounds, seg, order, n_order, stop_at, out, tested,
         [&](uint32_t f) {
    uint32_t tb, chunk;
    decode<false>(L, f, tb, chunk);
    return origin_index(o, tb, chunk);
  });
}

extern "C" uint32_t host_launch_rounds(uint32_t n, uint32_t blocks, uint32_t threads,
                                       uint32_t most) {
  return launch_rounds(n, blocks, threads, most);
}
"""

NEVER = 0xFFFFFFFF  # stop_at: the flag is never set


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
    launch_args = [u8p, u32, u32, u32, u32, u32, U32P, u32, u32, U32P, U32P]
    dll.host_persistent_launch.argtypes = launch_args
    dll.host_persistent_launch.restype = None
    dll.host_persistent_shard_launch.argtypes = launch_args + [u32] * 6
    dll.host_persistent_shard_launch.restype = None
    dll.host_launch_rounds.argtypes = [u32] * 4
    dll.host_launch_rounds.restype = u32
    return dll


def _run_launch(twin, hit, blocks, threads, rounds, seg, cell, segments, rng=None,
                stop_at=NEVER, shard=()):
    """The simulated launch's (words, candidates tested, claims): blocks
    drawn at random by ``rng``, or in round robin without one."""
    hits = np.ascontiguousarray(hit.astype(np.uint8))
    steps = 0 if rng is None else 4 * (len(hit) // threads + 4 * blocks) * (rounds + 2)
    order, order_p = _arr(rng.integers(0, blocks, size=steps) if steps else [0])
    out, out_p = _arr([cell, segments, 0])
    tested, tested_p = _arr([0])
    fn = twin.host_persistent_shard_launch if shard else twin.host_persistent_launch
    fn(hits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(hit), blocks, threads, rounds,
       seg, order_p, steps, stop_at, out_p, tested_p, *shard)
    return out[:2].tolist(), int(tested[0]), int(out[2])


def _stopped_words_hold(words, hit, seg, segments, report=lambda f: f):
    """With the flag set during the launch: every index below the segments
    executed was tested, so the least hit there is the first word, and any
    first word is a hit."""
    below = [report(f) for f in np.flatnonzero(hit) if report(f) < words[1] * seg]
    assert words[1] <= segments
    assert words[0] == (min(below) if below else words[0])
    assert words[0] == SENTINEL or words[0] in {report(f) for f in np.flatnonzero(hit)}


@pytest.mark.parametrize("seed", range(12))
def test_persistent_exit_rule_keeps_the_least_index(persistent_twin, seed):
    """With the cell pre-set to SENTINEL or to a hit above the least (one a
    block published already), under random interleavings of the blocks,
    tile sizes, segments and hits sparse or dense: the launch's words are
    the least hit and its segment + 1, as the serial kernel's least index.
    No hit: every segment runs, each block's last claim past the end.  The
    flag set before the launch: nothing tested, (SENTINEL, 0); set during
    it: the words keep the least hit below the segments executed."""
    rng = np.random.default_rng(seed)
    n, seg = int(rng.integers(500, 4000)), int(rng.integers(16, 300))
    segments = -(-n // seg)
    n = segments * seg
    hit = rng.random(n) < float(rng.choice([0.0005, 0.003, 0.05]))
    hit[int(rng.integers(n // 2, n))] = True  # at least one hit
    least = int(np.flatnonzero(hit)[0])
    later = np.flatnonzero(hit)[-1]
    threads = int(rng.choice([7, 32, 96, 256]))
    rounds = int(rng.choice([1, 2, 3, 8, 16]))
    blocks = int(rng.integers(1, 9))
    for cell in (SENTINEL, int(later)):
        words, tested, _ = _run_launch(persistent_twin, hit, blocks, threads, rounds, seg, cell,
                                       segments, rng)
        assert words == [least, least // seg + 1], (cell, blocks, threads, rounds, seg, n)
        assert tested <= n
    # no hit: every segment runs, and each block claims once past the end
    words, tested, claims = _run_launch(persistent_twin, np.zeros(n, bool), blocks, threads,
                                        rounds, seg, SENTINEL, segments, rng)
    assert words == [SENTINEL, segments] and tested == n
    assert claims == -(-n // (rounds * threads)) + blocks
    # a flag set before the launch: nothing tested, (SENTINEL, 0)
    words, tested, _ = _run_launch(persistent_twin, hit, blocks, threads, rounds, seg, SENTINEL,
                                   segments, rng, stop_at=0)
    assert words == [SENTINEL, 0] and tested == 0
    # set during the launch
    for stop_at in rng.integers(1, 4 * n // (threads * rounds) + 8, size=4):
        words, _, _ = _run_launch(persistent_twin, hit, blocks, threads, rounds, seg, SENTINEL,
                                  segments, rng, stop_at=int(stop_at))
        _stopped_words_hold(words, hit, seg, segments)


@pytest.mark.parametrize("seed", range(6))
def test_persistent_exit_rule_on_a_mesh_shard(persistent_twin, seed):
    """One shard of a mesh launch (a run of 3 thread bytes inside the
    partition's run of 12, its cursor two chunks on), the cell in partition
    indices: the shard's least hit as the partition's index, whatever the
    cell held above it, under random interleavings; with the flag set during
    the launch, the least hit below the segments executed."""
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
    shard = (chunk0, tb_lo, tbc, *origin)
    blocks, rounds = int(rng.integers(1, 5)), int(rng.choice([1, 2, 4]))
    for cell in (SENTINEL, g[-1]):
        words, _, _ = _run_launch(persistent_twin, hit, blocks, 32, rounds, seg, cell, segments,
                                  rng, shard=shard)
        assert words == [least, least // seg + 1]
    words, _, _ = _run_launch(persistent_twin, hit, blocks, 32, rounds, seg, SENTINEL, segments,
                              rng, stop_at=int(rng.integers(1, 40)), shard=shard)
    _stopped_words_hold(words, hit, seg, segments, report=lambda f: g[f])


@pytest.mark.parametrize("rounds,threads,blocks", [
    (1, 1, 1), (1, 32, 4), (2, 7, 3), (4, 256, 2), (8, 32, 8), (16, 96, 3), (64, 8, 5),
    (3, 17, 6)])
def test_persistent_claims_stop_one_tile_past_the_hit(persistent_twin, rounds, threads, blocks):
    """Blocks that keep pace (round robin, as one resident wave does) test
    no more candidates than the tiles claimed up to the hit's tile, plus one
    tile a block, and claim at most one tile more a block; the words are the
    least hit's.  Without a hit, every index is tested once."""
    rng = np.random.default_rng(rounds * 1000 + threads * 10 + blocks)
    tile = rounds * threads
    n = tile * (4 * blocks + int(rng.integers(4, 12))) - int(rng.integers(0, tile))
    seg = tile * int(rng.integers(1, 4))
    segments = -(-n // seg)
    for h in (int(rng.integers(0, tile)), int(rng.integers(n // 3, n))):
        hit = np.zeros(n, bool)
        hit[h] = True
        hit[min(n - 1, h + int(rng.integers(1, 3 * tile)))] = True
        words, tested, claims = _run_launch(persistent_twin, hit, blocks, threads, rounds, seg,
                                            SENTINEL, segments)
        assert words == [h, h // seg + 1]
        assert tested <= (h // tile + 1 + blocks) * tile, (h, tested)
        assert claims <= h // tile + 1 + 2 * blocks, (h, claims)
    words, tested, claims = _run_launch(persistent_twin, np.zeros(n, bool), blocks, threads,
                                        rounds, seg, SENTINEL, segments)
    assert words == [SENTINEL, segments] and tested == n
    assert claims == -(-n // tile) + blocks


@pytest.mark.parametrize("n,blocks,most,want", [
    (1 << 20, 1056, 64, 1),     # md5's width-1 dispatch on its wave: a candidate a tile
    (1 << 24, 1056, 64, 7),     # its width-2 dispatch: at least 8 tiles a block
    (1 << 30, 1056, 64, 64),    # the main path's launch: the model's rounds
    (1 << 30, 396, 4, 4),       # sha3_256's rounds on a wave of 3 blocks a SM
    (1 << 24, 3, 1, 1),         # a tool's grid and rounds: the override holds
    (255, 1, 16, 1),            # fewer indices than a block's threads
    (0xFFFFFFFF, 1, 1 << 16, 1 << 16),
    (3 << 20, 0, 8, 8),         # no blocks asked of the device: counted as one
])
def test_launch_rounds_leave_each_block_eight_tiles(persistent_twin, n, blocks, most, want):
    """The launcher's tile (``launch_rounds``): the model's rounds where
    the launch has room for them, else as many as leave each block of the
    grid at least 8 tiles, and never under 1 candidate a thread, so a
    launch of few tiles a wave still fills the wave and can stop near its
    hit."""
    got = persistent_twin.host_launch_rounds(n, blocks, 256, most)
    assert got == want
    assert 1 <= got <= most
    tiles = -(-n // (got * 256))
    assert got == 1 or tiles >= 8 * max(1, blocks)
    assert got in (1, most) or n < (got + 1) * 256 * 8 * blocks


# The group kernel (hash_search.cuh hash_group_block) over a simulated
# launch of md5 slots: first each slot's candidates are tested with the
# kernel's candidate test (md5's Tail made from the slot's operands,
# slot_layout, the full digest's masks), then a grid of blocks of `threads`
# threads, at most `resident` of them running at once and each started in
# index order as another ends, claims tiles of rounds * threads flat
# indices of one slot from that slot's counter (claim c is the tile at
# tile_index(c, tile)), one tile ahead as the kernel does.  A block starts
# on its home slot (group_home_slot) where that is open, else on the next
# open one (group_next_slot over group_slot_open), claims a tile there and
# checks it with group_tests on the slot's cell as it stands, moving on
# while its first claim is dropped; then it tests its slot tile after
# tile, checking each claim as the tile before ends, and ends where one is
# dropped.  A block in a tile runs one round at a time, each of its threads
# that has not hit testing its index claim_index(base, t, threads, j) and
# publishing a hit into the slot's cell at once.  Which running block acts
# at each step is drawn from `order` (round robin once it is used up).
GROUP_CLAIM_SOURCE = r"""
#include <vector>
#include "md5.cuh"
using namespace distpow;

template <int VW = 0, class F>
static int at_var_word(int vw, F f) {
  if constexpr (VW > 15) return -1;
  else return vw == VW ? f(Md5<VW>{}) : at_var_word<VW + 1>(vw, f);
}

extern "C" int host_group_hits(int n_blocks, int var_word, int var_shift, uint32_t chunk_mask,
                               int n_slots, const uint32_t* init, const uint32_t* base,
                               const uint32_t* masks, const uint32_t* tb_lo,
                               const uint32_t* log_tbc, const uint32_t* chunk0, uint32_t batch,
                               uint8_t* hit) {
  return at_var_word(var_word, [&](auto h) -> int {
    using H = decltype(h);
    auto go = [&](auto nb) -> int {
      constexpr int NB = decltype(nb)::value;
      if constexpr (!H::builds(NB)) {
        return -1;
      } else {
        for (int s = 0; s < n_slots; ++s) {
          const typename H::template Tail<NB> tail(init + 4 * s, base + 16 * NB * s);
          const Layout L = slot_layout(chunk0[s], tb_lo[s], log_tbc[s], var_word, var_shift,
                                       chunk_mask);
          for (uint32_t f = 0; f < batch; ++f) {
            uint32_t tb, chunk;
            decode<true>(L, f, tb, chunk);
            hit[s * batch + f] = keyed_candidate_hits<H, 4, NB>(tail, masks + 4 * s, L, tb, chunk);
          }
        }
        return 0;
      }
    };
    return n_blocks == 1 ? go(std::integral_constant<int, 1>{})
                         : go(std::integral_constant<int, 2>{});
  });
}

struct Block {
  int state = 0;  // 0: start, 1: at a check, 2: in a tile, 3: ended
  bool tested = false;  // handed a tile: a dropped claim now ends the block
  int slot = 0;
  uint32_t next = 0, base = 0, j = 0, seen = 0;
  std::vector<char> hit;
};

extern "C" void host_group_launch(const uint8_t* hit, int n_slots, uint32_t batch,
                                  uint32_t grid, uint32_t resident, uint32_t threads,
                                  uint32_t rounds, int early, const uint32_t* order,
                                  uint32_t n_order, uint32_t* out, uint32_t* tested) {
  const uint32_t tile = rounds * threads;
  uint32_t* const cell = out;
  uint32_t* const counter = out + n_slots;
  auto open = [&](int t) { return group_slot_open(cell[t], counter[t], tile, batch); };
  std::vector<Block> blocks(grid);
  std::vector<uint32_t> running;  // the blocks running, by index
  uint32_t started = 0;
  while (started < grid && running.size() < resident) running.push_back(started++);
  auto act = [&](Block& b, uint32_t i) {
    if (b.state == 0) {  // warp 0 as the block starts: its home slot, else the next open one
      b.slot = group_home_slot(i, n_slots);
      if (!open(b.slot)) b.slot = group_next_slot(b.slot, n_slots, open);
      if (b.slot < 0) {
        b.state = 3;
        return;
      }
      b.next = tile_index(counter[b.slot]++, tile);
      b.hit.assign(threads, 0);
      b.state = 1;
    } else if (b.state == 1) {  // a check of the claim ahead
      if (group_tests(early && b.tested ? b.seen : cell[b.slot], batch, b.next)) {
        b.base = b.next;
        b.next = tile_index(counter[b.slot]++, tile);
        b.tested = true;
        b.j = 0;
        b.state = 2;
      } else if (b.tested) {
        b.state = 3;
      } else {  // still starting: the next open slot
        b.slot = group_next_slot(b.slot, n_slots, open);
        if (b.slot < 0) {
          b.state = 3;
          return;
        }
        b.next = tile_index(counter[b.slot]++, tile);
      }
    } else if (b.state == 2) {  // one round of the tile
      if (b.j == 0) b.seen = cell[b.slot];  // the cell as the tile begins
      for (uint32_t t = 0; t < threads; ++t) {
        const uint32_t f = claim_index(b.base, t, threads, b.j);
        if (b.hit[t] || f >= batch) continue;
        const uint64_t at = static_cast<uint64_t>(b.slot) * batch + f;
        ++tested[at];
        if (hit[at]) {
          if (f < cell[b.slot]) cell[b.slot] = f;
          b.hit[t] = 1;
        }
      }
      if (++b.j == rounds) b.state = 1;
    }
  };
  for (uint32_t i = 0; !running.empty(); ++i) {
    const uint32_t k = (i < n_order ? order[i] : i) % static_cast<uint32_t>(running.size());
    const uint32_t id = running[k];
    act(blocks[id], id);
    if (blocks[id].state == 3) {  // the next block of the grid takes its place
      if (started < grid) running[k] = started++;
      else running.erase(running.begin() + k);
    }
  }
}

extern "C" uint32_t host_group_rounds(uint64_t n, uint32_t blocks, uint32_t threads,
                                      uint32_t most) {
  return group_rounds(n, blocks, threads, most);
}
"""


@pytest.fixture(scope="module")
def group_claim_twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host twins cannot be built")
    d = tmp_path_factory.mktemp("group_claim_twin")
    src, lib = d / "group_claims.cpp", d / "libgroup_claims.so"
    src.write_text(GROUP_CLAIM_SOURCE)
    proc = subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-o",
                           str(lib), str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    u32, i32, u8p = ctypes.c_uint32, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)
    dll.host_group_hits.argtypes = [i32, i32, i32, u32, i32] + [U32P] * 6 + [u32, u8p]
    dll.host_group_hits.restype = i32
    dll.host_group_launch.argtypes = [u8p, i32, u32, u32, u32, u32, u32, i32, U32P, u32, U32P,
                                      U32P]
    dll.host_group_launch.restype = None
    dll.host_group_rounds.argtypes = [ctypes.c_uint64, u32, u32, u32]
    dll.host_group_rounds.restype = u32
    return dll


def _group_case(seed):
    """A group of 1-8 md5 slots of one tail layout (width 1-4, one or two
    tail blocks), each with its own nonce, power-of-two run, cursor and
    difficulty; one slot at difficulty 0 (its hit is index 0, in the first
    tile) and, where the group has two slots or more, one at the full
    digest (no hit)."""
    from distpow_tpu_torch.ops.difficulty import nibble_masks
    from distpow_tpu_torch.ops.operands import group_operands

    rng = np.random.default_rng(seed)
    md5 = get_hash_model("md5")
    n_slots = int(rng.integers(1, 9))
    width = int(rng.integers(1, 5))
    nonce_len = 5 if seed % 2 == 0 else md5.block_bytes - 2
    batch = int(rng.choice([1 << 12, 3000, 5 << 10]))
    ds = [int(rng.integers(1, 4)) for _ in range(n_slots)]
    ds[int(rng.integers(0, n_slots))] = 0
    if n_slots > 1:
        ds[next(s for s in range(n_slots) if ds[s] != 0)] = md5.max_difficulty
    specs, logs, tb_lo, chunk0 = [], [], [], []
    for s in range(n_slots):
        nonce = rng.integers(0, 256, size=nonce_len, dtype=np.uint8).tobytes()
        specs.append(build_tail_spec(nonce, width, md5))
        lg = int(rng.choice([0, 1, 4, 8]))
        logs.append(lg)
        tb_lo.append(int(rng.integers(0, 256 >> lg)) << lg)
        chunk0.append(256 ** (width - 1) + int(rng.integers(0, 1000)))
    ops = group_operands([x.init_state for x in specs], [x.base_words for x in specs],
                         [nibble_masks(d, md5) for d in ds], tb_lo, logs, chunk0)
    return md5, specs[0], ops, batch, ds


def _group_hits(twin, md5, spec, ops, batch):
    var_word, var_shift, chunk_mask = kernel_layout(spec.tb_loc, spec.chunk_locs, md5)
    rows = [_arr(t.numpy().view(np.uint32)) for t in (ops.init, ops.base, ops.masks, ops.tb_lo,
                                                       ops.log_tbc, ops.chunk0)]
    hit = np.zeros(ops.n_slots * batch, np.uint8)
    assert twin.host_group_hits(ops.n_blocks, var_word, var_shift, chunk_mask, ops.n_slots,
                                *(p for _, p in rows), batch,
                                hit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))) == 0
    return hit.reshape(ops.n_slots, batch).astype(bool)


def _group_launch(twin, hit, grid, resident, threads, rounds, early, rng=None):
    """The simulated launch's words, claims per slot and tests per index:
    running blocks drawn at random by ``rng``, or in round robin without
    one."""
    n_slots, batch = hit.shape
    hits = np.ascontiguousarray(hit.reshape(-1).astype(np.uint8))
    steps = 0 if rng is None else \
        4 * (n_slots * batch // threads + 4 * grid * n_slots) * (rounds + 2)
    order, order_p = _arr(rng.integers(0, 1 << 30, size=steps) if steps else [0])
    out, out_p = _arr([SENTINEL] * n_slots + [0] * n_slots)
    tested, tested_p = _arr(np.zeros(n_slots * batch))
    twin.host_group_launch(hits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_slots, batch,
                           grid, resident, threads, rounds, int(early), order_p, steps, out_p,
                           tested_p)
    return (out[:n_slots].tolist(), out[n_slots:].tolist(),
            tested.reshape(n_slots, batch).copy())


@pytest.mark.parametrize("early", [False, True], ids=["cell_at_check", "cell_at_tile_start"])
@pytest.mark.parametrize("seed", range(10))
def test_group_claims_keep_each_slots_least_index(group_claim_twin, seed, early):
    """Under seeded interleavings of the running blocks, for groups of 1-8
    slots of one layout and different runs and difficulties, on grids of a
    block a slot or more, some running all at once, some a few at a time
    (blocks that start later take the slots still open): each slot's word
    equals the plain group step's (exact), every index is tested at most
    once, and a slot without a hit has every index tested, its claims
    covering its tiles, at most one more a block.  Running blocks that keep
    pace (round robin) test no more of a slot than its tiles up to the
    hit's, plus one a running block, and claim at most one more a block of
    the grid besides.  Where a block checks its claims against the cell as
    it read it when its tile began (``early``, the kernel's form for all
    hashes but md5's), the same holds with one more tile a running block."""
    from distpow_tpu_torch.ops.search_step import plain_group_search

    md5, spec, ops, batch, ds = _group_case(seed)
    want = plain_group_search(md5, ops, spec.tb_loc, spec.chunk_locs, batch).tolist()
    hit = _group_hits(group_claim_twin, md5, spec, ops, batch)
    # the kernel's candidate test finds the plain step's first hits
    assert [int(np.flatnonzero(h)[0]) if h.any() else SENTINEL for h in hit] == want
    assert want[ds.index(0)] == 0
    if ops.n_slots > 1:
        assert want[ds.index(md5.max_difficulty)] == SENTINEL
    rng = np.random.default_rng(1000 + seed)
    for trial in range(4):
        threads = int(rng.choice([7, 32, 96, 256]))
        rounds = int(rng.choice([1, 2, 3, 8]))
        grid = ops.n_slots + int(rng.integers(0, 3 * ops.n_slots + 3))
        resident = grid if trial % 2 else int(rng.integers(1, grid + 1))
        tile = threads * rounds
        tiles = -(-batch // tile)
        for paced in (False, True):
            words, claims, tested = _group_launch(group_claim_twin, hit, grid, resident, threads,
                                                  rounds, early, None if paced else rng)
            where = (seed, early, trial, paced, grid, resident, threads, rounds)
            assert words == want, where
            assert tested.max() <= 1, where
            for s, w in enumerate(want):
                if w == SENTINEL:
                    assert tested[s].sum() == batch, where
                    assert tiles <= claims[s] <= tiles + grid, where
                elif paced:
                    past = (1 + early) * resident
                    assert tested[s].sum() <= (w // tile + 1 + past) * tile, where
                    assert claims[s] <= w // tile + 1 + past + grid, where


@pytest.mark.parametrize("n,blocks,most,want", [
    (8 << 20, 792, 64, 2),     # md5's engine launch (8 slots x 2^20) on 6 blocks an SM
    (8 << 20, 264, 4, 2),      # sha512's, on 2 blocks an SM: at most 2 rounds
    (8 << 20, 264, 1, 1),      # a model's (or a tool's) fewer rounds hold
    (1 << 23, 8192, 64, 1),    # a wave that leaves each block 4 tiles of 1 round
    (3 << 12, 792, 64, 1),     # a group of 3 small slots: a candidate a tile
    (65535 << 31, 1, 1 << 16, 2),  # past 2^32 indices: cut to 2^32 - 1
])
def test_group_rounds_leave_each_block_sixteen_tiles(group_claim_twin, n, blocks, most, want):
    """The group launch's tile (``group_rounds``): ``launch_rounds`` over
    the whole group's indices on one wave, at 16 tiles a block, twice the
    persistent form's, and at most 2 rounds, so that a launch's last tiles
    end close together whatever the model's cost: md5's engine launch of 8
    slots x 2^20 leaves each block of its wave at least 16 tiles, of 2
    rounds."""
    got = group_claim_twin.host_group_rounds(n, blocks, 256, most)
    assert got == want
    assert 1 <= got <= min(most, 2)
    assert got == 1 or got == min(most, 2) or -(-min(n, 0xFFFFFFFF) // (got * 256)) >= 16 * blocks
