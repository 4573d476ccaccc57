// SHA-384 proof-of-work search kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel distpow_tpu/ops/md5_pallas.py _dyn_pallas_step
// (the scaffold) around _sha384_tile, over _sha512_tile_impl (the rounds).
// The kernel, its design and what bounds it are in hash_search.cuh; the
// rounds in sha512.cuh.
//
// Interface: five plain C functions, launched on the caller's stream;
// they do not synchronise and allocate nothing.  The search of one request
// (arguments as in distpow::launch_hash_search), the scheduler's search of
// a group of slots (DISTPOW_GROUP_FUNCTION) and one shard's
// launch of a mesh search (distpow::launch_hash_mesh_search); and the
// persistent forms of the first and the third (DISTPOW_PERSISTENT_FUNCTIONS).
#include "sha512.cuh"

extern "C" int distpow_sha384_search(const void* init, const void* base, const void* masks,
                                     int n_blocks, int mask_words, uint32_t chunk0, uint32_t tb_lo,
                                     uint32_t tbc, int log_tbc, int var_word, int var_shift,
                                     uint32_t chunk_mask, uint32_t n, void* out, int grid,
                                     void* stream) {
  return distpow::launch_hash_search<distpow::Sha384>(init, base, masks, n_blocks, mask_words,
                                                      chunk0, tb_lo, tbc, log_tbc, var_word, var_shift,
                                                      chunk_mask, n, out, grid, stream);
}

DISTPOW_GROUP_FUNCTION(sha384, distpow::Sha384, true)

extern "C" int distpow_sha384_mesh_search(
    const void* init, const void* base, const void* masks, int n_blocks, int mask_words,
    uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word, int var_shift,
    uint32_t chunk_mask, uint32_t n, uint32_t origin_chunk0, uint32_t origin_tb_lo,
    uint32_t origin_tbc, void* out, int grid, void* stream) {
  return distpow::launch_hash_mesh_search<distpow::Sha384>(
      init, base, masks, n_blocks, mask_words, chunk0, tb_lo, tbc, log_tbc, var_word, var_shift,
      chunk_mask, n, origin_chunk0, origin_tb_lo, origin_tbc, out, grid, stream);
}

DISTPOW_PERSISTENT_FUNCTIONS(sha384, distpow::Sha384, true)
