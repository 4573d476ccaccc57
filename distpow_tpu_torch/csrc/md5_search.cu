// MD5 proof-of-work search kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel distpow_tpu/ops/md5_pallas.py _dyn_pallas_step
// (the scaffold) around _md5_tile (the rounds).  The kernel, its design and
// what bounds it are in hash_search.cuh; the rounds, built for one tail
// layout's var_word, in md5.cuh.
//
// Built once per var_word (nvcc -DDISTPOW_VAR_WORD=<0-15>, ops/_build.py):
// the library holds the kernels of the tails whose run starts at that
// message word (one- and two-block tails, or two-block ones only for words
// 14 and 15).
//
// Interface: five plain C functions, launched on the caller's stream;
// they do not synchronise and allocate nothing.  The search of one request
// (arguments as in distpow::launch_hash_search), the scheduler's search of
// a group of slots (distpow::launch_hash_group_search) and one shard's
// launch of a mesh search (distpow::launch_hash_mesh_search); and the
// persistent forms of the first and the third (DISTPOW_PERSISTENT_FUNCTIONS).  Each returns
// cudaErrorInvalidValue for a var_word other than the library's.
#include "md5.cuh"

#ifndef DISTPOW_VAR_WORD
#error "md5_search.cu is built once per var_word: nvcc -DDISTPOW_VAR_WORD=<0-15>"
#endif

namespace {
using H = distpow::Md5<DISTPOW_VAR_WORD>;
}

extern "C" int distpow_md5_search(const void* init, const void* base, const void* masks,
                                  int n_blocks, int mask_words, uint32_t chunk0, uint32_t tb_lo,
                                  uint32_t tbc, int log_tbc, int var_word, int var_shift,
                                  uint32_t chunk_mask, uint32_t n, void* out, int grid,
                                  void* stream) {
  if (var_word != DISTPOW_VAR_WORD) return static_cast<int>(cudaErrorInvalidValue);
  return distpow::launch_hash_search<H>(init, base, masks, n_blocks, mask_words, chunk0, tb_lo,
                                        tbc, log_tbc, var_word, var_shift, chunk_mask, n, out,
                                        grid, stream);
}

extern "C" int distpow_md5_group_search(
    const void* init, const void* base, const void* masks, int n_blocks, int var_word,
    int var_shift, uint32_t chunk_mask, const void* tb_lo, const void* log_tbc,
    const void* chunk0, int n_slots, uint32_t batch, void* out, int grid_x, void* stream) {
  if (var_word != DISTPOW_VAR_WORD) return static_cast<int>(cudaErrorInvalidValue);
  return distpow::launch_hash_group_search<H>(init, base, masks, n_blocks, var_word, var_shift,
                                              chunk_mask, tb_lo, log_tbc, chunk0, n_slots, batch,
                                              out, grid_x, stream);
}

extern "C" int distpow_md5_mesh_search(
    const void* init, const void* base, const void* masks, int n_blocks, int mask_words,
    uint32_t chunk0, uint32_t tb_lo, uint32_t tbc, int log_tbc, int var_word, int var_shift,
    uint32_t chunk_mask, uint32_t n, uint32_t origin_chunk0, uint32_t origin_tb_lo,
    uint32_t origin_tbc, void* out, int grid, void* stream) {
  if (var_word != DISTPOW_VAR_WORD) return static_cast<int>(cudaErrorInvalidValue);
  return distpow::launch_hash_mesh_search<H>(init, base, masks, n_blocks, mask_words, chunk0,
                                             tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask,
                                             n, origin_chunk0, origin_tb_lo, origin_tbc, out,
                                             grid, stream);
}

DISTPOW_PERSISTENT_FUNCTIONS(md5, H, var_word == DISTPOW_VAR_WORD)
