// One round variant (round_variants.cuh) as a search kernel, built by
// round_variants.py from a source that names the hash first:
//   #define VARIANT Blake2bAs<BlakeForms<SUM_CARRY, ROT_SHF, ROT_SHF, ROT_SHF, 0>>
//   #include "round_variants.cu"
// Only the main path's specializations are built: one tail block, a
// power-of-two run, mask words 1 and 2.  Arguments as in
// distpow::launch_hash_search; any other configuration returns
// cudaErrorInvalidValue.
#include "round_variants.cuh"

extern "C" int variant_search(const void* init, const void* base, const void* masks,
                              int n_blocks, int mask_words, uint32_t chunk0, uint32_t tb_lo,
                              uint32_t tbc, int log_tbc, int var_word, int var_shift,
                              uint32_t chunk_mask, uint32_t n, void* out, int grid,
                              void* stream) {
  using namespace distpow;
  using V = VARIANT;
  if (n_blocks != 1 || log_tbc < 0 || (mask_words != 1 && mask_words != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Layout L{chunk0, tb_lo, tbc, log_tbc, var_word, var_shift, chunk_mask};
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const uint32_t*>(init);
  auto b = static_cast<const uint32_t*>(base);
  auto m = static_cast<const uint32_t*>(masks);
  auto o = static_cast<uint32_t*>(out);
  if (mask_words == 1) launch_search_kernel<V, 1, 1, true>(i, b, m, L, n, o, grid, s);
  else launch_search_kernel<V, 2, 1, true>(i, b, m, L, n, o, grid, s);
  return static_cast<int>(cudaGetLastError());
}

// The table of K[i] + m[g] of a variant that reads it from constant memory
// (Md5KcConst): written before a launch on the default stream.
extern "C" int variant_set_kc(const uint32_t* kc) {
#if defined(VARIANT_KC_CONST)
  return static_cast<int>(cudaMemcpyToSymbol(distpow::kVariantKc, kc, 64 * sizeof(uint32_t)));
#else
  (void)kc;
  return 0;
#endif
}
