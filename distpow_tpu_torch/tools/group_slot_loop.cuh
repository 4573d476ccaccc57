// A design of the group kernel's block that tools/group_variants.py times
// beside the one built (hash_search.cuh hash_group_block): each block
// stays resident and loops over slots, moving to the next open slot when
// its own is no longer open, and makes each slot's launch constants at
// the top of that loop.  The variant's build puts it in place of
// hash_group_block in a copy of hash_search.cuh; it uses the header's
// GroupTile and group_claim.

// Warp 0's move of a block that leaves slot `slot`: the first open slot
// after it in turn (32 read at once), where lane 0 claims a tile and
// checks it; slot -1 when none is open.
__device__ __forceinline__ GroupTile slot_loop_move(int& slot, uint32_t& next, uint32_t* out,
                                                    int n_slots, uint32_t batch, uint32_t tile) {
  uint32_t* const counters = out + n_slots;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (;;) {
    int to = -1;
#pragma unroll 1
    for (int k = 1; k < n_slots && to < 0; k += 32) {
      const int i = k + lane, t = (slot + i) % n_slots;
      const bool open = i < n_slots && group_slot_open(live_word(out + t),
                                                       live_word(counters + t), tile, batch);
      const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, open);
      if (ballot != 0) to = (slot + k + __ffs(ballot) - 1) % n_slots;
    }
    if (to < 0) return GroupTile{-1, SENTINEL};
    slot = to;
    uint32_t b = SENTINEL;
    if (lane == 0) {
      next = atomicAdd(counters + slot, 1u);
      b = group_claim(slot, next, live_word(out + slot), out, n_slots, batch, tile);
    }
    b = __shfl_sync(0xFFFFFFFFu, b, 0);
    if (b != SENTINEL) return GroupTile{slot, b};
  }
}

template <class H, int N_BLOCKS>
__device__ __forceinline__ void hash_group_block(DISTPOW_GROUP_PARAMS) {
  constexpr int D = H::DIGEST_WORDS, BASE_WORDS = H::ROW_WORDS * N_BLOCKS;
  __shared__ uint32_t init[H::STATE_WORDS], base[BASE_WORDS];
  __shared__ GroupTile handed[2];
  const uint32_t tile = rounds * HASH_BLOCK_THREADS;
  int slot = group_home_slot(blockIdx.x, n_slots);  // warp 0's
  uint32_t next = 0;                                 // thread 0's claim ahead, as counted
  int buf = 0;
  auto hand_over = [&](GroupTile t) {
    if (threadIdx.x == 0) handed[buf] = t;
    __syncthreads();
    t = handed[buf];
    buf ^= 1;
    return t;
  };
  uint32_t b = SENTINEL;
  if (threadIdx.x == 0) {
    next = atomicAdd(out + n_slots + slot, 1u);
    b = group_claim(slot, next, live_word(out + slot), out, n_slots, batch, tile);
  }
  GroupTile t = hand_over(GroupTile{slot, b});
#pragma unroll 1
  for (;;) {
    if (t.b == SENTINEL) {
      if (threadIdx.x < 32) t = slot_loop_move(slot, next, out, n_slots, batch, tile);
      t = hand_over(t);
      if (t.slot < 0) return;
    }
    const int s = t.slot;
    for (int i = threadIdx.x; i < H::STATE_WORDS; i += blockDim.x)
      init[i] = init_g[s * H::STATE_WORDS + i];
    for (int i = threadIdx.x; i < BASE_WORDS; i += blockDim.x) base[i] = base_g[s * BASE_WORDS + i];
    uint32_t masks[D];
#pragma unroll
    for (int i = 0; i < D; ++i) masks[i] = __ldg(masks_g + s * D + i);
    const Layout L = slot_layout(__ldg(chunk0 + s), __ldg(tb_lo + s), __ldg(log_tbc + s), var_word,
                                 var_shift, chunk_mask);
    __syncthreads();
    // the slot's launch constants, inside the loop over slots
    const CandidateTest<H, D, N_BLOCKS> hits(init, base, masks);
    bool testing = true;
#pragma unroll 1
    do {
      if (testing) {
        const uint32_t end = min(t.b + tile, batch);
#pragma unroll 1
        for (uint32_t f = claim_index(t.b, threadIdx.x, HASH_BLOCK_THREADS, 0); f < end;
             f += HASH_BLOCK_THREADS) {
          uint32_t tb, chunk;
          decode<true>(L, f, tb, chunk);
          if (hits(L, tb, chunk)) {
            atomicMin(out + s, f);
            testing = false;
            break;
          }
        }
      }
      b = threadIdx.x == 0 ? group_claim(s, next, live_word(out + s), out, n_slots, batch, tile)
                           : SENTINEL;
      t = hand_over(GroupTile{s, b});
    } while (t.b != SENTINEL);
  }
}
