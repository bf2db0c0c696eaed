// Which rows of a flash-CE call count, shared by the forward
// (csrc/flash_ce_fwd.cu) and the backward (csrc/flash_ce_bwd.cu) kernels.
// Header-only.
#pragma once

#include "common.cuh"

namespace egom2p {

// One block of 1024 threads.  A row counts where mark[row] != 0 (every row
// when mark is null).  live_tiles / n_live: the kTile-row tiles of the rows
// that hold a row that counts, compacted in order; pair_live (may be null):
// whether a block of two neighbouring tiles holds one.
template <int kTile, typename T>
__global__ void __launch_bounds__(1024)
    ce_live_scan_kernel(const T* __restrict__ mark, int n_rows, int* __restrict__ live_tiles,
                        int* __restrict__ n_live, int* __restrict__ pair_live) {
  __shared__ int warp_count[32];
  __shared__ int base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_t = (n_rows + kTile - 1) / kTile;
  if (tid == 0) base = 0;
  for (int t0 = 0; t0 < n_t; t0 += 1024) {  // 1024 tiles a round, one tile a thread
    const int t = t0 + tid;
    bool live = false;
    if (t < n_t) {
      const int lim = min(kTile, n_rows - t * kTile);
      if (mark == nullptr) {
        live = true;
      } else {
        for (int i = 0; i < lim && !live; ++i) live = mark[t * kTile + i] != T(0);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    // a block is two neighbouring tiles: lanes 2k and 2k + 1
    if (pair_live != nullptr && t < n_t && (lane & 1) == 0) {
      pair_live[t >> 1] = (ballot >> lane) & 3u ? 1 : 0;
    }
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = base;
    for (int w = 0; w < warp; ++w) before += warp_count[w];
    if (live) live_tiles[before + __popc(ballot & ((1u << lane) - 1u))] = t;
    __syncthreads();
    if (tid == 0) {
      int total = base;
      for (int w = 0; w < 32; ++w) total += warp_count[w];
      base = total;
    }
    __syncthreads();
  }
  if (tid == 0) *n_live = base;
}

}  // namespace egom2p
