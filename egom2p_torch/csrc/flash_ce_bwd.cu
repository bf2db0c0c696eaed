// Backward of the cross-entropy of a large-vocab head for Hopper (sm_90a):
// for total = sum_r wc_r (logz_r - y_r . w_{t_r}) over y (R, D) and head
// W (V, D),
//   dl = (exp(s - logz) - onehot(t)) * wc,   s = fp32(y . w) (R x V logits)
//   dy = dl W   (R, D) fp32,   dW = dl^T y   (V, D) fp32,
// with dl rounded to bf16 before both products, and the logits never in
// device memory.  Called from egom2p_torch/ops/flash_ce.py (`ce_bwd`, under
// EGOM2P_CE_PALLAS_BWD=1).
//
// Replaces the Pallas TPU kernel egom2p_tpu/ops/flash_ce.py `_ce_bwd_kernel`
// (reached through `_bwd_pallas` -> `pl.pallas_call`).  Math as there: padded
// vocab columns (past V) give p = 0, rows past R and rows of weight 0 give
// dl = 0 exactly.
//
// What bounds it on this card: arithmetic.  At the training step's shapes
// (R = 16384, D = 768, V = 64000) the three products (logits, dy, dW) are
// 1.6 TFLOP each over all rows: 4.9 ms at 989 TFLOP/s, 2.4 ms when half the
// rows weigh 0 (as in training); y, W, dy and dW are 0.37 GB, 0.11 ms.  The
// TPU kernel keeps a (bv, 768) fp32 dW block resident in VMEM; on an SM a
// 64 x 768 fp32 accumulator is 192 KB, three quarters of the register file,
// so a block can own 64 output rows and no more, and every block streams the
// whole other operand from L2: 128 FLOPs per byte.
//
// What the design does about it: two instances of one block routine, each
// owning its output, so that nothing needs atomics and the result is
// deterministic.  A dy block owns 64 rows of y and walks the vocab; a dW
// block owns 64 vocab rows of W and walks only the 32-row tiles of y that
// hold a row of nonzero weight (a dy block whose rows all weigh 0 returns at
// once).  Both run in ONE grid, the dy blocks first: they are few and long
// (R / 64 blocks walking V / 32 tiles), and the many short dW blocks fill
// the SMs that the last dy blocks leave idle.  A block owns ALL D output
// columns, so each logits tile is computed once per block:
//   * the owned 64 x D tile X stays in shared memory; the walked operand goes
//     by in tiles Z of 32 rows x D through a ring of two stages; both as
//     D / 64 column blocks of rows x 128 bytes (TMA, 128-byte swizzle);
//   * D / 256 warpgroups each hold 64 x 256 fp32 of the output (128 registers
//     a thread) and add dl . Z over their own 256 columns: wgmma m64n256k16,
//     A = the bf16 dl tile from shared memory, B = their Z column blocks read
//     MN-major.  A warpgroup that is done with its column blocks of a stage
//     refills them with the tile after next by TMA itself;
//   * the last warpgroup also computes the whole 64 x 32 logits tile: wgmma
//     m64n32k16 over the D / 16 k-steps (A = X, B = Z, both K-major), then
//     dl = (exp(s - logz) - onehot) * wc in registers, rounded to bf16 into
//     one half of a 64 x 64 swizzled tile (the halves alternate), and an
//     mbarrier tells the others.  It issues tile t+1's logits ahead of its
//     own dl . Z of tile t and makes dl(t+1) while that product runs, so
//     the other warpgroups never wait for dl in the steady state.
// Any D a multiple of 128 (the column plan, egom2p_torch/ops/flash_ce.py
// `bwd_column_plan`, which hands the kernel its group width):
//   * up to D = 768 one block owns all D columns as above; a remainder of
//     128 columns goes to a last warpgroup of m64n128k16 (kHalf: D = 128,
//     384, 640);
//   * above D = 768 the owned 64 x D tile no longer fits beside the walked
//     stages (D = 1024: 128 KB + 2 x 64 KB), so a second grid dimension
//     splits the columns into equal groups of 512, 256 or 128 (D = 1024 and
//     2048: groups of 512).  A block owns its 64 rows and one group's
//     columns; its walked stages hold only that group's column blocks, and
//     the last warpgroup computes the whole logits tile anew (every group
//     recomputes it) from a ring of kRing stages of (X, Z) 128-column pairs
//     over all of D that its leader fills by TMA (kStream).  The logits cost
//     one product per group on top of the group's two, and their ring loop
//     waits for each stage's product before it refills the stage.
// Which tiles and blocks of y hold a row of nonzero weight is found by a
// small scan kernel first (csrc/ce_scan.cuh, shared with the forward), into
// scratch that the caller provides.
// Shared memory at D = 768: 96 KB (X) + 2 x 48 KB (Z) + 8 KB (dl) = 201 KB.
// Registers (ptxas, CUDA 12.8): 184 at D = 256 and 512, no spills.  At
// D = 768 three warpgroups start at 168 each; setmaxnreg moves 8 from each
// accumulate-only warpgroup to the last (160 / 160 / 184), which still
// spills 144 bytes, and ptxas reports that it serialises wgmma there for
// want of registers (C7512): the open end of this design.

#include "ce_scan.cuh"
#include "hopper.cuh"

namespace {

using namespace egom2p;

constexpr int kOwn = 64;          // owned rows per block
constexpr int kWalk = 32;         // walked rows per tile (the logits tile's columns)
constexpr int kMaxDim = 768;      // widest group; above it the owned tile is streamed
constexpr int kRing = 4;          // kStream: stages of (X, Z) column pairs for the logits
constexpr int kPair = 2;          // kStream: 64-column blocks a ring stage holds
constexpr int kXBlockBytes = kOwn * 128;    // one column block of X: 64 rows x 64 columns
constexpr int kZBlockBytes = kWalk * 128;   // ... of a Z stage: 32 rows x 64 columns
constexpr int kAccRegs = 160, kLastRegs = 184;  // D = 768: 2 x 160 + 184 = 3 x 168
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const int* targets;
  const float *wc, *logz;  // (R,) fp32: row weight times the upstream gradient; logsumexp
  float *dy, *dw;          // zeroed (R, D) and (V, D) fp32 outputs
  // from the scan kernel: the 32-row tiles of y that hold a row of nonzero
  // weight, in order, their count, and a flag per 64-row block of y
  const int *live_tiles, *n_live, *block_live;
  int n_rows, vocab, dim;
};

// kBlocks: 64-column blocks of the group (of D when the owned tile is
// resident)
template <int kBlocks, bool kStream>
struct Smem {
  __nv_bfloat16 x[kBlocks][kXBlockBytes / 2];      // the owned tile
  __nv_bfloat16 z[2][kBlocks][kZBlockBytes / 2];   // two stages of the walked operand
  __nv_bfloat16 dl[kOwn * 64];                     // bf16 dl, K-major: tile t in columns 32 (t & 1) ..
  float lz[2][kWalk], cw[2][kWalk];        // dW instance: the walked rows' logz, weight
  int tg[2][kWalk];                        // ... and target
  uint64_t x_full, z_full[2], dl_full[2], dl_free[2];
};

// Streamed owned tile: the group's columns of two walked stages, and a ring
// of (X, Z) column blocks over all of D for the logits.
template <int kBlocks>
struct Smem<kBlocks, true> {
  __nv_bfloat16 z[2][kBlocks][kZBlockBytes / 2];
  __nv_bfloat16 rx[kRing][kPair * kXBlockBytes / 2], rz[kRing][kPair * kZBlockBytes / 2];
  __nv_bfloat16 dl[kOwn * 64];
  float lz[2][kWalk], cw[2][kWalk];
  int tg[2][kWalk];
  uint64_t z_full[2], dl_full[2], dl_free[2], ring_full[kRing];
};

// One block's work: kDw = false owns rows own0 .. of y (map_x) and walks W
// (map_z); kDw = true owns vocab rows of W and walks the live tiles of y.
// kNW warpgroups own 256 columns each, but the last only 128 under kHalf;
// kStream: the block owns one column group (blockIdx.y) of a D above
// kMaxDim and streams the owned tile for the logits.
template <bool kDw, int kNW, bool kHalf, bool kStream>
__device__ __forceinline__ void ce_bwd_block(const CUtensorMap& map_x, const CUtensorMap& map_z,
                                             const Args& a, const int own_block) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kBlocks = 4 * kNW - (kHalf ? 2 : 0);  // column blocks of the group
  using Tiles = Smem<kBlocks, kStream>;
  Tiles& sm = *reinterpret_cast<Tiles*>(smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x, wg = tid >> 7;  // every warpgroup accumulates, the last also makes dl
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // accumulator row group / column pair
  const int own0 = own_block * kOwn;
  const int n_own = kDw ? a.vocab : a.n_rows, n_walk = kDw ? a.n_rows : a.vocab;
  const int row_in = warp * 16 + gid;  // this thread's owned rows: row_in, row_in + 8
  const int r0 = own0 + row_in;
  const int col0 = kStream ? blockIdx.y * kBlocks * 64 : 0;  // the group's first column
  // this warpgroup's column blocks of the group: wg * 4 ..
  const int wg_blocks = kHalf && wg == kNW - 1 ? 2 : 4;

  // dy instance: a block whose rows all weigh 0 has no tile to walk and
  // leaves its zeroed dy as it is.
  const int n_tiles = kDw ? *a.n_live
                          : (a.block_live[own_block] != 0 ? (n_walk + kWalk - 1) / kWalk : 0);
  if (n_tiles == 0) return;
  auto tile_row0 = [&](int ti) { return (kDw ? a.live_tiles[ti] : ti) * kWalk; };

  if (tid == 0) {
    if constexpr (kStream) {
#pragma unroll
      for (int i = 0; i < kRing; ++i) mbar_init(&sm.ring_full[i], 1);  // (+ the TMA bytes)
    } else {
      mbar_init(&sm.x_full, 1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.z_full[i], kNW);       // the warpgroups' leaders (+ their TMA bytes)
      mbar_init(&sm.dl_full[i], 1);        // the last warpgroup's leader
      mbar_init(&sm.dl_free[i], 4 * kNW);  // one lane of each warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Descriptors are made where they are used, from the tiles' shared
  // addresses in 16-byte units and constant upper halves.
  const uint32_t z16 = smem_addr(sm.z[0][0]) >> 4;
  const uint32_t dl16 = smem_addr(sm.dl) >> 4;
  constexpr uint32_t kZStep = kZBlockBytes >> 4;
  constexpr uint32_t kKMajorHi = (1024 >> 4) | (1u << 30);  // SBO 1024, 128-byte swizzle
  auto desc = [](uint32_t lo, uint32_t hi) { return (static_cast<uint64_t>(hi) << 32) | lo; };

  // this warpgroup streams its own 4 column blocks of walked tile ti into
  // stage ti & 1
  auto load_z = [&](int ti) {
    const int z0 = tile_row0(ti), s = ti & 1;
    mbar_arrive_expect_tx(&sm.z_full[s], wg_blocks * kZBlockBytes);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = wg * 4 + i;
      if (i < wg_blocks) tma_load_2d(sm.z[s][c], &map_z, &sm.z_full[s], col0 + c * 64, z0);
    }
  };
  if constexpr (!kStream) {
    if (tid == 0) {
      mbar_arrive_expect_tx(&sm.x_full, kBlocks * kXBlockBytes);
#pragma unroll
      for (int c = 0; c < kBlocks; ++c) tma_load_2d(sm.x[c], &map_x, &sm.x_full, c * 64, own0);
    }
  }
  if ((tid & 127) == 0) {
    load_z(0);
    if (n_tiles > 1) load_z(1);
  }

  float acc[128];  // 64 owned rows x 256 output columns
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // B of dl . Z: this warpgroup's column blocks, MN-major: 16 walked rows
  // are 2048 bytes, the next 64 columns one column block on
  const uint32_t zn16 = (z16 + wg * 4 * kZStep) | (kZStep << 16);
  // acc (64 x 256, or 64 x 128) += bf16(dl) (64 owned x 32 walked) . Z (32
  // walked x 256 or 128), stage s
  auto issue_acc = [&](auto& out, int s) {
#pragma unroll
    for (int kk = 0; kk < kWalk / 16; ++kk) {
      wgmma_ss<1>(out, desc(dl16 + s * (64 >> 4) + 2 * kk, kKMajorHi),
                  desc(zn16 + s * kBlocks * kZStep + kk * (2048 >> 4), kKMajorHi), 1);
    }
    wgmma_commit();
  };
  // after this warpgroup's product over tile ti: the dl half is free, and its
  // column blocks of the stage take the tile after next
  auto release = [&](int ti) {
    if (lane == 0) mbar_arrive(&sm.dl_free[ti & 1]);
    if (ti + 2 < n_tiles) {
      named_barrier_sync(2 + wg, 128);  // every warp of the warpgroup is done with them
      if ((tid & 127) == 0) load_z(ti + 2);
    }
  };
  auto store_acc = [&](const auto& res) {
    constexpr int kTiles = sizeof(res) / sizeof(float) / 4;  // 8-column tiles
    float* out = kDw ? a.dw : a.dy;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + i * 8;
      if (row >= n_own) continue;
      float* o = out + static_cast<int64_t>(row) * a.dim + col0 + wg * 256;
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        *reinterpret_cast<float2*>(o + j * 8 + tig * 2) =
            make_float2(res[4 * j + 2 * i], res[4 * j + 2 * i + 1]);
      }
    }
  };

  if (wg < kNW - 1) {
    // ------------------------------------------- warpgroups that only accumulate
    if (kNW == 3 && !kHalf) setmaxnreg_dec<kAccRegs>();
    for (int ti = 0; ti < n_tiles; ++ti) {
      const int s = ti & 1, phase = (ti >> 1) & 1;
      mbar_wait(&sm.z_full[s], phase);
      mbar_wait(&sm.dl_full[s], phase);
      fence_regs(acc);
      wgmma_fence();
      issue_acc(acc, s);
      wgmma_wait<0>();
      fence_regs(acc);
      release(ti);
    }
    store_acc(acc);
    return;
  }

  // ------------------------- the last warpgroup: logits and dl, and its own columns
  if (kNW == 3 && !kHalf) setmaxnreg_inc<kLastRegs>();
  // dy instance: the owned rows' logz, weight and target
  float own_lz[2] = {0.f, 0.f}, own_wc[2] = {0.f, 0.f};
  int own_t[2] = {-1, -1};
  if (!kDw) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + i * 8;
      if (row < a.n_rows) {
        own_lz[i] = a.logz[row];
        own_wc[i] = a.wc[row];
        own_t[i] = a.targets[row];
      }
    }
  }
  constexpr uint32_t kXStep = kXBlockBytes >> 4;
  float lg[16];  // logits: 64 owned rows x 32 walked rows
  unsigned char* dl_tile = reinterpret_cast<unsigned char*>(sm.dl);

  // dW instance: the walked rows' logz, weight and target of tile ti
  auto load_meta = [&](int ti) {
    if (kDw && (tid & 127) < kWalk) {
      const int c = tid & 127, row = tile_row0(ti) + c, s = ti & 1;
      const bool ok = row < n_walk;
      sm.lz[s][c] = ok ? a.logz[row] : 0.f;
      sm.cw[s][c] = ok ? a.wc[row] : 0.f;
      sm.tg[s][c] = ok ? a.targets[row] : -1;
    }
  };
  // logits (64 owned x 32 walked) = X . Z^T over all of D, both K-major
  auto issue_logits = [&](int s) {
    if constexpr (!kStream) {
      // the bases pass through an empty asm for each column block, or the
      // compiler hoists all 12 x 4 descriptor pairs into registers that this
      // warpgroup lacks
      uint32_t xa = smem_addr(sm.x[0]) >> 4, za = z16 + s * kBlocks * kZStep;
#pragma unroll
      for (int c = 0; c < kBlocks; ++c, xa += kXStep, za += kZStep) {
        asm volatile("" : "+r"(xa), "+r"(za));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<0>(lg, desc(xa + 2 * kk, kKMajorHi), desc(za + 2 * kk, kKMajorHi),
                      (c | kk) != 0);
        }
      }
      wgmma_commit();
    }
  };
  // kStream: the (X, Z) column pairs of every walked tile in order, pair g =
  // tile g / n_kp, columns (g % n_kp) * 128, through the ring (D is a
  // multiple of 128); the leader loads, and refills a slot once the
  // warpgroup's product has read it
  const int n_kp = a.dim / (64 * kPair);
  const bool leader = (tid & 127) == 0;
  auto ring_load = [&](int g) {
    if constexpr (kStream) {
      const int slot = g % kRing, c = (g % n_kp) * kPair;
      mbar_arrive_expect_tx(&sm.ring_full[slot], kPair * (kXBlockBytes + kZBlockBytes));
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        tma_load_2d(sm.rx[slot] + i * (kXBlockBytes / 2), &map_x, &sm.ring_full[slot],
                    (c + i) * 64, own0);
        tma_load_2d(sm.rz[slot] + i * (kZBlockBytes / 2), &map_z, &sm.ring_full[slot],
                    (c + i) * 64, tile_row0(g / n_kp));
      }
    }
  };
  // kStream: the logits of walked tile ti, one ring stage (two column
  // blocks) at a time (the product before it, if any, completes at the first
  // wait)
  auto stream_logits = [&](int ti) {
    if constexpr (kStream) {
      const uint32_t rx16 = smem_addr(sm.rx[0]) >> 4, rz16 = smem_addr(sm.rz[0]) >> 4;
      for (int c = 0; c < n_kp; ++c) {
        const int g = ti * n_kp + c, slot = g % kRing;
        mbar_wait(&sm.ring_full[slot], (g / kRing) & 1);
        fence_regs(lg);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < kPair; ++i) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_ss<0>(lg, desc(rx16 + (slot * kPair + i) * kXStep + 2 * kk, kKMajorHi),
                        desc(rz16 + (slot * kPair + i) * kZStep + 2 * kk, kKMajorHi),
                        (c | i | kk) != 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(lg);
        named_barrier_sync(6, 128);  // every warp's share of the product has read the slot
        if (leader && g + kRing < n_tiles * n_kp) ring_load(g + kRing);
      }
    }
  };
  // dl = (p - onehot) * weight of tile ti, rounded to bf16 into its half of
  // the swizzled dl tile, then handed to every warpgroup
  auto make_dl = [&](int ti) {
    const int s = ti & 1, z0 = tile_row0(ti);
    named_barrier_sync(1, 128);  // the walked rows' values are written
    // every warp is done with this half of the dl tile (tile ti - 2)
    if (ti >= 2) mbar_wait(&sm.dl_free[s], ((ti >> 1) - 1) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j * 8 + tig * 2;  // walked rows z0 + c, z0 + c + 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float lz, wt;
          bool gold;
          if (kDw) {  // owned vocab row r0 + 8i, walked row z0 + c + e
            lz = sm.lz[s][c + e];
            wt = sm.cw[s][c + e];
            gold = sm.tg[s][c + e] == r0 + i * 8;
          } else {    // owned row r0 + 8i, walked vocab column z0 + c + e
            lz = own_lz[i];
            wt = own_wc[i];
            gold = z0 + c + e == own_t[i];
          }
          float p = exp2_approx((lg[4 * j + 2 * i + e] - lz) * kLog2e);
          if (!kDw && z0 + c + e >= a.vocab) p = 0.f;  // padded vocab column
          dl[e] = (p - (gold ? 1.f : 0.f)) * wt;
        }
        const int r = row_in + i * 8, col = s * kWalk + c;  // this tile's half of the dl tile
        *reinterpret_cast<uint32_t*>(dl_tile + r * 128 + (((col >> 3) ^ (r & 7)) << 4) +
                                     (col & 7) * 2) = pack_bf16(dl[0], dl[1]);
      }
    }
    fence_proxy_async();  // the tile is read by wgmma (async proxy)
    named_barrier_sync(1, 128);
    if ((tid & 127) == 0) mbar_arrive(&sm.dl_full[s]);
  };

  auto run_last = [&](auto& res) {
    if constexpr (kStream) {
      if (leader) {
        for (int g = 0; g < kRing && g < n_tiles * n_kp; ++g) ring_load(g);
      }
      load_meta(0);
      stream_logits(0);
      make_dl(0);
      // tile ti's dl . Z goes ahead of tile ti + 1's logits, and completes
      // at their first block
      for (int ti = 0; ti + 1 < n_tiles; ++ti) {
        const int s = ti & 1;
        load_meta(ti + 1);
        mbar_wait(&sm.z_full[s], (ti >> 1) & 1);
        fence_regs(res);
        wgmma_fence();
        issue_acc(res, s);
        stream_logits(ti + 1);
        fence_regs(res);
        make_dl(ti + 1);
        release(ti);
      }
      mbar_wait(&sm.z_full[(n_tiles - 1) & 1], ((n_tiles - 1) >> 1) & 1);
    } else {
      mbar_wait(&sm.x_full, 0);
      load_meta(0);
      mbar_wait(&sm.z_full[0], 0);
      wgmma_fence();
      issue_logits(0);
      wgmma_wait<0>();
      fence_regs(lg);
      make_dl(0);
      // tile ti + 1's logits go ahead of tile ti's dl . Z, and its dl is made
      // while that product runs
      for (int ti = 0; ti + 1 < n_tiles; ++ti) {
        const int s = ti & 1;
        load_meta(ti + 1);
        mbar_wait(&sm.z_full[s ^ 1], ((ti + 1) >> 1) & 1);
        fence_regs(res);
        fence_regs(lg);
        wgmma_fence();
        issue_logits(s ^ 1);
        issue_acc(res, s);
        wgmma_wait<1>();
        fence_regs(lg);
        make_dl(ti + 1);
        wgmma_wait<0>();
        fence_regs(res);
        release(ti);
      }
    }
    fence_regs(res);
    wgmma_fence();
    issue_acc(res, (n_tiles - 1) & 1);
    wgmma_wait<0>();
    fence_regs(res);
    store_acc(res);
  };
  if constexpr (kHalf) {
    float acc_half[64];  // 64 owned rows x 128 output columns
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_half[i] = 0.f;
    run_last(acc_half);
  } else {
    run_last(acc);
  }
}

// The tensor map of a (rows, D) bf16 matrix with row stride `stride`
// (elements): boxes of `box_rows` rows x 64 columns.
int matrix_map(CUtensorMap* map, const void* ptr, int rows, int dim, long long stride,
               int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(dim), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(stride) * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  return make_tensor_map(map, ptr, 2, dims, strides, box);
}

// One launch for both instances, so that the dW blocks fill the SMs that the
// last of the (longer) dy blocks leave idle: blocks 0 .. dy_blocks - 1 own
// rows of y, the rest own vocab rows of W.  owned / walked: the tensor maps
// of y ([0]) and W ([1]) with boxes of 64 and of 32 rows.
template <int kNW, bool kHalf, bool kStream>
__global__ void __launch_bounds__(kNW * 128, 1)
    flash_ce_bwd_kernel(const __grid_constant__ CUtensorMap owned_y,
                        const __grid_constant__ CUtensorMap owned_w,
                        const __grid_constant__ CUtensorMap walked_y,
                        const __grid_constant__ CUtensorMap walked_w, const Args a,
                        const int dy_blocks) {
  const int block = blockIdx.x;
  if (block < dy_blocks) {
    ce_bwd_block<false, kNW, kHalf, kStream>(owned_y, walked_w, a, block);
  } else {
    ce_bwd_block<true, kNW, kHalf, kStream>(owned_w, walked_y, a, block - dy_blocks);
  }
}

// groups: column groups side by side in the grid's second dimension
template <int kNW, bool kHalf, bool kStream>
cudaError_t launch(cudaStream_t st, const CUtensorMap (&owned)[2], const CUtensorMap (&walked)[2],
                   const Args& a, int groups) {
  constexpr int kBlocks = 4 * kNW - (kHalf ? 2 : 0);
  // base rounded up to 1024
  constexpr int smem = static_cast<int>(sizeof(Smem<kBlocks, kStream>)) + 1024;
  auto kernel = flash_ce_bwd_kernel<kNW, kHalf, kStream>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int dy_blocks = (a.n_rows + kOwn - 1) / kOwn, dw_blocks = (a.vocab + kOwn - 1) / kOwn;
  kernel<<<dim3(dy_blocks + dw_blocks, groups), kNW * 128, smem, st>>>(
      owned[0], owned[1], walked[0], walked[1], a, dy_blocks);
  return cudaGetLastError();
}

// The instance of a group of `group_dim` columns: 256 per warpgroup, the
// last 128 wide where 256 does not divide it.  The whole of a D up to 768,
// or (kStream) a group of 512, 256 or 128 columns of a wider D.
cudaError_t launch_group(cudaStream_t st, const CUtensorMap (&owned)[2],
                         const CUtensorMap (&walked)[2], const Args& a, int group_dim) {
  const int groups = a.dim / group_dim;
  if (a.dim > kMaxDim) {
    switch (group_dim) {
      case 128: return launch<1, true, true>(st, owned, walked, a, groups);
      case 256: return launch<1, false, true>(st, owned, walked, a, groups);
      case 512: return launch<2, false, true>(st, owned, walked, a, groups);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (group_dim) {
    case 128: return launch<1, true, false>(st, owned, walked, a, groups);
    case 256: return launch<1, false, false>(st, owned, walked, a, groups);
    case 384: return launch<2, true, false>(st, owned, walked, a, groups);
    case 512: return launch<2, false, false>(st, owned, walked, a, groups);
    case 640: return launch<3, true, false>(st, owned, walked, a, groups);
    default: return launch<3, false, false>(st, owned, walked, a, groups);  // 768
  }
}

}  // namespace

// C entry point, bound with ctypes.  y (R, D) and w (V, D) are bf16 rows with
// unit stride inside a row, 16-byte aligned bases and row strides y_s, w_s
// (elements, multiples of 8); D is a multiple of 128, cut into column groups
// of group_dim columns (the column plan): group_dim == D up to 768, a
// multiple of 128 of at most 768 that divides D above.  targets (R,) int32,
// wc and logz (R,) fp32.  dy (R, D) and dw (V, D) are contiguous fp32
// outputs that the caller has zeroed; scratch is int32 of ceil(R / 32) +
// ceil(R / 64) + 2 elements, written here.  Launches the scan, then both
// instances as one grid, on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int egom2p_flash_ce_bwd(const void* y, const void* w, const void* targets,
                                   const void* wc, const void* logz, void* dy, void* dw,
                                   void* scratch, int n_rows, int vocab, int dim, int group_dim,
                                   long long y_s, long long w_s, void* stream) {
  if (n_rows <= 0 || vocab <= 0 || dim <= 0 || dim % 128 != 0 || group_dim <= 0 ||
      group_dim % 128 != 0 || group_dim > kMaxDim || dim % group_dim != 0 ||
      (dim <= kMaxDim) != (group_dim == dim) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap owned[2], walked[2];  // of y and of w, boxes of 64 and of 32 rows
  int rc = matrix_map(&owned[0], y, n_rows, dim, y_s, kOwn);
  if (rc == 0) rc = matrix_map(&owned[1], w, vocab, dim, w_s, kOwn);
  if (rc == 0) rc = matrix_map(&walked[0], y, n_rows, dim, y_s, kWalk);
  if (rc == 0) rc = matrix_map(&walked[1], w, vocab, dim, w_s, kWalk);
  if (rc != 0) return rc;
  Args a;
  a.targets = static_cast<const int*>(targets);
  a.wc = static_cast<const float*>(wc);
  a.logz = static_cast<const float*>(logz);
  a.dy = static_cast<float*>(dy);
  a.dw = static_cast<float*>(dw);
  a.n_rows = n_rows;
  a.vocab = vocab;
  a.dim = dim;
  int* live_tiles = static_cast<int*>(scratch);
  int* n_live = live_tiles + (n_rows + kWalk - 1) / kWalk;
  int* block_live = n_live + 1;  // ceil(R / 32 / 2) entries, rounded up to an even tile count
  a.live_tiles = live_tiles;
  a.n_live = n_live;
  a.block_live = block_live;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  egom2p::ce_live_scan_kernel<kWalk, float><<<1, 1024, 0, st>>>(a.wc, n_rows, live_tiles, n_live, block_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_group(st, owned, walked, a, group_dim));
}
