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
// What bounds it on this card: arithmetic and the size of the accumulators.
// At the training step's shapes (R = 16384, D = 768, V = 64000) the three
// products (logits, dy, dW) are 1.6 TFLOP each.  The TPU kernel keeps a
// (bv, 768) fp32 dW block resident in VMEM and spills a (br, 768) dy block;
// on an SM (227 KB of shared memory, 64K registers) a 64 x 768 fp32
// accumulator alone is 192 KB, beside the operand tiles.
//
// What the design does about it: two instances of one kernel, each owning
// its output, so that nothing needs atomics and the result is
// deterministic (the public cut-cross-entropy backward instead adds both
// products with fp32 atomics from each (row, vocab) tile, which at D = 768
// and these tiles would mean tens of GB of atomic traffic).  A block owns 64
// rows of one operand (4 warps of 16) and a slice of 256 output columns: the
// dy instance owns rows of y and walks the vocab, the dW instance owns vocab
// rows of W and walks the rows of y.  The owned 64 x D tile stays resident
// in shared memory (99 KB at D = 768); the walked operand streams through
// double-buffered cp.async chunks of 64 x 64 for the logits tile (16 x 64 per
// warp, fp32 in registers), whose dl goes straight into the A fragments of
// dl . Z_slice, where Z_slice (64 walked rows x 256 columns) is loaded once
// per walked tile and read with ldmatrix.trans.  Each warp's 16 x 256 fp32
// accumulator is 128 registers per thread.  The price is recompute: each
// of the D / 256 column slices recomputes the logits (3 times at D = 768),
// so the two instances do 2 * (3 + 1) logits-sized products instead of 3.
// Rows of weight 0 cost nothing: a dy block whose 64 rows all weigh 0
// returns at once, and the dW instance walks only the 64-row tiles of y that
// hold a row of nonzero weight (in training about half of the rows of each
// 64k head belong to another modality).  Products are mma.sync m16n8k16
// (bf16 in, fp32 accumulate).  Shared memory is 156 KB (one block per SM).
// wgmma, TMA, more warps per SM and a cheaper split of D are later work.

#include "common.cuh"

namespace {

using namespace egom2p;

constexpr int kOwn = 64;          // owned rows per block: 4 warps x 16
constexpr int kWalk = 64;         // walked rows per tile (the logits tile's columns)
constexpr int kChunk = 64;        // depth of one streamed chunk
constexpr int kSlice = 256;       // output columns per block
constexpr int kThreads = 128;
constexpr int kMaxDim = 768;
constexpr int kMaxTiles = 2048;   // walked 64-row tiles of y in the dW instance: R <= 131072
constexpr int kZLd = kChunk + 8;  // padded smem rows: conflict-free fragments and ldmatrix
constexpr int kSLd = kSlice + 8;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16 *y, *w;
  const int* targets;
  const float *wc, *logz;  // (R,) fp32: row weight times the upstream gradient; logsumexp
  float *dy, *dw;          // zeroed (R, D) and (V, D) fp32 outputs
  int n_rows, vocab, dim;
  int64_t y_s, w_s;
};

struct Smem {
  __nv_bfloat16 x[kOwn * (kMaxDim + 8)];   // the owned tile, rows of dim + 8
  __nv_bfloat16 z[2][kWalk][kZLd];         // streamed chunks of the walked tile
  __nv_bfloat16 s[kWalk][kSLd];            // the walked tile's output-column slice
  float lz[2][kWalk], cw[2][kWalk];        // dW instance: the walked rows' logz, weight
  int tg[2][kWalk];                        // ... and target
  int16_t live[kMaxTiles];                 // dW instance: walked tiles of nonzero weight
  uint8_t flag[kMaxTiles];
  int count;
};

template <bool kDw>
__global__ void __launch_bounds__(kThreads, 1) flash_ce_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row
  const int own0 = blockIdx.x * kOwn;
  const int col0 = blockIdx.y * kSlice;        // this block's output columns
  const int x_ld = a.dim + 8;
  // the owned operand X and the walked operand Z
  const __nv_bfloat16* X = kDw ? a.w : a.y;
  const __nv_bfloat16* Z = kDw ? a.y : a.w;
  const int64_t x_s = kDw ? a.w_s : a.y_s, z_s = kDw ? a.y_s : a.w_s;
  const int n_own = kDw ? a.vocab : a.n_rows, n_walk = kDw ? a.n_rows : a.vocab;
  const int n_k = a.dim / kChunk;

  // This thread's owned rows r0, r0 + 8 (dy instance: their logz, weight,
  // target; a block whose rows all weigh 0 leaves its zeroed dy as it is).
  const int r0 = own0 + warp * 16 + gid;
  float own_lz[2] = {0.f, 0.f}, own_wc[2] = {0.f, 0.f};
  int own_t[2] = {-1, -1};
  int n_tiles;
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
    if (!__syncthreads_or(own_wc[0] != 0.f || own_wc[1] != 0.f)) return;
    n_tiles = (n_walk + kWalk - 1) / kWalk;
  } else {
    // the walked tiles that hold a row of nonzero weight, in order
    const int all = (n_walk + kWalk - 1) / kWalk;
    for (int tt = tid; tt < all; tt += kThreads) {
      const int lim = min(kWalk, n_walk - tt * kWalk);
      bool live = false;
      for (int i = 0; i < lim && !live; ++i) live = a.wc[tt * kWalk + i] != 0.f;
      sm.flag[tt] = live;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int tt = 0; tt < all; ++tt) {
        if (sm.flag[tt]) sm.live[n++] = static_cast<int16_t>(tt);
      }
      sm.count = n;
    }
    __syncthreads();
    n_tiles = sm.count;
    if (n_tiles == 0) return;
  }
  auto tile_row0 = [&](int ti) { return (kDw ? static_cast<int>(sm.live[ti]) : ti) * kWalk; };

  // the owned tile: kOwn x dim, rows past n_own zero-filled
  const int row_chunks = a.dim / 8;
  for (int c = tid; c < kOwn * row_chunks; c += kThreads) {
    const int r = c / row_chunks, col = (c % row_chunks) * 8;
    const bool ok = own0 + r < n_own;
    cp_async16(sm.x + r * x_ld + col, X + static_cast<int64_t>(ok ? own0 + r : 0) * x_s + col, ok);
  }
  const int n_steps = n_tiles * n_k;
  auto load_z = [&](int step, int stage) {  // walked tile step / n_k, depth chunk step % n_k
    const int ti = step / n_k, kc = step % n_k;
    const int z0 = tile_row0(ti), k0 = kc * kChunk;
#pragma unroll
    for (int i = 0; i < kWalk * kChunk / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      const bool ok = z0 + r < n_walk;
      cp_async16(&sm.z[stage][r][col], Z + static_cast<int64_t>(ok ? z0 + r : 0) * z_s + k0 + col,
                 ok);
    }
    if (kDw && kc == 0 && tid < kWalk) {  // read by tile ti's epilogue, after a barrier
      const int row = z0 + tid, b = ti & 1;
      const bool ok = row < n_walk;
      sm.lz[b][tid] = ok ? a.logz[row] : 0.f;
      sm.cw[b][tid] = ok ? a.wc[row] : 0.f;
      sm.tg[b][tid] = ok ? a.targets[row] : -1;
    }
  };
  load_z(0, 0);
  cp_async_commit();

  const __nv_bfloat16* xrow0 = sm.x + (warp * 16 + gid) * x_ld + tig * 2;
  const __nv_bfloat16* xrow8 = xrow0 + 8 * x_ld;
  float acc[kSlice / 8][4];  // this warp's 16 owned rows x 256 output columns
#pragma unroll
  for (int j = 0; j < kSlice / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float s[8][4];

  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1, kc = step % n_k;
    if (step + 1 < n_steps) {
      load_z(step + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    // logits (16 owned x 64 walked) += X_chunk . Z_chunk^T
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t af[4];
      const int col = kc * kChunk + kk * 16;
      load_a_frag(af, xrow0 + col, xrow8 + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* zrow = sm.z[stage][j * 8 + gid] + kk * 16 + tig * 2;
        mma_16816(s[j], af, ld_smem_u32(zrow), ld_smem_u32(zrow + 8));
      }
    }

    if (kc == n_k - 1) {  // the logits tile is complete
      const int ti = step / n_k, z0 = tile_row0(ti), b = ti & 1;
      // the walked rows' output-column slice, for the product below
#pragma unroll
      for (int i = 0; i < kWalk * kSlice / 8 / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (kSlice / 8), col = (c % (kSlice / 8)) * 8;
        const bool ok = z0 + r < n_walk;
        cp_async16(&sm.s[r][col], Z + static_cast<int64_t>(ok ? z0 + r : 0) * z_s + col0 + col,
                   ok);
      }
      cp_async_commit();
      // dl = (p - onehot) * weight, in place of the logits
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = j * 8 + tig * 2 + (e & 1);
          float lz, wt;
          bool gold;
          if (kDw) {  // owned vocab row r0 + 8i, walked row z0 + c
            lz = sm.lz[b][c];
            wt = sm.cw[b][c];
            gold = sm.tg[b][c] == r0 + i * 8;
          } else {    // owned row r0 + 8i, walked vocab column z0 + c
            lz = own_lz[i];
            wt = own_wc[i];
            gold = z0 + c == own_t[i];
          }
          float p = exp2_approx((s[j][e] - lz) * kLog2e);
          if (!kDw && z0 + c >= a.vocab) p = 0.f;  // padded vocab column
          s[j][e] = (p - (gold ? 1.f : 0.f)) * wt;
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      // acc (16 owned x 256) += bf16(dl) (16 x 64 walked) . Z_slice (64 x 256)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        acc_to_a_frag(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int jd = 0; jd < kSlice / 16; ++jd) {
          uint32_t bm[4];
          ldmatrix_x4_trans(bm, &sm.s[kk * 16 + (mat & 1) * 8 + mrow][jd * 16 + (mat >> 1) * 8]);
          mma_16816(acc[2 * jd], af, bm[0], bm[1]);
          mma_16816(acc[2 * jd + 1], af, bm[2], bm[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with `stage` (and the slice) before it is refilled
  }

  float* out = kDw ? a.dw : a.dy;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= n_own) continue;
    float* o = out + static_cast<int64_t>(row) * a.dim + col0;
#pragma unroll
    for (int j = 0; j < kSlice / 8; ++j) {
      *reinterpret_cast<float2*>(o + j * 8 + tig * 2) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

template <bool kDw>
cudaError_t launch(dim3 grid, cudaStream_t st, const Args& a) {
  constexpr int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(flash_ce_bwd_kernel<kDw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_ce_bwd_kernel<kDw><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  y (R, D) and w (V, D) are bf16 rows with
// unit stride inside a row and row strides y_s, w_s (elements); D is a
// multiple of 256 and at most 768; R is at most 131072.  targets (R,) int32,
// wc and logz (R,) fp32.  dy (R, D) and dw (V, D) are contiguous fp32 outputs
// that the caller has zeroed.  Launches the dy instance, then the dW
// instance, on `stream`; returns the first CUDA error (0 on success).
extern "C" int egom2p_flash_ce_bwd(const void* y, const void* w, const void* targets,
                                   const void* wc, const void* logz, void* dy, void* dw,
                                   int n_rows, int vocab, int dim, long long y_s, long long w_s,
                                   void* stream) {
  if (n_rows <= 0 || vocab <= 0 || dim <= 0 || dim % kSlice != 0 || dim > kMaxDim ||
      (n_rows + kWalk - 1) / kWalk > kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.targets = static_cast<const int*>(targets);
  a.wc = static_cast<const float*>(wc);
  a.logz = static_cast<const float*>(logz);
  a.dy = static_cast<float*>(dy);
  a.dw = static_cast<float*>(dw);
  a.n_rows = n_rows;
  a.vocab = vocab;
  a.dim = dim;
  a.y_s = y_s;
  a.w_s = w_s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch<false>(dim3((n_rows + kOwn - 1) / kOwn, dim / kSlice), st, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch<true>(dim3((vocab + kOwn - 1) / kOwn, dim / kSlice), st, a));
}
