// Cross-entropy row statistics of a large-vocab head for Hopper (sm_90a):
// per row r of y (R, D) and head W (V, D), logz[r] = logsumexp_c (y_r . w_c)
// and gold[r] = y_r . w_{t_r}, without the (R, V) logits ever reaching device
// memory.  Called from egom2p_torch/ops/flash_ce.py.
//
// Replaces the Pallas TPU kernel egom2p_tpu/ops/flash_ce.py `_ce_fwd_kernel`
// (reached through `_row_stats` -> `pl.pallas_call`), the forward of
// `flash_ce_total`.
//
// Math (as the TPU kernel): logits are fp32 sums of bf16 products; an online
// max over vocab tiles, alpha = exp2((m_old - m_new) log2 e), sum += exp2((s -
// m_new) log2 e); logz = m + log2(sum) / log2 e.  Columns past V are skipped
// (the TPU kernel masks its padded columns to -1e30, which adds exp2(-huge) =
// 0); gold is the logit at the target column, 0 if none matches.
//
// What bounds it on this card: arithmetic.  At the training step's shapes
// (R = 16384 rows, D = 768, V = 64000) one call is a 1.6 TFLOP GEMM with a
// reduction epilogue, and W (98 MB) is read once per row block.
//
// What the design does about it: each block owns 128 rows (eight warps of
// 16) and, up to D = 768, keeps that y tile resident in shared memory (194 KB
// at D = 768), so y is read from device memory once.  The block walks W in
// tiles of 64 vocab rows; each tile's D-deep product streams W through shared
// memory in double-buffered cp.async chunks of 64 x 64.  Above D = 768 the y
// tile does not fit (D = 1024: 258 KB): the streamed instance (kStreamY)
// loads y's 128 x 64 chunk beside W's in every step instead, so y is re-read
// from L2 once per vocab tile; the arithmetic is the same.  Products are
// mma.sync m16n8k16 (bf16 in, fp32 accumulate); a 16 x 64 logits tile lives
// only in each warp's registers, where the epilogue folds it into per-thread
// running max / sum / gold, which a quad shuffle combines at the end.
// 128-row blocks give 128 blocks for R = 16384: one wave on 132 SMs.
// Splitting the vocab across blocks (more blocks, then a combine pass),
// ldmatrix operand loads, wgmma and TMA are later work.

#include "common.cuh"

namespace {

using namespace egom2p;

constexpr int kRows = 128;                   // rows per block: 8 warps x 16
constexpr int kCols = 64;                    // vocab rows (logit columns) per tile
constexpr int kChunk = 64;                   // depth of one streamed W chunk
constexpr int kThreads = 256;
constexpr int kMaxDim = 768;                 // resident y tile of 128 x (768 + 8) bf16 = 194 KB
constexpr int kWLd = kChunk + 8;             // padded smem row: 144 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg = -1e30f;

// kStreamY: y's 128 x 64 chunk of each step streams beside W's (D > kMaxDim)
template <bool kStreamY>
__global__ void __launch_bounds__(kThreads, 1)
    flash_ce_fwd_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ w,
                        const int* __restrict__ targets, float* __restrict__ logz,
                        float* __restrict__ gold, int n_rows, int vocab, int dim, int64_t y_s,
                        int64_t w_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // padded y row: (dim + 8) * 2 bytes resident, or two stages of 128 x 72
  const int y_ld = kStreamY ? kWLd : dim + 8;
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16(*sW)[kCols][kWLd] = reinterpret_cast<__nv_bfloat16(*)[kCols][kWLd]>(
      sY + (kStreamY ? 2 : 1) * kRows * y_ld);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_base = blockIdx.x * kRows;

  if constexpr (!kStreamY) {
    // y tile: kRows x dim, dim / 8 chunks of 16 bytes per row; rows past R zero
    const int y_chunks = kRows * (dim / 8);
    for (int c = tid; c < y_chunks; c += kThreads) {
      const int r = c / (dim / 8), col = (c % (dim / 8)) * 8;
      const bool ok = row_base + r < n_rows;
      cp_async16(sY + r * y_ld + col, y + (ok ? row_base + r : 0) * y_s + col, ok);
    }
  }
  const int n_k = dim / kChunk;
  const int n_tiles = (vocab + kCols - 1) / kCols;
  const int n_steps = n_tiles * n_k;
  auto load_w = [&](int step, int stage) {  // vocab rows of tile step / n_k, depth chunk step % n_k
    const int v0 = (step / n_k) * kCols, k0 = (step % n_k) * kChunk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, col = (c & 7) * 8;
      const bool ok = v0 + r < vocab;
      cp_async16(&sW[stage][r][col], w + (ok ? v0 + r : 0) * w_s + k0 + col, ok);
    }
    if constexpr (kStreamY) {  // y's rows of the block, depth chunk k0; rows past R zero
#pragma unroll
      for (int i = 0; i < kRows * kChunk / 8 / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c >> 3, col = (c & 7) * 8;
        const bool ok = row_base + r < n_rows;
        cp_async16(sY + (stage * kRows + r) * kWLd + col,
                   y + (ok ? row_base + r : 0) * y_s + k0 + col, ok);
      }
    }
  };
  load_w(0, 0);
  cp_async_commit();

  const int r0 = row_base + warp * 16 + gid;  // this thread's rows r0, r0 + 8
  int tgt[2];
  tgt[0] = r0 < n_rows ? targets[r0] : -1;
  tgt[1] = r0 + 8 < n_rows ? targets[r0 + 8] : -1;
  float run_m[2] = {kNeg, kNeg}, run_s[2] = {0.f, 0.f}, run_g[2] = {0.f, 0.f};
  const __nv_bfloat16* yrow0 = sY + (warp * 16 + gid) * y_ld + tig * 2;
  const __nv_bfloat16* yrow8 = yrow0 + 8 * y_ld;

  float s[8][4];
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1, kc = step % n_k;
    if (step + 1 < n_steps) {
      load_w(step + 1, stage ^ 1);
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      // resident: column kc * 64 + kk * 16 of the tile; streamed: of the stage's chunk
      const int col = kStreamY ? stage * kRows * kWLd + kk * 16 : kc * kChunk + kk * 16;
      load_a_frag(a, yrow0 + col, yrow8 + col);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* wrow = sW[stage][j * 8 + gid] + kk * 16 + tig * 2;
        mma_16816(s[j], a, ld_smem_u32(wrow), ld_smem_u32(wrow + 8));
      }
    }

    if (kc == n_k - 1) {  // the 16 x 64 logits tile is complete: fold it in
      const int v0 = (step / n_k) * kCols;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNeg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = v0 + j * 8 + tig * 2 + e;
            if (c < vocab) mx = fmaxf(mx, s[j][2 * i + e]);
            if (c == tgt[i]) run_g[i] += s[j][2 * i + e];
          }
        }
        const float m_new = fmaxf(run_m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = v0 + j * 8 + tig * 2 + e;
            if (c < vocab) sum += exp2_approx((s[j][2 * i + e] - m_new) * kLog2e);
          }
        }
        run_s[i] = run_s[i] * exp2_approx((run_m[i] - m_new) * kLog2e) + sum;
        run_m[i] = m_new;
      }
    }
    __syncthreads();  // every warp is done with `stage` before it is refilled
  }

  // Combine the four threads of a quad (the 64 columns of a tile are spread
  // over them), then one thread per row writes.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m = run_m[i];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = run_s[i] * exp2_approx((run_m[i] - m) * kLog2e);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float g = run_g[i];
    g += __shfl_xor_sync(0xffffffffu, g, 1);
    g += __shfl_xor_sync(0xffffffffu, g, 2);
    const int row = r0 + i * 8;
    if (tig == 0 && row < n_rows) {
      logz[row] = m + log2f(sum) / kLog2e;
      gold[row] = g;
    }
  }
}

template <bool kStreamY>
cudaError_t launch(const void* y, const void* w, const void* targets, void* logz, void* gold,
                   int n_rows, int vocab, int dim, long long y_s, long long w_s,
                   cudaStream_t st) {
  const size_t y_elems = kStreamY ? 2 * kRows * kWLd : static_cast<size_t>(kRows) * (dim + 8);
  const size_t smem = sizeof(__nv_bfloat16) * (y_elems + 2 * kCols * kWLd);
  cudaError_t err = cudaFuncSetAttribute(flash_ce_fwd_kernel<kStreamY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + kRows - 1) / kRows);
  flash_ce_fwd_kernel<kStreamY><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(targets), static_cast<float*>(logz), static_cast<float*>(gold),
      n_rows, vocab, dim, y_s, w_s);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  y (R, D) and w (V, D) are bf16 rows with
// unit stride inside a row and row strides y_s, w_s (elements); D is a
// multiple of 64 (resident y up to 768, streamed above; the launcher asks for
// multiples of 128, as the JAX kernel does).  targets (R,) int32; logz and
// gold (R,) fp32 outputs.  Returns the CUDA error of the launch (0 on success).
extern "C" int egom2p_flash_ce_fwd(const void* y, const void* w, const void* targets, void* logz,
                                   void* gold, int n_rows, int vocab, int dim, long long y_s,
                                   long long w_s, void* stream) {
  if (n_rows <= 0 || vocab <= 0 || dim <= 0 || dim % kChunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dim > kMaxDim ? launch<true>(y, w, targets, logz, gold, n_rows, vocab, dim, y_s, w_s, st)
                    : launch<false>(y, w, targets, logz, gold, n_rows, vocab, dim, y_s, w_s, st);
  return static_cast<int>(err);
}
