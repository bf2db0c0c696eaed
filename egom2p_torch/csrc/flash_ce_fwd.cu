// Cross-entropy row statistics of a large-vocab head for Hopper (sm_90a):
// per row r of y (R, D) and head W (V, D), logz[r] = logsumexp_c (y_r . w_c)
// and gold[r] = y_r . w_{t_r}, without the (R, V) logits ever reaching device
// memory.  Called from egom2p_torch/ops/flash_ce.py (`row_stats`).
//
// Replaces the Pallas TPU kernel egom2p_tpu/ops/flash_ce.py `_ce_fwd_kernel`
// (reached through `_row_stats` -> `pl.pallas_call`), the forward of
// `flash_ce_total`.
//
// Math (as the TPU kernel): logits are fp32 sums of bf16 products; an online
// max over vocab tiles, sum = sum exp2((s - m) log2 e) rescaled by exp2((m_old
// - m_new) log2 e); logz = m + log2(sum) / log2 e.  Columns past V count
// nothing (the TPU kernel masks its padded columns to -1e30, which adds
// exp2(-huge) = 0); gold is the logit at the target column, 0 if none matches.
// Rows marked dead by the caller (`live`, the rows of weight 0) get logz =
// +inf and gold = 0, whether their block was computed or skipped.
//
// What bounds it on this card: arithmetic.  At the training step's shapes
// (R = 16384 rows, D = 768, V = 64000) one call is a 1.6 TFLOP GEMM with a
// reduction epilogue: 1.63 ms at 989 TFLOP/s, against 0.13 ms of bytes.  The
// exp2 pass (R x V = 1.05e9) is 0.25 ms on the SFUs and overlaps the products.
//
// What the design does about it:
//   * a block owns 128 rows of y and one slice of the vocab: two consumer
//     warpgroups of 64 rows each and one producer warp.  The product is a
//     plain GEMM main loop: every k-step of 64 columns the producer brings
//     y's 128 x 64 chunk and W's 256 x 64 chunk by TMA (128-byte swizzle)
//     into a ring of stages with a "full" and an "empty" mbarrier each; the
//     same code takes every D % 128 == 0 (y streams; no resident tile that
//     stops fitting above some D).  Each consumer warpgroup issues wgmma
//     m64n256k16 on its 64 rows of the y chunk and the whole W chunk, both
//     by descriptor, the logits tile (64 x 256 fp32) in registers.
//   * two k-steps go to the tensor cores per wait, and the two warpgroups
//     run out of phase: one's wait and epilogue (max, exp2, sum, gold on the
//     accumulator in registers) overlap the other's products.
//   * rows are split from the vocab: the grid holds (live row block, vocab
//     slice) pairs, slice-major, so that the blocks that run together share
//     W's tiles in L2.  The slice count S comes from the caller
//     (ops/flash_ce.py `fwd_splits`, a function of R, D, V and the SM count):
//     enough pairs to fill the card several times over, so that R = 1000 runs
//     on every SM and the last wave is short.  Each pair writes its rows'
//     partial (max, sum, gold) to a workspace; a combine kernel folds the S
//     slices of a row in slice order, so two runs give equal bits.
//   * a scan kernel (csrc/ce_scan.cuh, shared with the backward) lists the
//     128-row blocks that hold a live row; the grid walks only those, so
//     rows of weight 0 cost nothing when a whole block of them is dead.
// The kernel masks its own ragged edges (rows past R and W rows past V
// arrive as zeros from TMA; columns past V are set to -inf before the max),
// allocates nothing, and runs on the caller's stream.

#include "ce_scan.cuh"
#include "hopper.cuh"

namespace {

using namespace egom2p;

constexpr int kRows = 128;       // rows per block: 2 consumer warpgroups x 64
constexpr int kThreads = 384;    // 2 consumer warpgroups + the producer's
constexpr int kConsumerWarps = 8;
constexpr int kCols = 256;       // vocab columns per tile (ops/flash_ce.py FWD_COLS)
constexpr int kStages = 4;       // 4 x 48 KB
constexpr int kYBytes = kRows * 128;  // a y chunk: 128 rows x 64 columns
constexpr int kWBytes = kCols * 128;  // a W chunk: 256 vocab rows x 64 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kStart = -1e30f;  // running max before any column: below every logit

struct Smem {
  __nv_bfloat16 y[kStages][kRows * 64];   // tiles first: each a multiple of 1024 bytes
  __nv_bfloat16 w[kStages][kCols * 64];
  uint64_t full[kStages], empty[kStages];
};
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem)) + 1024;  // base rounded up to 1024

struct FwdArgs {
  const int* targets;
  const int* live_blocks;  // from the scan: the 128-row blocks that hold a live row, in order
  const int* n_live;       // ... and their count
  float *pm, *ps, *pg;     // (S, R) partial max, sum and gold per slice
  int n_rows, vocab, dim, splits, slice_tiles;
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_ce_fwd_kernel(const __grid_constant__ CUtensorMap map_y,
                        const __grid_constant__ CUtensorMap map_w, const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));

  // this block's (live row block, vocab slice) pair, slice-major
  const int n_live = *a.n_live;
  if (static_cast<int>(blockIdx.x) >= n_live * a.splits) return;
  const int slice = blockIdx.x / n_live;
  const int row0 = a.live_blocks[blockIdx.x % n_live] * kRows;
  const int n_tiles = (a.vocab + kCols - 1) / kCols;
  const int t0 = slice * a.slice_tiles, t1 = min(n_tiles, t0 + a.slice_tiles);
  const int n_k = a.dim / 64;  // even: D is a multiple of 128
  const int n_steps = (t1 - t0) * n_k;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);                // the producer (+ the TMA bytes)
      mbar_init(&sm.empty[i], kConsumerWarps);  // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid != 2 * 128) return;
    for (int g = 0; g < n_steps; ++g) {
      const int stage = g % kStages;
      if (g >= kStages) mbar_wait(&sm.empty[stage], (g / kStages - 1) & 1);
      const int col = (g % n_k) * 64, v0 = (t0 + g / n_k) * kCols;
      mbar_arrive_expect_tx(&sm.full[stage], kYBytes + kWBytes);
      tma_load_2d(sm.y[stage], &map_y, &sm.full[stage], col, row0);
      tma_load_2d(sm.w[stage], &map_w, &sm.full[stage], col, v0);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // accumulator row group / column pair
  const int r0 = row0 + wg * 64 + warp * 16 + gid;  // this thread's rows: r0 and r0 + 8
  int tgt[2];
  tgt[0] = r0 < a.n_rows ? a.targets[r0] : -1;
  tgt[1] = r0 + 8 < a.n_rows ? a.targets[r0 + 8] : -1;
  float run_m[2] = {kStart, kStart}, run_s[2] = {0.f, 0.f}, run_g[2] = {0.f, 0.f};

  float acc[kCols / 2];  // logits: 64 rows x kCols columns
  constexpr uint32_t kHi = (1024 >> 4) | (1u << 30);  // SBO 1024, 128-byte swizzle
  auto desc = [](uint32_t lo) { return (static_cast<uint64_t>(kHi) << 32) | lo; };
  // acc (+)= y chunk (this warpgroup's 64 rows, K-major) . W chunk^T (K-major)
  // over the 4 k-steps of stage s
  auto issue = [&](int s, bool first) {
    uint32_t ya = (smem_addr(sm.y[s]) >> 4) + wg * ((64 * 128) >> 4);
    uint32_t wa = smem_addr(sm.w[s]) >> 4;
    // the bases pass through an empty asm, or the compiler hoists every
    // stage's descriptors into registers
    asm volatile("" : "+r"(ya), "+r"(wa));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<0>(acc, desc(ya + 2 * kk), desc(wa + 2 * kk), !first || kk > 0);
    }
  };

  int g = 0;  // k-steps consumed so far
  for (int t = t0; t < t1; ++t) {
    for (int c = 0; c < n_k; c += 2, g += 2) {
      const int s0 = g % kStages, s1 = (g + 1) % kStages;
      mbar_wait(&sm.full[s0], (g / kStages) & 1);
      mbar_wait(&sm.full[s1], ((g + 1) / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
      issue(s0, c == 0);
      wgmma_commit();
      issue(s1, false);
      wgmma_commit();
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&sm.empty[s0]);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&sm.empty[s1]);
    }

    // The 64 x kCols logits tile is complete: fold it into this thread's
    // running max, sum and gold of its two rows.
    const int col0 = t * kCols;
    // gold first, while every logit is finite: a sum of each column's logit
    // times (column == target), so that no register is indexed at run time
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int want = tgt[i] - col0 - tig * 2;  // the target's place in this thread's columns
      if (want >= 0 && want < kCols - 6 && (want & 6) == 0) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          v = fmaf(acc[4 * j + 2 * i], want == 8 * j ? 1.f : 0.f, v);
          v = fmaf(acc[4 * j + 2 * i + 1], want == 8 * j + 1 ? 1.f : 0.f, v);
        }
        run_g[i] += v;
      }
    }
    if (col0 + kCols > a.vocab) {  // the last tile: columns past V count nothing
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col0 + j * 8 + tig * 2 + e >= a.vocab) {
            acc[4 * j + e] = acc[4 * j + 2 + e] = __uint_as_float(0xff800000u);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = run_m[i];
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]));
      }
      const float ml = mx * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        sum += exp2_approx(fmaf(acc[4 * j + 2 * i], kLog2e, -ml));
        sum += exp2_approx(fmaf(acc[4 * j + 2 * i + 1], kLog2e, -ml));
      }
      run_s[i] = run_s[i] * exp2_approx(fmaf(run_m[i], kLog2e, -ml)) + sum;
      run_m[i] = mx;
    }
  }

  // Combine the four threads of a quad (a row's columns are spread over
  // them), then one thread per row writes the slice's partials.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float m = run_m[i];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = run_s[i] * exp2_approx((run_m[i] - m) * kLog2e);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    float gs = run_g[i];
    gs += __shfl_xor_sync(0xffffffffu, gs, 1);
    gs += __shfl_xor_sync(0xffffffffu, gs, 2);
    const int row = r0 + i * 8;
    if (tig == 0 && row < a.n_rows) {
      const int64_t o = static_cast<int64_t>(slice) * a.n_rows + row;
      a.pm[o] = m;
      a.ps[o] = sum;
      a.pg[o] = gs;
    }
  }
}

// One thread per row: the S slices' partials folded in slice order, or +inf
// and 0 for a dead row.
__global__ void flash_ce_combine_kernel(const float* __restrict__ pm, const float* __restrict__ ps,
                                        const float* __restrict__ pg,
                                        const uint8_t* __restrict__ live, float* __restrict__ logz,
                                        float* __restrict__ gold, int n_rows, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  if (live != nullptr && live[r] == 0) {
    logz[r] = __uint_as_float(0x7f800000u);
    gold[r] = 0.f;
    return;
  }
  float m = kStart;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[static_cast<int64_t>(s) * n_rows + r]);
  float sum = 0.f, g = 0.f;
  for (int s = 0; s < splits; ++s) {
    const int64_t o = static_cast<int64_t>(s) * n_rows + r;
    sum += ps[o] * exp2f((pm[o] - m) * kLog2e);
    g += pg[o];
  }
  logz[r] = m + log2f(sum) / kLog2e;
  gold[r] = g;
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

}  // namespace

// C entry point, bound with ctypes.  y (R, D) and w (V, D) are bf16 rows with
// unit stride inside a row, 16-byte aligned bases and row strides y_s, w_s
// (elements, multiples of 8); D is a multiple of 128.  targets (R,) int32;
// live (R,) bytes, nonzero for a row that counts, or null for every row.
// logz and gold (R,) fp32 outputs.  splits: the vocab slices S, each of
// ceil(ceil(V / 256) / S) tiles of 256 columns, none empty.  partial: 3 * S * R fp32, scratch: ceil(R / 128) + 1 int32, both
// written here.  Launches the scan, the product and the combine on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int egom2p_flash_ce_fwd(const void* y, const void* w, const void* targets,
                                   const void* live, void* logz, void* gold, void* partial,
                                   void* scratch, int n_rows, int vocab, int dim, int splits,
                                   long long y_s, long long w_s, void* stream) {
  const int n_tiles = (vocab + kCols - 1) / kCols;
  const int slice_tiles = splits > 0 ? (n_tiles + splits - 1) / splits : 0;
  if (n_rows <= 0 || vocab <= 0 || dim <= 0 || dim % 128 != 0 || splits <= 0 ||
      (splits - 1) * slice_tiles >= n_tiles || partial == nullptr || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_y, map_w;
  int rc = matrix_map(&map_y, y, n_rows, dim, y_s, kRows);
  if (rc == 0) rc = matrix_map(&map_w, w, vocab, dim, w_s, kCols);
  if (rc != 0) return rc;
  const int row_blocks = (n_rows + kRows - 1) / kRows;
  int* live_blocks = static_cast<int*>(scratch);
  FwdArgs a;
  a.targets = static_cast<const int*>(targets);
  a.live_blocks = live_blocks;
  a.n_live = live_blocks + row_blocks;
  float* pm = static_cast<float*>(partial);
  a.pm = pm;
  a.ps = pm + static_cast<int64_t>(splits) * n_rows;
  a.pg = pm + 2 * static_cast<int64_t>(splits) * n_rows;
  a.n_rows = n_rows;
  a.vocab = vocab;
  a.dim = dim;
  a.splits = splits;
  a.slice_tiles = slice_tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mark = static_cast<const uint8_t*>(live);
  egom2p::ce_live_scan_kernel<kRows, uint8_t><<<1, 1024, 0, st>>>(mark, n_rows, live_blocks,
                                                           live_blocks + row_blocks, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_ce_fwd_kernel<<<row_blocks * splits, kThreads, kSmemBytes, st>>>(map_y, map_w, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_ce_combine_kernel<<<(n_rows + 255) / 256, 256, 0, st>>>(a.pm, a.ps, a.pg, mark,
                                                                static_cast<float*>(logz),
                                                                static_cast<float*>(gold), n_rows,
                                                                splits);
  return static_cast<int>(cudaGetLastError());
}
