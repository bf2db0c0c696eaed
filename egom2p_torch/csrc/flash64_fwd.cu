// Forward attention at head_dim 64 for Hopper (sm_90a), non-causal, for
// inference and for training.  Called from egom2p_torch/ops/flash64.py
// (inference) and egom2p_torch/ops/flash64_train.py (training forward).
//
// Replaces three Pallas TPU kernels, all one template here:
//   * egom2p_tpu/ops/flash64.py `_kernel_noshift` (clamp-only softmax, the
//     default) and `_kernel` (running-max "safemax" softmax), both reached
//     through `flash64_attention` -> `pl.pallas_call`: SAFEMAX selects;
//   * egom2p_tpu/ops/flash64_train.py `_fwd_kernel`, the training forward:
//     the same math plus the per-row L2 output (L2 = true) and the segment
//     mask mode (SEG = true).
//
// Math (identical to the TPU kernels):
//   s = fp32(q . k) * (64^-0.5 * log2 e) + bias,   bias = -1e30 where blocked
//   clamp:   p = exp2(min(s, 80)),   l = sum p,   o = sum bf16(p) v / l,
//            a row with l == 0 (every key blocked) writes exact zeros;
//   safemax: online softmax in the exp2 domain with running max m; a row whose
//            m never rose above -5e29 (every key blocked) writes exact zeros.
//   l is summed from the fp32 p before p is rounded to bf16 for P.V; p stays
//   bf16 (never fp16: in clamp mode p reaches 2^80).
//   L2 (training): log2 l (clamp) or m + log2 l (safemax), +1e30 for a dead
//   row, so that the backward's p = exp2(s - L2) is 0 there.
// Masks: a key is blocked when it lies past M, when kv_blocked marks it (key
// padding), or, in segment mode, when its segment id differs from the
// query's.  Keys past M are blocked by the bounds check, never through a
// segment value.
//
// What bounds it on this card: arithmetic.  At the inference path's shapes
// (N = M = 5120..8704, B*H = 96) and the training step's (N = M = 2048,
// B*H = 96) a (batch, head) pair's K and V are 0.5-2.2 MB, and the q tiles of
// one pair run side by side (blockIdx.x is the fastest grid index), so K/V are
// read from device memory about once and re-read from L2: the work is
// 4*N*M*64 tensor-core FLOPs plus N*M exp2 on the SFU.
//
// What the design does about it: each block owns 64 query rows of one
// (batch, head), four warps of 16 rows.  The block walks the keys in tiles of
// 64 held in shared memory, double-buffered with cp.async so the next tile
// loads while this one computes.  S = Q K^T and O += P V run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the S accumulator
// fragment is re-packed in registers as the A operand of P V, so P never
// touches shared memory.  V's B operand comes from ldmatrix.trans.  Static
// shared memory is 46.5 KB (47 KB with segments, under the 48 KB static
// limit).  This is the simple first kernel: wgmma, TMA and warp
// specialisation are later work.
//
// The kernel masks its own ragged edges (rows past N, keys past M are
// zero-filled and keys past M carry the -1e30 bias), reads q/k/v through a
// row stride each (they may be views of a fused qkv or kv projection),
// allocates nothing, and runs on the caller's stream.

#include "common.cuh"

namespace {

using namespace egom2p;

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;                  // query rows per block: 4 warps x 16
constexpr int kBlockK = 64;                  // keys per shared-memory tile
constexpr int kLd = kHeadDim + 8;            // padded smem row: 144 bytes, conflict-free fragments
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kDeadRow = -5e29f;           // kNegInf * 0.5: safemax dead-row threshold
constexpr float kDeadL2 = 1e30f;             // L2 of a row with no live key
constexpr float kClamp = 80.f;

// SAFEMAX: running-max softmax.  SEG: block where segments[q] != segments[k]
// (self-attention; `mask` is then the (B, N) int32 segment ids).  L2: write
// the per-row log-sum for the training backward.
template <bool kSafemax, bool kSeg, bool kL2>
__global__ void __launch_bounds__(kThreads)
    flash64_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_blocked,
                       const int* __restrict__ segments, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ l2, int n_q, int n_kv, int64_t q_sb, int64_t q_sn,
                       int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn, int64_t m_sb,
                       int64_t o_sb, int64_t o_sn, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kLd];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlockK][kLd];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlockK][kLd];
  __shared__ float sBias[2][kBlockK];
  __shared__ int sSeg[kSeg ? 2 : 1][kSeg ? kBlockK : 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row group / column pair
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y, batch = blockIdx.z;

  const __nv_bfloat16* qb = q + batch * q_sb + head * kHeadDim;
  const __nv_bfloat16* kb = k + batch * k_sb + head * kHeadDim;
  const __nv_bfloat16* vb = v + batch * v_sb + head * kHeadDim;
  const uint8_t* mb = kv_blocked == nullptr ? nullptr : kv_blocked + batch * m_sb;
  const int* sb = kSeg ? segments + batch * m_sb : nullptr;

  // A 64 x 64 bf16 tile is 512 chunks of 16 bytes: 4 per thread.  Rows at or
  // past `rows` are zero-filled (their address is clamped to row 0).
  auto load_tile = [&](__nv_bfloat16(*dst)[kLd], const __nv_bfloat16* src, int64_t stride,
                       int row0, int rows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk >> 3, col = (chunk & 7) * 8;
      const bool ok = row0 + r < rows;
      cp_async16(&dst[r][col], src + (ok ? row0 + r : 0) * stride + col, ok);
    }
  };
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBlockK;
    load_tile(sK[stage], kb, k_sn, k0, n_kv);
    load_tile(sV[stage], vb, v_sn, k0, n_kv);
    if (tid < kBlockK) {
      const int key = k0 + tid;
      const bool blocked = key >= n_kv || (mb != nullptr && mb[key] != 0);
      sBias[stage][tid] = blocked ? kNegInf : 0.f;
      if (kSeg) sSeg[stage][tid] = key < n_kv ? sb[key] : 0;
    }
  };

  load_tile(sQ, qb, q_sn, q0, n_q);
  load_kv(0, 0);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + gid;  // this thread's rows: r0 and r0 + 8
  int seg_q[2] = {0, 0};
  if (kSeg) {
    seg_q[0] = r0 < n_q ? sb[r0] : 0;
    seg_q[1] = r0 + 8 < n_q ? sb[r0 + 8] : 0;
  }

  const int n_tiles = (n_kv + kBlockK - 1) / kBlockK;
  float acc[8][4];  // O: 16 rows x 64 dims per warp, 8 n-tiles of 8 dims
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float row_l[2] = {0.f, 0.f};           // rows gid, gid + 8: this thread's partial sums
  float row_m[2] = {kNegInf, kNegInf};   // safemax running max (quad-uniform)
  uint32_t qf[4][4];                     // Q A-fragments for the 4 k-steps over head_dim

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (t == 0) {
      const int r = warp * 16 + gid;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        load_a_frag(qf[kk], &sQ[r][kk * 16 + tig * 2], &sQ[r + 8][kk * 16 + tig * 2]);
      }
    }

    // S = Q K^T: 16 x 64 per warp, fragment s[j] covers keys j*8 .. j*8+7.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sK[stage][j * 8 + gid];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_16816(s[j], qf[kk], ld_smem_u32(krow + kk * 16 + tig * 2),
                  ld_smem_u32(krow + kk * 16 + 8 + tig * 2));
      }
    }
    // scale, then the mask bias (the TPU kernel's order)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + tig * 2;
      float b00 = sBias[stage][c], b01 = sBias[stage][c + 1];  // row gid
      float b10 = b00, b11 = b01;                              // row gid + 8
      if (kSeg) {
        const int k0s = sSeg[stage][c], k1s = sSeg[stage][c + 1];
        if (seg_q[0] != k0s) b00 = kNegInf;
        if (seg_q[0] != k1s) b01 = kNegInf;
        if (seg_q[1] != k0s) b10 = kNegInf;
        if (seg_q[1] != k1s) b11 = kNegInf;
      }
      s[j][0] = s[j][0] * scale + b00;
      s[j][1] = s[j][1] * scale + b01;
      s[j][2] = s[j][2] * scale + b10;
      s[j][3] = s[j][3] * scale + b11;
    }

    if (kSafemax) {
      float mx0 = row_m[0], mx1 = row_m[1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // alpha = 0 once a live key lifts m above the -1e30 of a blocked prefix,
      // which washes out that prefix's exp2(0) = 1 garbage
      const float alpha0 = exp2_approx(row_m[0] - mx0);
      const float alpha1 = exp2_approx(row_m[1] - mx1);
      row_m[0] = mx0;
      row_m[1] = mx1;
      row_l[0] *= alpha0;
      row_l[1] *= alpha1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
        s[j][0] = exp2_approx(s[j][0] - mx0);
        s[j][1] = exp2_approx(s[j][1] - mx0);
        s[j][2] = exp2_approx(s[j][2] - mx1);
        s[j][3] = exp2_approx(s[j][3] - mx1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2_approx(fminf(s[j][0], kClamp));
        s[j][1] = exp2_approx(fminf(s[j][1], kClamp));
        s[j][2] = exp2_approx(fminf(s[j][2], kClamp));
        s[j][3] = exp2_approx(fminf(s[j][3], kClamp));
      }
    }
    // l from the fp32 p, before the bf16 rounding
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row_l[0] += s[j][0] + s[j][1];
      row_l[1] += s[j][2] + s[j][3];
    }

    // O += P V.  The S fragments of keys 16kk..16kk+15 (s[2kk], s[2kk+1]) are
    // exactly the A fragment of k-step kk.
    const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < 4; ++jd) {
        // matrices: (keys +0, dims +0), (keys +8, dims +0), (keys +0, dims +8), (keys +8, dims +8)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &sV[stage][kk * 16 + (mat & 1) * 8 + mrow][jd * 16 + (mat >> 1) * 8]);
        mma_16816(acc[2 * jd], a, bv[0], bv[1]);
        mma_16816(acc[2 * jd + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with `stage` before it is refilled
  }

  // Row sums across the quad that shares a row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 1);
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 2);
  }
  bool live[2];
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    live[i] = kSafemax ? row_m[i] > kDeadRow : row_l[i] > 0.f;
    denom[i] = row_l[i] > 0.f ? row_l[i] : 1.f;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= n_q) continue;
    __nv_bfloat16* orow = out + batch * o_sb + row * o_sn + head * kHeadDim;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = live[i] ? acc[j][2 * i] / denom[i] : 0.f;
      const float x1 = live[i] ? acc[j][2 * i + 1] / denom[i] : 0.f;
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tig * 2) = pack_bf16(x0, x1);
    }
    if (kL2 && tig == 0) {
      const float lse = (kSafemax ? row_m[i] : 0.f) + log2f(denom[i]);
      l2[(static_cast<int64_t>(batch) * gridDim.y + head) * n_q + row] = live[i] ? lse : kDeadL2;
    }
  }
}

template <bool kSeg, bool kL2>
void launch_fwd(bool safemax, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                const __nv_bfloat16* k, const __nv_bfloat16* v, const uint8_t* kv_blocked,
                const int* segments, __nv_bfloat16* out, float* l2, int n_q, int n_kv,
                int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb,
                int64_t v_sn, int64_t m_sb, int64_t o_sb, int64_t o_sn) {
  const float scale = static_cast<float>(0.125 * 1.4426950408889634);  // 64^-0.5 * log2(e)
  if (safemax) {
    flash64_fwd_kernel<true, kSeg, kL2><<<grid, kThreads, 0, st>>>(
        q, k, v, kv_blocked, segments, out, l2, n_q, n_kv, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
        m_sb, o_sb, o_sn, scale);
  } else {
    flash64_fwd_kernel<false, kSeg, kL2><<<grid, kThreads, 0, st>>>(
        q, k, v, kv_blocked, segments, out, l2, n_q, n_kv, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn,
        m_sb, o_sb, o_sn, scale);
  }
}

bool bad_shape(int batch, int n_q, int n_kv, int heads) {
  return batch <= 0 || n_q <= 0 || n_kv <= 0 || heads <= 0 || batch > 65535 || heads > 65535;
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements; q/k/v/out rows
// are 64*H wide with unit stride inside a row.  Both return the CUDA error of
// the launch (0 on success).

// Inference.  kv_blocked is (B, M) bytes (nonzero = blocked) with batch
// stride m_sb, or null.
extern "C" int egom2p_flash64_fwd(const void* q, const void* k, const void* v,
                                  const void* kv_blocked, void* out, int batch, int n_q, int n_kv,
                                  int heads, long long q_sb, long long q_sn, long long k_sb,
                                  long long k_sn, long long v_sb, long long v_sn, long long m_sb,
                                  long long o_sb, long long o_sn, int safemax, void* stream) {
  if (bad_shape(batch, n_q, n_kv, heads)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, heads, batch);
  launch_fwd<false, false>(safemax != 0, grid, static_cast<cudaStream_t>(stream),
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<const uint8_t*>(kv_blocked), nullptr,
                           static_cast<__nv_bfloat16*>(out), nullptr, n_q, n_kv, q_sb, q_sn, k_sb,
                           k_sn, v_sb, v_sn, m_sb, o_sb, o_sn);
  return static_cast<int>(cudaGetLastError());
}

// Training forward.  At most one of kv_blocked ((B, M) bytes) and segments
// ((B, N) int32 ids, N == M) is given, with batch stride m_sb.  l2 is a
// contiguous (B, H, N) fp32 output.
extern "C" int egom2p_flash64_train_fwd(const void* q, const void* k, const void* v,
                                        const void* kv_blocked, const void* segments, void* out,
                                        void* l2, int batch, int n_q, int n_kv, int heads,
                                        long long q_sb, long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb, long long v_sn,
                                        long long m_sb, long long o_sb, long long o_sn,
                                        int safemax, void* stream) {
  if (bad_shape(batch, n_q, n_kv, heads) || (kv_blocked != nullptr && segments != nullptr) ||
      (segments != nullptr && n_q != n_kv) || l2 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(l2);
  if (segments != nullptr) {
    launch_fwd<true, true>(safemax != 0, grid, st, qp, kp, vp, nullptr,
                           static_cast<const int*>(segments), op, lp, n_q, n_kv, q_sb, q_sn, k_sb,
                           k_sn, v_sb, v_sn, m_sb, o_sb, o_sn);
  } else {
    launch_fwd<false, true>(safemax != 0, grid, st, qp, kp, vp,
                            static_cast<const uint8_t*>(kv_blocked), nullptr, op, lp, n_q, n_kv,
                            q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, m_sb, o_sb, o_sn);
  }
  return static_cast<int>(cudaGetLastError());
}
