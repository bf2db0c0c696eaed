// Backward of training attention at head_dim 64 for Hopper (sm_90a), as two
// kernels: dq, and dk/dv.  Called from egom2p_torch/ops/flash64_train.py.
//
// Replaces the Pallas TPU kernels egom2p_tpu/ops/flash64_train.py
// `_dq_kernel` and `_dkv_kernel` (the split backward of
// `flash64_train_attention`, its default).  The forward is the L2 instance
// of csrc/flash64_fwd.cu.
//
// Math (identical to the TPU kernels), per (batch, head), with
// scale = 64^-0.5 * log2 e and the forward's mask:
//   s  = fp32(q . k) * scale + bias            (bias = -1e30 where blocked)
//   clamp mode: s = min(s, 80), exactly as the forward did, before
//   p  = exp2(s - L2)                          (true probabilities; L2 = +1e30
//                                               on a dead row gives p = 0)
//   dp = fp32(do . v),   ds = bf16(p * (dp - D)),   D = rowsum(do * o)
//   dq = bf16(64^-0.5 * sum_k ds k)
//   dk = bf16(64^-0.5 * sum_q ds q),   dv = bf16(sum_q bf16(p) do)
// Queries past N and keys past M match nothing: queries past N carry
// L2 = +1e30 (p = 0) and zero do, keys past M the -1e30 bias, both from
// bounds checks, never from a pad segment value.
//
// What bounds it on this card: arithmetic.  At the training step's shapes
// (B = 8, H = 12, N = M = 2048) the backward does about 3.5x the forward's
// tensor-core products: dq recomputes S and dP and adds dS K (3 products of
// 2*N*M*64), dk/dv recomputes S and dP^T and adds P^T dO and dS^T Q (4 more).
// The operands of one (batch, head) are 0.25 MB each, so K/V (dq) and Q/dO
// (dk/dv) are re-read from L2, not from device memory.
//
// What the design does about it: no atomics.  A dq block owns 64 query rows
// (four warps of 16) and walks all key tiles; a dk/dv block owns 64 keys and
// walks all query tiles, computing the transposed products S^T = K Q^T and
// dP^T = V dO^T so that each warp's 16 keys are the rows of its
// accumulators.  Every block's own operand is loaded once into registers as
// mma A fragments; the walked operands stream through shared memory in
// double-buffered cp.async tiles of 64 rows.  Each product is mma.sync
// m16n8k16 (bf16 in, fp32 accumulate).  P and dS go from their fp32
// accumulators straight into the next product's A fragments in registers
// (the flash64 forward's trick), and the second operand of P^T dO, dS K and
// dS^T Q comes from ldmatrix.trans.  Dynamic shared memory is 55 KB.  The
// result is deterministic.  wgmma, TMA and a fused one-pass backward are
// later work.

#include "common.cuh"

namespace {

using namespace egom2p;

constexpr int kHeadDim = 64;
constexpr int kTile = 64;                    // rows per block and per streamed tile
constexpr int kLd = kHeadDim + 8;            // padded smem row: 144 bytes
constexpr int kThreads = 128;                // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kDeadL2 = 1e30f;
constexpr float kClamp = 80.f;

enum MaskMode { kNone = 0, kKeyPad = 1, kSegment = 2 };

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *l2, *dvec;                    // (B, H, N) fp32, contiguous
  const uint8_t* kv_blocked;                 // (B, M) bytes, batch stride m_sb
  const int* segments;                       // (B, N) int32, batch stride m_sb
  __nv_bfloat16 *dq, *dk, *dv;               // contiguous (B, N|M, H*64)
  int n_q, n_kv, heads;
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb;
  float scale, nat_scale;
};

using Tile = __nv_bfloat16[kTile][kLd];

// Rows row0.. of a 64 x 64 bf16 tile, 4 chunks of 16 bytes per thread; rows
// at or past `rows` are zero-filled.
__device__ __forceinline__ void load_tile(Tile& dst, const __nv_bfloat16* src, int64_t stride,
                                          int row0, int rows, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk >> 3, col = (chunk & 7) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(&dst[r][col], src + (ok ? row0 + r : 0) * stride + col, ok);
  }
}

// A fragments of this warp's 16 rows of a resident tile, for the 4 k-steps
// over head_dim.
__device__ __forceinline__ void load_rows_frags(uint32_t (&f)[4][4], const Tile& t, int warp,
                                                int gid, int tig) {
  const int r = warp * 16 + gid;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a_frag(f[kk], &t[r][kk * 16 + tig * 2], &t[r + 8][kk * 16 + tig * 2]);
}

// acc (16 x 64) = A (this warp's 16 rows, 4 k-steps) . T^T, where the 64
// rows of smem tile T are the product's columns (T is the "col" B operand).
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                           const Tile& t, int gid, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16* row = t[j * 8 + gid];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_16816(acc[j], a[kk], ld_smem_u32(row + kk * 16 + tig * 2),
                ld_smem_u32(row + kk * 16 + 8 + tig * 2));
    }
  }
}

// acc (16 x 64 dims) += X (16 x 64, fp32 accumulator, rounded to bf16) . T,
// where T's 64 rows are the contraction index.
__device__ __forceinline__ void product_nn_acc(float (&acc)[8][4], const float (&x)[8][4],
                                               const Tile& t, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a_frag(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &t[kk * 16 + (mat & 1) * 8 + mrow][jd * 16 + (mat >> 1) * 8]);
      mma_16816(acc[2 * jd], a, b[0], b[1]);
      mma_16816(acc[2 * jd + 1], a, b[2], b[3]);
    }
  }
}

// Store this warp's 16 rows x 64 dims, times `mul`, as bf16 rows of `out`.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], float mul,
                                           __nv_bfloat16* out, int64_t row_stride, int row0,
                                           int rows, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= rows) continue;
    __nv_bfloat16* o = out + row * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(o + j * 8 + tig * 2) =
          pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
    }
  }
}

struct DqSmem {
  Tile q, dout, k[2], v[2];
  float bias[2][kTile];
  int seg[2][kTile];
};

// One block: 64 query rows of one (batch, head); walks every key tile.
template <bool kClampMode, int kMode>
__global__ void __launch_bounds__(kThreads) flash64_dq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kTile, head = blockIdx.y, batch = blockIdx.z;
  const int64_t hoff = head * kHeadDim;

  const __nv_bfloat16* kb = a.k + batch * a.k_sb + hoff;
  const __nv_bfloat16* vb = a.v + batch * a.v_sb + hoff;
  const uint8_t* mb = kMode == kKeyPad ? a.kv_blocked + batch * a.m_sb : nullptr;
  const int* sb = kMode == kSegment ? a.segments + batch * a.m_sb : nullptr;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kTile;
    load_tile(sm.k[stage], kb, a.k_sn, k0, a.n_kv, tid);
    load_tile(sm.v[stage], vb, a.v_sn, k0, a.n_kv, tid);
    if (tid < kTile) {
      const int key = k0 + tid;
      const bool blocked = key >= a.n_kv || (kMode == kKeyPad && mb[key] != 0);
      sm.bias[stage][tid] = blocked ? kNegInf : 0.f;
      if (kMode == kSegment) sm.seg[stage][tid] = key < a.n_kv ? sb[key] : 0;
    }
  };

  load_tile(sm.q, a.q + batch * a.q_sb + hoff, a.q_sn, q0, a.n_q, tid);
  load_tile(sm.dout, a.dout + batch * a.do_sb + hoff, a.do_sn, q0, a.n_q, tid);
  load_kv(0, 0);
  cp_async_commit();

  // This thread's rows r0, r0 + 8: L2 and D (rows past N: p = 0), segment.
  const int r0 = q0 + warp * 16 + gid;
  const int64_t lbase = (static_cast<int64_t>(batch) * a.heads + head) * a.n_q;
  float l2r[2], dr[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    const bool ok = row < a.n_q;
    l2r[i] = ok ? a.l2[lbase + row] : kDeadL2;
    dr[i] = ok ? a.dvec[lbase + row] : 0.f;
    if (kMode == kSegment) segq[i] = ok ? sb[row] : 0;
  }

  uint32_t qf[4][4], dof[4][4];
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (a.n_kv + kTile - 1) / kTile;
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
      load_rows_frags(qf, sm.q, warp, gid, tig);
      load_rows_frags(dof, sm.dout, warp, gid, tig);
    }

    float s[8][4], dp[8][4];
    product_nt(s, qf, sm.k[stage], gid, tig);     // S  = Q K^T
    product_nt(dp, dof, sm.v[stage], gid, tig);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = j * 8 + tig * 2 + (e & 1);
        float b = sm.bias[stage][c];
        if (kMode == kSegment && segq[i] != sm.seg[stage][c]) b = kNegInf;
        float x = s[j][e] * a.scale + b;
        if (kClampMode) x = fminf(x, kClamp);
        const float p = exp2_approx(x - l2r[i]);
        s[j][e] = p * (dp[j][e] - dr[i]);          // dS, fp32 (rounded to bf16 below)
      }
    }
    product_nn_acc(acc, s, sm.k[stage], lane);    // dQ += dS K
    __syncthreads();  // every warp is done with `stage` before it is refilled
  }
  store_rows(acc, a.nat_scale, a.dq + (static_cast<int64_t>(batch) * a.n_q) * (a.heads * kHeadDim) + hoff,
             a.heads * kHeadDim, r0, a.n_q, tig);
}

struct DkvSmem {
  Tile k, v, q[2], dout[2];
  float l2[2][kTile], d[2][kTile];
  int seg[2][kTile];
};

// One block: 64 keys of one (batch, head); walks every query tile.
template <bool kClampMode, int kMode>
__global__ void __launch_bounds__(kThreads) flash64_dkv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kTile, head = blockIdx.y, batch = blockIdx.z;
  const int64_t hoff = head * kHeadDim;

  const __nv_bfloat16* qb = a.q + batch * a.q_sb + hoff;
  const __nv_bfloat16* db = a.dout + batch * a.do_sb + hoff;
  const int* sb = kMode == kSegment ? a.segments + batch * a.m_sb : nullptr;
  const int64_t lbase = (static_cast<int64_t>(batch) * a.heads + head) * a.n_q;

  auto load_q = [&](int tile, int stage) {
    const int r0 = tile * kTile;
    load_tile(sm.q[stage], qb, a.q_sn, r0, a.n_q, tid);
    load_tile(sm.dout[stage], db, a.do_sn, r0, a.n_q, tid);
    if (tid < kTile) {
      const int row = r0 + tid;
      const bool ok = row < a.n_q;
      sm.l2[stage][tid] = ok ? a.l2[lbase + row] : kDeadL2;
      sm.d[stage][tid] = ok ? a.dvec[lbase + row] : 0.f;
      if (kMode == kSegment) sm.seg[stage][tid] = ok ? sb[row] : 0;
    }
  };

  load_tile(sm.k, a.k + batch * a.k_sb + hoff, a.k_sn, k0, a.n_kv, tid);
  load_tile(sm.v, a.v + batch * a.v_sb + hoff, a.v_sn, k0, a.n_kv, tid);
  load_q(0, 0);
  cp_async_commit();

  // This thread's keys c0, c0 + 8: bias (past M or padding) and segment.
  const int c0 = k0 + warp * 16 + gid;
  float kbias[2];
  int segk[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + i * 8;
    const bool ok = key < a.n_kv;
    bool blocked = !ok;
    if (kMode == kKeyPad && ok) blocked = a.kv_blocked[batch * a.m_sb + key] != 0;
    kbias[i] = blocked ? kNegInf : 0.f;
    if (kMode == kSegment) segk[i] = ok ? sb[key] : 0;
  }

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  const int n_tiles = (a.n_q + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_q(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      load_rows_frags(kf, sm.k, warp, gid, tig);
      load_rows_frags(vf, sm.v, warp, gid, tig);
    }

    float p[8][4], dpt[8][4];
    product_nt(p, kf, sm.q[stage], gid, tig);       // S^T  = K Q^T  (keys x queries)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = j * 8 + tig * 2 + (e & 1);
        float b = kbias[i];
        if (kMode == kSegment && segk[i] != sm.seg[stage][c]) b = kNegInf;
        float x = p[j][e] * a.scale + b;
        if (kClampMode) x = fminf(x, kClamp);
        p[j][e] = exp2_approx(x - sm.l2[stage][c]);
      }
    }
    product_nn_acc(dv, p, sm.dout[stage], lane);    // dV += P^T dO
    product_nt(dpt, vf, sm.dout[stage], gid, tig);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        p[j][e] = p[j][e] * (dpt[j][e] - sm.d[stage][c]);  // dS^T, fp32
      }
    }
    product_nn_acc(dk, p, sm.q[stage], lane);       // dK += dS^T Q
    __syncthreads();
  }
  const int64_t row_stride = a.heads * kHeadDim;
  const int64_t obase = static_cast<int64_t>(batch) * a.n_kv * row_stride + hoff;
  store_rows(dk, a.nat_scale, a.dk + obase, row_stride, c0, a.n_kv, tig);
  store_rows(dv, 1.f, a.dv + obase, row_stride, c0, a.n_kv, tig);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  // above 48 KB, dynamic shared memory needs the opt-in (cheap, idempotent)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t dispatch(bool dq, bool clamp, cudaStream_t st, const Args& a, int batch) {
  if (dq) {
    const dim3 grid((a.n_q + kTile - 1) / kTile, a.heads, batch);
    return clamp ? launch(flash64_dq_kernel<true, kMode>, grid, sizeof(DqSmem), st, a)
                 : launch(flash64_dq_kernel<false, kMode>, grid, sizeof(DqSmem), st, a);
  }
  const dim3 grid((a.n_kv + kTile - 1) / kTile, a.heads, batch);
  return clamp ? launch(flash64_dkv_kernel<true, kMode>, grid, sizeof(DkvSmem), st, a)
               : launch(flash64_dkv_kernel<false, kMode>, grid, sizeof(DkvSmem), st, a);
}

int run(bool dq, const void* q, const void* k, const void* v, const void* dout, const void* l2,
        const void* dvec, const void* kv_blocked, const void* segments, void* out0, void* out1,
        int batch, int n_q, int n_kv, int heads, long long q_sb, long long q_sn, long long k_sb,
        long long k_sn, long long v_sb, long long v_sn, long long do_sb, long long do_sn,
        long long m_sb, int safemax, void* stream) {
  if (batch <= 0 || n_q <= 0 || n_kv <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      (kv_blocked != nullptr && segments != nullptr) || (segments != nullptr && n_q != n_kv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.l2 = static_cast<const float*>(l2);
  a.dvec = static_cast<const float*>(dvec);
  a.kv_blocked = static_cast<const uint8_t*>(kv_blocked);
  a.segments = static_cast<const int*>(segments);
  a.dq = dq ? static_cast<__nv_bfloat16*>(out0) : nullptr;
  a.dk = dq ? nullptr : static_cast<__nv_bfloat16*>(out0);
  a.dv = dq ? nullptr : static_cast<__nv_bfloat16*>(out1);
  a.n_q = n_q;
  a.n_kv = n_kv;
  a.heads = heads;
  a.q_sb = q_sb; a.q_sn = q_sn; a.k_sb = k_sb; a.k_sn = k_sn;
  a.v_sb = v_sb; a.v_sn = v_sn; a.do_sb = do_sb; a.do_sn = do_sn; a.m_sb = m_sb;
  a.scale = static_cast<float>(0.125 * 1.4426950408889634);  // 64^-0.5 * log2(e)
  a.nat_scale = 0.125f;                                        // 64^-0.5
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool clamp = safemax == 0;
  cudaError_t err;
  if (segments != nullptr) {
    err = dispatch<kSegment>(dq, clamp, st, a, batch);
  } else if (kv_blocked != nullptr) {
    err = dispatch<kKeyPad>(dq, clamp, st, a, batch);
  } else {
    err = dispatch<kNone>(dq, clamp, st, a, batch);
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes.  q/k/v are (B, N|M, H*64) bf16 rows with
// unit stride inside a row and the given batch/row strides (views of fused
// projections are fine); dout is (B, N, H*64) bf16; l2 and dvec are
// contiguous (B, H, N) fp32 (the forward's L2 and rowsum(do * o)); at most one
// of kv_blocked ((B, M) bytes) and segments ((B, N) int32, N == M) is given,
// with batch stride m_sb.  Outputs are contiguous bf16: dq (B, N, H*64), dk
// and dv (B, M, H*64).  Each returns the CUDA error of the launch (0 on
// success).
extern "C" int egom2p_flash64_train_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* l2, const void* dvec,
                                       const void* kv_blocked, const void* segments, void* dq,
                                       int batch, int n_q, int n_kv, int heads, long long q_sb,
                                       long long q_sn, long long k_sb, long long k_sn,
                                       long long v_sb, long long v_sn, long long do_sb,
                                       long long do_sn, long long m_sb, int safemax,
                                       void* stream) {
  return run(true, q, k, v, dout, l2, dvec, kv_blocked, segments, dq, nullptr, batch, n_q, n_kv,
             heads, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb, safemax, stream);
}

extern "C" int egom2p_flash64_train_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* l2, const void* dvec,
                                        const void* kv_blocked, const void* segments, void* dk,
                                        void* dv, int batch, int n_q, int n_kv, int heads,
                                        long long q_sb, long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb, long long v_sn,
                                        long long do_sb, long long do_sn, long long m_sb,
                                        int safemax, void* stream) {
  return run(false, q, k, v, dout, l2, dvec, kv_blocked, segments, dk, dv, batch, n_q, n_kv,
             heads, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb, safemax, stream);
}
