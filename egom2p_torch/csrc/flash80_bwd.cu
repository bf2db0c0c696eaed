// Fused one-pass backward (dq, dk, dv) of training attention at head_dim 80
// for Hopper (sm_90a), exact (running-max) softmax form: the stock route's
// backward for heads of 65..80 that the caller zero-pads to 80 (EgoM2P-large:
// 68; the padding gives zero gradient columns), with the true head's scale
// passed in.  Called from egom2p_torch/ops/flash_attention.py through
// egom2p_torch/ops/flash64_train.py's launcher.  Heads of 64 take the fused
// kernel of csrc/flash64_train.cu; the forward is csrc/flash80_fwd.cu.
//
// Replaces the backward of the stock jax.experimental.pallas.ops.tpu
// flash_attention, reached through egom2p_tpu/ops/flash_attention.py
// `segment_flash_attention` / `padding_flash_attention`.
//
// Math, per (batch, head), with scale = hd^-0.5 * log2 e (hd the true head
// dim) and the forward's mask:
//   s  = fp32(q . k) * scale + bias            (bias = -1e30 where blocked)
//   p  = exp2(s - L2)                          (L2 = +1e30 on a dead row: p = 0)
//   dp = fp32(do . v),   ds = bf16(p * (dp - D)),   D = rowsum(do * o)
//   dq += hd^-0.5 * ds k   (fp32 atomic adds into a zeroed buffer)
//   dk = bf16(hd^-0.5 * sum_q ds q),   dv = bf16(sum_q bf16(p) do)
// Queries past N carry L2 = +1e30 and zero do, keys past M the -1e30 bias,
// both from bounds checks, never from a pad segment value.
//
// What bounds it on this card: arithmetic (5 products of 2*N*M*HD per (batch,
// head)) and the fp32 atomic adds of dq (M/64 adds per dq element, served by
// L2).  This is the first, simple design, not redesigned for wgmma: a row of
// 80 bf16 is 160 bytes and fits no single 128-byte swizzle atom.  A block of
// four warps owns 64 keys and walks all query tiles, computing the
// transposed products S^T = K Q^T and dP^T = V dO^T so that each warp's 16
// keys are the rows of its accumulators; K and V are loaded once into
// registers as mma A fragments, Q and dO stream through shared memory in
// double-buffered cp.async tiles of 64 rows.  Each product is mma.sync
// m16n8k16 (bf16 in, fp32 accumulate).  P and dS go from their fp32
// accumulators straight into the next product's A fragments in registers, and
// the second operand of P^T dO and dS^T Q comes from ldmatrix.trans.  dS^T is
// rounded to bf16 into shared memory and read back with ldmatrix.trans as the
// A operand of dQ_tile = dS K (each warp takes 16 query rows, all 64 keys),
// which is added to dq with float2 atomicAdd: the sum order changes from run
// to run, so dq is not bitwise deterministic (dk and dv are).  78 KB of
// dynamic shared memory.

#include "common.cuh"

namespace {

using namespace egom2p;

constexpr int kTile = 64;                    // rows per block and per streamed tile
constexpr int kThreads = 128;                // 4 warps x 16 rows
constexpr float kNegInf = -1e30f;
constexpr float kDeadL2 = 1e30f;
constexpr float kClamp = 80.f;
constexpr double kLog2e = 1.4426950408889634;

enum MaskMode { kNone = 0, kKeyPad = 1, kSegment = 2 };

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *l2, *dvec;                    // (B, H, N) fp32, contiguous
  const uint8_t* kv_blocked;                 // (B, M) bytes, batch stride m_sb
  const int* segments;                       // (B, N) int32, batch stride m_sb
  __nv_bfloat16 *dk, *dv;                    // contiguous (B, M, H*HD)
  float* dq_acc;                             // zeroed fp32 (B, N, H*HD)
  int n_q, n_kv, heads;
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb;
  float scale, nat_scale;
};

// A 64-row bf16 tile with padded rows (HD + 8: 144 bytes at 64, 176 at 80).
template <int kHD>
using Tile = __nv_bfloat16[kTile][kHD + 8];

// Rows row0.. of a 64 x HD bf16 tile, HD / 16 chunks of 16 bytes per
// thread; rows at or past `rows` are zero-filled.
template <int kHD>
__device__ __forceinline__ void load_tile(Tile<kHD>& dst, const __nv_bfloat16* src, int64_t stride,
                                          int row0, int rows, int tid) {
#pragma unroll
  for (int i = 0; i < kHD / 16; ++i) {
    // int, not unsigned as in the forward: with an unsigned index nvcc schedules
    // these kernels slower (key-padding dk/dv 1.02 against 0.77 ms at the
    // training step's shapes, H100 SXM, CUDA 12.8)
    const int chunk = tid + i * kThreads;
    const int r = chunk / (kHD / 8), col = (chunk % (kHD / 8)) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(&dst[r][col], src + (ok ? row0 + r : 0) * stride + col, ok);
  }
}

// A fragments of this warp's 16 rows of a resident tile, for the HD / 16
// k-steps over head_dim.
template <int kHD>
__device__ __forceinline__ void load_rows_frags(uint32_t (&f)[kHD / 16][4], const Tile<kHD>& t,
                                                int warp, int gid, int tig) {
  const int r = warp * 16 + gid;
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    load_a_frag(f[kk], &t[r][kk * 16 + tig * 2], &t[r + 8][kk * 16 + tig * 2]);
  }
}

// acc (16 x 64) = A (this warp's 16 rows, HD / 16 k-steps) . T^T, where the
// 64 rows of smem tile T are the product's columns (T is the "col" B operand).
template <int kHD>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const uint32_t (&a)[kHD / 16][4],
                                           const Tile<kHD>& t, int gid, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16* row = t[j * 8 + gid];
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      mma_16816(acc[j], a[kk], ld_smem_u32(row + kk * 16 + tig * 2),
                ld_smem_u32(row + kk * 16 + 8 + tig * 2));
    }
  }
}

// acc (16 x HD dims) += X (16 x 64, fp32 accumulator, rounded to bf16) . T,
// where T's 64 rows are the contraction index.
template <int kHD>
__device__ __forceinline__ void product_nn_acc(float (&acc)[kHD / 8][4], const float (&x)[8][4],
                                               const Tile<kHD>& t, int lane) {
  const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a_frag(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int jd = 0; jd < kHD / 16; ++jd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &t[kk * 16 + (mat & 1) * 8 + mrow][jd * 16 + (mat >> 1) * 8]);
      mma_16816(acc[2 * jd], a, b[0], b[1]);
      mma_16816(acc[2 * jd + 1], a, b[2], b[3]);
    }
  }
}

template <int kHD>
__device__ __forceinline__ void zero(float (&acc)[kHD / 8][4]) {
#pragma unroll
  for (int j = 0; j < kHD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Store this warp's 16 rows x HD dims, times `mul`, as bf16 rows of `out`.
template <int kHD>
__device__ __forceinline__ void store_rows(const float (&acc)[kHD / 8][4], float mul,
                                           __nv_bfloat16* out, int64_t row_stride, int row0,
                                           int rows, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= rows) continue;
    __nv_bfloat16* o = out + row * row_stride;
#pragma unroll
    for (int j = 0; j < kHD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(o + j * 8 + tig * 2) =
          pack_bf16(acc[j][2 * i] * mul, acc[j][2 * i + 1] * mul);
    }
  }
}

constexpr int kHD = 80;
constexpr bool kClampMode = false;           // the stock route's softmax is the exact form
constexpr bool kFused = true;                // dq is part of this kernel

struct Smem {
  Tile<kHD> k, v, q[2], dout[2];
  __nv_bfloat16 ds[kTile][kTile + 8];        // dS^T: keys x queries
  float l2[2][kTile], d[2][kTile];
  int seg[2][kTile];
};

// One block: 64 keys of one (batch, head); walks every query tile and adds
// its dQ contributions by fp32 atomics.
template <int kMode>
__global__ void __launch_bounds__(kThreads) flash80_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kTile, head = blockIdx.y, batch = blockIdx.z;
  const int64_t hoff = head * kHD;
  const int64_t row_stride = a.heads * kHD;

  const __nv_bfloat16* qb = a.q + batch * a.q_sb + hoff;
  const __nv_bfloat16* db = a.dout + batch * a.do_sb + hoff;
  const int* sb = kMode == kSegment ? a.segments + batch * a.m_sb : nullptr;
  const int64_t lbase = (static_cast<int64_t>(batch) * a.heads + head) * a.n_q;

  auto load_q = [&](int tile, int stage) {
    const int r0 = tile * kTile;
    load_tile<kHD>(sm.q[stage], qb, a.q_sn, r0, a.n_q, tid);
    load_tile<kHD>(sm.dout[stage], db, a.do_sn, r0, a.n_q, tid);
    if (tid < kTile) {
      const int row = r0 + tid;
      const bool ok = row < a.n_q;
      sm.l2[stage][tid] = ok ? a.l2[lbase + row] : kDeadL2;
      sm.d[stage][tid] = ok ? a.dvec[lbase + row] : 0.f;
      if (kMode == kSegment) sm.seg[stage][tid] = ok ? sb[row] : 0;
    }
  };

  load_tile<kHD>(sm.k, a.k + batch * a.k_sb + hoff, a.k_sn, k0, a.n_kv, tid);
  load_tile<kHD>(sm.v, a.v + batch * a.v_sb + hoff, a.v_sn, k0, a.n_kv, tid);
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

  uint32_t kf[kHD / 16][4], vf[kHD / 16][4];
  float dk[kHD / 8][4], dv[kHD / 8][4];
  zero<kHD>(dk);
  zero<kHD>(dv);
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row

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
      load_rows_frags<kHD>(kf, sm.k, warp, gid, tig);
      load_rows_frags<kHD>(vf, sm.v, warp, gid, tig);
    }

    float p[8][4], dpt[8][4];
    product_nt<kHD>(p, kf, sm.q[stage], gid, tig);       // S^T  = K Q^T  (keys x queries)
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
    product_nn_acc<kHD>(dv, p, sm.dout[stage], lane);    // dV += P^T dO
    product_nt<kHD>(dpt, vf, sm.dout[stage], gid, tig);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + tig * 2 + (e & 1);
        p[j][e] = p[j][e] * (dpt[j][e] - sm.d[stage][c]);  // dS^T, fp32
      }
    }
    product_nn_acc<kHD>(dk, p, sm.q[stage], lane);       // dK += dS^T Q
    if (kFused) {
      // dS^T (this warp's 16 keys x 64 queries) to shared memory as bf16 ...
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + tig * 2;
        const int r = warp * 16 + gid;
        *reinterpret_cast<uint32_t*>(&sm.ds[r][c]) = pack_bf16(p[j][0], p[j][1]);
        *reinterpret_cast<uint32_t*>(&sm.ds[r + 8][c]) = pack_bf16(p[j][2], p[j][3]);
      }
      __syncthreads();
      // ... then dQ (this warp's 16 queries x HD) = dS K over the block's 64
      // keys: dS's A fragments are ldmatrix.trans of the keys-major tile.
      float dq[kHD / 8][4];
      zero<kHD>(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4];
        ldmatrix_x4_trans(af, &sm.ds[kk * 16 + (mat >> 1) * 8 + mrow][warp * 16 + (mat & 1) * 8]);
#pragma unroll
        for (int jd = 0; jd < kHD / 16; ++jd) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, &sm.k[kk * 16 + (mat & 1) * 8 + mrow][jd * 16 + (mat >> 1) * 8]);
          mma_16816(dq[2 * jd], af, b[0], b[1]);
          mma_16816(dq[2 * jd + 1], af, b[2], b[3]);
        }
      }
      const int qrow = t * kTile + warp * 16 + gid;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = qrow + i * 8;
        if (row >= a.n_q) continue;
        float* o = a.dq_acc + (static_cast<int64_t>(batch) * a.n_q + row) * row_stride + hoff;
#pragma unroll
        for (int j = 0; j < kHD / 8; ++j) {
          atomicAdd(reinterpret_cast<float2*>(o + j * 8 + tig * 2),
                    make_float2(dq[j][2 * i] * a.nat_scale, dq[j][2 * i + 1] * a.nat_scale));
        }
      }
    }
    __syncthreads();  // every warp is done with `stage` (and ds) before it is refilled
  }
  const int64_t obase = static_cast<int64_t>(batch) * a.n_kv * row_stride + hoff;
  store_rows<kHD>(dk, a.nat_scale, a.dk + obase, row_stride, c0, a.n_kv, tig);
  store_rows<kHD>(dv, 1.f, a.dv + obase, row_stride, c0, a.n_kv, tig);
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
cudaError_t dispatch(cudaStream_t st, const Args& a, int batch) {
  const dim3 grid((a.n_kv + kTile - 1) / kTile, a.heads, batch);
  return launch(flash80_bwd_kernel<kMode>, grid, sizeof(Smem), st, a);
}

}  // namespace

// C entry point, bound with ctypes.  q/k/v are (B, N|M, H*80) bf16 rows with
// unit stride inside a row and the given batch/row strides; dout is (B, N,
// H*80) bf16; l2 and dvec are contiguous (B, H, N) fp32 (the forward's L2 and
// rowsum(do * o)); at most one of kv_blocked ((B, M) bytes) and segments ((B,
// N) int32, N == M) is given, with batch stride m_sb.  head_dim is 80 and
// safemax nonzero; sm_scale is the true head's hd^-0.5.  dk and dv are
// contiguous bf16 (B, M, H*80); dq is added into a zeroed fp32 (B, N, H*80)
// buffer.  Returns the CUDA error of the launch (0 on success).
extern "C" int egom2p_flash80_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  const void* l2, const void* dvec, const void* kv_blocked,
                                  const void* segments, void* dq_acc, void* dk, void* dv,
                                  int batch, int n_q, int n_kv, int heads, long long q_sb,
                                  long long q_sn, long long k_sb, long long k_sn, long long v_sb,
                                  long long v_sn, long long do_sb, long long do_sn,
                                  long long m_sb, int safemax, int head_dim, float sm_scale,
                                  void* stream) {
  if (batch <= 0 || n_q <= 0 || n_kv <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      (kv_blocked != nullptr && segments != nullptr) || (segments != nullptr && n_q != n_kv) ||
      head_dim != kHD || safemax == 0) {
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
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.n_q = n_q;
  a.n_kv = n_kv;
  a.heads = heads;
  a.q_sb = q_sb; a.q_sn = q_sn; a.k_sb = k_sb; a.k_sn = k_sn;
  a.v_sb = v_sb; a.v_sn = v_sn; a.do_sb = do_sb; a.do_sn = do_sn; a.m_sb = m_sb;
  a.scale = static_cast<float>(static_cast<double>(sm_scale) * kLog2e);  // hd^-0.5 * log2(e)
  a.nat_scale = sm_scale;                                                 // hd^-0.5
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (segments != nullptr) {
    err = dispatch<kSegment>(st, a, batch);
  } else if (kv_blocked != nullptr) {
    err = dispatch<kKeyPad>(st, a, batch);
  } else {
    err = dispatch<kNone>(st, a, batch);
  }
  return static_cast<int>(err);
}
