// Backward of training attention at head_dim 64 for Hopper (sm_90a): the
// split pair (dq, and dk/dv) and the fused one-pass dq/dk/dv kernel, all on
// wgmma, TMA and warp specialisation; the fused kernel also at head_dim 80
// (the stock route for heads of 65..80 zero-padded to 80).  Called from
// egom2p_torch/ops/flash64_train.py.
//
// Replaces the Pallas TPU kernels egom2p_tpu/ops/flash64_train.py
// `_dq_kernel` and `_dkv_kernel` (the split backward of
// `flash64_train_attention`, its default), `_dqkv_kernel` (the fused backward,
// EGOM2P_F64T_FUSED_BWD=1), and the backward of the stock
// jax.experimental.pallas.ops.tpu flash_attention that
// egom2p_tpu/ops/flash_attention.py reaches (the fused kernel in its safemax
// form with the true head's scale, at head width 64 or 80).  The forward is
// the L2 instance of csrc/flash64_fwd.cu.
//
// Math (identical to the TPU kernels), per (batch, head), with
// scale = hd^-0.5 * log2 e (hd the true head dim) and the forward's mask:
//   s  = fp32(q . k) * scale + bias            (bias = -1e30 where blocked)
//   clamp mode: s = min(s, 80), exactly as the forward did, before
//   p  = exp2(s - L2)                          (true probabilities; L2 = +1e30
//                                               on a dead row gives p = 0)
//   dp = fp32(do . v),   ds = bf16(p * (dp - D)),   D = rowsum(do * o)
//   dq = hd^-0.5 * sum_k ds k
//   dk = bf16(hd^-0.5 * sum_q ds q),   dv = bf16(sum_q bf16(p) do)
// The split dq kernel rounds dq to bf16; the fused kernel adds each 64 keys'
// fp32 contribution into a zeroed fp32 buffer, which the caller casts.
// Queries past N and keys past M match nothing: queries past N carry
// L2 = +1e30 (p = 0) and zero do, keys past M the -1e30 bias, both from
// bounds checks, never from a pad segment value.
//
// What bounds it on this card: arithmetic.  At the training step's shapes
// (B = 8, H = 12, N = M = 2048) dq runs 3 products of 2*N*M*64 per (batch,
// head) (S, dP, dS K), dk/dv 4 (S^T, dP^T, P^T dO, dS^T Q), the fused kernel
// the 5 distinct ones, plus one exp2 per score on the special function units
// (a third to a half of the tensor time).  The fused kernel pays for its two
// saved products with fp32 adds into dq, served by L2: every key block adds
// a 64 x 64 tile for every query tile.  The operands of one (batch, head) are
// 0.25 MB each, so they are re-read from L2, not from device memory.
//
// What the design does about it (the forward's, csrc/flash64_fwd.cu):
//   * a block owns 128 rows of one (batch, head): queries in the dq kernel,
//     keys in the dk/dv kernel.  Two consumer warpgroups take 64 rows each,
//     one producer warp loads.  The block's own operands (Q and dO, or K and
//     V) arrive once by TMA as 128-byte-swizzled K-major tiles; the walked
//     operands (K and V, or Q and dO) stream in tiles of 64 rows through a
//     ring of 4 stages, each with a full and an empty mbarrier.  The producer
//     also writes the stage's per-row values (the key bias and segment ids, or
//     L2, D and the query's segment ids; rows past N carry L2 = +1e30, D = 0)
//     and TMA delivers rows past N or M as zeros.
//   * every product is wgmma m64n64k16 with operands read by the tensor cores
//     through descriptors, never by load instructions.  S and dP (dq kernel)
//     or S^T = K Q^T and dP^T = V dO^T (dk/dv kernel) take both operands
//     K-major from shared memory.  P and dS go from their fp32 accumulators
//     into the A fragments of the next product in registers, and that
//     product's second operand (K in dQ += dS K; dO in dV += P^T dO, Q in
//     dK += dS^T Q) is the same streamed tile read again MN-major (the depth
//     runs across its 64 rows).  The transposed formulation of the dk/dv
//     kernel keeps P and dS out of shared memory: its accumulator rows are
//     keys (the key bias and segment id are registers) and its columns are
//     queries (L2, D and the query's segment id come from the stage's rows).
//   * overlap inside a warpgroup: S and dP are issued together and only S is
//     waited for, so the exp2 pass runs under dP.  The dq kernel issues tile
//     t-1's dS K in the same batch, so that it too runs under tile t's exp2
//     pass; the dk/dv kernel runs P^T dO under the dS pass.  The two
//     warpgroups interleave on top.
//   * what the compiler dictates (CUDA 12.8).  Every thread gets the
//     registers that the launch bounds leave at entry (168 at 384 threads),
//     whatever setmaxnreg says later: four accumulators of 32 plus two sets
//     of A fragments fill them, so the dk/dv kernel cannot defer a product to
//     the next tile or hold a dQ accumulator (ptxas: C7512, an accumulator in
//     local memory).  And no wgmma may be in flight across a loop's back
//     edge: ptxas then serialises every wgmma of the loop (C7515; 0.43 ->
//     0.33 ms for dq and 0.55 -> 0.47 ms for dk/dv at the training step's
//     shapes once none was, H100 SXM, 700 W).
//   * fused form: the consumers also store dS^T (their 64 keys x 64 queries,
//     bf16) into a double-buffered tile in shared memory, by hand in the
//     swizzled layout (16-byte chunk c of row r at c ^ (r % 8)), then
//     fence.proxy.async and an mbarrier.  The third warpgroup, whose first
//     warp stays the producer (three tiles ahead), computes dQ_tile = dS K
//     in one chain over the block's 128 keys: a wgmma whose A operand is the
//     dS^T tile read MN-major and whose B operand is the block's K read
//     MN-major.  The 64 x 64 fp32 tile goes to a double-buffered staging tile
//     (two swizzled boxes of 32 dims) and one thread adds each box into dq
//     with cp.reduce.async.bulk.tensor (a tensor map over the fp32 buffer;
//     rows past N are dropped): M/128 adds per dq element, 0.8 GB a launch at
//     these shapes.  L2 performs the adds in no fixed order, so the fused
//     kernel's dq is not bitwise deterministic (dk and dv are).  As float2
//     atomic adds from the consumers' registers (M/64 per element) the adds
//     took 0.53 ms of a 1.11 ms launch; as reduce-adds issued by the
//     consumers 0.25 of 0.83; from the third warpgroup the launch takes 0.65.
// Dynamic shared memory: dq 99 KB, dk/dv 99 KB, fused 163 KB (196 KB at head
// width 80, whose design stands above the dk/dv kernel); one block per SM
// (the registers allow no more).

#include "hopper.cuh"

namespace {

using namespace egom2p;

constexpr int kHD = 64;
constexpr int kHD0 = kHD;                    // columns of a head's first (128-byte) box
constexpr int kBlock = 128;                  // rows a block owns: 2 warpgroups x 64
constexpr int kStep = 64;                    // rows of a streamed tile
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;                // 2 consumer warpgroups + the producer's
constexpr int kOwnBytes = kBlock * kHD * 2;  // 16 KB
constexpr int kStepBytes = kStep * kHD * 2;  // 8 KB
constexpr uint64_t kStageStep = kStepBytes >> 4;  // descriptor units between stages
constexpr uint64_t kMnStep = 2048 >> 4;      // an MN-major k-step: 16 rows of 128 bytes
constexpr float kNegInf = -1e30f;
constexpr float kDeadL2 = 1e30f;
constexpr float kClamp = 80.f;
constexpr double kLog2e = 1.4426950408889634;

enum Which { kDq = 0, kDkv = 1, kDqkv = 2 };

struct Args {
  const float *l2, *dvec;                    // (B, H, N) fp32, contiguous
  const uint8_t* kv_blocked;                 // (B, M) bytes, batch stride m_sb, or null
  const int* segments;                       // (B, N) int32, batch stride m_sb, or null
  __nv_bfloat16 *dq, *dk, *dv;               // contiguous (B, N|M, H*64); the fused kernel's
                                             // fp32 dq goes through its tensor map
  int n_q, n_kv, heads;
  int64_t m_sb;
  float scale, nat_scale;
};

// p = exp2(min(x, 80) - L2) (no clamp under safemax)
template <bool kClampMode>
__device__ __forceinline__ float prob(float x, float l2) {
  if (kClampMode) x = fminf(x, kClamp);
  return exp2_approx(x - l2);
}

// An fp32 accumulator of 16 kK columns, rounded to bf16, as the A fragments
// of the kK k-steps over those columns: column tiles 2kk and 2kk + 1 are
// exactly k-step kk's fragment.
template <int kK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[kK][4], const float (&x)[8 * kK]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc = A B^T over head_dim, A and B K-major tiles of 64 rows
__device__ __forceinline__ void product_kk(float (&acc)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) wgmma_ss<0, 0>(acc, a + 2 * kk, b + 2 * kk, kk > 0);
  wgmma_commit();
}

// acc += A B over the 64 rows of tile B (read MN-major), A from registers
__device__ __forceinline__ void product_rs(float (&acc)[32], const uint32_t (&a)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) wgmma_rs<1>(acc, a[kk], b + kk * kMnStep, 1);
  wgmma_commit();
}

// This warp's rows row0, row0 + 8 (where below `rows`) x kN / 2 dims (64, or
// the 16 of a second box), times `mul`, as bf16 rows of `out`.
template <int kN>
__device__ __forceinline__ void store_rows(const float (&acc)[kN], float mul, __nv_bfloat16* out,
                                           int64_t row_stride, int row0, int rows, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= rows) continue;
    __nv_bfloat16* o = out + row * row_stride;
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      *reinterpret_cast<uint32_t*>(o + j * 8 + tig * 2) =
          pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// ------------------------------------------------------------------------ dq
struct DqSmem {
  __nv_bfloat16 q[kBlock * kHD], dout[kBlock * kHD];  // tiles first: multiples of 1024 bytes
  __nv_bfloat16 k[kStages][kStep * kHD], v[kStages][kStep * kHD];
  float bias[kStages][kStep];
  int seg[kStages][kStep];
  int masked[kStages];                       // the stage's tile has a blocked key
  uint64_t full[kStages], empty[kStages], own_full;
};

// One block: 128 query rows of one (batch, head); walks every key tile.
// kSeg: block where segments[q] != segments[k] (self-attention).
template <bool kClampMode, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    flash64_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align1024(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = blockIdx.x * kBlock;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = (a.n_kv + kStep - 1) / kStep;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 32);               // the producer warp's lanes (+ the TMA bytes)
      mbar_init(&sm.empty[i], kConsumerWarps);  // one lane of each consumer warp
    }
    mbar_init(&sm.own_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    if (tid >= 2 * 128 + 32) return;
    const int lane = tid & 31;
    const uint8_t* mb = a.kv_blocked == nullptr ? nullptr : a.kv_blocked + batch * a.m_sb;
    const int* sb = kSeg ? a.segments + batch * a.m_sb : nullptr;
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.own_full, 2 * kOwnBytes);
      tma_load_3d(sm.q, &map_q, &sm.own_full, head * kHD, q0, batch);
      tma_load_3d(sm.dout, &map_do, &sm.own_full, head * kHD, q0, batch);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kStages;
      if (t >= kStages) mbar_wait(&sm.empty[stage], (t / kStages - 1) & 1);
      const int k0 = t * kStep;
      bool any = false;
#pragma unroll
      for (int i = 0; i < kStep / 32; ++i) {
        const int c = lane + i * 32, key = k0 + c;
        const bool blocked = key >= a.n_kv || (mb != nullptr && mb[key] != 0);
        sm.bias[stage][c] = blocked ? kNegInf : 0.f;
        if (kSeg) sm.seg[stage][c] = key < a.n_kv ? sb[key] : 0;
        any |= blocked;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        sm.masked[stage] = (any || kSeg) ? 1 : 0;
        mbar_arrive_expect_tx(&sm.full[stage], 2 * kStepBytes);
        tma_load_3d(sm.k[stage], &map_k, &sm.full[stage], head * kHD, k0, batch);
        tma_load_3d(sm.v[stage], &map_v, &sm.full[stage], head * kHD, k0, batch);
      } else {
        mbar_arrive(&sm.full[stage]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // accumulator row group / column pair
  const int r0 = q0 + wg * 64 + warp * 16 + gid;  // this thread's rows: r0 and r0 + 8
  const int64_t lbase = (static_cast<int64_t>(batch) * a.heads + head) * a.n_q;
  float l2r[2], dr[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    const bool ok = row < a.n_q;
    l2r[i] = ok ? a.l2[lbase + row] : kDeadL2;
    dr[i] = ok ? a.dvec[lbase + row] : 0.f;
    if (kSeg) segq[i] = ok ? a.segments[batch * a.m_sb + row] : 0;
  }
  const float scale = a.scale;

  float s[32], dp[32], acc[32];  // S then P then dS; dP; dQ: 64 rows x 64 per warpgroup
  uint32_t dsa[4][4];            // bf16 dS as the A fragments of dS K
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const uint64_t desc_q = smem_desc(sm.q + wg * 64 * kHD, 16, 1024);
  const uint64_t desc_do = smem_desc(sm.dout + wg * 64 * kHD, 16, 1024);
  const uint64_t desc_k0 = smem_desc(sm.k[0], 16, 1024);
  const uint64_t desc_v0 = smem_desc(sm.v[0], 16, 1024);

  // s (S of `stage`, done) -> P in place
  auto to_p = [&](int stage) {
    if (sm.masked[stage] != 0) {
      // scale, then the mask bias (the TPU kernel's order)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + tig * 2;
        const float2 b = *reinterpret_cast<const float2*>(&sm.bias[stage][c]);
        float b00 = b.x, b01 = b.y;  // row gid
        float b10 = b.x, b11 = b.y;  // row gid + 8
        if (kSeg) {
          const int2 ks = *reinterpret_cast<const int2*>(&sm.seg[stage][c]);
          if (segq[0] != ks.x) b00 = kNegInf;
          if (segq[0] != ks.y) b01 = kNegInf;
          if (segq[1] != ks.x) b10 = kNegInf;
          if (segq[1] != ks.y) b11 = kNegInf;
        }
        s[4 * j + 0] = prob<kClampMode>(s[4 * j + 0] * scale + b00, l2r[0]);
        s[4 * j + 1] = prob<kClampMode>(s[4 * j + 1] * scale + b01, l2r[0]);
        s[4 * j + 2] = prob<kClampMode>(s[4 * j + 2] * scale + b10, l2r[1]);
        s[4 * j + 3] = prob<kClampMode>(s[4 * j + 3] * scale + b11, l2r[1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = prob<kClampMode>(s[i] * scale, l2r[(i >> 1) & 1]);
    }
  };
  // s (P) -> dS in place, fp32; dP must be done
  auto to_ds = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dr[(i >> 1) & 1];
  };

  // Tile t's S and dP are issued together with tile t-1's dS K; only S is
  // waited for, so the exp2 pass runs while the other two are in flight.
  // Nothing is in flight across the loop's back edge: ptxas serialises every
  // wgmma of a loop that carries one over it (C7515).
  mbar_wait(&sm.own_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  product_kk(s, desc_q, desc_k0);    // S  = Q K^T
  product_kk(dp, desc_do, desc_v0);  // dP = dO V^T
  wgmma_wait<1>();
  fence_regs(s);
  to_p(0);
  wgmma_wait<0>();
  fence_regs(dp);
  to_ds();
  pack_a(dsa, s);
  for (int t = 1; t < n_tiles; ++t) {
    const int stage = t % kStages, prev = (t - 1) % kStages;
    mbar_wait(&sm.full[stage], (t / kStages) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_kk(s, desc_q, desc_k0 + stage * kStageStep);
    product_kk(dp, desc_do, desc_v0 + stage * kStageStep);
    product_rs(acc, dsa, desc_k0 + prev * kStageStep);  // dQ += dS K, K read again MN-major
    wgmma_wait<2>();  // S is there
    fence_regs(s);
    to_p(stage);
    wgmma_wait<1>();  // dP is there
    fence_regs(dp);
    to_ds();
    wgmma_wait<0>();  // dS K has read dsa and stage prev
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    pack_a(dsa, s);
  }
  wgmma_fence();
  product_rs(acc, dsa, desc_k0 + ((n_tiles - 1) % kStages) * kStageStep);
  wgmma_wait<0>();
  fence_regs(acc);
  store_rows(acc, a.nat_scale,
             a.dq + (static_cast<int64_t>(batch) * a.n_q) * (a.heads * kHD) + head * kHD,
             a.heads * kHD, r0, a.n_q, tig);
}

// --------------------------------------------------------------------- dk/dv
// A head of 80 (the stock route's fused kernel): every tile is two TMA boxes,
// columns 0-63 with the 128-byte swizzle and columns 64-79 as 32-byte rows
// with the 32-byte swizzle (hopper.cuh), and the queries go by in steps of
// 32 rows (walk_rows) through 8 stages, so that S^T and dP^T are 64 x 32 (16
// registers each) beside dK and dV of 64 x 80 (40 each): 128 registers of
// accumulators and A fragments, where steps of 64 rows would need 176 of the
// 168 a thread gets.  The dQ warpgroup still takes 64 queries at a time, from
// the dS^T halves of two steps.  On an H100 (700 W) at 15 heads of 68 packed
// to 80, B = 8, 2048^2: 1.22 ms, against 2.03 for the earlier mma.sync
// kernel and 1.84 for cuDNN's backward on the same padded heads.
__host__ __device__ constexpr int walk_rows(int hd) { return hd == 80 ? 32 : kStep; }
__host__ __device__ constexpr int walk_stages(int hd) { return hd == 80 ? 8 : kStages; }
constexpr int kBox2 = 16;                    // columns of the second box of a head of 80
constexpr int kDsBytes = kBlock * kStep * 2; // a dS^T buffer: 128 keys x 64 queries, 16 KB

// The second boxes of a head of 80: own K and V, the walked Q and dO stages,
// and the staging of dq's columns 64-79 (64 queries x 16 fp32, plain rows).
template <int kHD>
struct DkvWide {};
template <>
struct alignas(1024) DkvWide<80> {
  __nv_bfloat16 k[kBlock * kBox2], v[kBlock * kBox2];
  __nv_bfloat16 q[walk_stages(80)][walk_rows(80) * kBox2];
  __nv_bfloat16 dout[walk_stages(80)][walk_rows(80) * kBox2];
  float dqs[2][kStep * kBox2];
};

template <int kHD, bool kFused>
struct DkvSmem {
  static constexpr int kW = walk_rows(kHD), kS = walk_stages(kHD);
  __nv_bfloat16 k[kBlock * kHD0], v[kBlock * kHD0];  // tiles first: multiples of 1024 bytes
  __nv_bfloat16 q[kS][kW * kHD0], dout[kS][kW * kHD0];
  // fused: dS^T of a query tile (the block's 128 keys x 64 queries, bf16),
  // double-buffered, and the dQ tile on its way to dq, double-buffered, as
  // two swizzled boxes of 64 queries x 32 dims (128-byte rows)
  __nv_bfloat16 ds[kFused ? 2 : 1][kFused ? kBlock * kStep : 8];
  float dqs[kFused ? 2 : 1][kFused ? kStep * kHD0 : 4];
  float l2[kS][kW], d[kS][kW];
  int seg[kS][kW];
  uint64_t full[kS], empty[kS], own_full;
  uint64_t ds_full[2], ds_empty[2];          // fused: a dS^T buffer is written / has been read
  DkvWide<kHD> w;
};

// One block: 128 keys of one (batch, head); walks every query tile.  kFused
// adds dQ (the `_dqkv_kernel` of the TPU package) by bulk reduce-adds, from
// the third warpgroup, whose first warp stays the producer.  kHD: 64, or 80
// (fused, safemax; map_q2 .. map_dq2 are then the second boxes' maps, unused
// at 64).
template <int kHD, bool kClampMode, bool kSeg, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
    flash64_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_dq,
                       const __grid_constant__ CUtensorMap map_q2,
                       const __grid_constant__ CUtensorMap map_k2,
                       const __grid_constant__ CUtensorMap map_v2,
                       const __grid_constant__ CUtensorMap map_do2,
                       const __grid_constant__ CUtensorMap map_dq2, const Args a) {
  static_assert(kHD == 64 || (kHD == 80 && kFused), "heads of 64, or 80 in the fused form");
  constexpr bool kWide = kHD == 80;
  constexpr int kW = walk_rows(kHD), kS = walk_stages(kHD);  // walked rows a tile; stages
  constexpr int kWalkBytes = kW * kHD0 * 2, kWalk2Bytes = kW * kBox2 * 2;
  constexpr uint64_t kWalkStep = kWalkBytes >> 4, kWalk2Step = kWalk2Bytes >> 4;
  // an MN-major k-step of a second box: 16 rows of 32 bytes
  constexpr uint64_t kMnStep2 = 512 >> 4;
  using Smem = DkvSmem<kHD, kFused>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int k0 = blockIdx.x * kBlock;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = (a.n_q + kW - 1) / kW;
  const int64_t lbase = (static_cast<int64_t>(batch) * a.heads + head) * a.n_q;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      mbar_init(&sm.full[i], 32);
      mbar_init(&sm.empty[i], kConsumerWarps);
    }
    mbar_init(&sm.own_full, 1);
    if (kFused) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // one lane of each consumer warp (at 80: for each of the buffer's two halves)
        mbar_init(&sm.ds_full[i], kWide ? 2 * kConsumerWarps : kConsumerWarps);
        mbar_init(&sm.ds_empty[i], 4);              // one lane of each warp of the dQ warpgroup
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16 + gid;         // this thread's rows in the warpgroup: wrow, wrow + 8

  if (wg == 2) {
    // --------------------------------------- producer (and, fused, dQ) warpgroup
    // registers after setmaxnreg: 2 x 232 + 40, or, fused, 2 x 216 + 72, of 3 x 168
    // (a head of 80: 2 x 208 + 88)
    setmaxnreg_dec<kFused ? (kWide ? 88 : 72) : 40>();
    if (!kFused && warp != 0) return;
    const int* sb = kSeg ? a.segments + batch * a.m_sb : nullptr;
    // warp 0: fills the ring's stage of query tile t
    auto produce = [&](int t) {
      const int stage = t % kS;
      if (t >= kS) mbar_wait(&sm.empty[stage], (t / kS - 1) & 1);
      const int row0 = t * kW;
#pragma unroll
      for (int i = 0; i < kW / 32; ++i) {
        const int c = lane + i * 32, row = row0 + c;
        const bool ok = row < a.n_q;
        sm.l2[stage][c] = ok ? a.l2[lbase + row] : kDeadL2;
        sm.d[stage][c] = ok ? a.dvec[lbase + row] : 0.f;
        if (kSeg) sm.seg[stage][c] = ok ? sb[row] : 0;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full[stage], 2 * (kWide ? kWalkBytes + kWalk2Bytes : kWalkBytes));
        tma_load_3d(sm.q[stage], &map_q, &sm.full[stage], head * kHD, row0, batch);
        tma_load_3d(sm.dout[stage], &map_do, &sm.full[stage], head * kHD, row0, batch);
        if constexpr (kWide) {
          tma_load_3d(sm.w.q[stage], &map_q2, &sm.full[stage], head * kHD + kHD0, row0, batch);
          tma_load_3d(sm.w.dout[stage], &map_do2, &sm.full[stage], head * kHD + kHD0, row0, batch);
        }
      } else {
        mbar_arrive(&sm.full[stage]);
      }
    };
    if (tid == 2 * 128) {
      mbar_arrive_expect_tx(&sm.own_full, 2 * (kWide ? kOwnBytes + kBlock * kBox2 * 2 : kOwnBytes));
      tma_load_3d(sm.k, &map_k, &sm.own_full, head * kHD, k0, batch);
      tma_load_3d(sm.v, &map_v, &sm.own_full, head * kHD, k0, batch);
      if constexpr (kWide) {
        tma_load_3d(sm.w.k, &map_k2, &sm.own_full, head * kHD + kHD0, k0, batch);
        tma_load_3d(sm.w.v, &map_v2, &sm.own_full, head * kHD + kHD0, k0, batch);
      }
    }
    if constexpr (!kFused) {
      for (int t = 0; t < n_tiles; ++t) produce(t);
    } else {
      // Warp 0 keeps the ring kS - 1 tiles ahead.  Then, per query tile of
      // 64: dQ_tile (64 queries x 64 dims, or 80) = dS K in one chain over
      // the block's 128 keys, A = the tile's dS^T read MN-major from the
      // buffer the consumers filled, B = the block's K read MN-major; the
      // fp32 tile goes to a staging buffer and one thread adds it into dq
      // with a bulk reduce-add per box of 32 dims (and one of 16 at 80; rows
      // past N are dropped).
      constexpr int kAhead = kS - 1;
      constexpr int kPer = kStep / kW;      // walked tiles per dQ tile: 1, or 2 at 80
      const int n_dq = (n_tiles + kPer - 1) / kPer;
      if (warp == 0) {
        for (int t = 0; t < kAhead && t < n_tiles; ++t) produce(t);
      }
      const bool elected = (tid & 127) == 0;
      const uint64_t desc_k = smem_desc(sm.k, 16, 1024);
      const uint64_t desc_ds0 = smem_desc(sm.ds[0], 16, 1024);
      float dq[32];
      float dq2[kWide ? 8 : 1];              // a head of 80: dims 64-79
      mbar_wait(&sm.own_full, 0);
      for (int t = 0; t < n_dq; ++t) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (warp == 0 && kPer * t + i + kAhead < n_tiles) produce(kPer * t + i + kAhead);
        }
        const int buf = t & 1;
        mbar_wait(&sm.ds_full[buf], (t >> 1) & 1);
        const uint64_t d = desc_ds0 + buf * (kDsBytes >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlock / 16; ++kk) {
          wgmma_ss<1, 1>(dq, d + kk * kMnStep, desc_k + kk * kMnStep, kk > 0);
        }
        if constexpr (kWide) {
          const uint64_t desc_k2 = smem_desc_sw32(sm.w.k);
#pragma unroll
          for (int kk = 0; kk < kBlock / 16; ++kk) {
            wgmma_ss<1, 1>(dq2, d + kk * kMnStep, desc_k2 + kk * kMnStep2, kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        if constexpr (kWide) fence_regs(dq2);
        if (lane == 0) mbar_arrive(&sm.ds_empty[buf]);
        // the reduce that read this staging buffer, two tiles ago, is done
        if (elected) bulk_wait_read<1>();
        named_barrier_sync(1, 128);
        // 16-byte chunk c of row r at c ^ (r % 8), as a TMA load would lay it out
        float* stg = sm.dqs[buf];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int chunk = (j & 3) * 2 + (tig >> 1);
          unsigned char* p = reinterpret_cast<unsigned char*>(stg) + (j >> 2) * (kStep * 128) +
                             wrow * 128 + ((chunk ^ gid) << 4) + (tig & 1) * 8;
          *reinterpret_cast<float2*>(p) =
              make_float2(dq[4 * j + 0] * a.nat_scale, dq[4 * j + 1] * a.nat_scale);
          *reinterpret_cast<float2*>(p + 8 * 128) =
              make_float2(dq[4 * j + 2] * a.nat_scale, dq[4 * j + 3] * a.nat_scale);
        }
        if constexpr (kWide) {  // dims 64-79: plain rows of 16 fp32
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float* p = sm.w.dqs[buf] + wrow * kBox2 + j * 8 + tig * 2;
            *reinterpret_cast<float2*>(p) =
                make_float2(dq2[4 * j + 0] * a.nat_scale, dq2[4 * j + 1] * a.nat_scale);
            *reinterpret_cast<float2*>(p + 8 * kBox2) =
                make_float2(dq2[4 * j + 2] * a.nat_scale, dq2[4 * j + 3] * a.nat_scale);
          }
        }
        fence_proxy_async();
        named_barrier_sync(1, 128);
        if (elected) {
          tma_reduce_add_3d(&map_dq, stg, head * kHD, t * kStep, batch);
          tma_reduce_add_3d(&map_dq, stg + kStep * 32, head * kHD + 32, t * kStep, batch);
          if constexpr (kWide) {
            tma_reduce_add_3d(&map_dq2, sm.w.dqs[buf], head * kHD + kHD0, t * kStep, batch);
          }
          bulk_commit();
        }
      }
      if (elected) bulk_wait_read<0>();  // shared memory stays until the reduces have read it
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kFused ? (kWide ? 208 : 216) : 232>();
  const int c0 = k0 + wg * 64 + wrow;       // this thread's keys: c0 and c0 + 8
  float kbias[2];
  int segk[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = c0 + i * 8;
    const bool ok = key < a.n_kv;
    bool blocked = !ok;
    if (a.kv_blocked != nullptr && ok) blocked = a.kv_blocked[batch * a.m_sb + key] != 0;
    kbias[i] = blocked ? kNegInf : 0.f;
    if (kSeg) segk[i] = ok ? a.segments[batch * a.m_sb + key] : 0;
  }
  const float scale = a.scale;
  const int64_t row_stride = a.heads * kHD;

  // S^T then P^T then dS^T; dP^T (64 keys x kW queries); dK; dV (64 keys x 64 dims)
  float s[kW / 2], dp[kW / 2], dk[32], dv[32];
  float dk2[kWide ? 8 : 1], dv2[kWide ? 8 : 1];  // a head of 80: dims 64-79
  uint32_t pa[kW / 16][4], dsa[kW / 16][4];      // bf16 P^T and dS^T as A fragments
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  if constexpr (kWide) {
#pragma unroll
    for (int i = 0; i < 8; ++i) dk2[i] = dv2[i] = 0.f;
  }

  const uint64_t desc_k = smem_desc(sm.k + wg * 64 * kHD0, 16, 1024);
  const uint64_t desc_v = smem_desc(sm.v + wg * 64 * kHD0, 16, 1024);
  const uint64_t desc_q0 = smem_desc(sm.q[0], 16, 1024);
  const uint64_t desc_do0 = smem_desc(sm.dout[0], 16, 1024);
  // fused: this thread's first row of dS^T in buffer 0 (keys wg * 64 + wrow, + 8)
  unsigned char* ds_row = reinterpret_cast<unsigned char*>(sm.ds[0]) + (wg * 64 + wrow) * 128 +
                          tig * 4;

  // s (S^T of `stage`, done) -> P^T in place
  auto to_p = [&](int stage) {
#pragma unroll
    for (int j = 0; j < kW / 8; ++j) {
      const int c = j * 8 + tig * 2;
      const float2 l2c = *reinterpret_cast<const float2*>(&sm.l2[stage][c]);
      float b00 = kbias[0], b01 = kbias[0];  // key c0
      float b10 = kbias[1], b11 = kbias[1];  // key c0 + 8
      if (kSeg) {
        const int2 qs = *reinterpret_cast<const int2*>(&sm.seg[stage][c]);
        if (segk[0] != qs.x) b00 = kNegInf;
        if (segk[0] != qs.y) b01 = kNegInf;
        if (segk[1] != qs.x) b10 = kNegInf;
        if (segk[1] != qs.y) b11 = kNegInf;
      }
      s[4 * j + 0] = prob<kClampMode>(s[4 * j + 0] * scale + b00, l2c.x);
      s[4 * j + 1] = prob<kClampMode>(s[4 * j + 1] * scale + b01, l2c.y);
      s[4 * j + 2] = prob<kClampMode>(s[4 * j + 2] * scale + b10, l2c.x);
      s[4 * j + 3] = prob<kClampMode>(s[4 * j + 3] * scale + b11, l2c.y);
    }
  };
  // s (P^T) -> dS^T in place; dP^T must be done
  auto to_ds = [&](int stage) {
#pragma unroll
    for (int j = 0; j < kW / 8; ++j) {
      const int c = j * 8 + tig * 2;
      const float2 dc = *reinterpret_cast<const float2*>(&sm.d[stage][c]);
      s[4 * j + 0] *= dp[4 * j + 0] - dc.x;
      s[4 * j + 1] *= dp[4 * j + 1] - dc.y;
      s[4 * j + 2] *= dp[4 * j + 2] - dc.x;
      s[4 * j + 3] *= dp[4 * j + 3] - dc.y;
    }
  };
  // fused: dS^T of tile t into its buffer for the dQ warpgroup, in the
  // swizzled layout: row r, 16-byte chunk j at chunk j ^ (r % 8); r % 8 == gid
  // for both of this thread's rows.  At 80 a step fills one half (32
  // queries, chunks 4 (t & 1) ..) of buffer (t / 2) & 1, and the last step of
  // an odd count arrives for the half that no step fills (its queries lie
  // past N: their dq rows are dropped).
  auto hand_ds = [&](int t) {
    constexpr int kPer = kStep / kW;
    const int u = t / kPer, buf = u & 1, half = t % kPer;
    if (u >= 2 && half == 0) mbar_wait(&sm.ds_empty[buf], ((u >> 1) - 1) & 1);
#pragma unroll
    for (int j = 0; j < kW / 8; ++j) {
      unsigned char* p = ds_row + buf * kDsBytes + (((half * (kW / 8) + j) ^ gid) << 4);
      *reinterpret_cast<uint32_t*>(p) = dsa[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(p + 8 * 128) = dsa[j >> 1][(j & 1) * 2 + 1];
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&sm.ds_full[buf]);
      if (kPer == 2 && half == 0 && t == n_tiles - 1) mbar_arrive(&sm.ds_full[buf]);
    }
  };

  // S^T and dP^T are issued together and only S^T is waited for, so the exp2
  // pass runs under dP^T, the dS pass under P^T dO, and (fused) the dS^T
  // hand-over under dS^T Q.  Every tile ends with all its products done: ptxas
  // serialises every wgmma of a loop that carries one over its back edge
  // (C7515), and the registers (four accumulators of 32 and two sets of A
  // fragments) leave no room to defer a product to the next tile instead, nor
  // for a dQ accumulator (C7512, spills): hence dQ in the third warpgroup.
  mbar_wait(&sm.own_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kS;
    mbar_wait(&sm.full[stage], (t / kS) & 1);
    const uint64_t tq = desc_q0 + stage * kWalkStep, tdo = desc_do0 + stage * kWalkStep;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (kWide) {
      // S^T = K Q^T and dP^T = V dO^T: four k-steps on the first boxes, a
      // fifth on the second
      const uint64_t tq2 = smem_desc_sw32(sm.w.q[0]) + stage * kWalk2Step;
      const uint64_t tdo2 = smem_desc_sw32(sm.w.dout[0]) + stage * kWalk2Step;
#pragma unroll
      for (int kk = 0; kk < kHD0 / 16; ++kk) wgmma_ss<0>(s, desc_k + 2 * kk, tq + 2 * kk, kk > 0);
      wgmma_ss<0>(s, smem_desc_sw32(sm.w.k + wg * 64 * kBox2), tq2, 1);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kHD0 / 16; ++kk) wgmma_ss<0>(dp, desc_v + 2 * kk, tdo + 2 * kk, kk > 0);
      wgmma_ss<0>(dp, smem_desc_sw32(sm.w.v + wg * 64 * kBox2), tdo2, 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      to_p(stage);
      pack_a(pa, s);
      wgmma_fence();
      // dV += P^T dO: m64n64k16 on dO's first box, m64n16k16 on its second
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk) {
        wgmma_rs<1>(dv, pa[kk], tdo + kk * kMnStep, 1);
        wgmma_rs<1>(dv2, pa[kk], tdo2 + kk * kMnStep2, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);
      to_ds(stage);
      pack_a(dsa, s);
      wgmma_fence();
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk) {
        wgmma_rs<1>(dk, dsa[kk], tq + kk * kMnStep, 1);
        wgmma_rs<1>(dk2, dsa[kk], tq2 + kk * kMnStep2, 1);
      }
      wgmma_commit();
    } else {
      product_kk(s, desc_k, tq);    // S^T  = K Q^T  (keys x queries)
      product_kk(dp, desc_v, tdo);  // dP^T = V dO^T
      wgmma_wait<1>();
      fence_regs(s);
      to_p(stage);
      pack_a(pa, s);
      wgmma_fence();
      product_rs(dv, pa, tdo);  // dV += P^T dO, dO read again MN-major
      wgmma_wait<1>();
      fence_regs(dp);
      to_ds(stage);
      pack_a(dsa, s);
      wgmma_fence();
      product_rs(dk, dsa, tq);  // dK += dS^T Q, Q read again MN-major
    }
    if (kFused) hand_ds(t);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);  // this warp is done with the stage
  }
  fence_regs(dk);
  fence_regs(dv);
  const int64_t obase = static_cast<int64_t>(batch) * a.n_kv * row_stride + head * kHD;
  store_rows(dk, a.nat_scale, a.dk + obase, row_stride, c0, a.n_kv, tig);
  store_rows(dv, 1.f, a.dv + obase, row_stride, c0, a.n_kv, tig);
  if constexpr (kWide) {
    fence_regs(dk2);
    fence_regs(dv2);
    store_rows(dk2, a.nat_scale, a.dk + obase + kHD0, row_stride, c0, a.n_kv, tig);
    store_rows(dv2, 1.f, a.dv + obase + kHD0, row_stride, c0, a.n_kv, tig);
  }
}

template <typename Kernel, typename... Maps>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a,
                   const Maps&... maps) {
  smem += 1024;  // the base is rounded up to 1024 bytes
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(maps..., a);
  return cudaGetLastError();
}

// maps: q, k, v, do, the fused kernel's fp32 dq, and for a head of 80 the
// second boxes of q, k, v, do and dq
template <bool kClampMode, bool kSeg>
cudaError_t dispatch(Which which, cudaStream_t st, const CUtensorMap (&m)[10], const Args& a,
                     int batch, int hd) {
  const int rows = which == kDq ? a.n_q : a.n_kv;
  const dim3 grid((rows + kBlock - 1) / kBlock, a.heads, batch);
  if (hd == 80) {  // the stock route's fused kernel, safemax only
    if constexpr (kClampMode) {
      return cudaErrorInvalidValue;
    } else {
      return launch(flash64_dkv_kernel<80, false, kSeg, true>, grid, sizeof(DkvSmem<80, true>),
                    st, a, m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9]);
    }
  }
  if (which == kDq) {
    return launch(flash64_dq_kernel<kClampMode, kSeg>, grid, sizeof(DqSmem), st, a, m[0], m[1],
                  m[2], m[3]);
  }
  if (which == kDkv) {
    return launch(flash64_dkv_kernel<64, kClampMode, kSeg, false>, grid,
                  sizeof(DkvSmem<64, false>), st, a, m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                  m[7], m[8], m[9]);
  }
  return launch(flash64_dkv_kernel<64, kClampMode, kSeg, true>, grid, sizeof(DkvSmem<64, true>),
                st, a, m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8], m[9]);
}

int run(Which which, const void* q, const void* k, const void* v, const void* dout,
        const void* l2, const void* dvec, const void* kv_blocked, const void* segments,
        void* out0, void* out1, void* out2, int batch, int n_q, int n_kv, int heads,
        long long q_sb, long long q_sn, long long k_sb, long long k_sn, long long v_sb,
        long long v_sn, long long do_sb, long long do_sn, long long m_sb, int safemax,
        int head_dim, float sm_scale, void* stream) {
  if (batch <= 0 || n_q <= 0 || n_kv <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      (kv_blocked != nullptr && segments != nullptr) || (segments != nullptr && n_q != n_kv) ||
      !(head_dim == kHD || (head_dim == 80 && which == kDqkv && safemax != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // q, k, v, do: the block's own operand in boxes of 128 rows, the walked one
  // in boxes of 64 (32 at head_dim 80); a head of 80 also in boxes of its
  // columns 64-79
  const int walk = walk_rows(head_dim);
  const int q_box = which == kDq ? kBlock : walk, k_box = which == kDq ? kStep : kBlock;
  CUtensorMap maps[10] = {};
  int rc = 0;
  for (int pass = 0; pass < (head_dim == 80 ? 2 : 1); ++pass) {
    const int box = pass == 0 ? kHD0 : kBox2, i = 5 * pass, hd = head_dim;
    if (rc == 0) {
      rc = attention_operand_map(&maps[i], q, n_q, q_sb, q_sn, batch, heads, q_box, hd, box);
    }
    if (rc == 0) {
      rc = attention_operand_map(&maps[i + 1], k, n_kv, k_sb, k_sn, batch, heads, k_box, hd, box);
    }
    if (rc == 0) {
      rc = attention_operand_map(&maps[i + 2], v, n_kv, v_sb, v_sn, batch, heads, k_box, hd, box);
    }
    if (rc == 0) {
      rc = attention_operand_map(&maps[i + 3], dout, n_q, do_sb, do_sn, batch, heads, q_box, hd,
                                 box);
    }
    if (rc == 0 && which == kDqkv) {
      // dq (B, N, H*hd) fp32, contiguous: boxes of 64 queries x 32 dims
      // (128-byte swizzle), and at 80 one of 64 queries x 16 dims (plain rows)
      const uint64_t row_bytes = static_cast<uint64_t>(heads) * head_dim * 4;
      const uint64_t dims[3] = {static_cast<uint64_t>(heads) * head_dim, static_cast<uint64_t>(n_q),
                                static_cast<uint64_t>(batch)};
      const uint64_t strides[2] = {row_bytes, row_bytes * n_q};
      const uint32_t dq_box[2] = {box == kHD0 ? 32u : static_cast<uint32_t>(kBox2), kStep};
      rc = make_tensor_map(&maps[i + 4], out0, 3, dims, strides, dq_box,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           box == kHD0 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
    }
  }
  if (rc != 0) return rc;
  if (head_dim != 80) {  // the second boxes' places, unused at head_dim 64
    for (int i = 0; i < 5; ++i) maps[5 + i] = maps[i];
  }
  Args a;
  a.l2 = static_cast<const float*>(l2);
  a.dvec = static_cast<const float*>(dvec);
  a.kv_blocked = static_cast<const uint8_t*>(kv_blocked);
  a.segments = static_cast<const int*>(segments);
  a.dq = which == kDq ? static_cast<__nv_bfloat16*>(out0) : nullptr;
  a.dk = which == kDq ? nullptr : static_cast<__nv_bfloat16*>(out1);
  a.dv = which == kDq ? nullptr : static_cast<__nv_bfloat16*>(out2);
  a.n_q = n_q;
  a.n_kv = n_kv;
  a.heads = heads;
  a.m_sb = m_sb;
  a.scale = static_cast<float>(static_cast<double>(sm_scale) * kLog2e);  // hd^-0.5 * log2(e)
  a.nat_scale = sm_scale;                                                 // hd^-0.5
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool seg = segments != nullptr;
  cudaError_t err;
  if (safemax == 0) {
    err = seg ? dispatch<true, true>(which, st, maps, a, batch, head_dim)
              : dispatch<true, false>(which, st, maps, a, batch, head_dim);
  } else {
    err = seg ? dispatch<false, true>(which, st, maps, a, batch, head_dim)
              : dispatch<false, false>(which, st, maps, a, batch, head_dim);
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes.  q/k/v are (B, N|M, H*64) bf16 rows with
// unit stride inside a row and the given batch/row strides in elements (views
// of fused projections are fine); dout is (B, N, H*64) bf16 with its own
// strides; all four are read by TMA, so bases and strides are multiples of 8
// elements (16 bytes).  l2 and dvec are contiguous (B, H, N) fp32 (the
// forward's L2 and rowsum(do * o)); at most one of kv_blocked ((B, M) bytes)
// and segments ((B, N) int32, N == M) is given, with batch stride m_sb.
// head_dim is 64, or 80 for the fused kernel in safemax form (the stock
// route; rows are then H*80 wide); sm_scale is the true head's hd^-0.5.
// Outputs are contiguous: dq bf16 (B, N, H*hd), dk and dv bf16 (B, M, H*hd);
// the fused kernel adds dq into a zeroed, contiguous fp32 (B, N, H*hd)
// buffer.  Each returns the CUDA error of the launch (0 on success).
extern "C" int egom2p_flash64_train_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* l2, const void* dvec,
                                       const void* kv_blocked, const void* segments, void* dq,
                                       int batch, int n_q, int n_kv, int heads, long long q_sb,
                                       long long q_sn, long long k_sb, long long k_sn,
                                       long long v_sb, long long v_sn, long long do_sb,
                                       long long do_sn, long long m_sb, int safemax,
                                       int head_dim, float sm_scale, void* stream) {
  return run(kDq, q, k, v, dout, l2, dvec, kv_blocked, segments, dq, nullptr, nullptr, batch,
             n_q, n_kv, heads, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb, safemax,
             head_dim, sm_scale, stream);
}

extern "C" int egom2p_flash64_train_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* l2, const void* dvec,
                                        const void* kv_blocked, const void* segments, void* dk,
                                        void* dv, int batch, int n_q, int n_kv, int heads,
                                        long long q_sb, long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb, long long v_sn,
                                        long long do_sb, long long do_sn, long long m_sb,
                                        int safemax, int head_dim, float sm_scale, void* stream) {
  return run(kDkv, q, k, v, dout, l2, dvec, kv_blocked, segments, nullptr, dk, dv, batch, n_q,
             n_kv, heads, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb, safemax,
             head_dim, sm_scale, stream);
}

extern "C" int egom2p_flash64_train_dqkv(const void* q, const void* k, const void* v,
                                         const void* dout, const void* l2, const void* dvec,
                                         const void* kv_blocked, const void* segments,
                                         void* dq_acc, void* dk, void* dv, int batch, int n_q,
                                         int n_kv, int heads, long long q_sb, long long q_sn,
                                         long long k_sb, long long k_sn, long long v_sb,
                                         long long v_sn, long long do_sb, long long do_sn,
                                         long long m_sb, int safemax, int head_dim,
                                         float sm_scale, void* stream) {
  return run(kDqkv, q, k, v, dout, l2, dvec, kv_blocked, segments, dq_acc, dk, dv, batch, n_q,
             n_kv, heads, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, do_sb, do_sn, m_sb, safemax,
             head_dim, sm_scale, stream);
}
