// Forward attention at head_dim 64 and 80 for Hopper (sm_90a), non-causal,
// for inference and for training: wgmma, TMA, warp-specialised.  Called from
// egom2p_torch/ops/flash64.py (inference), egom2p_torch/ops/flash64_train.py
// (training forward) and egom2p_torch/ops/flash_attention.py (the stock
// route, through flash64_train.py's launcher: heads of up to 64 at 64, heads
// of 65..80 zero-padded to 80, EgoM2P-large's 68 among them).
//
// Replaces four Pallas TPU kernels, all one template here:
//   * egom2p_tpu/ops/flash64.py `_kernel_noshift` (clamp-only softmax, the
//     default) and `_kernel` (running-max "safemax" softmax), both reached
//     through `flash64_attention` -> `pl.pallas_call`: SAFEMAX selects;
//   * egom2p_tpu/ops/flash64_train.py `_fwd_kernel`, the training forward:
//     the same math plus the per-row L2 output (L2 = true) and the segment
//     mask mode (SEG = true);
//   * the forward of the stock jax.experimental.pallas.ops.tpu
//     flash_attention, reached through egom2p_tpu/ops/flash_attention.py
//     `segment_flash_attention` / `padding_flash_attention`: the safemax
//     training instance with the true head's scale, at head width 64 or 80
//     (kHD; zero columns change no score and give zero output columns).
//
// Math (identical to the TPU kernels):
//   s = fp32(q . k) * (hd^-0.5 * log2 e) + bias,   bias = -1e30 where blocked
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
// What bounds it on this card: two units of the SM, equally.  A score costs
// 4 * 64 = 256 tensor-core FLOPs (Q K^T and P V) and one exp2 on the special
// function unit.  An SM does 16 exp2 a clock and, at the data sheet's 989
// TFLOP/s, 3,800-4,300 dense bf16 FLOPs a clock (1.98-1.75 GHz), so both
// take about 1/16 clock a score: at B*H = 96, N = M = 8704 the tensor bound
// is 1.88 ms and the exp2 bound 1.74 ms at 1980 MHz (1.96 ms at 1755).
// q/k/v/o bytes are 15x below either (K and V of a (batch, head) pair are
// 0.5-2.2 MB and stay in L2 while its query tiles run).  Half the tensor
// peak is therefore the ceiling unless the two overlap perfectly.
//
// What the design does about it:
//   * a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, and one producer warp.  Keys go by in tiles
//     of 128.  S = Q K^T is wgmma m64n128k16 with Q and K read from shared
//     memory by descriptor (K-major tiles, 128-byte swizzle), O += P V is
//     wgmma m64n64k16 with P from registers (the S accumulator re-packed as
//     the A fragment, so P never touches shared memory) and V as an MN-major
//     tile.  K and V leave shared memory once per 64 query rows, read by the
//     tensor cores, not by load instructions.
//   * the producer warp keeps a ring of 4 K/V stages full by TMA (tensor maps
//     over the strided q/k/v views; rows past N or M arrive as zeros), each
//     stage with a "full" and an "empty" mbarrier; it also writes the stage's
//     mask bias (and segment ids) and a flag that says whether the tile has
//     any blocked key, so that unmasked tiles skip the bias.  setmaxnreg
//     moves its registers to the consumers (40 / 232).
//   * in a consumer, tile t's S product is issued before tile t-1's P V and
//     its exp2 pass runs while that P V is in flight (one wgmma group
//     pending), so the tensor cores and the SFU work at the same time; the
//     two warpgroups interleave on top of that.
// Shared memory: 16 KB (Q) + 4 x 32 KB (K, V) + 4 KB of mask rows, one block
// per SM.  ptxas (CUDA 12.8): 168 registers at launch for every instance, no
// spills, no remark about serialised wgmma; 24 HGMMA instructions in each
// instance's SASS.  On an H100 (700 W): 3.6-3.7 ms at 8704^2 with key
// padding (clamp), 4.2 ms safemax, 0.25 ms for the training forward at
// 2048^2, about half of the tensor bound.
//
// A head of 80 (kHD = 80; the stock route's safemax L2 instances): a row of
// 160 bytes fits no 128-byte swizzle atom, so every tile of Q, K and V is two
// TMA boxes, columns 0-63 with the 128-byte swizzle as above and columns
// 64-79 as 32-byte rows with the 32-byte swizzle, each with its own tensor
// map and descriptors.  S = Q K^T takes four k-steps on the first box and a
// fifth on the second; O += P V takes m64n64k16 on V's first box and
// m64n16k16 on its second with the same P fragments, so O is 40 registers
// instead of 32.  Shared memory 186 KB.  The alternative, packing heads to
// 96 or 128 columns, would cost 20% or 60% more tensor work for the same
// bound.  On an H100 (700 W) at 15 heads of 68 packed to 80, B = 8, 2048^2,
// key padding: 0.42 ms, against 0.76 for the earlier mma.sync kernel and 0.63
// for cuDNN's forward on the same padded heads.
//
// The kernel masks its own ragged edges, reads q/k/v through a row stride and
// a batch stride each (they may be views of a fused qkv or kv projection; TMA
// needs 16-byte aligned bases and strides), allocates nothing, and runs on
// the caller's stream.

#include "hopper.cuh"

namespace {

using namespace egom2p;

constexpr int kBox = 64;                     // columns of a head's first (128-byte) box
constexpr int kBox2 = 16;                    // a head of 80: columns of its second box
constexpr int kBlockQ = 128;                 // query rows per block: 2 warpgroups x 64
constexpr int kBlockK = 128;                 // keys per stage
constexpr int kStages = 4;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;                // 2 consumer warpgroups + the producer's
constexpr int kTileBytes = kBlockK * kBox * 2;
constexpr int kTile2Bytes = kBlockK * kBox2 * 2;
constexpr float kNegInf = -1e30f;
constexpr float kDeadRow = -5e29f;           // kNegInf * 0.5: safemax dead-row threshold
constexpr float kDeadL2 = 1e30f;             // L2 of a row with no live key
constexpr float kClamp = 80.f;
constexpr double kLog2e = 1.4426950408889634;

// Columns 64-79 of a head of 80: the second box of each tile, 32-byte rows.
template <int kHD>
struct Wide {};
template <>
struct alignas(1024) Wide<80> {
  __nv_bfloat16 q[kBlockQ * kBox2];
  __nv_bfloat16 k[kStages][kBlockK * kBox2];
  __nv_bfloat16 v[kStages][kBlockK * kBox2];
};

template <int kHD>
struct Smem {
  __nv_bfloat16 q[kBlockQ * kBox];           // tiles first: each a multiple of 1024 bytes
  __nv_bfloat16 k[kStages][kBlockK * kBox];
  __nv_bfloat16 v[kStages][kBlockK * kBox];
  float bias[kStages][kBlockK];
  int seg[kStages][kBlockK];
  int masked[kStages];                       // the stage's tile has a blocked key
  uint64_t full[kStages], empty[kStages], q_full;
  Wide<kHD> w;
};
template <int kHD>
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem<kHD>)) + 1024;  // base rounded up to 1024

struct FwdArgs {
  const uint8_t* kv_blocked;
  const int* segments;
  __nv_bfloat16* out;
  float* l2;
  int n_q, n_kv;
  int64_t m_sb, o_sb, o_sn;
  float scale;  // hd^-0.5 * log2(e)
};

// HD: the head's width, 64 or 80 (map_q2 .. map_v2: the second boxes of a
// head of 80, unused at 64).  SAFEMAX: running-max softmax.  SEG: block where
// segments[q] != segments[k] (self-attention; `segments` is then the (B, N)
// int32 ids).  L2: write the per-row log-sum for the training backward.
template <int kHD, bool kSafemax, bool kSeg, bool kL2>
__global__ void __launch_bounds__(kThreads, 1)
    flash64_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_q2,
                       const __grid_constant__ CUtensorMap map_k2,
                       const __grid_constant__ CUtensorMap map_v2, const FwdArgs a) {
  static_assert(kHD == 64 || kHD == 80, "heads of 64 or 80");
  constexpr bool kWide = kHD == 80;
  extern __shared__ unsigned char smem_raw[];
  Smem<kHD>& sm =
      *reinterpret_cast<Smem<kHD>*>(smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int n_tiles = (a.n_kv + kBlockK - 1) / kBlockK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 32);               // the producer warp's lanes (+ the TMA bytes)
      mbar_init(&sm.empty[i], kConsumerWarps);  // one lane of each consumer warp
    }
    mbar_init(&sm.q_full, 1);
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
      mbar_arrive_expect_tx(&sm.q_full, kBlockQ * kHD * 2);
      tma_load_3d(sm.q, &map_q, &sm.q_full, head * kHD, q0, batch);
      if constexpr (kWide) tma_load_3d(sm.w.q, &map_q2, &sm.q_full, head * kHD + kBox, q0, batch);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kStages;
      if (t >= kStages) mbar_wait(&sm.empty[stage], (t / kStages - 1) & 1);
      const int k0 = t * kBlockK;
      bool any = false;
#pragma unroll
      for (int i = 0; i < kBlockK / 32; ++i) {
        const int c = lane + i * 32, key = k0 + c;
        const bool blocked = key >= a.n_kv || (mb != nullptr && mb[key] != 0);
        sm.bias[stage][c] = blocked ? kNegInf : 0.f;
        if (kSeg) sm.seg[stage][c] = key < a.n_kv ? sb[key] : 0;
        any |= blocked;
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        sm.masked[stage] = (any || kSeg) ? 1 : 0;
        mbar_arrive_expect_tx(&sm.full[stage], 2 * (kWide ? kTileBytes + kTile2Bytes : kTileBytes));
        tma_load_3d(sm.k[stage], &map_k, &sm.full[stage], head * kHD, k0, batch);
        tma_load_3d(sm.v[stage], &map_v, &sm.full[stage], head * kHD, k0, batch);
        if constexpr (kWide) {
          tma_load_3d(sm.w.k[stage], &map_k2, &sm.full[stage], head * kHD + kBox, k0, batch);
          tma_load_3d(sm.w.v[stage], &map_v2, &sm.full[stage], head * kHD + kBox, k0, batch);
        }
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
  int seg_q[2] = {0, 0};
  if (kSeg) {
    const int* sb = a.segments + batch * a.m_sb;
    seg_q[0] = r0 < a.n_q ? sb[r0] : 0;
    seg_q[1] = r0 + 8 < a.n_q ? sb[r0 + 8] : 0;
  }
  const float scale = a.scale;

  float o[32];     // O: 64 rows x 64 dims per warpgroup
  float o2[kWide ? 8 : 1];  // a head of 80: its dims 64-79
  float s[64];     // S, then P in fp32: 64 rows x 128 keys
  uint32_t p[8][4];  // bf16 P as the A fragments of the 8 k-steps over the tile's keys
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  if constexpr (kWide) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o2[i] = 0.f;
  }
  float row_l[2] = {0.f, 0.f};           // rows gid, gid + 8: this thread's partial sums
  float row_m[2] = {kNegInf, kNegInf};   // safemax running max (quad-uniform)

  const uint64_t desc_q = smem_desc(sm.q + wg * 64 * kBox, 16, 1024);
  const uint64_t desc_k0 = smem_desc(sm.k[0], 16, 1024);
  const uint64_t desc_v0 = smem_desc(sm.v[0], 16, 1024);
  constexpr uint64_t kStageStep = kTileBytes >> 4;
  constexpr uint64_t kStageStep2 = kTile2Bytes >> 4;

  // S = Q K^T over the 4 k-steps of head_dim (32 bytes of a row each); a head
  // of 80 adds a fifth on the second boxes (a whole 32-byte row)
  auto issue_s = [&](int stage) {
    const uint64_t dk = desc_k0 + stage * kStageStep;
#pragma unroll
    for (int kk = 0; kk < kBox / 16; ++kk) wgmma_ss<0>(s, desc_q + 2 * kk, dk + 2 * kk, kk > 0);
    if constexpr (kWide) {
      wgmma_ss<0>(s, smem_desc_sw32(sm.w.q + wg * 64 * kBox2),
                  smem_desc_sw32(sm.w.k[0]) + stage * kStageStep2, 1);
    }
    wgmma_commit();
  };
  // O += P V over the 8 k-steps of the tile's keys (16 rows of 128 bytes each;
  // of 32 bytes in V's second box)
  auto issue_pv = [&](int stage) {
    const uint64_t dv = desc_v0 + stage * kStageStep;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) wgmma_rs<1>(o, p[kk], dv + kk * (2048 >> 4), 1);
    if constexpr (kWide) {
      const uint64_t dv2 = smem_desc_sw32(sm.w.v[0]) + stage * kStageStep2;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) wgmma_rs<1>(o2, p[kk], dv2 + kk * (512 >> 4), 1);
    }
    wgmma_commit();
  };
  // s -> p (fp32, in place), the row sums and, in safemax mode, the running
  // max; alpha is the factor that the earlier tiles' O takes.
  auto softmax = [&](int stage, float (&alpha)[2]) {
    if (sm.masked[stage] != 0) {
      // scale, then the mask bias (the TPU kernel's order)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = j * 8 + tig * 2;
        const float2 b = *reinterpret_cast<const float2*>(&sm.bias[stage][c]);
        float b00 = b.x, b01 = b.y;  // row gid
        float b10 = b.x, b11 = b.y;  // row gid + 8
        if (kSeg) {
          const int2 ks = *reinterpret_cast<const int2*>(&sm.seg[stage][c]);
          if (seg_q[0] != ks.x) b00 = kNegInf;
          if (seg_q[0] != ks.y) b01 = kNegInf;
          if (seg_q[1] != ks.x) b10 = kNegInf;
          if (seg_q[1] != ks.y) b11 = kNegInf;
        }
        s[4 * j + 0] = s[4 * j + 0] * scale + b00;
        s[4 * j + 1] = s[4 * j + 1] * scale + b01;
        s[4 * j + 2] = s[4 * j + 2] * scale + b10;
        s[4 * j + 3] = s[4 * j + 3] * scale + b11;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= scale;
    }
    if (kSafemax) {
      float mx0 = row_m[0], mx1 = row_m[1];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // alpha = 0 once a live key lifts m above the -1e30 of a blocked prefix,
      // which washes out that prefix's exp2(0) = 1 garbage
      alpha[0] = exp2_approx(row_m[0] - mx0);
      alpha[1] = exp2_approx(row_m[1] - mx1);
      row_m[0] = mx0;
      row_m[1] = mx1;
      row_l[0] *= alpha[0];
      row_l[1] *= alpha[1];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j + 0] = exp2_approx(s[4 * j + 0] - mx0);
        s[4 * j + 1] = exp2_approx(s[4 * j + 1] - mx0);
        s[4 * j + 2] = exp2_approx(s[4 * j + 2] - mx1);
        s[4 * j + 3] = exp2_approx(s[4 * j + 3] - mx1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = exp2_approx(fminf(s[i], kClamp));
    }
    // l from the fp32 p, before the bf16 rounding
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      row_l[0] += s[4 * j + 0] + s[4 * j + 1];
      row_l[1] += s[4 * j + 2] + s[4 * j + 3];
    }
  };
  // The S fragments of keys 16kk..16kk+15 (column tiles 2kk, 2kk+1) are
  // exactly the A fragment of P V's k-step kk.
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  float alpha[2] = {1.f, 1.f};
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, alpha);  // O is still zero: no rescale
  pack_p();

  for (int t = 1; t < n_tiles; ++t) {
    const int stage = t % kStages, prev = (t - 1) % kStages;
    mbar_wait(&sm.full[stage], (t / kStages) & 1);
    fence_regs(s);
    fence_regs(o);
    if constexpr (kWide) fence_regs(o2);
    wgmma_fence();
    issue_s(stage);   // tile t's scores ...
    issue_pv(prev);   // ... ahead of tile t-1's P V
    wgmma_wait<1>();  // S is there; P V runs on under the exp2 pass
    fence_regs(s);
    softmax(stage, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (kWide) fence_regs(o2);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);  // this warp is done with stage prev
    if (kSafemax) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 0] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      if constexpr (kWide) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          o2[4 * j + 0] *= alpha[0];
          o2[4 * j + 1] *= alpha[0];
          o2[4 * j + 2] *= alpha[1];
          o2[4 * j + 3] *= alpha[1];
        }
      }
    }
    pack_p();
  }
  fence_regs(o);
  if constexpr (kWide) fence_regs(o2);
  wgmma_fence();
  issue_pv((n_tiles - 1) % kStages);
  wgmma_wait<0>();
  fence_regs(o);
  if constexpr (kWide) fence_regs(o2);

  // Row sums across the quad that shares a row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 1);
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= a.n_q) continue;
    const bool live = kSafemax ? row_m[i] > kDeadRow : row_l[i] > 0.f;
    const float denom = row_l[i] > 0.f ? row_l[i] : 1.f;
    __nv_bfloat16* orow = a.out + batch * a.o_sb + row * a.o_sn + head * kHD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = live ? o[4 * j + 2 * i] / denom : 0.f;
      const float x1 = live ? o[4 * j + 2 * i + 1] / denom : 0.f;
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tig * 2) = pack_bf16(x0, x1);
    }
    if constexpr (kWide) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x0 = live ? o2[4 * j + 2 * i] / denom : 0.f;
        const float x1 = live ? o2[4 * j + 2 * i + 1] / denom : 0.f;
        *reinterpret_cast<uint32_t*>(orow + kBox + j * 8 + tig * 2) = pack_bf16(x0, x1);
      }
    }
    if (kL2 && tig == 0) {
      const float lse = (kSafemax ? row_m[i] : 0.f) + log2f(denom);
      a.l2[(static_cast<int64_t>(batch) * gridDim.y + head) * a.n_q + row] = live ? lse : kDeadL2;
    }
  }
}

struct Operand {
  const void* ptr;
  int rows;
  long long batch_stride, row_stride;  // elements
};

template <int kHD, bool kSafemax, bool kSeg, bool kL2>
cudaError_t launch_fwd(dim3 grid, cudaStream_t st, const CUtensorMap (&maps)[6], const FwdArgs& a) {
  auto kernel = flash64_fwd_kernel<kHD, kSafemax, kSeg, kL2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<kHD>);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes<kHD>, st>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                  maps[5], a);
  return cudaGetLastError();
}

// Checks the shapes, builds the tensor maps (three, or six for a head of 80)
// and launches the instance.  A head of 80 has the stock route's instances
// only: safemax with L2.
int run(const void* q, const void* k, const void* v, const void* kv_blocked, const void* segments,
        void* out, void* l2, int batch, int n_q, int n_kv, int heads, long long q_sb,
        long long q_sn, long long k_sb, long long k_sn, long long v_sb, long long v_sn,
        long long m_sb, long long o_sb, long long o_sn, bool safemax, bool want_l2,
        double sm_scale, int hd, void* stream) {
  if (batch <= 0 || n_q <= 0 || n_kv <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      (kv_blocked != nullptr && segments != nullptr) || (segments != nullptr && n_q != n_kv) ||
      (want_l2 && l2 == nullptr) || (hd != 64 && hd != 80) ||
      (hd == 80 && !(safemax && want_l2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[6];
  const Operand ops[3] = {{q, n_q, q_sb, q_sn}, {k, n_kv, k_sb, k_sn}, {v, n_kv, v_sb, v_sn}};
  for (int i = 0; i < 3; ++i) {
    static_assert(kBlockQ == kBlockK, "one box shape for q, k and v");
    int rc = attention_operand_map(&maps[i], ops[i].ptr, ops[i].rows, ops[i].batch_stride,
                                   ops[i].row_stride, batch, heads, kBlockQ, hd, kBox);
    // a head of 64 passes its maps again in the second boxes' places, unused
    if (rc == 0 && hd == 80) {
      rc = attention_operand_map(&maps[3 + i], ops[i].ptr, ops[i].rows, ops[i].batch_stride,
                                 ops[i].row_stride, batch, heads, kBlockQ, hd, kBox2);
    } else {
      maps[3 + i] = maps[i];
    }
    if (rc != 0) return rc;
  }
  FwdArgs a;
  a.kv_blocked = static_cast<const uint8_t*>(kv_blocked);
  a.segments = static_cast<const int*>(segments);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.l2 = static_cast<float*>(l2);
  a.n_q = n_q;
  a.n_kv = n_kv;
  a.m_sb = m_sb;
  a.o_sb = o_sb;
  a.o_sn = o_sn;
  a.scale = static_cast<float>(sm_scale * kLog2e);
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool seg = segments != nullptr;
  cudaError_t err;
  if (hd == 80) {
    err = seg ? launch_fwd<80, true, true, true>(grid, st, maps, a)
              : launch_fwd<80, true, false, true>(grid, st, maps, a);
  } else if (!want_l2) {
    err = safemax ? launch_fwd<64, true, false, false>(grid, st, maps, a)
                  : launch_fwd<64, false, false, false>(grid, st, maps, a);
  } else if (safemax) {
    err = seg ? launch_fwd<64, true, true, true>(grid, st, maps, a)
              : launch_fwd<64, true, false, true>(grid, st, maps, a);
  } else {
    err = seg ? launch_fwd<64, false, true, true>(grid, st, maps, a)
              : launch_fwd<64, false, false, true>(grid, st, maps, a);
  }
  return static_cast<int>(err);
}

}  // namespace

// C entry points, bound with ctypes.  Strides are in elements; q/k/v/out rows
// are head_dim * H wide with unit stride inside a row; q/k/v bases and
// strides are multiples of 8 elements (16 bytes, for TMA).  Both return the
// CUDA error of the launch (0 on success).

// Inference.  kv_blocked is (B, M) bytes (nonzero = blocked) with batch
// stride m_sb, or null.
extern "C" int egom2p_flash64_fwd(const void* q, const void* k, const void* v,
                                  const void* kv_blocked, void* out, int batch, int n_q, int n_kv,
                                  int heads, long long q_sb, long long q_sn, long long k_sb,
                                  long long k_sn, long long v_sb, long long v_sn, long long m_sb,
                                  long long o_sb, long long o_sn, int safemax, void* stream) {
  return run(q, k, v, kv_blocked, nullptr, out, nullptr, batch, n_q, n_kv, heads, q_sb, q_sn, k_sb,
             k_sn, v_sb, v_sn, m_sb, o_sb, o_sn, safemax != 0, false, 0.125, 64, stream);
}

// Training forward at head_dim 64, and the stock route's at 64 or 80 (80:
// safemax only).  At most one of kv_blocked ((B, M) bytes) and segments
// ((B, N) int32 ids, N == M) is given, with batch stride m_sb.  l2 is a
// contiguous (B, H, N) fp32 output.  sm_scale is the natural scale, the true
// head's hd^-0.5.
extern "C" int egom2p_flash64_train_fwd(const void* q, const void* k, const void* v,
                                        const void* kv_blocked, const void* segments, void* out,
                                        void* l2, int batch, int n_q, int n_kv, int heads,
                                        long long q_sb, long long q_sn, long long k_sb,
                                        long long k_sn, long long v_sb, long long v_sn,
                                        long long m_sb, long long o_sb, long long o_sn,
                                        int safemax, int head_dim, float sm_scale, void* stream) {
  return run(q, k, v, kv_blocked, segments, out, l2, batch, n_q, n_kv, heads, q_sb, q_sn, k_sb,
             k_sn, v_sb, v_sn, m_sb, o_sb, o_sn, safemax != 0, true,
             static_cast<double>(sm_scale), head_dim, stream);
}
