// LayerNorm over the last dim, forward and backward, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses them.  In PyTorch the same formula ran as ~10 ATen kernels forward
// and ~20 backward, each a full pass over an fp32 copy of the activation,
// and autograd kept three fp32 activation-sized tensors a norm.  These
// kernels read the activation in its own dtype (bf16 or fp32) and keep the
// fp32 math in registers.
//
// Bound: bytes.  Forward reads x and writes y once (and 8 bytes a row of
// statistics); backward reads x and dy and writes dx once.  A warp owns a
// row; the row's later passes re-read it from L1, so device memory sees
// each element once.  Sums are warp shuffles in a fixed order: the results
// are deterministic.
//
// Forward (`ln_fwd_kernel`): mean, then the variance as the mean of
// (x - mean)^2 (two passes, as the plain formula), rstd = rsqrt(var + eps),
// y = (x - mean) * rstd * w + b rounded once to x's dtype; fp32 mean and
// rstd a row for the backward.
// Backward (`ln_bwd_kernel`): per row g = dy * w, xhat = (x - mean) * rstd,
// dx = rstd * (g - (sum(g) + xhat * sum(g * xhat)) / D) in x's dtype.  The
// weight's and bias's gradients (sum over rows of dy * xhat and of dy) are
// summed per warp in shared memory, per block into a partial row, and the
// partial rows by `ln_params_kernel`, all in fixed orders.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<uint32_t*>(&a);
    t.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

// One warp a row; lane l holds columns [c, c + VEC) for c = l*VEC + k*32*VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int rows, int dim, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * dim;
  T* yr = y + row * dim;
  const float inv_dim = 1.0f / static_cast<float>(dim);
  float v[VEC];

  float s = 0.f;
#pragma unroll 4
  for (int c = lane * VEC; c < dim; c += 32 * VEC) {
    load<VEC>(xr + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += v[i];
  }
  const float mean = warp_sum(s) * inv_dim;

  float q = 0.f;
#pragma unroll 4
  for (int c = lane * VEC; c < dim; c += 32 * VEC) {
    load<VEC>(xr + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = v[i] - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) * inv_dim + eps);

  float wv[VEC], bv[VEC];
#pragma unroll 4
  for (int c = lane * VEC; c < dim; c += 32 * VEC) {
    load<VEC>(xr + c, v);
    load<VEC>(w + c, wv);
    if (b != nullptr) {
      load<VEC>(b + c, bv);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) bv[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = (v[i] - mean) * rstd * wv[i] + bv[i];
    store<VEC>(yr + c, v);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// `warps` warps a block, each walking rows warp_id, warp_id + total warps, ...;
// dynamic shared memory: the per-warp sums of dy * xhat and dy, 2 x warps x dim
// floats.  Writes the block's sums to partial[blockIdx.x] and
// partial[gridDim.x + blockIdx.x].
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
              T* __restrict__ dx, float* __restrict__ partial, int rows, int dim) {
  extern __shared__ float acc[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc_w = acc + warp * dim;            // this warp's sum of dy * xhat
  float* acc_b = acc + (warps + warp) * dim;  // ... and of dy
  for (int c = lane; c < dim; c += 32) {
    acc_w[c] = 0.f;
    acc_b[c] = 0.f;
  }
  __syncwarp();
  const float inv_dim = 1.0f / static_cast<float>(dim);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  float xv[VEC], gv[VEC], wv[VEC], aw[VEC], ab[VEC];
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * warps + warp; row < rows;
       row += stride) {
    const T* xr = x + row * dim;
    const T* dyr = dy + row * dim;
    const float mean = mean_in[row], rstd = rstd_in[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
    for (int c = lane * VEC; c < dim; c += 32 * VEC) {
      load<VEC>(xr + c, xv);
      load<VEC>(dyr + c, gv);
      load<VEC>(w + c, wv);
      load<VEC>(acc_w + c, aw);
      load<VEC>(acc_b + c, ab);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - mean) * rstd;
        aw[i] += gv[i] * xhat;
        ab[i] += gv[i];
        const float g = gv[i] * wv[i];
        s1 += g;
        s2 += g * xhat;
      }
      store<VEC>(acc_w + c, aw);
      store<VEC>(acc_b + c, ab);
    }
    s1 = warp_sum(s1) * inv_dim;
    s2 = warp_sum(s2) * inv_dim;
    T* dxr = dx + row * dim;
#pragma unroll 2
    for (int c = lane * VEC; c < dim; c += 32 * VEC) {
      load<VEC>(xr + c, xv);
      load<VEC>(dyr + c, gv);
      load<VEC>(w + c, wv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - mean) * rstd;
        gv[i] = rstd * (gv[i] * wv[i] - (s1 + xhat * s2));
      }
      store<VEC>(dxr + c, gv);
    }
  }
  __syncthreads();
  float* pw = partial + static_cast<int64_t>(blockIdx.x) * dim;
  float* pb = partial + static_cast<int64_t>(gridDim.x + blockIdx.x) * dim;
  for (int c = threadIdx.x; c < dim; c += blockDim.x) {
    float sw = 0.f, sb = 0.f;
    for (int k = 0; k < warps; ++k) {
      sw += acc[k * dim + c];
      sb += acc[(warps + k) * dim + c];
    }
    pw[c] = sw;
    pb[c] = sb;
  }
}

// dw[c] = sum over the n partial rows of partial[r][c]; db from the next n
// rows (skipped when db is null).  A block takes 32 columns; its 8 warps sum
// every 8th partial row, then warp 0 adds the 8 sums in order.
__global__ void __launch_bounds__(256)
ln_params_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                 float* __restrict__ db, int n, int dim) {
  __shared__ float sums[2][8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float sw = 0.f, sb = 0.f;
  if (c < dim) {
    for (int r = warp; r < n; r += 8) {
      sw += partial[static_cast<int64_t>(r) * dim + c];
      sb += partial[static_cast<int64_t>(n + r) * dim + c];
    }
  }
  sums[0][warp][lane] = sw;
  sums[1][warp][lane] = sb;
  __syncthreads();
  if (warp == 0 && c < dim) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      tw += sums[0][k][lane];
      tb += sums[1][k][lane];
    }
    dw[c] = tw;
    if (db != nullptr) db[c] = tb;
  }
}

template <typename T, int VEC>
int launch_fwd(const void* x, const void* w, const void* b, void* y, void* mean, void* rstd,
               int rows, int dim, float eps, cudaStream_t st) {
  const int blocks = (rows + kFwdWarps - 1) / kFwdWarps;
  ln_fwd_kernel<T, VEC><<<blocks, kFwdWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), rows, dim, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd(const void* dy, const void* x, const void* w, const void* mean,
               const void* rstd, void* dx, void* partial, void* dw, void* db, int rows,
               int dim, int blocks, int warps, cudaStream_t st) {
  const size_t smem = 2ull * warps * dim * sizeof(float);
  auto kern = ln_bwd_kernel<T, VEC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<blocks, warps * 32, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, dim);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_params_kernel<<<(dim + 31) / 32, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), static_cast<float*>(db),
      blocks, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (rows, dim) contiguous in one dtype (0: fp32, 1: bf16); w, b (dim,)
// fp32, b may be null; mean, rstd (rows,) fp32.  `vec` 4 needs dim % 4 == 0
// and 4-element-aligned pointers, else 1.
extern "C" int egom2p_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                     void* mean, void* rstd, int rows, int dim, float eps,
                                     int dtype, int vec, void* stream) {
  if (rows <= 0 || dim <= 0 || (vec != 1 && vec != 4) || (vec == 4 && dim % 4 != 0) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec == 4 ? launch_fwd<float, 4>(x, w, b, y, mean, rstd, rows, dim, eps, st)
                    : launch_fwd<float, 1>(x, w, b, y, mean, rstd, rows, dim, eps, st);
  }
  return vec == 4 ? launch_fwd<__nv_bfloat16, 4>(x, w, b, y, mean, rstd, rows, dim, eps, st)
                  : launch_fwd<__nv_bfloat16, 1>(x, w, b, y, mean, rstd, rows, dim, eps, st);
}

// dy, x, dx (rows, dim) contiguous in one dtype; w (dim,), mean, rstd (rows,)
// fp32; partial (2 * blocks, dim) fp32 scratch; dw, db (dim,) fp32, db may be
// null.  `blocks` blocks of `warps` warps (2 * warps * dim floats of shared
// memory a block).
extern "C" int egom2p_layer_norm_bwd(const void* dy, const void* x, const void* w,
                                     const void* mean, const void* rstd, void* dx,
                                     void* partial, void* dw, void* db, int rows, int dim,
                                     int blocks, int warps, int dtype, int vec, void* stream) {
  if (rows <= 0 || dim <= 0 || blocks <= 0 || warps <= 0 || warps > 8 ||
      (vec != 1 && vec != 4) || (vec == 4 && dim % 4 != 0) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec == 4 ? launch_bwd<float, 4>(dy, x, w, mean, rstd, dx, partial, dw, db, rows,
                                           dim, blocks, warps, st)
                    : launch_bwd<float, 1>(dy, x, w, mean, rstd, dx, partial, dw, db, rows,
                                           dim, blocks, warps, st);
  }
  return vec == 4 ? launch_bwd<__nv_bfloat16, 4>(dy, x, w, mean, rstd, dx, partial, dw, db,
                                                 rows, dim, blocks, warps, st)
                  : launch_bwd<__nv_bfloat16, 1>(dy, x, w, mean, rstd, dx, partial, dw, db,
                                                 rows, dim, blocks, warps, st);
}
