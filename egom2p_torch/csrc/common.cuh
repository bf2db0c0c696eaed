// Device helpers shared by the port's kernels (sm_90a): cp.async tile loads,
// the bf16 mma.sync m16n8k16 tensor-core product, exp2 and bf16 packing.
// Header-only; every function is inline.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egom2p {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid = false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 -> one register of two bf16 (round to nearest even); `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_smem_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of one m16n8k16 k-step read from a row-major bf16 tile in
// shared memory: rows r, r + 8 and columns c .. c + 15 (r = warp row base +
// gid, c = k-step base + tig * 2 already applied by the caller's pointers).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* row0,
                                            const __nv_bfloat16* row8) {
  a[0] = ld_smem_u32(row0);
  a[1] = ld_smem_u32(row8);
  a[2] = ld_smem_u32(row0 + 8);
  a[3] = ld_smem_u32(row8 + 8);
}

}  // namespace egom2p
