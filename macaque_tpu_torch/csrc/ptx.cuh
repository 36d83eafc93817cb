// The PTX pieces the port's tensor-core kernels share: cp.async staging,
// ldmatrix fragment loads and the bf16 mma.sync. Included by
// attention_core.cuh (K1, K4), int8_matmul.cu (K5b), swin_block.cu (K6),
// window_attention.cu (K3) and roi_align_windowed.cu (K2).
//
// One ldmatrix scheme serves bf16 and s8 operands alike: ldmatrix reads
// 8 x 8 matrices of 16-bit words, 16 bytes a row, and gives lane l the
// 32-bit word l % 4 of row l / 4. That is the m16n8k16 bf16 fragment layout
// (row g = lane / 4, columns 2t, 2t + 1) and equally the m16n8k32 s8 one
// (row g, bytes 4t .. 4t + 3), so an x4 load of 16-byte rows gives either
// type's A fragment (rows +0 / +8 times bytes +0 / +16) or two n8 tiles'
// B fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

// as cp_async16, or 16 zero bytes (nothing read) where !full
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(full ? 16 : 0));
}

// 4 bytes global -> shared (cached in L1 too: .cg takes only 16)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two matrices; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16_rn(x), lo = bf16_rn(x - hi), packed as two A-fragment
// registers: hi + lo carries x to 16 significant bits (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane offsets of an x4 ldmatrix, in 16-byte units of a row (8 bf16 or 16
// s8): (row, column) for the A fragment of an m16 tile -- matrices (rows +0,
// +8) x (columns +0, +1) -- and for the B fragments of two n8 tiles stored
// (n, k) row-major -- matrices (n +0, k +0), (n +0, k +1), (n +8, k +0),
// (n +8, k +1). An x2 load with the B offsets gives one n8 tile.
__device__ __forceinline__ int ldsm_a_row(int lane) { return ((lane >> 3) & 1) * 8 + (lane & 7); }
__device__ __forceinline__ int ldsm_a_col(int lane) { return lane >> 4; }
__device__ __forceinline__ int ldsm_b_row(int lane) { return (lane >> 4) * 8 + (lane & 7); }
__device__ __forceinline__ int ldsm_b_col(int lane) { return (lane >> 3) & 1; }

}  // namespace
