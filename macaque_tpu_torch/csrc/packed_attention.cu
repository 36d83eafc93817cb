// Packed multi-head attention for the ViTPose blocks.
//
// Replaces macaque_tpu/nn/pallas_attention.py::fused_attention_packed
// (_attn_kernel_packed): softmax(Q K^T / sqrt(d)) V computed directly on the
// packed qkv Dense output (B, N, 3C) bf16, written as (B, N, C) bf16 with head
// h at columns [h*d, (h+1)*d) -- the layout the output projection reads.
//
// What bounds it on an H100: at ViTPose-huge shapes (N = 192, d = 80) one
// (sequence, head) reads 3*N*d*2 = 92 KB, writes N*d*2 = 31 KB and does
// 2*2*N*N*d = 11.8 MFLOP, about 96 FLOP per byte -- below the ~295 FLOP/byte
// at which the bf16 tensor cores, not HBM, become the limit. So it is bound by
// bytes: the design reads each input byte from HBM once and keeps the N x N
// score tile out of HBM altogether.
//
// Design: one block per (sequence, head). The block stages that head's Q and K
// panels (row-major) and V^T in shared memory (~97 KB, dynamic shared memory).
// Each warp owns 16-row query tiles: S = Q K^T runs on mma.sync m16n8k16 bf16
// with f32 accumulation, the row softmax runs in f32 on the accumulators in
// registers, and the normalised probabilities, rounded to bf16 as the TPU
// kernel rounds them, feed P V as the A operand without leaving registers.
// Row strides are padded so that every fragment load is free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

template <int N, int D>
struct AttnShape {
  static_assert(N % 16 == 0 && D % 16 == 0, "N and d must be multiples of 16");
  static constexpr int kRowStride = D + 8;  // Q, K rows, in bf16 elements
  static constexpr int kVtStride = N + 8;   // V^T rows, in bf16 elements
  static constexpr int kSmemBytes = (2 * N * kRowStride + D * kVtStride) * 2;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int N, int D>
__global__ void __launch_bounds__(kWarps * 32)
packed_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ out, int heads,
                        float scale) {
  using S = AttnShape<N, D>;
  constexpr int RS = S::kRowStride;
  constexpr int VS = S::kVtStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + N * RS;
  __nv_bfloat16* sVt = sK + N * RS;

  const int C = heads * D;
  const int seq = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const __nv_bfloat16* src0 = qkv + (size_t)seq * N * 3 * C + h * D;

  // stage Q, K and V^T: 16-byte vectors, neighbouring threads on
  // neighbouring addresses of one row
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < N * kVec; idx += blockDim.x) {
    const int n = idx / kVec;
    const int c8 = (idx % kVec) * 8;
    const __nv_bfloat16* src = src0 + (size_t)n * 3 * C + c8;
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    const uint4 k = *reinterpret_cast<const uint4*>(src + C);
    const uint4 v = *reinterpret_cast<const uint4*>(src + 2 * C);
    *reinterpret_cast<uint4*>(sQ + n * RS + c8) = q;
    *reinterpret_cast<uint4*>(sK + n * RS + c8) = k;
    const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sVt[(c8 + e) * VS + n] = ve[e];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the tile
  const int t = lane & 3;   // fragment column pair

  for (int rt = warp; rt < N / 16; rt += kWarps) {
    const int r0 = rt * 16;

    // S = Q K^T for rows r0 .. r0+15, all N keys
    float s[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int k0 = kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = ld32(sQ + (r0 + g) * RS + k0);
      a[1] = ld32(sQ + (r0 + g + 8) * RS + k0);
      a[2] = ld32(sQ + (r0 + g) * RS + k0 + 8);
      a[3] = ld32(sQ + (r0 + g + 8) * RS + k0 + 8);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * RS + k0;
        mma_bf16(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    // row softmax in f32: this thread holds rows g (s[.][0..1]) and g+8
    // (s[.][2..3]); the other columns of a row live in the 3 lanes of its quad
    float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0;
    const float i1 = 1.f / l1;

    // O = P V: the accumulator layout of two adjacent S tiles is the A
    // fragment layout of one k-step
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0);
      a[1] = pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1);
      a[2] = pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0);
      a[3] = pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vr = sVt + (j * 8 + g) * VS + kk * 16 + 2 * t;
        mma_bf16(o[j], a, ld32(vr), ld32(vr + 8));
      }
    }

    __nv_bfloat16* orow = out + ((size_t)seq * N + r0) * C + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + (size_t)g * C + col) =
          pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(g + 8) * C + col) =
          pack_bf16(o[j][2], o[j][3]);
    }
  }
}

template <int N, int D>
int launch(const void* qkv, void* out, int batch, int heads, float scale,
           cudaStream_t stream) {
  auto kernel = packed_attention_kernel<N, D>;
  const int smem = AttnShape<N, D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (batch, n, 3 * heads * head_dim) bf16 contiguous -> out (batch, n,
// heads * head_dim) bf16. Returns a cudaError_t (0 on success).
extern "C" int macaque_packed_attention(const void* qkv, void* out, int batch,
                                        int n, int heads, int head_dim,
                                        float scale, void* stream) {
  if (batch <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 192 && head_dim == 80) return launch<192, 80>(qkv, out, batch, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
