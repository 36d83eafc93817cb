// Multi-head attention on unpacked (B, N, H, D) q, k, v (K4).
//
// Replaces macaque_tpu/nn/pallas_attention.py::fused_attention (_attn_kernel,
// one grid step per batch element and head) and ::fused_attention_blocked
// (_attn_kernel_blocked, one step per batch element with its heads in turn),
// which compute one function in float32:
//   S = (Q K^T) * scale,  P = softmax_rows(S),  O = P V     (all f32)
// with O written in the input dtype. Both take the one grid here, one block
// per (batch element, head): heads share no K or V, so a block per batch
// element only leaves SMs idle (64 blocks on 132 SMs at the crop shape).
//
// What bounds it on an H100: at the ViT-huge crop shape (64, 192, 16, 80)
// bf16 the call reads q, k, v and writes o once, 126 MB, and does
// 4 * B * H * N^2 * D = 12.1 GFLOP: 96 FLOP per byte, below the ~295 at which
// the bf16 tensor cores outrun 3.35 TB/s, so bytes bound it (0.038 ms).
//
// Design (simple first): S = Q K^T runs on mma.sync m16n8k16 bf16 with f32
// accumulation -- products of two bf16 values are exact in f32, so this is
// the kernel's f32 dot up to summation order. P stays f32, as in the TPU
// kernel, so P V cannot take a bf16 mma: it runs as f32 FMAs on the CUDA
// cores. A 128-thread block stages one head's K (row-major, rows padded for
// conflict-free fragment loads) and V in shared memory; each warp takes
// 16-row query tiles, loads its Q fragments straight from global memory,
// keeps the 16 x N scores in registers for the softmax, writes the f32
// probabilities to its own shared tile, and forms O = P V with each lane
// owning 8 rows x 5 columns of the 16 x 80 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

template <int N, int D>
struct AttnShape {
  static_assert(N % 16 == 0 && D % 16 == 0, "N and d must be multiples of 16");
  static constexpr int kKStride = D + 8;  // K rows, in bf16 elements
  static constexpr int kPStride = N + 4;  // probability rows, in floats
  static constexpr int kKBytes = N * kKStride * 2;
  static constexpr int kVBytes = N * D * 2;
  static constexpr int kPBytes = kWarps * 16 * kPStride * 4;
  static constexpr int kSmemBytes = kKBytes + kVBytes + kPBytes;
  static_assert((kKBytes + kVBytes) % 16 == 0, "probability tiles 16-byte aligned");
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int heads, float scale) {
  using S = AttnShape<N, D>;
  constexpr int KS = S::kKStride;
  constexpr int PS = S::kPStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + N * KS;
  float* sP = reinterpret_cast<float*>(smem_raw + S::kKBytes + S::kVBytes);

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t tok = (size_t)heads * D;  // elements from one token to the next
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;     // mma fragment row, column pair
  const int dl = lane & 15, rl = lane >> 4;  // P V: columns dl + 16j, rows rl + 2i
  float* wP = sP + warp * 16 * PS;

  const size_t base = (size_t)b * N * tok + (size_t)h * D;
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < N * kVec; idx += blockDim.x) {
    const int n = idx / kVec, c8 = (idx % kVec) * 8;
    *reinterpret_cast<uint4*>(sK + n * KS + c8) =
        *reinterpret_cast<const uint4*>(k + base + n * tok + c8);
    *reinterpret_cast<uint4*>(sV + n * D + c8) =
        *reinterpret_cast<const uint4*>(v + base + n * tok + c8);
  }
  __syncthreads();

  for (int rt = warp; rt < N / 16; rt += kWarps) {
    const int r0 = rt * 16;
    const __nv_bfloat16* q0 = q + base + (size_t)(r0 + g) * tok + 2 * t;
    const __nv_bfloat16* q8 = q0 + 8 * tok;
    uint32_t a[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a[kk][0] = ld32(q0 + kk * 16);
      a[kk][1] = ld32(q8 + kk * 16);
      a[kk][2] = ld32(q0 + kk * 16 + 8);
      a[kk][3] = ld32(q8 + kk * 16 + 8);
    }
    float s[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * KS + kk * 16 + 2 * t;
        mma_bf16(s[j], a[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // f32 row softmax: rows g (s[.][0..1]) and g + 8 (s[.][2..3]); a row's
    // other columns live in the 3 other lanes of the quad
    float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
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
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    __syncwarp();  // this warp's previous tile is done reading wP
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<float2*>(wP + g * PS + col) =
          make_float2(__fdiv_rn(s[j][0], l0), __fdiv_rn(s[j][1], l0));
      *reinterpret_cast<float2*>(wP + (g + 8) * PS + col) =
          make_float2(__fdiv_rn(s[j][2], l1), __fdiv_rn(s[j][3], l1));
    }
    __syncwarp();

    // O = P V in f32 on the CUDA cores
    float o[8][D / 16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) o[i][j] = 0.f;
    for (int m = 0; m < N; m += 4) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = *reinterpret_cast<const float4*>(wP + (rl + 2 * i) * PS + m);
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        float vv[D / 16];
#pragma unroll
        for (int j = 0; j < D / 16; ++j)
          vv[j] = __bfloat162float(sV[(m + mm) * D + dl + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pi = mm == 0 ? p[i].x : mm == 1 ? p[i].y : mm == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int j = 0; j < D / 16; ++j) o[i][j] = fmaf(pi, vv[j], o[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat16* orow = out + base + (size_t)(r0 + rl + 2 * i) * tok + dl;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) orow[16 * j] = __float2bfloat16_rn(o[i][j]);
    }
  }
}

template <int N, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, float scale, cudaStream_t stream) {
  auto kernel = attention_kernel<N, D>;
  const int smem = AttnShape<N, D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out (batch, n, heads, head_dim) bf16, contiguous and 16-byte
// aligned. One block per (batch element, head). Returns a cudaError_t (0 on
// success).
extern "C" int macaque_attention(const void* q, const void* k, const void* v,
                                 void* out, int batch, int n, int heads,
                                 int head_dim, float scale, void* stream) {
  if (batch <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 192 && head_dim == 80)
    return launch<192, 80>(q, k, v, out, batch, heads, scale, s);
  return (int)cudaErrorInvalidValue;
}
