// Fused dynamic-quantization int8 matmul for the int8 ViT/Swin Dense layers
// (K5b).
//
// Replaces macaque_tpu/nn/pallas_int8.py::quant_int8_matmul, both its
// weights-resident (_wres_kernel) and its tiled (_tiled_kernel) form, which
// compute one function:
//   s[m]      = max(max_k |x[m, k]|, 1e-8) * (1/127)
//   xq[m, k]  = clip(rint(x[m, k] / s[m]), -127, 127)            (int8)
//   acc[m, n] = sum_k xq[m, k] * wq[n, k]                         (int32)
//   out[m, n] = bf16(fma((float)acc * s[m], wscale[n], bias[n]))
// with x (M, K) bf16, wq (N, K) int8 (the JAX kernel_q transposed: K is
// contiguous, the layout of the tensor cores' B operand), wscale and bias
// (N) f32. The epilogue is the JAX kernels' as XLA compiles it: the last
// multiply and the bias add contract into one fused multiply-add. The
// products are exact in int32 and every rounding of the epilogue is spelled
// out (__fmul_rn, __fmaf_rn), so nvcc cannot round differently: the output
// equals the plain version bit for bit.
//
// What bounds it on an H100: operations. At ViTPose-huge shapes (M = 49,152,
// K = 1280 or 5120, N = 1280..5120) a layer does 2*M*N*K int8 operations on
// (2K + N) * M + N * K bytes, well above the ~590 operations per byte at
// which 1,979 int8 TOPS outrun 3.35 TB/s.
//
// Design (a simple first kernel; the fast form is wgmma with TMA-fed
// stages): a 256-thread block computes a 128 x 128 output tile. It first
// takes the row maxima of its 128-row panel of x (one warp per 16 rows,
// 16-byte loads), then streams K in 64-deep steps: the bf16 x tile is
// quantized on its way into shared memory as int8 (every N tile quantizes
// its panel again), the int8 weight tile is
// copied beside it, and 8 warps (2 x 4, each 64 x 32 outputs) run
// mma.sync m16n8k32 s8 x s8 -> s32. The next step's tiles are loaded into
// registers while the tensor cores work on the current one. Shared rows are
// padded to 80 bytes, so every fragment load is free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kThreads = 256;
constexpr int kStride = BK + 16;  // shared row stride in bytes
constexpr int kXVec = BM * BK / 8 / kThreads;   // 16-byte x vectors a thread
constexpr int kWVec = BN * BK / 16 / kThreads;  // 16-byte w vectors a thread

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, s32) += A (16x32, s8, row) * B (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t quantize4(const __nv_bfloat16* e, float s) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float r = fminf(
        fmaxf(rintf(__fdiv_rn(__bfloat162float(e[i]), s)), -127.f), 127.f);
    w |= ((uint32_t)(uint8_t)(int8_t)(int)r) << (8 * i);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
quant_int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ wscale,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[BM * kStride];
  __shared__ __align__(16) int8_t sB[BN * kStride];
  __shared__ float sS[BM];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // 1. row scales of the block's x panel: warp w takes rows 16w .. 16w+15
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float amax = 0.f;
    if (m0 + r < M) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K);
      for (int v = lane; v < K / 8; v += 32) {
        const uint4 u = xr[v];
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) sS[r] = __fmul_rn(fmaxf(amax, (float)1e-8), (float)(1.0 / 127.0));
  }
  __syncthreads();

  // 2. stream K: registers hold the next step's tiles
  uint4 xa[kXVec], wb[kWVec];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      xa[i] = (m0 + r < M && k0 + c < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
      wb[i] = (n0 + r < N && k0 + c < K)
                  ? *reinterpret_cast<const uint4*>(wq + (size_t)(n0 + r) * K + k0 + c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  const int wm = (warp / 4) * 64;  // this warp's 64 x 32 output tile
  const int wn = (warp % 4) * 32;
  const int g = lane >> 2, t = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kXVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xa[i]);
      *reinterpret_cast<uint2*>(sA + r * kStride + c) =
          make_uint2(quantize4(e, sS[r]), quantize4(e + 4, sS[r]));
    }
#pragma unroll
    for (int i = 0; i < kWVec; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(sB + r * kStride + c) = wb[i];
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      if (k0 + kk < K) {  // K % 32 == 0: a step is whole or absent
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int8_t* p = sA + (wm + i * 16 + g) * kStride + kk + 4 * t;
          a[i][0] = ld32(p);
          a[i][1] = ld32(p + 8 * kStride);
          a[i][2] = ld32(p + 16);
          a[i][3] = ld32(p + 8 * kStride + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int8_t* p = sB + (wn + j * 8 + g) * kStride + kk + 4 * t;
          b[j][0] = ld32(p);
          b[j][1] = ld32(p + 16);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }

  // 3. epilogue in f32, one rounding to bf16
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
    const float ws0 = wscale[col], ws1 = wscale[col + 1];
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + i * 16 + g + 8 * h;
        if (m0 + r >= M) continue;
        const float s = sS[r];
        const float p0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s);
        const float p1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s);
        const float v0 = bias ? __fmaf_rn(p0, ws0, b0) : __fmul_rn(p0, ws0);
        const float v1 = bias ? __fmaf_rn(p1, ws1, b1) : __fmul_rn(p1, ws1);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + r) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x (m, k) bf16, wq (n, k) int8, wscale (n) f32, bias (n) f32 or null, all
// contiguous and 16-byte aligned; k % 32 == 0, n % 8 == 0 -> out (m, n) bf16.
// Returns a cudaError_t (0 on success).
extern "C" int macaque_quant_int8_matmul(const void* x, const void* wq,
                                         const void* wscale, const void* bias,
                                         void* out, int m, int n, int k,
                                         void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 || n % 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  quant_int8_matmul_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), m, n, k);
  return (int)cudaGetLastError();
}
