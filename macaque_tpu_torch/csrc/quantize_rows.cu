// Dynamic per-row int8 quantization of an activation (K5a).
//
// Replaces macaque_tpu/nn/pallas_int8.py::quantize_rows (_quantize_kernel):
// x (M, K) bf16 -> codes q (M, K) int8 and scales s (M) f32 with
//   s = max(max_k |x[m, k]|, 1e-8) * (1/127),  q = clip(rint(x / s), -127, 127)
// exactly as nn/quant.py::int8_matmul computes them: an IEEE division (not a
// multiply by 1/s), round half to even, no fast-math anywhere.
//
// What bounds it on an H100: bytes. It reads 2 bytes and writes 1 per element
// and does a handful of operations on each. The design reads each row from
// HBM once in 16-byte vectors (the second pass over the row, after the warp
// has its maximum, hits L1/L2) and writes the codes as 8-byte vectors.
//
// Design: one warp per row, 8 rows per 256-thread block; the row maximum is
// a warp shuffle reduction (max is exact in any order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ void bf16x8_to_float(const uint4& v, float (&f)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}

__global__ void __launch_bounds__(kWarps * 32)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int M, int K) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const int nvec = K / 8;

  float amax = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[8];
    bf16x8_to_float(xr[v], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, (float)1e-8), (float)(1.0 / 127.0));
  if (lane == 0) scale[row] = s;

  uint2* qr = reinterpret_cast<uint2*>(q + (size_t)row * K);
  for (int v = lane; v < nvec; v += 32) {
    float f[8];
    bf16x8_to_float(xr[v], f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(f[i], s)), -127.f), 127.f);
      w[i / 4] |= ((uint32_t)(uint8_t)(int8_t)(int)r) << (8 * (i % 4));
    }
    qr[v] = make_uint2(w[0], w[1]);
  }
}

}  // namespace

// x (m, k) bf16 contiguous, k % 8 == 0 -> q (m, k) int8, scale (m) f32.
// Returns a cudaError_t (0 on success).
extern "C" int macaque_quantize_rows(const void* x, void* q, void* scale, int m,
                                     int k, void* stream) {
  if (m <= 0 || k <= 0 || k % 8) return (int)cudaErrorInvalidValue;
  const int blocks = (m + kWarps - 1) / kWarps;
  quantize_rows_kernel<<<blocks, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), m, k);
  return (int)cudaGetLastError();
}
