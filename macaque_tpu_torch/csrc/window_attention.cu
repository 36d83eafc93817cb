// Swin window attention on the packed qkv activation (K3).
//
// Replaces macaque_tpu/nn/pallas_attention.py::fused_window_attention
// (_window_attn_kernel) and ::fused_window_attention_blocked
// (_window_attn_kernel_g). For window w and head h of qkv (B_, T, 3C):
//   S = (Q K^T) * scale + bias[h] + mask[w % nW]      (f32, T x T)
//   P = softmax_rows(S)                               (f32)
//   O = P V                                           (f32 accumulation)
// written as head h's d columns of out (B_, T, C) in the input dtype. The
// shift mask is read as (nW, T, T) and indexed by w % nW: windows are laid
// out image-major (window w of image b is row b * nW + w), so the mask is
// never tiled to (B_, T, T) in HBM as the JAX path tiles it. With `blocked`
// set, P is rounded to the input dtype before P V, as the blocked Pallas
// variant (input-dtype products, f32 accumulation) does; without it P stays
// f32, as the unblocked variant computes in f32 throughout. Products of two
// bf16 values are exact in f32, so f32 FMAs give the blocked variant's
// input-dtype products too. The scale multiplies the finished dot, as in
// both Pallas kernels.
//
// What bounds it on an H100: at Swin-S shapes (T = 49, d = 32) one (window,
// head) reads 3 * 49 * 32 inputs and writes 49 * 32, and does 2 * 2 * 49^2
// * 32 = 307 kFLOP: about 33 FLOP per byte in bf16. That is below the bf16
// tensor cores' ~295 FLOP per byte, so HBM bounds it; on the CUDA cores'
// 67 TFLOP/s f32 it is near the balance point.
//
// Design (simple first): one 128-thread block per (window, head). It stages
// that head's Q, K and V (49 x 32 each) in shared memory as f32, with the K
// rows padded to 33 words so that the 49 x 49 score loop is free of bank
// conflicts; each thread computes scores with f32 FMAs, each warp takes the
// softmax of whole rows with shuffle reductions, and each thread forms
// outputs of P V. The scores never leave shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 49;  // tokens of a 7 x 7 window
constexpr int D = 32;  // head width of every Swin-S stage
constexpr int kThreads = 128;
constexpr int kKStride = D + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const Tin* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, Tin* __restrict__ out,
                        int heads, int n_mask, float scale, int blocked) {
  __shared__ float sQ[T * D];
  __shared__ float sK[T * kKStride];
  __shared__ float sV[T * D];
  __shared__ float sS[T * T];

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int C = heads * D;
  const Tin* src = qkv + (size_t)w * T * 3 * C + h * D;
  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    const int n = i / D, d = i % D;
    const Tin* row = src + (size_t)n * 3 * C + d;
    sQ[i] = to_f32(row[0]);
    sK[n * kKStride + d] = to_f32(row[C]);
    sV[i] = to_f32(row[2 * C]);
  }
  __syncthreads();

  const float* bh = bias + (size_t)h * T * T;
  const float* mw = mask ? mask + (size_t)(w % n_mask) * T * T : nullptr;
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    const int n = i / T, m = i % T;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot = fmaf(sQ[n * D + d], sK[m * kKStride + d], dot);
    float s = __fadd_rn(__fmul_rn(dot, scale), bh[i]);
    if (mw) s = __fadd_rn(s, mw[i]);
    sS[i] = s;
  }
  __syncthreads();

  // row softmax: a warp per row, each lane two columns (49 <= 64)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n = warp; n < T; n += kThreads / 32) {
    float* row = sS + n * T;
    const bool has1 = lane + 32 < T;
    const float a = row[lane];
    const float b = has1 ? row[lane + 32] : __int_as_float(0xff800000);
    float mx = fmaxf(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float ea = expf(a - mx);
    const float eb = has1 ? expf(b - mx) : 0.f;
    float sum = ea + eb;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float pa = __fdiv_rn(ea, sum), pb = __fdiv_rn(eb, sum);
    if (blocked) {
      pa = round_to(pa, out);
      pb = round_to(pb, out);
    }
    row[lane] = pa;
    if (has1) row[lane + 32] = pb;
  }
  __syncthreads();

  Tin* dst = out + (size_t)w * T * C + h * D;
  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    const int n = i / D, d = i % D;
    float o = 0.f;
    for (int m = 0; m < T; ++m) o = fmaf(sS[n * T + m], sV[m * D + d], o);
    from_f32(o, dst + (size_t)n * C + d);
  }
}

template <typename Tin>
int launch(const void* qkv, const void* bias, const void* mask, void* out,
           int windows, int heads, int n_mask, float scale, int blocked,
           cudaStream_t stream) {
  window_attention_kernel<Tin><<<dim3(windows, heads), kThreads, 0, stream>>>(
      static_cast<const Tin*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<Tin*>(out), heads, n_mask,
      scale, blocked);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (windows, 49, 3 * heads * 32) contiguous, dtype 0 = f32, 1 = bf16;
// bias (heads, 49, 49) f32; mask (n_mask, 49, 49) f32 or null, windows %
// n_mask == 0 -> out (windows, 49, heads * 32) in the input dtype. Returns a
// cudaError_t (0 on success).
extern "C" int macaque_window_attention(const void* qkv, const void* bias,
                                        const void* mask, void* out, int windows,
                                        int tokens, int heads, int head_dim,
                                        int n_mask, float scale, int blocked,
                                        int dtype, void* stream) {
  if (windows <= 0 || heads <= 0 || tokens != T || head_dim != D ||
      (mask && (n_mask <= 0 || windows % n_mask)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(qkv, bias, mask, out, windows, heads, n_mask, scale, blocked, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, bias, mask, out, windows, heads, n_mask, scale,
                                 blocked, s);
  return (int)cudaErrorInvalidValue;
}
