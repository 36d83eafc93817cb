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
// never tiled to (B_, T, T) in HBM as the JAX path tiles it. The scale
// multiplies the finished dot, then the bias and then the mask are added,
// each an f32 rounding, in both Pallas kernels' order. With `blocked` set,
// P is rounded to the input dtype before P V, as the blocked Pallas variant
// (input-dtype products, f32 accumulation) does; without it P keeps f32
// precision, as the unblocked variant computes in f32 throughout.
//
// What bounds it on an H100: at Swin-S shapes (T = 49, d = 32) one (window,
// head) reads 3 * 49 * 32 inputs and writes 49 * 32, and does 2 * 2 * 49^2
// * 32 = 307 kFLOP: about 33 FLOP per byte in bf16, far below the bf16
// tensor cores' ~295 FLOP per byte, so HBM bounds it. A detector frame makes
// 24 calls of 288-1914 (window, head) pairs (5-20 MB each, a few
// microseconds at the HBM rate), so the latency of one tile and the launch
// weigh as much as the bytes.
//
// bf16 design (window_attention_blocked_kernel, window_attention_split_kernel):
// one block of 4 warps per (window, head), the 49 tokens padded to a 64-row
// tile, one warp per 16 query rows.
// - Q, K and V reach shared memory by cp.async 16-byte copies, the bias
//   and mask tiles (49 x 49 f32 each, read from L2 once a tile) by 4-byte
//   ones: Q, K, bias and mask in one commit group, V in a second, so Q K^T
//   starts while V is in flight and no load waits in a register. Token
//   rows 49-63 are zero-filled (cp_async16_zfill), rows padded to 40
//   elements (80 bytes) so every ldmatrix phase reads 8 distinct 16-byte
//   bank groups. 34.6 KB a block, 6 blocks an SM.
// - S = Q K^T runs on mma.sync m16n8k16 bf16 with f32 accumulation, Q's A
//   and K's B fragments from ldmatrix.x4. Products of two bf16 values are
//   exact in f32, so this is both Pallas kernels' f32 dot up to summation
//   order. Each lane then adds its scores' scale, bias and mask in
//   registers. The
//   scores cover keys 0-55 (7 n8 tiles): keys 49-55 get -inf before the
//   row maximum, keys 56-63 only pad P V's last k16 step and get P = 0.
//   The padded query rows are computed and never stored.
// - The row softmax runs in f32 on the accumulators with quad shuffles, as
//   exp2 of one FFMA a score, normalised by the reciprocal of the row sum:
//   f32 roundings of the exponent's argument, about 2^-24 times the row's
//   largest |score| relative to P, below the split's 2^-16 and the bf16
//   rounding's 2^-8. No IEEE division per probability (__fdiv_rn's slow
//   path is a subroutine call that made K4 spill).
// - P V runs on mma.sync too: the accumulators of two adjacent n8 score
//   tiles, times the reciprocal, are the A fragment of one k16 step, and V's
//   B fragments come from ldmatrix.x4.trans. Blocked: P rounded to bf16
//   once. Unblocked: P split as hi = bf16_rn(P), lo = bf16_rn(P - hi) and
//   O = hi V + lo V, as K4 does (csrc/attention_core.cuh): |P - hi - lo| <=
//   2^-16 P, so O moves by at most 2^-16 max|V|.
//
// f32 input (window_attention_kernel; no card path runs it) keeps the
// CUDA-core design: one 128-thread block per (window, head), Q, K, V staged
// as f32, scores, softmax and P V as f32 FMAs with the scores in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int T = 49;  // tokens of a 7 x 7 window
constexpr int D = 32;  // head width of every Swin-S stage
constexpr int kThreads = 128;

// ------------------------------------------------------- bf16, tensor cores

constexpr int kRows = 64;          // the padded tile: 4 m16 tiles, 4 k16 steps
constexpr int kStride = D + 8;     // Q, K, V rows in bf16 elements
// resident blocks an SM the design holds (<= 80 registers a thread, 34.6 KB
// of shared memory a block): a stage-3 call's 576 blocks run in one wave on
// 132 SMs
constexpr int kMinBlocks = 6;

template <bool kSplitP>
__device__ __forceinline__ void window_tile(const __nv_bfloat16* __restrict__ qkv,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask,
                                            __nv_bfloat16* __restrict__ out,
                                            int heads, int n_mask, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kRows * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kRows * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kRows * kStride];
  __shared__ float sB[T * T];   // bias[h]
  __shared__ float sM[T * T];   // mask[w % nW]

  const int w = blockIdx.x, h = blockIdx.y;
  const int C = heads * D;
  const __nv_bfloat16* src = qkv + (size_t)w * T * 3 * C + h * D;
  const float* bh = bias + (size_t)h * T * T;
  const float* mw = mask ? mask + (size_t)(w % n_mask) * T * T : nullptr;

  // 16-byte copies, 4 a token row: Q and K (idx 0-511), then V (512-767)
  auto copy = [&](int idx) {
    const int o = idx >> 8, n = (idx >> 2) & (kRows - 1), c8 = (idx & 3) * 8;
    __nv_bfloat16* dst = (o == 0 ? sQ : o == 1 ? sK : sV) + n * kStride + c8;
    const bool full = n < T;
    cp_async16_zfill(dst, src + (size_t)(full ? n : 0) * 3 * C + o * C + c8, full);
  };
#pragma unroll
  for (int i = 0; i < 4; ++i) copy(threadIdx.x + i * kThreads);
  // the bias and mask tiles, contiguous 49 x 49 f32 (rows of 196 bytes,
  // 4-byte aligned only), in the same group
  for (int i = threadIdx.x; i < T * T; i += kThreads) {
    cp_async4(sB + i, bh + i);
    if (mw) cp_async4(sM + i, mw + i);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 4; i < 6; ++i) copy(threadIdx.x + i * kThreads);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row, column pair
  const int r0 = warp * 16;               // this warp's query rows

  cp_async_wait<1>();  // Q, K, bias and mask have landed
  __syncthreads();

  // S = Q K^T over keys 0-55 (n8 tiles 0-6); tile 7, keys 56-63, holds no
  // key and its probabilities are 0
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    ldsm_x4(qa, smem_u32(sQ + (r0 + ldsm_a_row(lane)) * kStride + kk * 16 +
                         ldsm_a_col(lane) * 8));
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
      uint32_t bk[4];
      ldsm_x4(bk, smem_u32(sK + (jj * 16 + ldsm_b_row(lane)) * kStride + kk * 16 +
                           ldsm_b_col(lane) * 8));
      mma_bf16(s[2 * jj], qa, bk[0], bk[1]);
      mma_bf16(s[2 * jj + 1], qa, bk[2], bk[3]);
    }
    uint32_t bk[2];  // lanes 0-15 address keys 48-55
    ldsm_x2(bk, smem_u32(sK + (48 + ldsm_b_row(lane % 16)) * kStride + kk * 16 +
                         ldsm_b_col(lane % 16) * 8));
    mma_bf16(s[6], qa, bk[0], bk[1]);
  }

  // scale, bias, mask in the Pallas kernels' order; rows r0 + g (e = 0, 1)
  // and r0 + g + 8 (e = 2, 3), keys 8n + 2t + (e & 1); the padded keys get
  // -inf
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int n = 0; n < 7; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, col = n * 8 + 2 * t + (e & 1);
      if (col >= T) {
        s[n][e] = neg_inf;
      } else if (row < T) {
        float v = __fadd_rn(__fmul_rn(s[n][e], scale), sB[row * T + col]);
        if (mw) v = __fadd_rn(v, sM[row * T + col]);
        s[n][e] = v;
      }
    }

  // f32 row softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3); a row's other
  // columns live in the 3 other lanes of the quad
  float m0 = neg_inf, m1 = neg_inf;
#pragma unroll
  for (int n = 0; n < 7; ++n) {
    m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
    m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  constexpr float kLog2e = 1.4426950408889634f;
  const float mc0 = -m0 * kLog2e, mc1 = -m1 * kLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < 7; ++n) {
    s[n][0] = exp2f(fmaf(s[n][0], kLog2e, mc0));
    s[n][1] = exp2f(fmaf(s[n][1], kLog2e, mc0));
    s[n][2] = exp2f(fmaf(s[n][2], kLog2e, mc1));
    s[n][3] = exp2f(fmaf(s[n][3], kLog2e, mc1));
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;

  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // O = P V: score tiles 2kk and 2kk + 1, times the reciprocal row sum, are
  // the A fragment of key step kk
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const uint32_t vAddr = smem_u32(sV + ldsm_a_row(lane) * kStride + ldsm_a_col(lane) * 8);
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const int j0 = 2 * kk, j1 = 2 * kk + 1;
    uint32_t ph[4], pl[4];
    if constexpr (kSplitP) {
      split_bf16(s[j0][0] * i0, s[j0][1] * i0, ph[0], pl[0]);
      split_bf16(s[j0][2] * i1, s[j0][3] * i1, ph[1], pl[1]);
      split_bf16(s[j1][0] * i0, s[j1][1] * i0, ph[2], pl[2]);
      split_bf16(s[j1][2] * i1, s[j1][3] * i1, ph[3], pl[3]);
    } else {
      ph[0] = pack_bf16(s[j0][0] * i0, s[j0][1] * i0);
      ph[1] = pack_bf16(s[j0][2] * i1, s[j0][3] * i1);
      ph[2] = pack_bf16(s[j1][0] * i0, s[j1][1] * i0);
      ph[3] = pack_bf16(s[j1][2] * i1, s[j1][3] * i1);
    }
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t bv4[4];
      ldsm_x4_trans(bv4, vAddr + (kk * 16 * kStride + jp * 16) * 2);
      mma_bf16(o[2 * jp], ph, bv4[0], bv4[1]);
      mma_bf16(o[2 * jp + 1], ph, bv4[2], bv4[3]);
      if constexpr (kSplitP) {
        mma_bf16(o[2 * jp], pl, bv4[0], bv4[1]);
        mma_bf16(o[2 * jp + 1], pl, bv4[2], bv4[3]);
      }
    }
  }

  __nv_bfloat16* dst = out + (size_t)w * T * C + h * D;
  const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (ra < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)ra * C + col) = pack_bf16(o[j][0], o[j][1]);
    if (rb < T)
      *reinterpret_cast<uint32_t*>(dst + (size_t)rb * C + col) = pack_bf16(o[j][2], o[j][3]);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_attention_blocked_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask,
                                __nv_bfloat16* __restrict__ out, int heads,
                                int n_mask, float scale) {
  window_tile<false>(qkv, bias, mask, out, heads, n_mask, scale);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_attention_split_kernel(const __nv_bfloat16* __restrict__ qkv,
                              const float* __restrict__ bias,
                              const float* __restrict__ mask,
                              __nv_bfloat16* __restrict__ out, int heads,
                              int n_mask, float scale) {
  window_tile<true>(qkv, bias, mask, out, heads, n_mask, scale);
}

using TileKernel = void (*)(const __nv_bfloat16*, const float*, const float*,
                            __nv_bfloat16*, int, int, float);

// The kernel for `blocked`, asked once for the largest shared-memory carveout
// (6 x 34.6 KB an SM)
TileKernel tile_kernel(int blocked) {
  static const bool carveout = [] {
    for (TileKernel k : {window_attention_blocked_kernel, window_attention_split_kernel})
      cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
    return true;
  }();
  (void)carveout;
  return blocked ? window_attention_blocked_kernel : window_attention_split_kernel;
}

// ------------------------------------------------------- f32, CUDA cores

constexpr int kKStride = D + 1;  // K rows padded: the score loop is conflict-free

__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, float* __restrict__ out,
                        int heads, int n_mask, float scale) {
  __shared__ float sQ[T * D];
  __shared__ float sK[T * kKStride];
  __shared__ float sV[T * D];
  __shared__ float sS[T * T];

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int C = heads * D;
  const float* src = qkv + (size_t)w * T * 3 * C + h * D;
  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    const int n = i / D, d = i % D;
    const float* row = src + (size_t)n * 3 * C + d;
    sQ[i] = row[0];
    sK[n * kKStride + d] = row[C];
    sV[i] = row[2 * C];
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
    row[lane] = __fdiv_rn(ea, sum);
    if (has1) row[lane + 32] = __fdiv_rn(eb, sum);
  }
  __syncthreads();

  float* dst = out + (size_t)w * T * C + h * D;
  for (int i = threadIdx.x; i < T * D; i += kThreads) {
    const int n = i / D, d = i % D;
    float o = 0.f;
    for (int m = 0; m < T; ++m) o = fmaf(sS[n * T + m], sV[m * D + d], o);
    dst[(size_t)n * C + d] = o;
  }
}

}  // namespace

// qkv (windows, 49, 3 * heads * 32) contiguous, dtype 0 = f32, 1 = bf16
// (16-byte aligned); bias (heads, 49, 49) f32; mask (n_mask, 49, 49) f32 or
// null, windows % n_mask == 0 -> out (windows, 49, heads * 32) in the input
// dtype. One block per (window, head). Returns a cudaError_t (0 on success).
extern "C" int macaque_window_attention(const void* qkv, const void* bias,
                                        const void* mask, void* out, int windows,
                                        int tokens, int heads, int head_dim,
                                        int n_mask, float scale, int blocked,
                                        int dtype, void* stream) {
  if (windows <= 0 || heads <= 0 || tokens != T || head_dim != D ||
      (mask && (n_mask <= 0 || windows % n_mask)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(windows, heads);
  if (dtype == 0) {
    // f32 P is its own rounding: both variants compute the same function
    window_attention_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<float*>(out), heads, n_mask,
        scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(qkv) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
      return (int)cudaErrorMisalignedAddress;
    tile_kernel(blocked)<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), heads,
        n_mask, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The blocks of the kernel for `dtype` (0 = f32, 1 = bf16) and `blocked`
// that one SM of the current device keeps resident. Returns a cudaError_t
// (0 on success).
extern "C" int macaque_window_attention_blocks_per_sm(int dtype, int blocked,
                                                      int* blocks) {
  if (dtype == 0)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, window_attention_kernel, kThreads, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tile_kernel(blocked), kThreads, 0);
}
