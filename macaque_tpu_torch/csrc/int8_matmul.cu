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
// or, with out_bias in place of bias (the int8 layers' chain, nn/quant.py),
//   out[m, n] = bf16(bf16((float)acc * s[m] * wscale[n]) + bf16(out_bias[n]))
// with x (M, K) bf16, wq (N, K) int8 (the JAX kernel_q transposed: K is
// contiguous, the layout of the tensor cores' B operand), wscale and bias
// (N) f32. The epilogue is the JAX kernels' as XLA compiles it: the last
// multiply and the bias add contract into one fused multiply-add. The
// products are exact in int32 and every rounding is spelled out (__fdiv_rn
// and rintf in the quantizer, __fmul_rn and __fmaf_rn here), so nvcc cannot
// round differently: the output equals the plain version bit for bit.
//
// What bounds it on an H100: operations. At ViTPose-huge shapes (M = 49,152,
// K = 1280 or 5120, N = 1280..5120) a layer does 2*M*N*K int8 operations on
// (2K + N) * M + N * K bytes, well above the ~590 operations per byte at
// which 1,979 int8 TOPS outrun 3.35 TB/s.
//
// Design: two passes on one stream.
// 1. Each row is quantized once, by the row quantizer K5a
//    (quantize_rows.cu, macaque_quantize_rows), into a caller's workspace:
//    codes xq (M, K) int8 and scales (M) f32. A 128-column output tile no
//    longer quantizes its x panel again (N / 128 times a row before), and
//    the GEMM reads 1 byte an element where it read 2.
// 2. An int8 GEMM over xq: a 256-thread block computes a 128 x 128 output
//    tile. K streams in 64-byte slabs of A (128 x 64 codes) and B (128 x 64
//    weight codes) through a 4-stage ring in shared memory, filled by
//    cp.async.cg 16-byte copies (zero-filled past M, N and K, so a ragged
//    edge or K = 96's half slab adds zeros); rows are padded to 80 bytes, so
//    every ldmatrix phase reads 8 distinct 16-byte bank groups. 8 warps
//    (2 x 4, each 64 x 32 outputs) take their fragments by ldmatrix.x4 and
//    run mma.sync m16n8k32 s8 x s8 -> s32; one __syncthreads a slab, while
//    the copies of the next three slabs are in flight. 4 x 20 KB of shared
//    memory and at most 128 registers a thread (__launch_bounds__(256, 2))
//    keep two blocks on an SM. The grid runs the N tiles of one 128-row
//    panel at adjacent block indices, so the panel is read from HBM about
//    once and from L2 by the others; the weights (at most 6.5 MB) stay in
//    L2.

#include "ptx.cuh"

// K5a's entry point (quantize_rows.cu, same library)
extern "C" int macaque_quantize_rows(const void* x, void* q, void* scale, int m,
                                     int k, void* stream);

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // BK in bytes (int8 codes)
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;           // resident blocks per SM the design holds
constexpr int kStride = BK + 16;        // shared row stride in bytes
constexpr int kStageBytes = (BM + BN) * kStride;
constexpr int kSmemBytes = kStages * kStageBytes;  // 81,920
constexpr int kChunks = BK / 16;        // 16-byte copies a row of a slab

// D (16x8, s32) += A (16x32, s8, row) * B (32x8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ wscale,
                 const float* __restrict__ bias, const float* __restrict__ out_bias,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = (K + BK - 1) / BK;

  // slab kt of A (rows m0..) and B (rows n0..) into stage `st`: 2 copies of
  // each a thread, zeros past the edges
  auto load = [&](int st, int kt) {
    int8_t* sA = reinterpret_cast<int8_t*>(smem_raw) + st * kStageBytes;
    int8_t* sB = sA + BM * kStride;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kChunks, c = (idx % kChunks) * 16;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16_zfill(sA + r * kStride + c,
                       ok ? xq + (size_t)(m0 + r) * K + k0 + c : xq, ok);
    }
#pragma unroll
    for (int i = 0; i < BN * kChunks / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kChunks, c = (idx % kChunks) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      cp_async16_zfill(sB + r * kStride + c,
                       ok ? wq + (size_t)(n0 + r) * K + k0 + c : wq, ok);
    }
  };

  const int wm = (warp / 4) * 64;  // this warp's 64 x 32 output tile
  const int wn = (warp % 4) * 32;
  const int g = lane >> 2, t = lane & 3;
  // this lane's ldmatrix row addresses within a stage
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t aOff = (wm + ldsm_a_row(lane)) * kStride + ldsm_a_col(lane) * 16;
  const uint32_t bOff = BM * kStride + (wn + ldsm_b_row(lane)) * kStride +
                        ldsm_b_col(lane) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // slab kt has landed
    __syncthreads();               // ... for every thread; slab kt - 1 is free
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();

    const uint32_t st = base + (kt % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(a[i], st + aOff + i * 16 * kStride + kk);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, st + bOff + jp * 16 * kStride + kk);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // epilogue in f32, one rounding to bf16 (two with out_bias, as the
  // layer's chain rounds: the cast, then the bf16 bias add)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
    const float ws0 = wscale[col], ws1 = wscale[col + 1];
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
    // the bias after the cast, rounded to bf16 as the layer's bias add reads it
    const float o0 = out_bias ? __bfloat162float(__float2bfloat16_rn(out_bias[col])) : 0.f;
    const float o1 = out_bias ? __bfloat162float(__float2bfloat16_rn(out_bias[col + 1])) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        const float s = xs[row];
        const float p0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s);
        const float p1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s);
        float v0 = bias ? __fmaf_rn(p0, ws0, b0) : __fmul_rn(p0, ws0);
        float v1 = bias ? __fmaf_rn(p1, ws1, b1) : __fmul_rn(p1, ws1);
        if (out_bias) {
          v0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v0)), o0);
          v1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(v1)), o1);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

int prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)  // 2 x 80 KB wants the largest shared-memory carveout
    err = cudaFuncSetAttribute(int8_gemm_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

}  // namespace

// x (m, k) bf16, wq (n, k) int8, wscale (n) f32, bias and out_bias (n) f32
// or null (not both), all contiguous and 16-byte aligned; k % 32 == 0,
// n % 8 == 0; workspace xq (m, k) int8 and xs (m) f32, 16-byte aligned ->
// out (m, n) bf16. Runs the row quantizer into the workspace, then the
// GEMM. Returns a cudaError_t (0 on success).
extern "C" int macaque_quant_int8_matmul(const void* x, const void* wq,
                                         const void* wscale, const void* bias,
                                         const void* out_bias, void* xq, void* xs,
                                         void* out, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 || n % 8 || (bias && out_bias))
    return (int)cudaErrorInvalidValue;
  int err = prepare();
  if (err) return err;
  err = macaque_quantize_rows(x, xq, xs, m, k, stream);
  if (err) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  int8_gemm_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<const float*>(out_bias),
      static_cast<__nv_bfloat16*>(out), m, n, k);
  return (int)cudaGetLastError();
}

// Blocks of the GEMM one SM of the current device keeps resident.
extern "C" int macaque_quant_int8_matmul_blocks_per_sm(int* blocks) {
  int err = prepare();
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, int8_gemm_kernel,
                                                            kThreads, kSmemBytes);
}
