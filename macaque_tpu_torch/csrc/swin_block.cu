// A whole Swin block in one kernel (K6).
//
// Replaces macaque_tpu/nn/pallas_swin_block.py::fused_swin_block
// (_swin_block_kernel). For window w of x (nW, 49, C) bf16:
//   h   = LN1(x), zeroed on spatial-pad tokens         (f32 statistics)
//   qkv = bf16(h Wqkv^T) + bqkv                        (f32 accumulation)
//   per head: S = (Q K^T) * scale + bias[h] + mask[w % nM]  (f32)
//             P = bf16(softmax_rows(S)),  O = bf16(P V)
//   r1  = x + (bf16(O Wproj^T) + bproj)
//   f1  = gelu(bf16(LN2(r1) Wfc1^T) + bfc1)            (A&S erf polynomial)
//   out = r1 + (bf16(f1 Wfc2^T) + bfc2)
// Each Dense output is rounded to bf16 before its bias is added in bf16, P
// is rounded to bf16 before P V, every residual sum is a bf16 sum: the
// plain version (nn/swin_block.py::fused_swin_block_reference) rounds at the
// same places. Only the summation order of the dots differs.
//
// What bounds it on an H100: operations. A block does 2 * 12 * C^2 FLOP per
// token in its four Dense layers (plus 4 * 49 * C for attention) and moves
// each activation in and out once: at C = 384 that is 3.5 MFLOP per 1.5 KB,
// far above the ~295 FLOP per byte where the bf16 tensor cores outrun HBM.
// The TPU kernel keeps the block's weights resident in VMEM; shared memory
// cannot (14.2 MB at C = 768), so here they stream from L2, which holds any
// one block's weights (50 MB).
//
// Design (simple first): a persistent grid -- as many 256-thread blocks as
// fit on the card -- walks the windows. A window's 49 tokens are padded to
// 64 rows (four m16 tiles): pad rows enter as zeros after LN1, and their
// columns are excluded from every softmax (exp(-inf) = 0), so they never
// touch a real row. Every Dense runs as 64 x 96 output tiles on mma.sync
// m16n8k16 bf16 with f32 accumulation (8 warps, 2 x 4, each 32 x 24), A
// from shared memory, B fragments straight from the (N, K) weight in global
// memory (L2/L1). Shared memory holds two 64 x C bf16 panels: LN1's output,
// then r1; the attention output, then LN2's output. Attention runs head by
// head: the qkv Dense of one head writes its Q, K and V^T (64 x 32 each) to
// shared memory, four warps each take 16 query rows with the scores in
// registers, and the probabilities feed P V as the A operand without leaving
// registers. The GELU activation (64 x 4C) does not fit shared memory at
// C = 768: fc1 writes it to this block's slot of a global workspace (a few
// hundred KB, L2-resident), and fc2 reads it back as its A operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // a window's tokens, padded
constexpr int kTok = 49;       // a 7 x 7 window
constexpr int kHd = 32;        // head width
constexpr int kTile = 96;      // output columns of one Dense pass
constexpr int kQStride = kHd + 8;     // sQ, sK rows (bf16)
constexpr int kVStride = kRows + 8;   // sVt rows (bf16)

__host__ __device__ constexpr int panel_stride(int C) { return C + 8; }

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)2 * kRows * panel_stride(C) * 2 + 2 * kRows * kQStride * 2 +
         kHd * kVStride * 2;
}

struct Params {
  const __nv_bfloat16* x;
  const uint8_t* tok_valid;
  const float* bias;
  const float* mask;
  const float *ln1w, *ln1b;
  const __nv_bfloat16 *qkvw, *qkvb, *projw, *projb;
  const float *ln2w, *ln2b;
  const __nv_bfloat16 *fc1w, *fc1b, *fc2w, *fc2b;
  __nv_bfloat16* out;
  __nv_bfloat16* work;
  int windows, C, heads, n_mask;
  float eps, scale;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// bf16(acc) + bias in bf16: the Dense epilogue
__device__ __forceinline__ float dense_out(float acc, __nv_bfloat16 b) {
  return rbf(__fadd_rn(rbf(acc), bf(b)));
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

// 0.5 x (1 + erf(x / sqrt 2)) with the Abramowitz & Stegun 7.1.26 erf, as
// pallas_swin_block.py::_gelu_exact spells it
__device__ __forceinline__ float gelu_poly(float x) {
  const float z = __fmul_rn(x, 0.70710677f);
  const float az = fabsf(z);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, az)));
  float poly = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  poly = __fadd_rn(1.421413741f, __fmul_rn(t, poly));
  poly = __fadd_rn(-0.284496736f, __fmul_rn(t, poly));
  poly = __fadd_rn(0.254829592f, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float sgn = (z > 0.f) - (z < 0.f);
  const float erf = __fmul_rn(sgn, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-az, az)))));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf));
}

// LayerNorm of one C-wide row by one warp: f32 statistics E[x^2] - E[x]^2,
// y = ((x - mu) * (1 / sqrt(var + eps))) * w + b, rounded to bf16
__device__ void ln_row(const __nv_bfloat16* src, __nv_bfloat16* dst, int C,
                       const float* __restrict__ w, const float* __restrict__ b,
                       float eps, int lane) {
  float sum = 0.f, sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = bf(src[c]);
    sum = __fadd_rn(sum, v);
    sq = __fadd_rn(sq, __fmul_rn(v, v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mu = __fdiv_rn(sum, (float)C);
  const float var = __fsub_rn(__fdiv_rn(sq, (float)C), __fmul_rn(mu, mu));
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(fmaxf(var, 0.f), eps)));
  for (int c = lane; c < C; c += 32) {
    const float y = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(bf(src[c]), mu), inv), w[c]), b[c]);
    dst[c] = __float2bfloat16_rn(y);
  }
}

// One 64 x 96 output tile of a Dense: out[r][n] = sum_k A[r][k] W[wrow(n)][k]
// for the tile's columns n = n0 .. n0 + 95; W is (rows, K) row-major (the
// port's Linear layout, K contiguous: the B operand's layout). Warp (wm, wn)
// owns rows 32 wm .. + 31 and columns n0 + 24 wn .. + 23. `epi(row, col, v0,
// v1)` receives the f32 sums of columns col and col + 1.
template <class Map, class Epi>
__device__ __forceinline__ void dense_tile(const __nv_bfloat16* A, int lda,
                                           const __nv_bfloat16* __restrict__ W,
                                           int K, int n0, Map wrow, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = n0 + (warp & 3) * 24;
  const __nv_bfloat16* a0 = A + (size_t)(wm + g) * lda + 2 * t;
  const __nv_bfloat16* a1 = a0 + (size_t)16 * lda;
  const size_t l8 = (size_t)8 * lda;
  const __nv_bfloat16* bp[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) bp[j] = W + (size_t)wrow(wn + j * 8 + g) * K + 2 * t;
  float acc[2][3][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[2][4], b[3][2];
    a[0][0] = ld32(a0 + k0);
    a[0][1] = ld32(a0 + l8 + k0);
    a[0][2] = ld32(a0 + k0 + 8);
    a[0][3] = ld32(a0 + l8 + k0 + 8);
    a[1][0] = ld32(a1 + k0);
    a[1][1] = ld32(a1 + l8 + k0);
    a[1][2] = ld32(a1 + k0 + 8);
    a[1][3] = ld32(a1 + l8 + k0 + 8);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b[j][0] = ldg32(bp[j] + k0);
      b[j][1] = ldg32(bp[j] + k0 + 8);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(wm + i * 16 + g + 8 * h, wn + j * 8 + 2 * t, acc[i][j][2 * h],
            acc[i][j][2 * h + 1]);
}

struct Identity {
  __device__ __forceinline__ int operator()(int n) const { return n; }
};

// Attention of one head for query rows r0 .. r0 + 15 (one warp): scores in
// registers, f32 softmax over the 49 real keys, P rounded to bf16, O = P V
// written as bf16 to columns hd * 32 .. + 31 of `dst`.
__device__ __forceinline__ void head_attention(
    const __nv_bfloat16* sQ, const __nv_bfloat16* sK, const __nv_bfloat16* sVt,
    const float* __restrict__ bias_h, const float* __restrict__ mask_w,
    float scale, __nv_bfloat16* dst, int lds, int hd, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[kRows / 8][4];
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const int k0 = kk * 16 + 2 * t;
    uint32_t a[4];
    a[0] = ld32(sQ + (r0 + g) * kQStride + k0);
    a[1] = ld32(sQ + (r0 + g + 8) * kQStride + k0);
    a[2] = ld32(sQ + (r0 + g) * kQStride + k0 + 8);
    a[3] = ld32(sQ + (r0 + g + 8) * kQStride + k0 + 8);
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const __nv_bfloat16* kr = sK + (j * 8 + g) * kQStride + k0;
      mma_bf16(s[j], a, ld32(kr), ld32(kr + 8));
    }
  }
  const float ninf = __int_as_float(0xff800000);
  float m[2] = {ninf, ninf};
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = j * 8 + 2 * t + (e & 1);
      float v = __fmul_rn(s[j][e], scale);
      if (col >= kTok) {
        v = ninf;
      } else if (row < kTok) {
        v = __fadd_rn(v, bias_h[row * kTok + col]);
        if (mask_w) v = __fadd_rn(v, mask_w[row * kTok + col]);
      }
      s[j][e] = v;
      m[e >> 1] = fmaxf(m[e >> 1], v);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float o[kHd / 8][4];
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(__fdiv_rn(s[2 * kk][0], l[0]), __fdiv_rn(s[2 * kk][1], l[0]));
    a[1] = pack_bf16(__fdiv_rn(s[2 * kk][2], l[1]), __fdiv_rn(s[2 * kk][3], l[1]));
    a[2] = pack_bf16(__fdiv_rn(s[2 * kk + 1][0], l[0]), __fdiv_rn(s[2 * kk + 1][1], l[0]));
    a[3] = pack_bf16(__fdiv_rn(s[2 * kk + 1][2], l[1]), __fdiv_rn(s[2 * kk + 1][3], l[1]));
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      const __nv_bfloat16* vr = sVt + (j * 8 + g) * kVStride + kk * 16 + 2 * t;
      mma_bf16(o[j], a, ld32(vr), ld32(vr + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j) {
    const int col = hd * kHd + j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + (r0 + g) * lds + col) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8) * lds + col) =
        pack_bf16(o[j][2], o[j][3]);
  }
}

__global__ void __launch_bounds__(kThreads) swin_block_kernel(Params p) {
  const int C = p.C, CS = panel_stride(C), C4 = 4 * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // h, then r1
  __nv_bfloat16* sB = sA + kRows * CS;        // attention output, then LN2(r1)
  __nv_bfloat16* sQ = sB + kRows * CS;
  __nv_bfloat16* sK = sQ + kRows * kQStride;
  __nv_bfloat16* sVt = sK + kRows * kQStride;
  __nv_bfloat16* gF = p.work + (size_t)blockIdx.x * kRows * C4;  // GELU(fc1)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int w = blockIdx.x; w < p.windows; w += gridDim.x) {
    const __nv_bfloat16* xw = p.x + (size_t)w * kTok * C;
    const uint8_t* tv = p.tok_valid + (size_t)w * kTok;

    // LN1; pad rows and spatial-pad tokens are zeros
    for (int r = warp; r < kRows; r += kThreads / 32) {
      if (r < kTok && tv[r]) {
        ln_row(xw + (size_t)r * C, sA + r * CS, C, p.ln1w, p.ln1b, p.eps, lane);
      } else {
        for (int c = lane; c < C; c += 32) sA[r * CS + c] = __float2bfloat16_rn(0.f);
      }
    }

    const float* mask_w = p.mask ? p.mask + (size_t)(w % p.n_mask) * kTok * kTok : nullptr;
    for (int hd = 0; hd < p.heads; ++hd) {
      __syncthreads();  // LN1 written; the previous head's attention is done
      // this head's q, k, v columns of the qkv Dense: tile column n is part
      // n / 32 (q, k, v), dimension n % 32
      dense_tile(sA, CS, p.qkvw, C, 0,
                 [&](int n) { return (n >> 5) * C + hd * kHd + (n & 31); },
                 [&](int row, int col, float v0, float v1) {
                   const int part = col >> 5, d = col & 31;
                   const int wr = part * C + hd * kHd + d;
                   const float y0 = dense_out(v0, p.qkvb[wr]);
                   const float y1 = dense_out(v1, p.qkvb[wr + 1]);
                   if (part == 2) {
                     sVt[d * kVStride + row] = __float2bfloat16_rn(y0);
                     sVt[(d + 1) * kVStride + row] = __float2bfloat16_rn(y1);
                   } else {
                     __nv_bfloat16* q = (part == 0 ? sQ : sK) + row * kQStride + d;
                     *reinterpret_cast<uint32_t*>(q) = pack_bf16(y0, y1);
                   }
                 });
      __syncthreads();
      if (warp < kRows / 16)
        head_attention(sQ, sK, sVt, p.bias + (size_t)hd * kTok * kTok, mask_w,
                       p.scale, sB, CS, hd, warp * 16, lane);
    }
    __syncthreads();

    // proj, + residual: r1 = x + (bf16(O Wproj^T) + bproj) into sA
    for (int n0 = 0; n0 < C; n0 += kTile)
      dense_tile(sB, CS, p.projw, C, n0, Identity(),
                 [&](int row, int col, float v0, float v1) {
                   float x0 = 0.f, x1 = 0.f;
                   if (row < kTok) {
                     x0 = bf(xw[(size_t)row * C + col]);
                     x1 = bf(xw[(size_t)row * C + col + 1]);
                   }
                   *reinterpret_cast<uint32_t*>(sA + row * CS + col) =
                       pack_bf16(__fadd_rn(x0, dense_out(v0, p.projb[col])),
                                 __fadd_rn(x1, dense_out(v1, p.projb[col + 1])));
                 });
    __syncthreads();
    for (int r = warp; r < kRows; r += kThreads / 32)
      ln_row(sA + r * CS, sB + r * CS, C, p.ln2w, p.ln2b, p.eps, lane);
    __syncthreads();

    // fc1 + GELU into this block's workspace slot
    for (int n0 = 0; n0 < C4; n0 += kTile)
      dense_tile(sB, CS, p.fc1w, C, n0, Identity(),
                 [&](int row, int col, float v0, float v1) {
                   *reinterpret_cast<uint32_t*>(gF + (size_t)row * C4 + col) =
                       pack_bf16(gelu_poly(dense_out(v0, p.fc1b[col])),
                                 gelu_poly(dense_out(v1, p.fc1b[col + 1])));
                 });
    __syncthreads();

    // fc2, + residual: out = r1 + (bf16(f1 Wfc2^T) + bfc2), real rows only
    __nv_bfloat16* ow = p.out + (size_t)w * kTok * C;
    for (int n0 = 0; n0 < C; n0 += kTile)
      dense_tile(gF, C4, p.fc2w, C4, n0, Identity(),
                 [&](int row, int col, float v0, float v1) {
                   if (row >= kTok) return;
                   const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
                       sA + row * CS + col);
                   *reinterpret_cast<uint32_t*>(ow + (size_t)row * C + col) =
                       pack_bf16(__fadd_rn(bf(r.x), dense_out(v0, p.fc2b[col])),
                                 __fadd_rn(bf(r.y), dense_out(v1, p.fc2b[col + 1])));
                 });
    __syncthreads();  // sA, sB and the slot are free for the next window
  }
}

int prepare(int C) {
  return (int)cudaFuncSetAttribute(swin_block_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(C));
}

}  // namespace

// The number of blocks the kernel keeps resident on the current device at
// width `channels`: the largest grid it is launched with, one workspace slot
// each. Returns a cudaError_t (0 on success).
extern "C" int macaque_swin_block_slots(int channels, int* slots) {
  if (channels <= 0 || channels % kTile || channels > 768) return (int)cudaErrorInvalidValue;
  int err = prepare(channels);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swin_block_kernel, kThreads,
                                                      smem_bytes(channels));
  if (e != cudaSuccess) return (int)e;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  return 0;
}

// x, out (windows, 49, channels) bf16; tok_valid (windows, 49) uint8; bias
// (heads, 49, 49) f32; mask (n_mask, 49, 49) f32 or null, window w masked by
// mask[w % n_mask]; LayerNorm weights and biases (channels) f32; Dense
// weights (out, in) and biases bf16; workspace (slots, 64, 4 * channels)
// bf16 with slots <= macaque_swin_block_slots; channels = 32 * heads, a
// multiple of 96 up to 768. Returns a cudaError_t (0 on success).
extern "C" int macaque_swin_block(
    const void* x, const void* tok_valid, const void* bias, const void* mask,
    const void* ln1w, const void* ln1b, const void* qkvw, const void* qkvb,
    const void* projw, const void* projb, const void* ln2w, const void* ln2b,
    const void* fc1w, const void* fc1b, const void* fc2w, const void* fc2b,
    void* out, void* workspace, int windows, int channels, int heads, int n_mask,
    int slots, float eps, void* stream) {
  if (windows <= 0 || slots <= 0 || channels != heads * kHd || channels % kTile ||
      channels > 768 || (mask && (n_mask <= 0 || windows % n_mask)))
    return (int)cudaErrorInvalidValue;
  int err = prepare(channels);
  if (err) return err;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.tok_valid = static_cast<const uint8_t*>(tok_valid);
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.ln1w = static_cast<const float*>(ln1w);
  p.ln1b = static_cast<const float*>(ln1b);
  p.qkvw = static_cast<const __nv_bfloat16*>(qkvw);
  p.qkvb = static_cast<const __nv_bfloat16*>(qkvb);
  p.projw = static_cast<const __nv_bfloat16*>(projw);
  p.projb = static_cast<const __nv_bfloat16*>(projb);
  p.ln2w = static_cast<const float*>(ln2w);
  p.ln2b = static_cast<const float*>(ln2b);
  p.fc1w = static_cast<const __nv_bfloat16*>(fc1w);
  p.fc1b = static_cast<const __nv_bfloat16*>(fc1b);
  p.fc2w = static_cast<const __nv_bfloat16*>(fc2w);
  p.fc2b = static_cast<const __nv_bfloat16*>(fc2b);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.work = static_cast<__nv_bfloat16*>(workspace);
  p.windows = windows;
  p.C = channels;
  p.heads = heads;
  p.n_mask = n_mask;
  p.eps = eps;
  p.scale = (float)(1.0 / sqrt((double)kHd));  // head_dim ** -0.5, rounded once
  const int grid = windows < slots ? windows : slots;
  swin_block_kernel<<<grid, kThreads, smem_bytes(channels),
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
