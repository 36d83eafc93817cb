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
// one block's weights (50 MB), through shared memory.
//
// Design: a persistent grid -- as many 256-thread blocks as the card keeps
// resident -- walks the windows. A window's 49 tokens are padded to 64 rows
// (four m16 tiles): pad rows enter as zeros after LN1, and their columns are
// excluded from every softmax (exp(-inf) = 0), so they never touch a real
// row.
// - Every Dense runs as 64 x NT output tiles (NT = 192; 96 for proj and fc2
//   at C = 96) on mma.sync m16n8k16 bf16 with f32 accumulation, 8
//   warps (2 x 4, each 32 x NT/4). The weight's (NT x 32) K slabs stream
//   through a 3-stage ring in shared memory by cp.async.cg 16-byte copies,
//   one __syncthreads a slab, and all 8 warps take their B fragments from
//   it by ldmatrix.x4 (x2 for a third n8 tile); no B fragment comes from
//   global memory. The A operand is a panel resident in shared memory (qkv,
//   fc1) or, where it lives in the global slot (proj, fc2), its (64 x 32)
//   slabs ride in the same ring; A fragments come by ldmatrix.x4 too. Rows
//   are padded by 16 bytes (80-byte slab rows, C + 8 panel rows, C a
//   multiple of 96), so every ldmatrix phase reads 8 distinct 16-byte bank
//   groups. The epilogue loads its biases and residuals before it hands on
//   any output, so those loads overlap.
// - Shared memory holds one 64 x C bf16 panel (LN1's output, then LN2's)
//   and a 61,440-byte scratch region: the ring during a Dense, two heads'
//   Q, K and V^T during attention. The attention output, r1 and the GELU
//   activation (64 x 4C, which does not fit at C = 768) go to this block's
//   slot of a global workspace, 64 x 5C bf16 (the attention output shares
//   the activation's rows: fc1 writes them after proj has read it), and
//   come back through the ring (proj, fc2) or by plain loads (LN2, the fc2
//   residual). That is 112 KB at C = 384, where 75 % of the FLOP are: two
//   blocks fit an SM (__launch_bounds__(256, 2) caps a thread at 128
//   registers), so one block's LayerNorm, softmax and barriers overlap the
//   other's tensor-core work. At C = 768 one block fits (161 KB).
// - What holds it back on the H100: instruction issue, not the tensor
//   cores or L2. Variants built on the card showed it: without the weight
//   copies the time does not move, twice the mma add little, one block an
//   SM (no spills) is much slower at C <= 384, and computing the copies'
//   offsets once a tile, not every slab, made it faster. A mma is one
//   instruction in dozens; the exact GELU of the fc1 epilogue (an IEEE
//   division and expf an element) is the largest share of the rest.
// - Attention takes two heads at a time on all 8 warps: one qkv tile of 192
//   columns gives both heads' Q, K and V^T (64 x 32 each), four warps a
//   head each take 16 query rows with the scores in registers, and the
//   probabilities feed P V as the A operand without leaving registers. An
//   odd last head (C = 96: 3 heads) leaves warps 4-7 idle for that pair.

#include <math.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kMinBlocks = 2;  // resident blocks per SM the design holds at C <= 384
constexpr int kRows = 64;      // a window's tokens, padded
constexpr int kTok = 49;       // a 7 x 7 window
constexpr int kHd = 32;        // head width
constexpr int kTile = 96;      // output columns of a tile where C % 192 != 0 (C = 96)
constexpr int kWide = 192;     // output columns of a tile: qkv (two heads), fc1, and
                               // proj and fc2 where C % 192 == 0
constexpr int kSlab = 32;      // K elements (64 bytes) of a ring stage
constexpr int kSlabStride = kSlab + 8;  // ring rows (bf16)
constexpr int kChunks = kSlab / 8;      // 16-byte copies a slab row
constexpr int kStages = 3;
constexpr int kQStride = kHd + 8;     // sQ, sK rows (bf16)
constexpr int kVStride = kRows + 8;   // sVt rows (bf16)
constexpr int kHeadElems = 2 * kRows * kQStride + kHd * kVStride;  // one head's Q, K, V^T
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the scratch region: the widest ring (NT = 192 with A staged), or two
// heads' Q, K, V^T
constexpr int kScratchBytes = cmax(kStages * (kWide + kRows) * kSlabStride, 2 * kHeadElems) * 2;
static_assert(kScratchBytes == 61440, "the layout mirror in nn/swin_block.py");

__host__ __device__ constexpr int panel_stride(int C) { return C + 8; }

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)kRows * panel_stride(C) * 2 + kScratchBytes;
}

// bf16 elements of a block's workspace slot: GELU(fc1) (64 x 4C; its first
// 64 x C elements hold the attention output before fc1), then r1 (64 x C)
__host__ __device__ constexpr size_t slot_elems(int C) { return (size_t)kRows * 5 * C; }

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

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(v));
}
// bf16(acc) + bias (a bf16 value) in bf16: the Dense epilogue
__device__ __forceinline__ float dense_out(float acc, float b) {
  return rbf(__fadd_rn(rbf(acc), b));
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

// One 64 x NT output tile of a Dense: out[r][n] = sum_k A[r][k] W[wrow(n)][k]
// for the tile's columns n = n0 .. n0 + NT - 1; W is (rows, K) row-major
// (the port's Linear layout, K contiguous: the B operand's layout). A is a
// panel in shared memory (kStageA false) or 64 rows in global memory whose
// slabs ride in the ring beside W's (kStageA true). Warp (wm, wn) owns rows
// 32 wm .. + 31 and columns n0 + NT/4 wn .. + NT/4 - 1. The epilogue rounds
// each sum to bf16 and adds the bias bias[wrow(n)] in bf16 (dense_out);
// with kRes it then adds the residual res[r * ldr + n] in f32 (zero for
// r >= kTok). Biases and residuals are loaded before any output is passed
// on, so the loads overlap. `epi(row, col, y0, y1)` receives the values of
// columns col and col + 1, after a barrier that frees the ring (the scratch
// region may be written). The caller makes sure nobody still reads the
// scratch region when it is called.
template <int NT, bool kStageA, bool kRes, class Map, class Epi>
__device__ __forceinline__ void dense_tile(const __nv_bfloat16* A, int lda,
                                           const __nv_bfloat16* __restrict__ W,
                                           const __nv_bfloat16* __restrict__ bias,
                                           int K, int n0, Map wrow,
                                           const __nv_bfloat16* res, int ldr, Epi epi,
                                           __nv_bfloat16* ring) {
  constexpr int NJ = NT / 32;                    // n8 tiles a warp
  constexpr int kB = NT * kSlabStride;           // a stage's W slab (elements)
  constexpr int kStage = kB + (kStageA ? kRows * kSlabStride : 0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (NT / 4);
  const int nk = K / kSlab;

  // This thread's 16-byte copies of a slab, their offsets worked out once a
  // tile: copy i of W's slab is row tid / kChunks + i * kThreads / kChunks
  // of the tile, 8 columns (tid % kChunks) * 8 on; A's slab takes one copy
  // a thread at the same row and column.
  constexpr int kBCopies = NT * kChunks;
  constexpr int kBPer = (kBCopies + kThreads - 1) / kThreads;
  static_assert(!kStageA || kRows * kChunks == kThreads, "one A copy a thread");
  const int row0 = tid / kChunks, col0 = (tid % kChunks) * 8;
  int boff[kBPer];
#pragma unroll
  for (int i = 0; i < kBPer; ++i)
    boff[i] = wrow(n0 + min(row0 + i * (kThreads / kChunks), NT - 1)) * K + col0;
  const int aoff = row0 * lda + col0;
  const int soff = row0 * kSlabStride + col0;

  auto load = [&](int st, int kt) {
    __nv_bfloat16* sb = ring + st * kStage + soff;
    const int k0 = kt * kSlab;
#pragma unroll
    for (int i = 0; i < kBPer; ++i)
      if (kBCopies % kThreads == 0 || tid + i * kThreads < kBCopies)
        cp_async16(sb + i * (kThreads / kChunks) * kSlabStride, W + boff[i] + k0);
    if constexpr (kStageA) cp_async16(sb + kB, A + aoff + k0);
  };

  // this lane's ldmatrix addresses (bytes) in stage 0 / at k = 0
  const uint32_t bAddr = smem_u32(ring + (wn + ldsm_b_row(lane)) * kSlabStride +
                                  ldsm_b_col(lane) * 8);
  uint32_t aAddr;
  if constexpr (kStageA)
    aAddr = smem_u32(ring + kB + (wm + ldsm_a_row(lane)) * kSlabStride + ldsm_a_col(lane) * 8);
  else
    aAddr = smem_u32(A + (wm + ldsm_a_row(lane)) * lda + ldsm_a_col(lane) * 8);
  const int aRow16 = 16 * (kStageA ? kSlabStride : lda) * 2;  // bytes of 16 rows

  float acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

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

    const uint32_t st = (kt % kStages) * kStage * 2;
    const uint32_t a0 = aAddr + (kStageA ? st : kt * kSlab * 2);
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      uint32_t a[2][4], b[NJ][2];
      ldsm_x4(a[0], a0 + kk * 2);
      ldsm_x4(a[1], a0 + aRow16 + kk * 2);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, bAddr + st + (jp * 16 * kSlabStride + kk) * 2);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
      if constexpr (NJ % 2) {
        uint32_t r[2];
        ldsm_x2(r, bAddr + st + ((NJ - 1) * 8 * kSlabStride + kk) * 2);
        b[NJ - 1][0] = r[0];
        b[NJ - 1][1] = r[1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  float bv[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    bv[j][0] = bf(bias[wrow(col)]);
    bv[j][1] = bf(bias[wrow(col + 1)]);
  }
  __nv_bfloat162 rv[2][kRes ? NJ : 1][2];
  if constexpr (kRes) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm + i * 16 + g + 8 * h;
          rv[i][j][h] = row < kTok ? *reinterpret_cast<const __nv_bfloat162*>(
                                         res + (size_t)row * ldr + n0 + wn + j * 8 + 2 * t)
                                   : __floats2bfloat162_rn(0.f, 0.f);
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = dense_out(acc[i][j][2 * h], bv[j][0]);
        float y1 = dense_out(acc[i][j][2 * h + 1], bv[j][1]);
        if constexpr (kRes) {
          y0 = __fadd_rn(__low2float(rv[i][j][h]), y0);
          y1 = __fadd_rn(__high2float(rv[i][j][h]), y1);
        }
        epi(wm + i * 16 + g + 8 * h, n0 + wn + j * 8 + 2 * t, y0, y1);
      }
}

struct Identity {
  __device__ __forceinline__ int operator()(int n) const { return n; }
};

// proj or fc2: the 64 x C outputs of A (in the global slot) times W^T, plus
// a residual, in tiles of 192 columns where C allows (half the tiles, each
// slab step twice the mma a barrier), else 96
template <class Epi>
__device__ __forceinline__ void residual_dense(const __nv_bfloat16* A, int lda,
                                               const __nv_bfloat16* W,
                                               const __nv_bfloat16* bias, int K, int C,
                                               const __nv_bfloat16* res, Epi epi,
                                               __nv_bfloat16* ring) {
  if (C % kWide == 0) {
    for (int n0 = 0; n0 < C; n0 += kWide)
      dense_tile<kWide, true, true>(A, lda, W, bias, K, n0, Identity(), res, C, epi, ring);
  } else {
    for (int n0 = 0; n0 < C; n0 += kTile)
      dense_tile<kTile, true, true>(A, lda, W, bias, K, n0, Identity(), res, C, epi, ring);
  }
}

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

__global__ void __launch_bounds__(kThreads, kMinBlocks) swin_block_kernel(Params p) {
  const int C = p.C, CS = panel_stride(C), C4 = 4 * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // LN1(x), then LN2(r1)
  __nv_bfloat16* scratch = sH + kRows * CS;  // the ring, or two heads' Q, K, V^T
  __nv_bfloat16* gF = p.work + (size_t)blockIdx.x * slot_elems(C);  // GELU(fc1), 64 x 4C
  __nv_bfloat16* gO = gF;                    // attention output, 64 x C (before fc1)
  __nv_bfloat16* gR = gF + (size_t)kRows * C4;  // r1, 64 x C
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int w = blockIdx.x; w < p.windows; w += gridDim.x) {
    const __nv_bfloat16* xw = p.x + (size_t)w * kTok * C;
    const uint8_t* tv = p.tok_valid + (size_t)w * kTok;

    // LN1; pad rows and spatial-pad tokens are zeros
    for (int r = warp; r < kRows; r += kThreads / 32) {
      if (r < kTok && tv[r]) {
        ln_row(xw + (size_t)r * C, sH + r * CS, C, p.ln1w, p.ln1b, p.eps, lane);
      } else {
        for (int c = lane; c < C; c += 32) sH[r * CS + c] = __float2bfloat16_rn(0.f);
      }
    }

    const float* mask_w = p.mask ? p.mask + (size_t)(w % p.n_mask) * kTok * kTok : nullptr;
    for (int hd0 = 0; hd0 < p.heads; hd0 += 2) {
      const int nh = p.heads - hd0 < 2 ? 1 : 2;  // heads of this pair
      __syncthreads();  // LN1 written; the previous pair's attention is done
      // both heads' q, k, v columns of the qkv Dense: tile column n is head
      // hd0 + n / 96, part (n % 96) / 32 (q, k, v), dimension n % 32; a
      // missing second head repeats the first, and its columns are dropped
      dense_tile<kWide, false, false>(
          sH, CS, p.qkvw, p.qkvb, C, 0,
          [&](int n) {
            const int hd = hd0 + (n >= kTile && nh == 2), c = n % kTile;
            return (c >> 5) * C + hd * kHd + (c & 31);
          },
          nullptr, 0,
          [&](int row, int col, float y0, float y1) {
            const int slot = col / kTile;
            if (slot >= nh) return;
            const int c = col % kTile, part = c >> 5, d = c & 31;
            __nv_bfloat16* sQ = scratch + slot * kHeadElems;
            __nv_bfloat16* sK = sQ + kRows * kQStride;
            __nv_bfloat16* sVt = sK + kRows * kQStride;
            if (part == 2) {
              sVt[d * kVStride + row] = __float2bfloat16_rn(y0);
              sVt[(d + 1) * kVStride + row] = __float2bfloat16_rn(y1);
            } else {
              *reinterpret_cast<uint32_t*>((part == 0 ? sQ : sK) + row * kQStride + d) =
                  pack_bf16(y0, y1);
            }
          },
          scratch);
      __syncthreads();
      const int slot = warp >> 2;  // warps 0-3 the pair's first head, 4-7 its second
      if (slot < nh) {
        const __nv_bfloat16* sQ = scratch + slot * kHeadElems;
        head_attention(sQ, sQ + kRows * kQStride, sQ + 2 * kRows * kQStride,
                       p.bias + (size_t)(hd0 + slot) * kTok * kTok, mask_w, p.scale, gO, C,
                       hd0 + slot, (warp & 3) * 16, lane);
      }
    }
    __syncthreads();  // the attention output is in the slot; the scratch is free

    // proj, + residual: r1 = x + (bf16(O Wproj^T) + bproj) into the slot
    residual_dense(gO, C, p.projw, p.projb, C, C, xw,
                   [&](int row, int col, float y0, float y1) {
                     *reinterpret_cast<uint32_t*>(gR + (size_t)row * C + col) = pack_bf16(y0, y1);
                   },
                   scratch);
    __syncthreads();
    for (int r = warp; r < kRows; r += kThreads / 32)
      ln_row(gR + (size_t)r * C, sH + r * CS, C, p.ln2w, p.ln2b, p.eps, lane);
    __syncthreads();

    // fc1 + GELU into the slot (over the attention output, which proj has read)
    for (int n0 = 0; n0 < C4; n0 += kWide)
      dense_tile<kWide, false, false>(sH, CS, p.fc1w, p.fc1b, C, n0, Identity(), nullptr, 0,
                                      [&](int row, int col, float y0, float y1) {
                                        *reinterpret_cast<uint32_t*>(gF + (size_t)row * C4 + col) =
                                            pack_bf16(gelu_poly(y0), gelu_poly(y1));
                                      },
                                      scratch);
    __syncthreads();

    // fc2, + residual: out = r1 + (bf16(f1 Wfc2^T) + bfc2), real rows only
    __nv_bfloat16* ow = p.out + (size_t)w * kTok * C;
    residual_dense(gF, C4, p.fc2w, p.fc2b, C4, C, gR,
                   [&](int row, int col, float y0, float y1) {
                     if (row < kTok)
                       *reinterpret_cast<uint32_t*>(ow + (size_t)row * C + col) = pack_bf16(y0, y1);
                   },
                   scratch);
    __syncthreads();  // the panel, the scratch and the slot are free for the next window
  }
}

int prepare(int C) {
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(C));
  if (err == cudaSuccess)  // two 112 KB blocks want the largest shared-memory carveout
    err = cudaFuncSetAttribute(swin_block_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

}  // namespace

// The kernel's layout at width `channels`: shared memory bytes a block and
// bf16 elements of a workspace slot (nn/swin_block.py mirrors both). Returns
// a cudaError_t (0 on success).
extern "C" int macaque_swin_block_layout(int channels, int* smem, int* slot) {
  if (channels <= 0 || channels % kTile || channels > 768) return (int)cudaErrorInvalidValue;
  *smem = (int)smem_bytes(channels);
  *slot = (int)slot_elems(channels);
  return 0;
}

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
// weights (out, in) and biases bf16; workspace (slots, 64, 5 * channels)
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
