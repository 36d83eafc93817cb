// Attention with ViTDet's decomposed relative position (K7).
//
// For the ViTDet-H backbone (nn/vit.py::Attention with rel_pos): per (frame
// or window, head), over the T tokens of a G x G grid (row-major),
//   S[q, k] = (Q K^T)[q, k] * scale + rel_h[q, k_h] + rel_w[q, k_w],
//   P = softmax_rows(S),  O = P V,
// with (k_h, k_w) = divmod(k, G) and rel_h, rel_w the float32 factors
// q . Rh[q_h - k_h] and q . Rw[q_w - k_w] of the unscaled queries, which the
// caller computes as one small product each. The bias is formed inside the
// tile from those two (T, G) tables: the (T, T) bias a materialized form
// would take (17 GB in bf16 for a 32-frame chunk's global block) is never
// written. Inputs are the packed qkv Dense output (B, T, 3C) bf16 and the
// tables (B, heads, T, G) float32; the output is (B, T, C) bf16, the layout
// the output projection reads. ViTDet-H runs it at two shapes of one head
// size, d = 80:
// - G = 64, T = 4,096: the four global blocks, one frame a sequence. One
//   (frame, head) reads 2.1 MB and does 5.4 GFLOP, ~2,600 FLOP a byte:
//   bound by operations.
// - G = 14, T = 196: the 28 window blocks, one window a sequence (25 a
//   frame, 800 a 32-frame chunk). One (window, head) reads 147 KB (the
//   tables 22 KB of it) and does 12 MFLOP, ~84 FLOP a byte: bound by bytes.
// There is no counterpart in the JAX package.
//
// Design: flash attention on mma.sync (the PTX of ptx.cuh, the fragment
// layouts of attention_core.cuh). A block of 4 warps takes 64 query rows of
// one (sequence, head), each warp 16; the keys stream through shared memory
// in 64-key tiles, K and V double-buffered by cp.async (zero-filled past T),
// rows padded to 88 elements so that ldmatrix reads 8 distinct bank groups.
// - S = Q K^T on m16n8k16 bf16 with f32 accumulation, Q fragments from
//   global memory into registers once (rows past T read as zero).
// - The logits are taken in log2 units, s * scale * log2(e) + bias *
//   log2(e), and the row softmax runs online in f32: the row maximum and
//   sum are carried across tiles and O is rescaled when the maximum moves.
//   P, unnormalized in (0, 1], is rounded to bf16 for P V (K1 rounds its
//   normalized P the same way); O is divided by the row sum at the end.
// - The bias: at G = 64 a key tile is one row of the key grid, so k_h is
//   the tile and k_w the column: each lane keeps its 32 rel_w entries in
//   registers for the whole sweep and reads two rel_h entries a tile. At
//   G = 14 both tables' rows of the block (2 x 64 x 14 floats) sit in
//   shared memory and each score reads its two entries there.
// - Keys past T (the last of the four tiles of a window holds 4 of its 64)
//   are masked to -inf, and their 16-key steps skip the mma entirely.
// Shared memory: 45 KB a block (52 KB at G = 14).

#include "ptx.cuh"

namespace {

constexpr int kD = 80;                 // head size (ViT-H: 1280 / 16)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;       // query rows a block
constexpr int kBK = 64;                // keys a tile
constexpr int kKS = kD + 8;            // K, V rows in shared memory (bf16)
constexpr int kVec = kD / 8;           // 16-byte pieces of a row
constexpr float kLog2e = 1.4426950408889634f;

struct RelposArgs {
  const __nv_bfloat16* qkv;  // (B, T, 3C)
  const float* rel_h;        // (B, heads, T, G)
  const float* rel_w;        // (B, heads, T, G)
  __nv_bfloat16* out;        // (B, T, C)
  int heads;
  float scale;
};

template <int G>
struct RelposShape {
  static constexpr int T = G * G;
  static constexpr int kQBlocks = (T + kBQ - 1) / kBQ;
  static constexpr int kTiles = (T + kBK - 1) / kBK;
  // a key tile is one row of the key grid: rel_w in registers
  static constexpr bool kRowTiles = G == kBK;
  static constexpr int kKVBytes = 2 * 2 * kBK * kKS * 2;  // K, V x 2 stages
  static constexpr int kTableBytes = kRowTiles ? 0 : 2 * kBQ * G * 4;
  static constexpr int kSmemBytes = kKVBytes + kTableBytes;
};

// One block: 64 query rows of (sequence, head); blockIdx.x =
// (sequence * heads + head) * kQBlocks + query block.
template <int G>
__global__ void __launch_bounds__(kThreads, 2) relpos_attention_kernel(RelposArgs a) {
  using S = RelposShape<G>;
  constexpr int T = S::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kBK][kKS]
  __nv_bfloat16* sV = sK + 2 * kBK * kKS;
  float* sRH = reinterpret_cast<float*>(smem_raw + S::kKVBytes);   // [kBQ][G]
  float* sRW = sRH + kBQ * G;

  const int qb = blockIdx.x % S::kQBlocks;
  const int bh = blockIdx.x / S::kQBlocks;
  const int b = bh / a.heads, h = bh % a.heads;
  const int C = a.heads * kD;
  const size_t row3 = 3 * (size_t)C;  // token stride of qkv
  const __nv_bfloat16* qp = a.qkv + (size_t)b * T * row3 + (size_t)h * kD;
  const __nv_bfloat16* kp = qp + C;
  const __nv_bfloat16* vp = qp + 2 * C;
  const float* rh = a.rel_h + (size_t)bh * T * G;
  const float* rw = a.rel_w + (size_t)bh * T * G;
  const int q0 = qb * kBQ;

  // key tile `tile` of K and V into stage `st`, rows past T zero-filled
  auto stage = [&](int tile, int st) {
    __nv_bfloat16* dk = sK + st * kBK * kKS;
    __nv_bfloat16* dv = sV + st * kBK * kKS;
    for (int idx = threadIdx.x; idx < kBK * kVec; idx += kThreads) {
      const int n = idx / kVec, c8 = (idx % kVec) * 8;
      const int key = tile * kBK + n;
      const bool full = key < T;
      const size_t off = (size_t)(full ? key : 0) * row3 + c8;
      cp_async16_zfill(dk + n * kKS + c8, kp + off, full);
      cp_async16_zfill(dv + n * kKS + c8, vp + off, full);
    }
  };
  stage(0, 0);
  cp_async_commit();
  if constexpr (!S::kRowTiles) {
    for (int idx = threadIdx.x; idx < kBQ * G; idx += kThreads) {
      const bool in = q0 + idx / G < T;
      sRH[idx] = in ? rh[(size_t)q0 * G + idx] * kLog2e : 0.f;
      sRW[idx] = in ? rw[(size_t)q0 * G + idx] * kLog2e : 0.f;
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row, column pair
  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this lane's query rows
  const bool va = ra < T, vb = rb < T;

  uint32_t qa[kD / 16][4];
  {
    const __nv_bfloat16* qA = qp + (size_t)(va ? ra : 0) * row3 + 2 * t;
    const __nv_bfloat16* qB = qp + (size_t)(vb ? rb : 0) * row3 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qa[kk][0] = va ? ld32(qA + kk * 16) : 0u;
      qa[kk][1] = vb ? ld32(qB + kk * 16) : 0u;
      qa[kk][2] = va ? ld32(qA + kk * 16 + 8) : 0u;
      qa[kk][3] = vb ? ld32(qB + kk * 16 + 8) : 0u;
    }
  }
  // G = 64: this lane's rel_w columns (j * 8 + 2t, + 1) of rows ra and rb
  float rwa[kBK / 8][2], rwb[kBK / 8][2];
  if constexpr (S::kRowTiles) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 wa = va ? *reinterpret_cast<const float2*>(rw + (size_t)ra * G + col)
                           : make_float2(0.f, 0.f);
      const float2 wb = vb ? *reinterpret_cast<const float2*>(rw + (size_t)rb * G + col)
                           : make_float2(0.f, 0.f);
      rwa[j][0] = wa.x * kLog2e;
      rwa[j][1] = wa.y * kLog2e;
      rwb[j][0] = wb.x * kLog2e;
      rwb[j][1] = wb.y * kLog2e;
    }
  }

  const float cs = a.scale * kLog2e;
  const float kNegInf = __int_as_float(0xff800000);
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // ldmatrix rows as in attention_core.cuh: K (x4) b0, b1 of two n8 key
  // tiles; V (x4.trans) b0, b1 of two n8 d tiles
  const uint32_t kBase = smem_u32(sK + ldsm_b_row(lane) * kKS + ldsm_b_col(lane) * 8);
  const uint32_t vBase = smem_u32(sV + ldsm_a_row(lane) * kKS + ldsm_a_col(lane) * 8);
  constexpr uint32_t kStageBytes = kBK * kKS * 2;
  const int rowA = warp * 16 + g, rowB = rowA + 8;  // rows in the block

#pragma unroll 1
  for (int tile = 0; tile < S::kTiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < S::kTiles) stage(tile + 1, st ^ 1);
    cp_async_commit();
    float rha = 0.f, rhb = 0.f;
    if constexpr (S::kRowTiles) {  // k_h = tile for every key of the tile
      rha = va ? rh[(size_t)ra * G + tile] * kLog2e : 0.f;
      rhb = vb ? rh[(size_t)rb * G + tile] * kLog2e : 0.f;
    }
    cp_async_wait<1>();  // this tile has landed (the next may be in flight)
    __syncthreads();
    const int valid = min(kBK, T - tile * kBK);  // keys of the tile below T

    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t kAddr = kBase + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kBK / 16; ++jj) {
        if (jj * 16 < valid) {
          uint32_t bk[4];
          ldsm_x4(bk, kAddr + (jj * 16 * kKS + kk * 16) * 2);
          mma_bf16(s[2 * jj], qa[kk], bk[0], bk[1]);
          mma_bf16(s[2 * jj + 1], qa[kk], bk[2], bk[3]);
        }
      }
    }

    // logits in log2 units; keys past T at -inf
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const bool lower = e >= 2;  // row rb
        float bias;
        if constexpr (S::kRowTiles) {
          bias = lower ? rhb + rwb[j][e & 1] : rha + rwa[j][e & 1];
        } else {
          const int key = min(tile * kBK + col, T - 1);
          const int kh = key / G, kw = key - kh * G;
          const int r = lower ? rowB : rowA;
          bias = sRH[r * G + kh] + sRW[r * G + kw];
        }
        s[j][e] = col < valid ? fmaf(s[j][e], cs, bias) : kNegInf;
      }
    }

    // online softmax: every tile holds a key below T, so the maxima are finite
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float ca = exp2f(m_a - mx_a), cb = exp2f(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mx_a);
      s[j][1] = exp2f(s[j][1] - mx_a);
      s[j][2] = exp2f(s[j][2] - mx_b);
      s[j][3] = exp2f(s[j][3] - mx_b);
      sa += s[j][0] + s[j][1];
      sb += s[j][2] + s[j][3];
    }
    l_a = l_a * ca + sa;  // this lane's part of the row sums
    l_b = l_b * cb + sb;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= ca;
      o[j][1] *= ca;
      o[j][2] *= cb;
      o[j][3] *= cb;
    }

    // O += P V: score tiles 2kk and 2kk + 1 are the A fragment of key step kk
    const uint32_t vAddr = vBase + st * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk * 16 < valid) {
        const int j0 = 2 * kk, j1 = 2 * kk + 1;
        uint32_t ph[4];
        ph[0] = pack_bf16(s[j0][0], s[j0][1]);
        ph[1] = pack_bf16(s[j0][2], s[j0][3]);
        ph[2] = pack_bf16(s[j1][0], s[j1][1]);
        ph[3] = pack_bf16(s[j1][2], s[j1][3]);
#pragma unroll
        for (int jp = 0; jp < kD / 16; ++jp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vAddr + (kk * 16 * kKS + jp * 16) * 2);
          mma_bf16(o[2 * jp], ph, bv[0], bv[1]);
          mma_bf16(o[2 * jp + 1], ph, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float ia = 1.f / l_a, ib = 1.f / l_b;
  __nv_bfloat16* oA = a.out + ((size_t)b * T + ra) * C + (size_t)h * kD + 2 * t;
  __nv_bfloat16* oB = oA + (size_t)8 * C;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    if (va) *reinterpret_cast<uint32_t*>(oA + j * 8) = pack_bf16(o[j][0] * ia, o[j][1] * ia);
    if (vb) *reinterpret_cast<uint32_t*>(oB + j * 8) = pack_bf16(o[j][2] * ib, o[j][3] * ib);
  }
}

template <int G>
int prepare() {
  cudaError_t err = cudaFuncSetAttribute(relpos_attention_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         RelposShape<G>::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(relpos_attention_kernel<G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

template <int G>
int launch(const RelposArgs& a, int batch, cudaStream_t stream) {
  int err = prepare<G>();
  if (err) return err;
  relpos_attention_kernel<G><<<batch * a.heads * RelposShape<G>::kQBlocks, kThreads,
                               RelposShape<G>::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int G>
int resident(int* blocks) {
  int err = prepare<G>();
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, relpos_attention_kernel<G>, kThreads, RelposShape<G>::kSmemBytes);
}

}  // namespace

// qkv (batch, tokens, 3 * heads * head_dim) bf16, contiguous and 16-byte
// aligned; rel_h, rel_w (batch, heads, tokens, grid) float32, contiguous;
// out (batch, tokens, heads * head_dim) bf16. tokens = grid^2, grid 14 or
// 64, head_dim 80. Returns a cudaError_t (0 on success).
extern "C" int macaque_relpos_attention(const void* qkv, const void* rel_h,
                                        const void* rel_w, void* out, int batch,
                                        int tokens, int heads, int head_dim,
                                        int grid, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || head_dim != kD || tokens != grid * grid)
    return (int)cudaErrorInvalidValue;
  const RelposArgs a{static_cast<const __nv_bfloat16*>(qkv),
                     static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
                     static_cast<__nv_bfloat16*>(out), heads, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grid == 14) return launch<14>(a, batch, s);
  if (grid == 64) return launch<64>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

// The blocks of the kernel at `grid` (14 or 64) one SM of the current
// device keeps resident. Returns a cudaError_t (0 on success).
extern "C" int macaque_relpos_attention_blocks_per_sm(int grid, int* blocks) {
  if (grid == 14) return resident<14>(blocks);
  if (grid == 64) return resident<64>(blocks);
  return (int)cudaErrorInvalidValue;
}
