// One attention template for the port's two (N = 192, d = 80) attention
// kernels: K1, packed ViTPose attention (packed_attention.cu), and K4,
// unpacked (B, N, H, D) attention (attention.cu). Each .cu defines its own
// __global__ kernel that calls attention_block<N, D, kSplitP> and its C
// entry points; this header holds everything they share.
//
// Per (sequence, head), one block of 4 warps computes
//   S = (Q K^T) * scale,  P = softmax_rows(S),  O = P V
// with the whole 192 x 192 score tile of a warp's 16 query rows in
// registers:
// - K and V are staged in shared memory by cp.async.cg 16-byte copies in two
//   commit groups, K then V, so that Q K^T starts while V is still in
//   flight. Both stay row-major, rows padded to 88 elements (176 bytes), so
//   every ldmatrix phase reads 8 rows from 8 distinct 16-byte bank groups.
//   That is 2 x 33.8 KB = 67.6 KB a block: 3 blocks (12 warps) on an SM,
//   which is also what the registers allow (__launch_bounds__(128, 3) caps a
//   thread at 168: 96 score and 40 output accumulators, the rest operands).
// - Q fragments come straight from global memory (each warp reads only its
//   own 16-row tiles, so a shared Q panel would be read once anyway).
// - S = Q K^T runs on mma.sync m16n8k16 bf16 with f32 accumulation, K's B
//   fragments from ldmatrix.x4. Products of two bf16 values are exact in
//   f32, so this is the TPU kernels' f32 dot up to summation order.
// - The row softmax runs in f32 on the accumulators (quad shuffles), as
//   exp2 of one FFMA per score (the scale folded into log2(e)), and P is
//   normalised by the reciprocal of the row sum. Both move P from the
//   plain version's exp(s * scale - m) / l by f32 roundings of the
//   exponent's argument, about 2^-24 times the row's largest |scaled
//   score| relative to P (2^-19 at 32): below the split's 2^-16 and the
//   bf16 rounding's 2^-8. An IEEE division per probability (__fdiv_rn)
//   would buy nothing the split keeps, and its slow path is a subroutine
//   call that makes the kernel spill.
// - P V runs on mma.sync as well: the accumulators of two adjacent n8
//   score tiles are the A fragment of one k16 step, and V's B fragments come
//   from ldmatrix.x4.trans. P never leaves registers.
// - kSplitP = false (K1) rounds P to bf16 once, as the TPU kernel
//   _attn_kernel_packed does (p.astype(qkv.dtype)). kSplitP = true (K4)
//   keeps P at f32 precision, as _attn_kernel does: the normalised P is
//   split as hi = bf16_rn(P), lo = bf16_rn(P - hi) (P - hi is exact in
//   f32), and O = hi V + lo V, both accumulated in f32 by
//   mma.sync. hi + lo carries P to 16 significant bits: |P - hi - lo| <=
//   2^-16 |P|, so O moves by at most 2^-16 * sum_m P_m |V_m| <= 2^-16
//   max|V|, next to 2^-8 max|V| if P were rounded once. Where the rows of V
//   cancel (|V| 64-256 times the output) only the split stays inside one
//   bf16 ulp of the output (tests/test_torch_attention.py emulates both).

#pragma once

#include "ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 3;  // resident blocks per SM that the design holds

// q, k, v point at (sequence 0, token 0, head 0) of each operand; token t of
// sequence b, head h starts at b * N * in_stride + t * in_stride + h * D (the
// same for out with out_stride). K4: in_stride = out_stride = H * D. K1: k
// and v are q + C and q + 2C of the packed rows, in_stride = 3C, out_stride
// = C.
struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  int heads;
  int in_stride;
  int out_stride;
  float scale;
};

template <int N, int D>
struct AttnShape {
  static_assert(N % 16 == 0 && D % 16 == 0, "N and d must be multiples of 16");
  static_assert((N / 16) % kWarps == 0, "every warp takes as many row tiles");
  static constexpr int kStride = D + 8;  // K, V rows in bf16 elements
  static constexpr int kSmemBytes = 2 * N * kStride * 2;
};

// The body of one block: (sequence, head) = divmod(blockIdx.x, heads).
template <int N, int D, bool kSplitP>
__device__ __forceinline__ void attention_block(const AttnArgs& a) {
  constexpr int KS = AttnShape<N, D>::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + N * KS;

  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const size_t in0 = (size_t)b * N * a.in_stride + (size_t)h * D;
  const size_t out0 = (size_t)b * N * a.out_stride + (size_t)h * D;

  // K, then V: 16-byte copies, neighbouring threads on neighbouring
  // addresses of one token's row, one commit group each
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < N * kVec; idx += kThreads) {
    const int n = idx / kVec, c8 = (idx % kVec) * 8;
    cp_async16(sK + n * KS + c8, a.k + in0 + (size_t)n * a.in_stride + c8);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < N * kVec; idx += kThreads) {
    const int n = idx / kVec, c8 = (idx % kVec) * 8;
    cp_async16(sV + n * KS + c8, a.v + in0 + (size_t)n * a.in_stride + c8);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row, column pair
  // this lane's ldmatrix row: for K (x4), matrices (keys +0, d +0), (+0, +8),
  // (+8, +0), (+8, +8) = b0, b1 of two n8 key tiles; for V (x4.trans),
  // (keys +0, d +0), (+8, +0), (+0, +8), (+8, +8) = b0, b1 of two n8 d tiles
  const uint32_t kAddr = smem_u32(sK + ldsm_b_row(lane) * KS + ldsm_b_col(lane) * 8);
  const uint32_t vAddr = smem_u32(sV + ldsm_a_row(lane) * KS + ldsm_a_col(lane) * 8);

#pragma unroll 1
  for (int rt = warp; rt < N / 16; rt += kWarps) {
    const bool first = rt == warp;  // the same iteration in every warp
    const int r0 = rt * 16;
    const __nv_bfloat16* q0 = a.q + in0 + (size_t)(r0 + g) * a.in_stride + 2 * t;
    const __nv_bfloat16* q8 = q0 + (size_t)8 * a.in_stride;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld32(q0 + kk * 16);
      qa[kk][1] = ld32(q8 + kk * 16);
      qa[kk][2] = ld32(q0 + kk * 16 + 8);
      qa[kk][3] = ld32(q8 + kk * 16 + 8);
    }
    if (first) {  // K has landed (V may still be in flight)
      cp_async_wait<1>();
      __syncthreads();
    }

    float s[N / 8][4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < N / 16; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, kAddr + (jj * 16 * KS + kk * 16) * 2);
        mma_bf16(s[2 * jj], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jj + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // f32 row softmax: rows g (s[.][0..1]) and g + 8 (s[.][2..3]); a row's
    // other columns live in the 3 other lanes of the quad. scale > 0, so the
    // row maximum of Q K^T gives that of the scaled scores, and
    // exp(scale * (s - m)) = exp2(s * c - m * c) with c = scale * log2(e):
    // one FFMA and one exp2f per score.
    float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const float c = a.scale * 1.4426950408889634f;
    const float mc0 = -m0 * c, mc1 = -m1 * c;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      s[j][0] = exp2f(fmaf(s[j][0], c, mc0));
      s[j][1] = exp2f(fmaf(s[j][1], c, mc0));
      s[j][2] = exp2f(fmaf(s[j][2], c, mc1));
      s[j][3] = exp2f(fmaf(s[j][3], c, mc1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;

    if (first) {  // V has landed
      cp_async_wait<0>();
      __syncthreads();
    }

    // O = P V: the accumulators of score tiles 2kk and 2kk + 1, times the
    // reciprocal row sum, are the A fragment of key step kk
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
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
        uint32_t bv[4];
        ldsm_x4_trans(bv, vAddr + (kk * 16 * KS + jp * 16) * 2);
        mma_bf16(o[2 * jp], ph, bv[0], bv[1]);
        mma_bf16(o[2 * jp + 1], ph, bv[2], bv[3]);
        if constexpr (kSplitP) {
          mma_bf16(o[2 * jp], pl, bv[0], bv[1]);
          mma_bf16(o[2 * jp + 1], pl, bv[2], bv[3]);
        }
      }
    }

    __nv_bfloat16* orow = a.out + out0 + (size_t)r0 * a.out_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(orow + (size_t)g * a.out_stride + col) =
          pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(orow + (size_t)(g + 8) * a.out_stride + col) =
          pack_bf16(o[j][2], o[j][3]);
    }
  }
}

using AttnKernel = void (*)(AttnArgs);

template <int N, int D>
int prepare(AttnKernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AttnShape<N, D>::kSmemBytes);
  if (err == cudaSuccess)  // 3 x 67.6 KB wants the largest shared-memory carveout
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

// One block per (sequence, head), on `stream`. Returns a cudaError_t.
template <int N, int D>
int launch(AttnKernel kernel, const AttnArgs& a, int batch, cudaStream_t stream) {
  int err = prepare<N, D>(kernel);
  if (err) return err;
  kernel<<<batch * a.heads, kThreads, AttnShape<N, D>::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of `kernel` one SM of the current device keeps resident.
template <int N, int D>
int resident_blocks(AttnKernel kernel, int* blocks) {
  int err = prepare<N, D>(kernel);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, AttnShape<N, D>::kSmemBytes);
}

}  // namespace
