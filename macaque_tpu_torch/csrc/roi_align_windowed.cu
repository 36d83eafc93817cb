// Windowed pyramid RoIAlign for the Mask R-CNN box head (K2).
//
// Replaces macaque_tpu/nn/pallas_roialign.py::roi_align_windowed_fused
// (_kernel), the window-bucket specialisations roi_align_windowed_switch
// selects included: mmcv aligned RoIAlign, 7x7 output, sampling ratio 2, in
// its separable form. For RoI r the per-axis interpolation matrices Ky, Kx
// (7 x window, the s x s sample average and mmcv's border rules folded in,
// built in plain PyTorch by nn/ops.py::_roi_window_geometry and rounded to
// bf16 by nn/roialign.py::window_inputs, as the TPU kernel is fed) give
//   out[r, p, q, c] = sum_i sum_j Ky[r, p, i] Kx[r, q, j] F[bl, y0 + i, x0 + j, c]
// over one window x window block F of the channels-last level canvas.
//
// What bounds it on an H100: bytes. The call reads the canvas pixels that
// carry a nonzero weight, once, and writes 49 * C outputs a RoI; the dense
// product would be 2 * C * (7 * window^2 + 49 * window) FLOP a RoI, far below
// what the card computes per byte of HBM. But most of that product is zeros:
// sampling ratio 2 puts at most 4 nonzero entries in a row of Ky (two
// samples, two bilinear taps each), so at most 28 of a window's rows carry a
// weight (and as few as 2 for a RoI under a pixel), and likewise its columns.
//
// Design: one block of 4 warps per (RoI, 128 channels), 32 channels a warp.
// - The block reads Ky and Kx (f32) once, finds the rows with a nonzero Ky
//   entry and the columns with a nonzero Kx entry (two ballots), and keeps
//   them compacted in shared memory in ascending order: Ky^T as bf16 B
//   fragments over the compacted rows (exact: window_inputs rounds Ky to the
//   bf16 canvas dtype, and roi_align_windows refuses a Ky with more bits,
//   which would be rounded here), Kx as f32 rows. Rows and columns without
//   a weight are never read: the terms skipped are exact zeros.
// - mid = Ky F runs on mma.sync m16n8k16 bf16 with f32 accumulation (every
//   product exact): for each weighted window column j, mid_j^T (C x 8) =
//   F[rows, j, :]^T (C x rows) * Ky^T (rows x 8), the 7 output rows p
//   filling an n8 tile, 16 rows (one k16 step) a pass. The A fragments
//   are the column's weighted pixels, staged by a per-warp 8-slot
//   cp.async ring of 16-row passes (16-byte copies of the warp's 64 bytes of each
//   pixel, rows padded to 80 bytes for conflict-free ldmatrix) and read
//   with ldmatrix.x4.trans. No block barrier after the prologue.
// - mid stays f32, as in the TPU kernel, where dot_general(kx, mid) runs in
//   f32: the second product out[p, q] += Kx[q, j] mid_j[p] is f32 FMAs on
//   the accumulators, in ascending j, as the dense loop ran them.
// - The 7 x 7 x 32 outputs of a warp are rounded to bf16 once, staged in
//   its ring and written as 16-byte rows.
// The TPU kernel's x-start rounding to multiples of 8 was a Mosaic DMA
// constraint and is not carried over. The window is a runtime argument, so
// one kernel serves every bucket (16/24/32/48).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kOut = 7;
constexpr int kMaxWindow = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;       // 64 row flags, then 64 column flags
constexpr int kWarpChannels = 32;           // two m16 tiles a warp
constexpr int kBlockChannels = kWarps * kWarpChannels;
constexpr int kPassRows = 16;               // weighted rows a stage holds: a k16 step
constexpr int kRowStride = kWarpChannels + 8;  // 80-byte stage rows
constexpr int kStages = 8;
constexpr int kStageElems = kPassRows * kRowStride;
constexpr int kKyStride = kMaxWindow + 8;   // conflict-free B fragment loads
constexpr int kOutStride = kWarpChannels + 8;  // staged output rows
static_assert(kThreads == 2 * kMaxWindow, "a flag per row and per column");
static_assert(kOut * kOut * kOutStride <= kStages * kStageElems,
              "the output fits the ring");

__global__ void __launch_bounds__(kThreads, 5)
roi_align_windowed_kernel(const __nv_bfloat16* __restrict__ canvas,
                          const int* __restrict__ plane,
                          const int* __restrict__ ystart,
                          const int* __restrict__ xstart,
                          const float* __restrict__ ky,
                          const float* __restrict__ kx,
                          __nv_bfloat16* __restrict__ out, int H0, int W0,
                          int C, int window) {
  __shared__ __align__(16) __nv_bfloat16 sRing[kWarps][kStages * kStageElems];
  __shared__ __align__(16) __nv_bfloat16 sKy[8 * kKyStride];   // [p][row rank]
  __shared__ __align__(16) float sKx[kMaxWindow * 8];          // [col rank][q]
  __shared__ int sRowOff[kMaxWindow], sColOff[kMaxWindow];  // in elements
  __shared__ unsigned sFlags[4];

  const int r = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- prologue: the weighted rows (threads 0-63) and columns (64-127)
  for (int i = tid; i < 8 * kKyStride / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(sKy)[i] = 0u;
  const bool is_row = tid < kMaxWindow;
  const int idx = tid % kMaxWindow;
  float v[kOut];
  bool live = false;
  const float* kmat = (is_row ? ky : kx) + (size_t)r * kOut * window + idx;
#pragma unroll
  for (int p = 0; p < kOut; ++p) {
    v[p] = idx < window ? kmat[p * window] : 0.f;
    live |= v[p] != 0.f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) sFlags[warp] = ballot;
  __syncthreads();   // sKy zeroed, flags visible
  const unsigned lo = sFlags[is_row ? 0 : 2], hi = sFlags[is_row ? 1 : 3];
  const int rank = idx < 32 ? __popc(lo & ((1u << idx) - 1u))
                            : __popc(lo) + __popc(hi & ((1u << (idx - 32)) - 1u));
  if (live) {
    if (is_row) {
      sRowOff[rank] = idx * W0 * C;
#pragma unroll
      for (int p = 0; p < kOut; ++p)
        sKy[p * kKyStride + rank] = __float2bfloat16_rn(v[p]);
    } else {
      sColOff[rank] = idx * C;
#pragma unroll
      for (int q = 0; q < kOut; ++q) sKx[rank * 8 + q] = v[q];
    }
  }
  // a RoI with no weighted row or no weighted column outputs zeros
  const int n_rows = __popc(sFlags[0]) + __popc(sFlags[1]);
  const int n_cols = n_rows ? __popc(sFlags[2]) + __popc(sFlags[3]) : 0;
  __syncthreads();   // the compacted lists and matrices

  const int c0 = blockIdx.y * kBlockChannels + warp * kWarpChannels;
  if (c0 >= C) return;   // no block barrier follows

  // the same start clamping as a window slice of the canvas
  const int y0 = min(max(ystart[r], 0), H0 - window);
  const int x0 = min(max(xstart[r], 0), W0 - window);
  const __nv_bfloat16* base =
      canvas + (((size_t)plane[r] * H0 + y0) * W0 + x0) * C + c0;
  __nv_bfloat16* ring = sRing[warp];

  // a column's weighted rows in passes of 16, one k16 step each (one or
  // two for sampling ratio 2, whose rows are at most 28); (ijc, ipass) is
  // the next pass to stage, islot its ring slot
  const int passes = (n_rows + kPassRows - 1) / kPassRows;
  const int c8 = (lane % 4) * 8;           // this lane's 16 bytes of a pixel
  int ijc = 0, ipass = 0, islot = 0;
  auto issue = [&]() {
    if (ijc < n_cols) {
      const int r0 = ipass * kPassRows;
      const int rows = min(kPassRows, n_rows - r0);
      const __nv_bfloat16* col = base + sColOff[ijc] + c8;
      __nv_bfloat16* st = ring + islot * kStageElems + c8;
#pragma unroll
      for (int it = 0; it < kPassRows / 8; ++it) {
        const int k = it * 8 + lane / 4;
        const bool full = k < rows;
        cp_async16_zfill(st + k * kRowStride, col + sRowOff[r0 + (full ? k : 0)], full);
      }
      if (++ipass == passes) {
        ipass = 0;
        ++ijc;
      }
    }
    cp_async_commit();   // empty groups keep the count uniform
    islot = islot + 1 == kStages ? 0 : islot + 1;
  };

  const int g = lane / 4, t = lane % 4;   // mma fragment row, column pair
  float acc[2][4][kOut];                  // [m tile][mid element][q]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < kOut; ++q) acc[mt][e][q] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();
  int slot = 0;
  for (int jc = 0; jc < n_cols; ++jc) {
    float mid[2][4] = {};
    for (int pass = 0; pass < passes; ++pass) {
      issue();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const __nv_bfloat16* st = ring + slot * kStageElems;
      const __nv_bfloat16* kyf = sKy + g * kKyStride + pass * kPassRows + 2 * t;
      const uint32_t b0 = ld32(kyf), b1 = ld32(kyf + 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        ldsm_x4_trans(a, smem_u32(st + ldsm_b_row(lane) * kRowStride + mt * 16 +
                                  ldsm_b_col(lane) * 8));
        mma_bf16(mid[mt], a, b0, b1);
      }
      __syncwarp();   // every lane is done with this slot
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
    // mid_j is complete: out += Kx[:, j] mid_j, for the q with a nonzero
    // weight (1-3 of 7 where bins span a pixel or more; every lane reads the
    // same Kx, so the branch is uniform across the warp)
    const float4 ka = *reinterpret_cast<const float4*>(sKx + jc * 8);
    const float4 kb = *reinterpret_cast<const float4*>(sKx + jc * 8 + 4);
    const float kq[kOut] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z};
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      if (kq[q] != 0.f) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][e][q] = fmaf(kq[q], mid[mt][e], acc[mt][e][q]);
      }
    }
  }

  // ---- epilogue: bf16 outputs staged in the ring as [p * 7 + q][channel]
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 2 * t + (e & 1), c = mt * 16 + g + (e >> 1) * 8;
      if (p < kOut) {
#pragma unroll
        for (int q = 0; q < kOut; ++q)
          ring[(p * kOut + q) * kOutStride + c] = __float2bfloat16_rn(acc[mt][e][q]);
      }
    }
  __syncwarp();
  __nv_bfloat16* o = out + (size_t)r * kOut * kOut * C + c0;
  for (int i = lane; i < kOut * kOut * 4; i += 32) {
    const int pq = i / 4, c8 = (i % 4) * 8;
    *reinterpret_cast<uint4*>(o + (size_t)pq * C + c8) =
        *reinterpret_cast<const uint4*>(ring + pq * kOutStride + c8);
  }
}

}  // namespace

// canvas (planes, H0, W0, C) bf16 contiguous, C a multiple of 32; plane/
// ystart/xstart (n_rois,) int32; ky/kx (n_rois, 7, window) f32, ky's values
// bf16-representable -> out (n_rois, 7, 7, C) bf16. canvas and out 16-byte
// aligned. Returns a cudaError_t (0 on success).
extern "C" int macaque_roi_align_windowed(const void* canvas, const void* plane,
                                          const void* ystart, const void* xstart,
                                          const void* ky, const void* kx,
                                          void* out, int n_rois, int H0, int W0,
                                          int C, int window, void* stream) {
  // (offsets inside a window are int: window * W0 * C < 2^31)
  if (n_rois < 0 || window < 1 || window > kMaxWindow || window > H0 ||
      window > W0 || C <= 0 || C % kWarpChannels != 0 ||
      (long long)window * W0 * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(canvas) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (n_rois == 0) return 0;
  dim3 grid(n_rois, (C + kBlockChannels - 1) / kBlockChannels);
  roi_align_windowed_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(canvas), static_cast<const int*>(plane),
      static_cast<const int*>(ystart), static_cast<const int*>(xstart),
      static_cast<const float*>(ky), static_cast<const float*>(kx),
      static_cast<__nv_bfloat16*>(out), H0, W0, C, window);
  return (int)cudaGetLastError();
}

// The blocks of the kernel one SM of the current device keeps resident.
// Returns a cudaError_t (0 on success).
extern "C" int macaque_roi_align_windowed_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, roi_align_windowed_kernel, kThreads, 0);
}
