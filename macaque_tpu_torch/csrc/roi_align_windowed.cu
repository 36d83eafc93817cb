// Windowed pyramid RoIAlign for the Mask R-CNN box head.
//
// Replaces macaque_tpu/nn/pallas_roialign.py::roi_align_windowed_fused
// (_kernel), the window-bucket specialisations roi_align_windowed_switch
// selects included: mmcv aligned RoIAlign, 7x7 output, sampling ratio 2, in
// its separable form. For RoI r the per-axis interpolation matrices Ky, Kx
// (7 x window, the s x s sample average and mmcv's border rules folded in,
// built in plain PyTorch by nn/ops.py::_roi_window_geometry) give
//   out[r, p, q, c] = sum_i sum_j Ky[r, p, i] Kx[r, q, j] F[bl, y0 + i, x0 + j, c]
// over one window x window block F of the channels-last level canvas.
//
// What bounds it on an H100: bytes. A RoI reads window^2 * C * 2 bytes of
// canvas and does 2 * C * (7 * window^2 + 49 * window) FLOP, about 7-10 FLOP
// per byte, far below what the card computes per byte of HBM. The design reads
// each window once, from consecutive addresses (neighbouring threads on
// neighbouring channel pairs, so a window row is one contiguous C * 2 byte
// run), never writes the window back (the XLA path materialised all windows),
// and keeps both interpolation products in registers with f32 accumulation.
// The TPU kernel's x-start rounding to multiples of 8 was a Mosaic DMA
// constraint and is not carried over. The window is a runtime argument, so one
// kernel serves every bucket (16/24/32/48).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 7;
constexpr int kMaxWindow = 64;
constexpr int kThreads = 128;  // channel pairs per block

__global__ void __launch_bounds__(kThreads)
roi_align_windowed_kernel(const __nv_bfloat16* __restrict__ canvas,
                          const int* __restrict__ plane,
                          const int* __restrict__ ystart,
                          const int* __restrict__ xstart,
                          const float* __restrict__ ky,
                          const float* __restrict__ kx,
                          __nv_bfloat16* __restrict__ out, int H0, int W0,
                          int C, int window) {
  __shared__ float sKy[kOut * kMaxWindow];
  __shared__ float sKx[kOut * kMaxWindow];
  const int r = blockIdx.x;
  const int nk = kOut * window;
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    sKy[i] = ky[(size_t)r * nk + i];
    sKx[i] = kx[(size_t)r * nk + i];
  }
  __syncthreads();

  const int c = 2 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (c >= C) return;
  // the same start clamping as a window slice of the canvas
  const int y0 = min(max(ystart[r], 0), H0 - window);
  const int x0 = min(max(xstart[r], 0), W0 - window);
  const size_t row_pitch = (size_t)W0 * C;
  const __nv_bfloat16* base =
      canvas + ((size_t)plane[r] * H0 + y0) * row_pitch + (size_t)x0 * C + c;

  float2 acc[kOut][kOut];
#pragma unroll
  for (int p = 0; p < kOut; ++p)
#pragma unroll
    for (int q = 0; q < kOut; ++q) acc[p][q] = make_float2(0.f, 0.f);

  for (int j = 0; j < window; ++j) {
    // column j of Ky @ F for this channel pair
    float2 mid[kOut];
#pragma unroll
    for (int p = 0; p < kOut; ++p) mid[p] = make_float2(0.f, 0.f);
    const __nv_bfloat16* col = base + (size_t)j * C;
    for (int i = 0; i < window; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(col + (size_t)i * row_pitch));
#pragma unroll
      for (int p = 0; p < kOut; ++p) {
        const float w = sKy[p * window + i];
        mid[p].x = fmaf(w, f.x, mid[p].x);
        mid[p].y = fmaf(w, f.y, mid[p].y);
      }
    }
    // then Kx: out[p, q] += Kx[q, j] * mid[p]
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const float w = sKx[q * window + j];
#pragma unroll
      for (int p = 0; p < kOut; ++p) {
        acc[p][q].x = fmaf(w, mid[p].x, acc[p][q].x);
        acc[p][q].y = fmaf(w, mid[p].y, acc[p][q].y);
      }
    }
  }

  __nv_bfloat16* o = out + (size_t)r * kOut * kOut * C + c;
#pragma unroll
  for (int p = 0; p < kOut; ++p)
#pragma unroll
    for (int q = 0; q < kOut; ++q)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(p * kOut + q) * C) =
          __floats2bfloat162_rn(acc[p][q].x, acc[p][q].y);
}

}  // namespace

// canvas (planes, H0, W0, C) bf16 contiguous; plane/ystart/xstart (n_rois,)
// int32; ky/kx (n_rois, 7, window) f32 -> out (n_rois, 7, 7, C) bf16.
// Returns a cudaError_t (0 on success).
extern "C" int macaque_roi_align_windowed(const void* canvas, const void* plane,
                                          const void* ystart, const void* xstart,
                                          const void* ky, const void* kx,
                                          void* out, int n_rois, int H0, int W0,
                                          int C, int window, void* stream) {
  if (n_rois < 0 || window < 1 || window > kMaxWindow || window > H0 ||
      window > W0 || C <= 0 || C % 2 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_rois == 0) return 0;
  const int pairs = C / 2;
  dim3 grid(n_rois, (pairs + kThreads - 1) / kThreads);
  roi_align_windowed_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(canvas), static_cast<const int*>(plane),
      static_cast<const int*>(ystart), static_cast<const int*>(xstart),
      static_cast<const float*>(ky), static_cast<const float*>(kx),
      static_cast<__nv_bfloat16*>(out), H0, W0, C, window);
  return (int)cudaGetLastError();
}
