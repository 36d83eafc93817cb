// Multi-head attention on unpacked (B, N, H, D) q, k, v (K4).
//
// Replaces macaque_tpu/nn/pallas_attention.py::fused_attention (:39,
// _attn_kernel :23, one grid step per batch element and head) and
// ::fused_attention_blocked (:86, _attn_kernel_blocked, one step per batch
// element with its heads in turn), which compute one function in float32:
//   S = (Q K^T) * scale,  P = softmax_rows(S),  O = P V     (all f32)
// with O written in the input dtype. Both take the one grid here, one block
// per (batch element, head): heads share no K or V, so a block per batch
// element only leaves SMs idle (64 blocks on 132 SMs at the crop shape).
//
// What bounds it on an H100: at the ViT-huge crop shape (64, 192, 16, 80)
// bf16 the call reads q, k, v and writes o once, 126 MB, and does
// 4 * B * H * N^2 * D = 12.1 GFLOP: 96 FLOP per byte, below the ~295 at which
// the bf16 tensor cores outrun 3.35 TB/s, so bytes bound it (0.038 ms).
// With P kept in f32, P V cannot take a plain bf16 mma; run on the CUDA
// cores it alone is 6 GFLOP of f32 FMAs, 0.09 ms at the 67 TFLOP/s peak.
//
// Design: the template of attention_core.cuh with kSplitP = true. P V runs
// on the tensor cores as hi V + lo V, P split into two bf16 terms that carry
// it to 16 significant bits (the header states the error bound): 18.1 GFLOP
// of bf16 mma with Q K^T, 0.055 ms at a third of the peak, beside the
// 0.038 ms that the bytes take. K and V reach
// shared memory by cp.async (V lands while Q K^T runs), P never leaves
// registers, and 67.6 KB of shared memory a block keeps 3 blocks on an SM.

#include "attention_core.cuh"

namespace {

constexpr int kN = 192, kD = 80;

__global__ void __launch_bounds__(kThreads, kMinBlocks) attention_kernel(AttnArgs a) {
  attention_block<kN, kD, true>(a);
}

}  // namespace

// q, k, v, out (batch, n, heads, head_dim) bf16, contiguous and 16-byte
// aligned. One block per (batch element, head). Returns a cudaError_t (0 on
// success).
extern "C" int macaque_attention(const void* q, const void* k, const void* v,
                                 void* out, int batch, int n, int heads,
                                 int head_dim, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || n != kN || head_dim != kD)
    return (int)cudaErrorInvalidValue;
  const AttnArgs a{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<__nv_bfloat16*>(out), heads, heads * kD, heads * kD,
                   scale};
  return launch<kN, kD>(attention_kernel, a, batch, static_cast<cudaStream_t>(stream));
}

// The blocks of the kernel one SM of the current device keeps resident.
// Returns a cudaError_t (0 on success).
extern "C" int macaque_attention_blocks_per_sm(int* blocks) {
  return resident_blocks<kN, kD>(attention_kernel, blocks);
}
