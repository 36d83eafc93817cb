// Packed multi-head attention for the ViTPose blocks (K1).
//
// Replaces macaque_tpu/nn/pallas_attention.py::fused_attention_packed
// (:137, _attn_kernel_packed :110): softmax(Q K^T / sqrt(d)) V computed
// directly on the packed qkv Dense output (B, N, 3C) bf16, written as
// (B, N, C) bf16 with head h at columns [h*d, (h+1)*d) -- the layout the
// output projection reads. The TPU kernel rounds P to the input dtype before
// P V; so does this one.
//
// What bounds it on an H100: at ViTPose-huge shapes (N = 192, d = 80) one
// (sequence, head) reads 3*N*d*2 = 92 KB, writes N*d*2 = 31 KB and does
// 2*2*N*N*d = 11.8 MFLOP, about 96 FLOP per byte -- below the ~295 FLOP/byte
// at which the bf16 tensor cores, not HBM, become the limit. So it is bound by
// bytes: each input byte is read from HBM once and the N x N score tile
// never leaves registers.
//
// Design: the template of attention_core.cuh with kSplitP = false, q, k and
// v at offsets 0, C and 2C of the packed rows (token stride 3C). K and V
// reach shared memory row-major by cp.async, with no transpose (P V reads V
// through ldmatrix.trans), and Q goes from global memory straight into
// registers, so a block holds 67.6 KB and 3 blocks share an SM, where the
// staged Q, K and V^T panels (97 KB) of the first version allowed 2; the
// blocks resident on an SM overlap one block's copies with another's math.

#include "attention_core.cuh"

namespace {

constexpr int kN = 192, kD = 80;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
packed_attention_kernel(AttnArgs a) {
  attention_block<kN, kD, false>(a);
}

}  // namespace

// qkv (batch, n, 3 * heads * head_dim) bf16 contiguous and 16-byte aligned ->
// out (batch, n, heads * head_dim) bf16. Returns a cudaError_t (0 on success).
extern "C" int macaque_packed_attention(const void* qkv, void* out, int batch,
                                        int n, int heads, int head_dim,
                                        float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || n != kN || head_dim != kD)
    return (int)cudaErrorInvalidValue;
  const int C = heads * kD;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const AttnArgs a{q, q + C, q + 2 * C, static_cast<__nv_bfloat16*>(out), heads,
                   3 * C, C, scale};
  return launch<kN, kD>(packed_attention_kernel, a, batch,
                        static_cast<cudaStream_t>(stream));
}

// The blocks of the kernel one SM of the current device keeps resident.
// Returns a cudaError_t (0 on success).
extern "C" int macaque_packed_attention_blocks_per_sm(int* blocks) {
  return resident_blocks<kN, kD>(packed_attention_kernel, blocks);
}
