// Multi-head flash attention for Hopper (sm_90a), forward only.
//
// Replaces: tim_tpu/ops/flash.py::flash_mha (the public Pallas TPU flash
// kernel, fa.flash_attention at :104). Exact unmasked
// softmax(q k^T * scale) v over [B, H, S, dh], fp32 scores and online
// accumulators, output in the input dtype. The JAX wrapper pads S to a
// multiple of 128 with segment ids, a TPU tiling rule; this kernel masks
// its own ragged last key tile instead (ViT-L: S = 1568 = 24.5 x 64).
//
// What bounds it on the H100: at ViT-L's shapes ([8, 16, 1568, 64] bf16)
// the products are 4 * B * H * S^2 * dh = 80.6 GFLOP against 51 MB of
// q/k/v/out, about 1,600 operations per byte, so the bound is the tensor
// cores (0.08 ms at 989 TFLOP/s), not memory. The einsum formulation also
// writes and re-reads a [B, H, S, S] fp32 score tensor (1.26 GB); this
// kernel keeps scores in registers. It is a first version (mma.sync
// m16n8k16, not wgmma; 64 x 64 tiles; a two-stage cp.async ring): the
// per-score softmax work and mma.sync's issue rate, not memory, are the
// likely limit (the card's machine gives no profiler counters to confirm).
// The core is in flash_attention.cuh.

#include "flash_attention.cuh"

// strides: 12 element strides, (batch, head, row) for q, k, v and out.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tim_flash_mha(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int batch,
                             int heads, int seq, int dh, int is_bf16,
                             float scale, void* stream) {
  tim_attn::Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out;
  tim_attn::set_strides(p, strides);
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = nullptr; p.region = nullptr; p.n_win = 1;
  return tim_attn::launch<false>(p, dh, is_bf16 != 0,
                                 static_cast<cudaStream_t>(stream));
}
