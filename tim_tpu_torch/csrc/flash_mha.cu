// Multi-head flash attention for Hopper (sm_90a), forward (the backward is
// flash_mha_bwd.cu).
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
// kernel keeps scores in registers. Each score also takes one exponential
// (315 M at this shape: 0.08 ms of the SM's 16-a-clock unit at 1.755 GHz,
// computed), as much as the products, so bf16 runs on the wgmma core of
// flash_attention_sm90.cuh, which overlaps the softmax work with the
// products (128 queries a block, 64-key tiles through a four-stage TMA
// ring). fp32 keeps flash_attention.cuh's CUDA-core kernel.

#include "flash_attention_sm90.cuh"

// Head dim 64 (ViT-B/L and the MAE decoder); another returns
// cudaErrorInvalidValue. strides: 12 element strides, (batch, head, row)
// for q, k, v and out. lse: [batch, heads, seq] fp32 for the backward, or null. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tim_flash_mha(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, float* lse,
                             int batch, int heads, int seq, int dh,
                             int is_bf16, float scale, void* stream) {
  tim_attn::Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out;
  tim_attn::set_strides(p, strides);
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.lse = lse;
  p.bias = nullptr; p.region = nullptr; p.n_win = 1;
  return tim_attn::launch<64, false>(p, dh, is_bf16 != 0,
                                 static_cast<cudaStream_t>(stream));
}
