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
//
// Head dims 128 and 256 take the same core with each tile split into
// 64-column blocks (one TMA box and one wgmma operand each); 256 streams
// 32-key tiles so that four stages still fit beside Q. bf16 head dims 80,
// 96 and 112 (VideoMAE ViT-H/16's 80, ViT-g/14's 88 and ViT-G/14's 104
// read in place) are flash_mha_wide.cu's instances of the same core, with
// a 32- and / or 16-column tail block in the 64- and 32-byte swizzles.

#include "flash_attention_sm90.cuh"

namespace tim_attn {
// flash_mha_wide.cu: bf16 at instances 80, 96 and 112
int launch_mha_bf16_wide(const Params& p, int inst, cudaStream_t stream);
}  // namespace tim_attn

// The instance `inst`: 64 (ViT-B/L and the MAE decoder), 128 and 256, and
// in bf16 80, 96 and 112 (the wrapper, ops/flash_mha.py, picks it and
// zero-pads the head dims it cannot read in place); another returns
// cudaErrorInvalidValue. dh: the head dim of q, k, v and out, the
// instance's, or in bf16 past 64 up to 8 less (read in place: TMA fills
// the columns past it with zeros, and they are not stored). strides: 12
// element strides, (batch, head, row) for q, k, v and out. lse: [batch,
// heads, seq] fp32 for the backward, or null. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int tim_flash_mha(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, float* lse,
                             int batch, int heads, int seq, int dh, int inst,
                             int is_bf16, float scale, void* stream) {
  tim_attn::Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out;
  tim_attn::set_strides(p, strides);
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.lse = lse;
  p.bias = nullptr; p.region = nullptr; p.n_win = 1;
  p.dh = dh;
  const bool bf16 = is_bf16 != 0;
  const bool in_place = bf16 && inst > 64 && inst <= 128 && dh == inst - 8;
  if (dh != inst && !in_place) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 64: return tim_attn::launch<64, false>(p, inst, bf16, st);
    case 128: return tim_attn::launch<128, false>(p, inst, bf16, st);
    case 256: return tim_attn::launch<256, false>(p, inst, bf16, st);
    case 80:
    case 96:
    case 112:
      return bf16 ? tim_attn::launch_mha_bf16_wide(p, inst, st)
                  : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}
