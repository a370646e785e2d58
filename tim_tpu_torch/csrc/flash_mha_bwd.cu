// Multi-head flash attention for Hopper (sm_90a), backward.
//
// Replaces: the backward of tim_tpu/ops/flash.py::flash_mha, i.e. the
// public Pallas TPU flash kernel's dkv and dq kernels (tiles set at
// flash.py:71-79; the JAX wrapper pads S to a multiple of 128 because
// those tiles must be multiples of 128). Here, as in the forward, the
// ragged last tile is masked and nothing is padded (S = 1568, 160, 37).
// Given q, k, v, the forward's output o and row statistic lse, and the
// output gradient do, it writes dq, dk and dv in the input dtype.
//
// What bounds it on the H100: at ViT-L's shapes ([8, 16, 1568, 64] bf16)
// the gradient is 5 products of 2 S^2 dh per (batch, head): 201 GFLOP,
// 0.20 ms at 989 TFLOP/s, against 0.1 GB of q/k/v/o/do/dq/dk/dv, so the
// tensor cores bound it, not memory. This first version recomputes the
// scores in two passes (dk/dv, then dq: 7 products, no atomics) with
// mma.sync and 64 x 64 tiles; per-score softmax work and mma.sync's issue
// rate are the likely limit. The core is in flash_attention_bwd.cuh.

#include "flash_attention_bwd.cuh"

// Head dim 64, as the forward. strides: 24 element strides, (batch, head, row) for q, k, v, o, do, dq,
// dk and dv. lse: the forward's [batch, heads, seq] fp32 row statistic;
// delta: [batch, heads, seq] fp32 scratch. Returns the first CUDA error of
// the launches (0 on success).
extern "C" int tim_flash_mha_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, void* dq,
                                 void* dk, void* dv, const long long* strides,
                                 const float* lse, float* delta, int batch,
                                 int heads, int seq, int dh, int is_bf16,
                                 float scale, void* stream) {
  tim_attn::BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  tim_attn::set_bwd_strides(p, strides);
  p.lse = lse; p.delta = delta;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = nullptr; p.region = nullptr; p.n_win = 1; p.dbias = nullptr;
  return tim_attn::launch_bwd<64, false>(p, dh, is_bf16 != 0,
                                     static_cast<cudaStream_t>(stream));
}
