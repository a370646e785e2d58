// Multi-head flash attention for Hopper (sm_90a), backward, at head dims
// past 256: the column-slice passes of attention_cols_bwd_sm90.cuh (bf16,
// wgmma) and attention_cols_bwd.cuh (fp32 on the CUDA cores, and D),
// whose comments give the function and the design; any head dim,
// atomic-free (the same bits every run).
//
// Replaces: the backward of tim_tpu/ops/flash.py::flash_mha (the public
// Pallas TPU flash kernel's dkv and dq kernels, tiles set at
// flash.py:71-79) past head dim 256.
//
// What bounds it on the H100: the 5 products of 2 S^2 dh per (batch,
// head) (201 GFLOP at [8, 2, 1568, 512], 0.20 ms at 989 TFLOP/s); the bf16
// route recomputes S and dP in each output slice of each pass (128
// columns for dk/dv, 256 for dq), 15 products' worth at 512 instead of 5.

#include "attention_cols_bwd_sm90.cuh"

// q, k, v, o, dout, dq, dk, dv: [batch, heads, seq, dh] views, the last
// dim contiguous (bf16: rows 16-byte aligned, dh a multiple of 8; the
// wrapper, ops/flash_mha.py, copies other inputs into zero-padded rows).
// strides: 24 element strides, (batch, head, row) for q, k, v, o, do, dq,
// dk and dv. lse: the forward's [batch, heads, seq] fp32 row statistic;
// delta: [batch, heads, seq] fp32 scratch. Returns the first CUDA error
// of the launches (0 on success).
extern "C" int tim_flash_mha_bwd_cols(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const long long* strides,
    const float* lse, float* delta, int batch, int heads, int seq, int dh,
    int is_bf16, float scale, void* stream) {
  tim_attn::BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  tim_attn::set_bwd_strides(p, strides);
  p.lse = lse; p.delta = delta;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = nullptr; p.region = nullptr; p.n_win = 1; p.dbias = nullptr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tim_attn::launch_bwd_cols_bf16(p, dh, st);
  return tim_attn::launch_bwd_cols_f32(p, dh, st);
}
