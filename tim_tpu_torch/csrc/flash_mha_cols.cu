// Multi-head flash attention for Hopper (sm_90a), forward, at head dims
// past 256: the column-slice route of attention_cols_sm90.cuh (whose
// comment gives the function, the bound and the design), bf16 on wgmma
// and fp32 on the CUDA cores, any head dim.
//
// Replaces: tim_tpu/ops/flash.py::flash_mha (the public Pallas TPU flash
// kernel, fa.flash_attention at :104) past head dim 256: a ViT at
// finetune_cli --num_heads 2 (ViT-L's 1024 wide: head dim 512) or 1.
//
// What bounds it on the H100: the products, 4 S^2 dh flops per (batch,
// head) (80.6 GFLOP at [8, 2, 1568, 512], 0.08 ms at 989 TFLOP/s), as at
// the presets' head dims, since H dh is the same. Up to 512 one block a
// 256-column output slice (Q resident in shared memory) forms Q K^T
// itself, 1.5x the products at 512; from 513 to 2048 in bf16 the slices of
// a query tile run as one thread-block cluster that forms it once; past
// 2048 Q streams with K.

#include "attention_cols_sm90.cuh"

// q, k, v, out: [batch, heads, seq, dh] views, the last dim contiguous
// (bf16: rows and base 16-byte aligned, dh a multiple of 8; the wrapper,
// ops/flash_mha.py, copies other inputs into zero-padded rows). strides:
// 12 element strides, (batch, head, row) for q, k, v and out. lse: [batch,
// heads, seq] fp32 for the backward, or null. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int tim_flash_mha_cols(const void* q, const void* k,
                                  const void* v, void* out,
                                  const long long* strides, float* lse,
                                  int batch, int heads, int seq, int dh,
                                  int is_bf16, float scale,
                                  void* stream) {
  tim_attn::ColsParams p{};
  p.q = q; p.k = k; p.v = v; p.out = out;
  long long st[18] = {};
  for (int i = 0; i < 12; ++i) st[i] = strides[i];
  tim_attn::set_cols_strides(p, st);
  p.batch = batch; p.heads = heads; p.nq = seq; p.nk = seq; p.dh = dh;
  p.scale = scale; p.lse = lse;
  return tim_attn::launch_cols<false>(p, is_bf16 != 0,
                                      static_cast<cudaStream_t>(stream));
}
