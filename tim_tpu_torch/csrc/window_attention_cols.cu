// Swin3D (shifted-)window attention for Hopper (sm_90a), forward, at head
// dims past 256: the column-slice route of attention_cols_sm90.cuh (whose
// comment gives the design; bf16 on wgmma, fp32 on the CUDA cores, any
// head dim) with kernel 4's per-score terms, the fp32 bias row of [H, N,
// N] and, in shifted blocks, -100 where two tokens' region ids differ.
// bf16 starts each key tile's S accumulator at (bias + mask) / scale, so
// that the products and the softmax are kernel 5's; fp32 adds them to the
// scaled scores. window_attention.cu's entry dispatches here.
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash (forward
// _kernel :71, pl.pallas_call :99) past head dim 256 (a Swin-B trunk at
// num_heads (1, 1, 1, 1): 512 at stage 3, 1024 at stage 4).
//
// What bounds it on the H100: the products, 4 N^2 dh flops per (window,
// head) (161 GFLOP a Swin-B stage at batch 8, 0.16 ms at 989 TFLOP/s);
// this route does 1.5x them at 512 and 1.25x at 1024 (Q K^T once per
// 256-column output slice).

#include "attention_cols_sm90.cuh"

namespace tim_attn {

int launch_window_cols(const Params& p, int dh, bool bf16,
                       cudaStream_t stream) {
  ColsParams c{};
  c.q = p.q; c.k = p.k; c.v = p.v; c.out = p.out;
  c.kq = nullptr; c.vq = nullptr;
  c.sq = p.sq; c.sk = p.sk; c.sv = p.sv; c.so = p.so;
  c.batch = p.batch; c.heads = p.heads; c.nq = p.seq; c.nk = p.seq;
  c.dh = dh; c.scale = p.scale; c.lse = p.lse;
  c.bias = p.bias; c.region = p.region; c.n_win = p.n_win;
  return launch_cols<false, true>(c, bf16, stream);
}

}  // namespace tim_attn
