// Swin3D (shifted-)window attention for Hopper (sm_90a), backward: the bf16
// bias gradient past head dim 32, window_dbias_sm90.cuh's wgmma pass
// (whose comment gives the function and the design), in a source of its
// own so that nvcc builds it beside the dq/dk/dv passes.
//
// Replaces: the dab output of tim_tpu/ops/pallas_swin.py::_bwd_kernel
// (:109; summed over the window types, the gradient of the
// relative-position bias) at bf16 head dims 33 and up.
//
// What bounds it on the H100: its two products, 4 N^2 dh flops per
// (window, head) (161 GFLOP a Swin-B stage at batch 8, 0.16 ms at 989
// TFLOP/s), and one exponential a score.

#include "window_dbias_sm90.cuh"

namespace tim_attn {

int launch_window_dbias(const BwdParams& p, const float* delta,
                        long long pitch, int dh, float* scratch, int groups,
                        cudaStream_t stream) {
  return launch_window_dbias_bf16(p, delta, pitch, dh, scratch, groups,
                                  stream);
}

}  // namespace tim_attn

// The dbias pass alone (to hold it and time it on its own): bf16 q, k, v,
// dout [batch, heads, seq, dh] views (dh a multiple of 8, rows 16-byte
// aligned), strides: 12 element strides, (batch, head, row) of q, k, v and
// dout; lse and delta (D = do . o): [batch, heads, seq] fp32; bias, region,
// dbias and the groups' scratch as tim_window_attention_bwd's. Returns the
// first CUDA error of the launches (0 on success).
extern "C" int tim_window_attention_dbias(
    const void* q, const void* k, const void* v, const void* dout,
    const long long* strides, const float* lse, const float* delta,
    const float* bias, const int* region, int n_win, float* dbias,
    float* scratch, int groups, int batch, int heads, int seq, int dh,
    float scale, void* stream) {
  tim_attn::BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  tim_attn::Strides* s[4] = {&p.sq, &p.sk, &p.sv, &p.sdo};
  for (int i = 0; i < 4; ++i)
    *s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.lse = lse;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = bias; p.region = region; p.n_win = n_win > 0 ? n_win : 1;
  p.dbias = dbias;
  return tim_attn::launch_window_dbias_bf16(p, delta, seq, dh, scratch,
                                            groups,
                                            static_cast<cudaStream_t>(stream));
}
