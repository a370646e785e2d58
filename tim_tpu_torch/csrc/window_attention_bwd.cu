// Swin3D (shifted-)window attention for Hopper (sm_90a), backward.
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash's backward
// (_bwd_kernel :109, pl.pallas_call :173, custom VJP :188-204). Given q, k,
// v, the bias [H, N, N] fp32, the [nW, N] region ids (or none), the
// forward's output o and row statistic lse, and do: dq, dk and dv in the
// input dtype, and dbias [H, N, N] fp32, the sum of dS over every window
// of the batch. The TPU kernel returns dab [n_types, H, N, N], dS summed
// over the windows of each type; the shift mask is a constant, so its sum
// over the types is the same quantity, and it is the gradient of the
// relative-position bias that WindowAttention3D gathers.
//
// What bounds it on the H100: at Swin-B stage 1 (batch 8 clips: 512
// windows x 4 heads, N = 784, dh = 32, bf16) the gradient is 5 products of
// 2 N^2 dh per (window, head): 403 GFLOP, 0.41 ms at 989 TFLOP/s (the
// bytes, 0.8 GB of q/k/v/o/do/dq/dk/dv plus 19.7 MB of bias and dbias,
// give 0.25 ms). The TPU kernel sums dab over a type's windows in a VMEM
// block the grid revisits; Hopper blocks run in no order, and one fp32
// atomic per score per window would be 1.26e9 atomics at that shape.
// Instead a third pass gives each (head, 64 x 64 tile) of dbias to one
// block, which walks the batch's windows and keeps the sum in registers
// (2 more products a score; no atomics, the same bits every run). The
// core is in flash_attention_bwd.cuh.

#include "flash_attention_bwd.cuh"

// Head dim 32, as the forward. strides: 24 element strides, (batch, head, row) for q, k, v, o, do, dq,
// dk and dv. bias: [heads, seq, seq] fp32, contiguous; region: [n_win, seq]
// int32 or null; dbias: [heads, seq, seq] fp32, contiguous, overwritten.
// lse: the forward's [batch, heads, seq] fp32 row statistic; delta:
// [batch, heads, seq] fp32 scratch. Returns the first CUDA error of the
// launches (0 on success).
extern "C" int tim_window_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const long long* strides,
    const float* lse, float* delta, const float* bias, const int* region,
    int n_win, float* dbias, int batch, int heads, int seq, int dh,
    int is_bf16, float scale, void* stream) {
  tim_attn::BwdParams p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  tim_attn::set_bwd_strides(p, strides);
  p.lse = lse; p.delta = delta;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = bias; p.region = region; p.n_win = n_win > 0 ? n_win : 1;
  p.dbias = dbias;
  return tim_attn::launch_bwd<32, true>(p, dh, is_bf16 != 0,
                                    static_cast<cudaStream_t>(stream));
}
