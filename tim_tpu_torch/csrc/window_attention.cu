// Swin3D (shifted-)window attention for Hopper (sm_90a), forward only.
//
// Replaces: tim_tpu/ops/pallas_swin.py::window_attention_flash (forward
// _kernel :71, pl.pallas_call :99). Per (window, head):
// softmax(q k^T * scale + ab[type]) v with fp32 scores. The TPU kernel
// takes ab = relative-position bias + shift mask materialised as
// [n_types, H, N, N] fp32 and a window-type-major batch, so that its
// BlockSpec pipeline keeps one ab block resident. Here the two terms come
// apart: bias [H, N, N] fp32 (shared by every window) and, for shifted
// blocks, a [nW, N] int32 table of region ids; the score gains -100 where
// query and key lie in different regions, as shift_attention_mask's mask
// does. The window type is window_index % nW on the batch-major order that
// window_partition produces, so q, k and v need no transposes.
//
// What bounds it on the H100: at Swin-B's stage-1 shape (batch 8 clips:
// 512 windows x 4 heads, N = 784, dh = 32, bf16) the products are
// 161 GFLOP against 0.41 GB of q/k/v/out plus 9.8 MB of bias, so the
// tensor cores bound it (0.16 ms at 989 TFLOP/s; 0.12 ms of bytes). The
// TPU-layout ab of a shifted stage-1 block alone is 629 MB. With dh = 32
// each score carries only 128 flops of products, so the per-score work
// (exponential, bias from shared memory, region compare) is the likely
// limit of this first version; each block also reads its rows' bias
// (64 x N fp32) from L2.
// The core is in flash_attention.cuh.

#include "flash_attention.cuh"

// strides: 12 element strides, (batch, head, row) for q, k, v and out.
// bias: [heads, seq, seq] fp32, contiguous. region: [n_win, seq] int32,
// or null for an unshifted block. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int tim_window_attention(const void* q, const void* k,
                                    const void* v, void* out,
                                    const long long* strides,
                                    const float* bias, const int* region,
                                    int n_win, int batch, int heads, int seq,
                                    int dh, int is_bf16, float scale,
                                    void* stream) {
  tim_attn::Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out;
  tim_attn::set_strides(p, strides);
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = bias; p.region = region; p.n_win = n_win > 0 ? n_win : 1;
  return tim_attn::launch<true>(p, dh, is_bf16 != 0,
                                static_cast<cudaStream_t>(stream));
}
