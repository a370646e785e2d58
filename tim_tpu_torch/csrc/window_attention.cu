// Swin3D (shifted-)window attention for Hopper (sm_90a), forward (the
// backward is window_attention_bwd.cu).
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
// sets the floor: 1.26 G exponentials take 0.34 ms of the SM's
// 16-a-clock unit at 1.755 GHz (computed), twice the products' bound, and
// each score also adds its fp32 bias and compares region ids. bf16 runs on
// the wgmma core of flash_attention_sm90.cuh (a block takes 64 query rows
// of a pair of windows, so each bias row is read from L2 once for two
// windows; two blocks an SM; 48-key tiles of k and v through four-stage
// TMA rings; the bias read into registers a tile ahead; the region compare
// skipped in windows of one region; the softmax work overlaps the
// products); fp32 keeps flash_attention.cuh's CUDA-core kernel.

#include "flash_attention_sm90.cuh"

// Past head dim 32 the instances live in sources of their own, built beside
// this one: window_attention_64.cu (bf16 48, 64: kernel 4's window-pair
// design, window_attention_sm90.cuh), window_attention_wide.cu (bf16 80,
// 96, 112), window_attention_256.cu (bf16 128, 256),
// window_attention_f32.cu (fp32 64, 128, 256) and window_attention_cols.cu
// (past 256, both types).
namespace tim_attn {
int launch_window_64(const Params& p, int inst, int bias_pitch,
                     cudaStream_t stream);
int launch_window_wide(const Params& p, int inst, cudaStream_t stream);
int launch_window_256(const Params& p, int inst, cudaStream_t stream);
int launch_window_f32(const Params& p, int inst, cudaStream_t stream);
int launch_window_cols(const Params& p, int dh, bool bf16,
                       cudaStream_t stream);
}  // namespace tim_attn

// The instance `inst` (the wrapper, ops/window_attention.py, picks it and
// zero-pads the head dims it cannot read in place): 32; 64, 128, 256 and in
// bf16 48, 80, 96, 112; past 256 the column-slice route at dh itself
// (in bf16 from 513 to 2048 the slices of a query tile as one cluster).
// dh: the head dim of q, k, v and out, the instance's, or in
// bf16 at 48 and 64 a multiple of 8 up to 8 less and past 64 8 less (read
// in place: TMA fills the columns past it with zeros, and they are not
// stored); another pair returns cudaErrorInvalidValue.
// strides: 12 element strides, (batch, head, row) for q, k, v and out.
// bias: [heads, seq, seq] fp32, 16-byte aligned, rows bias_pitch floats
// apart (seq, or in bf16 at 48 and 64 seq rounded up to a multiple of 4;
// seq elsewhere). region: [n_win, seq] int32, or null for an unshifted
// block. lse: [batch, heads, seq] fp32 for the backward, or null. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int tim_window_attention(const void* q, const void* k,
                                    const void* v, void* out,
                                    const long long* strides, float* lse,
                                    const float* bias, int bias_pitch,
                                    const int* region, int n_win, int batch,
                                    int heads, int seq, int dh, int inst,
                                    int is_bf16, float scale,
                                    void* stream) {
  tim_attn::Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out;
  tim_attn::set_strides(p, strides);
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.lse = lse;
  p.bias = bias; p.region = region; p.n_win = n_win > 0 ? n_win : 1;
  p.dh = dh;
  const bool bf16 = is_bf16 != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inst > 256)
    return dh == inst && bias_pitch == seq
               ? tim_attn::launch_window_cols(p, dh, bf16, st)
               : (int)cudaErrorInvalidValue;
  const bool pair = bf16 && (inst == 48 || inst == 64);
  if (pair) return tim_attn::launch_window_64(p, inst, bias_pitch, st);
  const bool in_place = bf16 && inst > 64 && inst <= 128 && dh == inst - 8;
  if ((dh != inst && !in_place) || bias_pitch != seq)
    return (int)cudaErrorInvalidValue;
  if (inst == 32) return tim_attn::launch<32, true>(p, dh, bf16, st);
  if (!bf16) return tim_attn::launch_window_f32(p, inst, st);
  return inst >= 128 ? tim_attn::launch_window_256(p, inst, st)
                     : tim_attn::launch_window_wide(p, inst, st);
}
