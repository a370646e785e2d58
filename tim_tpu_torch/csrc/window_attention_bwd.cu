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
// give 0.25 ms); the per-score work (an exponential, the bias, the region
// compare) weighs as much at dh 32. The TPU kernel sums dab over a type's
// windows in a VMEM block the grid revisits; Hopper blocks run in no
// order, and one fp32 atomic per score per window would be 1.26e9 atomics
// at that shape. The bf16 route (window_attention_bwd_sm90.cuh) is one
// wgmma pass whose blocks each sum dbias over a group of windows in
// shared memory; the fp32 route (CUDA cores, no TF32, three atomic-free
// passes) is the parity path, in flash_attention_bwd.cuh.
//
// Past head dim 32 that one pass does not fit (its dbias partial, seq x 64
// x 4 bytes, fills shared memory beside 32-column tiles, and it runs at
// 255 registers): bf16 takes kernel 5b's atomic-free two-pass routes of
// the instance, given the bias and the mask, and a dbias pass of its own
// (window_dbias_sm90.cuh); fp32 the CUDA-core passes of the instance. Every
// route past 32 is atomic-free: the same bits every run.

#include "flash_attention_bwd.cuh"
#include "flash_mha_bwd_sm90.cuh"

namespace {

constexpr int kDH = 32;

}  // namespace

// window_attention_bwd_sm90.cu (its own source, so that the two compile in
// parallel): the bf16 route's preprocess, one-pass kernel, groups' sum and,
// with a dq_accum, dq's postprocess.
extern "C" int tim_window_attention_bwd_sm90(
    const tim_attn::sm90::Params* p, cudaStream_t stream);

// Past head dim 32, sources of their own, built beside this one.
namespace tim_attn {
// window_attention_bwd_wide.cu: bf16 dq/dk/dv at 64, 80, 96, 112, 128
int launch_window_bwd_wide(const BwdParams& p, int dh, int inst,
                           cudaStream_t stream);
// window_attention_bwd_f32.cu: fp32 at 64 (dbias included)
int launch_window_bwd_f32(const BwdParams& p, cudaStream_t stream);
// window_attention_bwd_cols.cu: the column-chunk passes at 256 and past it
// in bf16, at 128 and past it in fp32 (fp32: dbias included)
int launch_window_bwd_cols(const BwdParams& p, int dh, bool bf16,
                           cudaStream_t stream);
// window_attention_dbias.cu: the bf16 dbias pass past 32
int launch_window_dbias(const BwdParams& p, const float* delta,
                        long long pitch, int dh, float* scratch, int groups,
                        cudaStream_t stream);
}  // namespace tim_attn

// The instance `inst` and head dim dh as the forward's (32; 64, 128, 256,
// in bf16 also 80, 96, 112; past 256 the column-slice route at dh). At 32:
// bf16 the one-pass wgmma core, fp32 the CUDA-core passes; past 32: bf16
// dq, dk and dv from two atomic-free wgmma passes (flash_mha_bwd_wide's at
// 64-128, the column-slice passes at 256 and past it) and dbias from the
// wgmma pass of window_dbias_sm90.cuh; fp32 the CUDA-core passes of
// flash_attention_bwd.cuh at 64, the column-chunk ones of
// attention_cols_bwd.cuh from 128 (the one-row-a-thread passes at 128 and
// 256 keep kilobytes a thread in local memory). strides: 24 element strides, (batch, head, row) for q, k, v,
// o, do, dq, dk and dv. bias: [heads, seq, seq] fp32, contiguous; region:
// [n_win, seq] int32 or null; dbias: [heads, seq, seq] fp32, contiguous,
// overwritten. lse: the forward's [batch, heads, seq] fp32 row statistic;
// delta: fp32 scratch for D, [batch, heads, seq] (bf16 at 64-128: [2][batch
// * heads][seq rounded up to 4]). bf16 at 32 only: dq_accum [batch, heads,
// seq, 32] fp32 scratch (zeroed here), or null for the deterministic route
// (dq without atomic adds). dbias_groups: [groups, heads, seq, seq] fp32
// scratch when groups is above 1, else null (bf16: at 32 groups from
// tim_window_attention_bwd_groups, past 32 from the wrapper). Returns the
// first CUDA error of the launches (0 on success).
extern "C" int tim_window_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const long long* strides,
    const float* lse, float* delta, float* dq_accum, const float* bias,
    const int* region, int n_win, float* dbias, float* dbias_groups,
    int groups, int batch, int heads, int seq, int dh, int inst,
    int is_bf16, float scale, void* stream) {
  const bool in_place = is_bf16 && inst > 64 && inst <= 128 && dh == inst - 8;
  if (dh != inst && !in_place) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0 || seq <= 0) return 0;
  if (groups < 1 || (groups > 1 && dbias_groups == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tim_attn::BwdParams bp{};
  bp.q = q; bp.k = k; bp.v = v; bp.o = o; bp.dout = dout;
  bp.dq = dq; bp.dk = dk; bp.dv = dv;
  tim_attn::set_bwd_strides(bp, strides);
  bp.lse = lse; bp.delta = delta;
  bp.batch = batch; bp.heads = heads; bp.seq = seq; bp.scale = scale;
  bp.bias = bias; bp.region = region; bp.n_win = n_win > 0 ? n_win : 1;
  bp.dbias = dbias;
  if (inst != kDH) {
    if (!is_bf16) {
      if (inst == 64) return tim_attn::launch_window_bwd_f32(bp, st);
      return inst >= 128 ? tim_attn::launch_window_bwd_cols(bp, dh, false, st)
                         : (int)cudaErrorInvalidValue;
    }
    int err;
    long long pitch = seq;
    const float* d = delta;
    if (inst >= 256) {
      err = tim_attn::launch_window_bwd_cols(bp, dh, true, st);
    } else if (inst >= 64 && inst <= 128 && inst % 16 == 0) {
      err = tim_attn::launch_window_bwd_wide(bp, dh, inst, st);
      // D is the second half of the passes' padded stats rows
      pitch = (seq + 3) / 4 * 4;
      d = delta + (long long)batch * heads * pitch;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
    return tim_attn::launch_window_dbias(bp, d, pitch, dh, dbias_groups,
                                         groups, st);
  }
  if (!is_bf16) return tim_attn::launch_bwd_f32<kDH, true>(bp, st);

  using bf = __nv_bfloat16;
  tim_attn::sm90::Params p{};
  p.q = static_cast<const bf*>(q); p.k = static_cast<const bf*>(k);
  p.v = static_cast<const bf*>(v); p.o = static_cast<const bf*>(o);
  p.dout = static_cast<const bf*>(dout);
  p.dq = static_cast<bf*>(dq); p.dk = static_cast<bf*>(dk);
  p.dv = static_cast<bf*>(dv);
  p.sq = bp.sq; p.sk = bp.sk; p.sv = bp.sv; p.so = bp.so;
  p.sdo = bp.sdo; p.sdq = bp.sdq; p.sdk = bp.sdk; p.sdv = bp.sdv;
  p.lse = lse; p.delta = delta; p.dq_accum = dq_accum;
  p.batch = batch; p.heads = heads; p.seq = seq; p.scale = scale;
  p.bias = bias; p.region = region; p.n_win = bp.n_win; p.dbias = dbias;
  p.dbias_groups = dbias_groups; p.groups = groups;
  const int err = tim_window_attention_bwd_sm90(&p, st);
  if (err != 0 || dq_accum != nullptr) return err;
  // the deterministic route's dq: the atomic-free pass of
  // flash_attention_bwd.cuh (one block per 64 queries walks the key tiles),
  // reading the D that the preprocess wrote
  const long long blocks = (long long)batch * heads * ((seq + 63) / 64);
  return tim_attn::launch_smem(tim_attn::dq_bf16_kernel<kDH, true>, blocks,
                               tim_attn::dq_smem_bytes<kDH, true>(), st, bp);
}
